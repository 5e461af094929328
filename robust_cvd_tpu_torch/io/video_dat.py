"""`video.dat` v13 — the binary clip-state container format.

A copy of robust_cvd_tpu/io/video_dat.py (numpy only), so that both
packages write byte-identical files.

Byte-compatible with the reference serializer (lib/DepthVideo.cpp:300-385
save, :121-298 load; DepthPhoto.cpp:101-110/178-205; DepthMapTransform.cpp
readXform/writeXform + XformDescriptor::str/parse/fwrite):

    [0xDEADBEEF:u32][fileFormat:u32=13][dpFormat:u32=3][numFrames:i32]
    [pts:f32 x N]
    [numColorStreams:i32] { name,dir,ext:str; cv_type:i32; w,h:i32;
                            hasGop:bool=false }
    [numDepthStreams:i32] { name,dir:str; depthXformDesc; spatialXformDesc;
                            w,h:i32; hasGop:bool=false;
      per frame: intrinsics(projection:i32, vFov,hFov,centerLat,centerLon:f32)
                 extrinsics(pos 3xf32, quat 4xf32 as [x,y,z,w])
                 enabled:bool, depthXform, spatialXform }
    [duration:f32][w,h:i32][aspect,invAspect:f32][0xDEADBEEF:u32]

Strings are [len:u64][bytes]. An xform is [XformType:i32][descriptor:str]
followed by numParams raw f64. Note: the reference's save() writes the
hasGop bool but its load() has the corresponding read commented out (a
latent reference bug, lib/DepthVideo.cpp:192-198 vs :331); we WRITE it for
byte parity with save() and READ it for files of format >= 12.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

MAGIC = 0xDEADBEEF
FILE_FORMAT = 13
MIN_SUPPORTED = 9
DP_FORMAT = 3

# enum wire values
XFORM_DEPTH, XFORM_SPATIAL = 0, 1
DEPTH_TYPES = ("None", "Identity", "Global", "Grid")
SPATIAL_TYPES = (
    "None", "Identity", "VerticalLinear", "CornersBilinear",
    "BilinearGrid", "BicubicGrid",
)
VALUE_XFORMS = ("None", "Scale", "ScaleShift")
VALUE_XFORM_NUM_PARAMS = {"None": 0, "Scale": 1, "ScaleShift": 2}


@dataclass
class XformDesc:
    """Mirror of reference XformDescriptor (lib/DepthMapTransform.h:50-84)."""

    type: str = "Depth"  # Depth | Spatial
    depth_type: str = "Identity"
    spatial_type: str = "None"
    value_xform: str = "None"
    cubic: bool = False
    grid_size: tuple = (0, 0, 0)  # (gx, gy, gz)
    depth_min_max: tuple = (0.0, 0.0)

    # -- string grammar (reference XformDescriptor::str, .cpp:116-165) ------

    def to_string(self) -> str:
        if self.type == "Depth":
            if self.depth_type == "Identity":
                return "Identity()"
            if self.depth_type == "Global":
                return f"Global({self.value_xform})"
            if self.depth_type == "Grid":
                gx, gy, gz = self.grid_size
                interp = "Cubic" if self.cubic else "Linear"
                if gz > 1:
                    return (
                        f"Grid({self.value_xform}, {interp}, {gx}, {gy}, {gz}, "
                        f"{self.depth_min_max[0]:f}, {self.depth_min_max[1]:f})"
                    )
                return f"Grid({self.value_xform}, {interp}, {gx}, {gy}, {gz})"
            raise ValueError(self.depth_type)
        if self.type == "Spatial":
            if self.spatial_type in ("BilinearGrid", "BicubicGrid"):
                gx, gy, _ = self.grid_size
                return f"{self.spatial_type}({gx}, {gy})"
            return self.spatial_type
        raise ValueError(self.type)

    @classmethod
    def parse(cls, s: str, type_hint: Optional[str] = None) -> "XformDesc":
        s = s.strip()
        name, args = (s.split("(", 1) + [""])[:2]
        name = name.strip()
        args = [a.strip() for a in args.rstrip(")").split(",")] if args else []
        args = [a for a in args if a]

        if name in ("Identity", "Global", "Grid") and type_hint != "Spatial":
            d = cls(type="Depth", depth_type=name)
            if name == "Global":
                d.value_xform = args[0]
            elif name == "Grid":
                d.value_xform = args[0]
                d.cubic = args[1] == "Cubic"
                gx, gy, gz = int(args[2]), int(args[3]), int(args[4])
                d.grid_size = (gx, gy, gz)
                if len(args) > 5:
                    d.depth_min_max = (float(args[5]), float(args[6]))
            return d
        if name in SPATIAL_TYPES:
            d = cls(type="Spatial", depth_type="None", spatial_type=name)
            if name in ("BilinearGrid", "BicubicGrid"):
                d.grid_size = (int(args[0]), int(args[1]), 0)
            return d
        # Identity is ambiguous between Depth "Identity()" and Spatial
        # "Identity" — the "( )" form means depth; bare means spatial.
        raise ValueError(f"cannot parse xform descriptor: {s!r}")

    def num_params(self) -> int:
        """(reference transform ctors, lib/DepthMapTransform.cpp)."""
        if self.type == "Depth":
            if self.depth_type == "Identity":
                return 0
            n = VALUE_XFORM_NUM_PARAMS[self.value_xform]
            if self.depth_type == "Global":
                return n
            gx, gy, gz = self.grid_size
            return n * gx * gy * gz
        st = self.spatial_type
        if st == "Identity":
            return 0
        if st == "VerticalLinear":
            return 4
        if st == "CornersBilinear":
            return 8
        gx, gy, _ = self.grid_size
        return 2 * gx * gy

    def default_params(self) -> np.ndarray:
        """Grid depth params init to 1, spatial warps to 0 (reference
        .cpp:707, 1346-1363)."""
        n = self.num_params()
        if self.type == "Depth":
            return np.ones(n, np.float64)
        return np.zeros(n, np.float64)


@dataclass
class ColorStreamInfo:
    name: str
    dir: str
    extension: str
    cv_type: int
    width: int
    height: int


@dataclass
class DepthFrameInfo:
    projection: int = 0  # Perspective
    vfov: float = 0.0
    hfov: float = 0.0
    center_lat: float = 0.0
    center_lon: float = 0.0
    position: tuple = (0.0, 0.0, 0.0)
    quaternion: tuple = (0.0, 0.0, 0.0, 1.0)  # [x, y, z, w]
    enabled: bool = True
    depth_params: Optional[np.ndarray] = None
    spatial_params: Optional[np.ndarray] = None


@dataclass
class DepthStreamInfo:
    name: str
    dir: str
    depth_desc: XformDesc
    spatial_desc: XformDesc
    width: int
    height: int
    frames: List[DepthFrameInfo] = field(default_factory=list)


@dataclass
class VideoDat:
    pts: List[float]
    color_streams: List[ColorStreamInfo]
    depth_streams: List[DepthStreamInfo]
    duration: float
    width: int
    height: int

    @property
    def aspect(self) -> float:
        return self.width / self.height


# -- low-level IO ------------------------------------------------------------


def _w(os, fmt, *vals):
    os.write(struct.pack("<" + fmt, *vals))


def _wstr(os, s: str):
    data = s.encode()
    _w(os, "Q", len(data))
    os.write(data)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, fmt):
        size = struct.calcsize("<" + fmt)
        vals = struct.unpack_from("<" + fmt, self.data, self.pos)
        self.pos += size
        return vals if len(vals) > 1 else vals[0]

    def take_str(self) -> str:
        n = self.take("Q")
        s = self.data[self.pos : self.pos + n].decode()
        self.pos += n
        return s

    def take_f64(self, n) -> np.ndarray:
        out = np.frombuffer(self.data, np.float64, count=n, offset=self.pos).copy()
        self.pos += 8 * n
        return out


def _write_xform(os, desc: XformDesc, params: np.ndarray):
    _w(os, "i", XFORM_DEPTH if desc.type == "Depth" else XFORM_SPATIAL)
    _wstr(os, desc.to_string())
    os.write(np.asarray(params, np.float64).tobytes())


def _read_xform(r: _Reader):
    t = r.take("i")
    desc = XformDesc.parse(r.take_str(), "Spatial" if t == XFORM_SPATIAL else "Depth")
    params = r.take_f64(desc.num_params())
    return desc, params


def save_video_dat(path, vd: VideoDat) -> None:
    with open(path, "wb") as os_:
        _w(os_, "I", MAGIC)
        _w(os_, "I", FILE_FORMAT)
        _w(os_, "I", DP_FORMAT)
        _w(os_, "i", len(vd.pts))
        for t in vd.pts:
            _w(os_, "f", t)

        _w(os_, "i", len(vd.color_streams))
        for cs in vd.color_streams:
            _wstr(os_, cs.name)
            _wstr(os_, cs.dir)
            _wstr(os_, cs.extension)
            _w(os_, "i", cs.cv_type)
            _w(os_, "ii", cs.width, cs.height)
            _w(os_, "?", False)  # hasGop (reference save, DepthVideo.cpp:331)

        _w(os_, "i", len(vd.depth_streams))
        for ds in vd.depth_streams:
            _wstr(os_, ds.name)
            _wstr(os_, ds.dir)
            _w(os_, "i", XFORM_DEPTH)
            _wstr(os_, ds.depth_desc.to_string())
            _w(os_, "i", XFORM_SPATIAL)
            _wstr(os_, ds.spatial_desc.to_string())
            _w(os_, "ii", ds.width, ds.height)
            _w(os_, "?", False)  # hasGop
            for f in ds.frames:
                _w(os_, "i", f.projection)
                _w(os_, "ffff", f.vfov, f.hfov, f.center_lat, f.center_lon)
                _w(os_, "fff", *f.position)
                _w(os_, "ffff", *f.quaternion)
                _w(os_, "?", f.enabled)
                dp = f.depth_params if f.depth_params is not None else ds.depth_desc.default_params()
                sp = f.spatial_params if f.spatial_params is not None else ds.spatial_desc.default_params()
                _write_xform(os_, ds.depth_desc, dp)
                _write_xform(os_, ds.spatial_desc, sp)

        _w(os_, "f", vd.duration)
        _w(os_, "ii", vd.width, vd.height)
        _w(os_, "ff", vd.aspect, 1.0 / vd.aspect)
        _w(os_, "I", MAGIC)


def load_video_dat(path) -> VideoDat:
    with open(path, "rb") as f:
        r = _Reader(f.read())
    if r.take("I") != MAGIC:
        raise ValueError("missing magic marker at start of video.dat")
    file_format = r.take("I")
    dp_format = r.take("I")
    if file_format > FILE_FORMAT:
        raise ValueError("file format too new")
    if file_format < MIN_SUPPORTED:
        raise ValueError("file format too old")

    n = r.take("i")
    pts = [r.take("f") for _ in range(n)]

    color_streams = []
    for _ in range(r.take("i")):
        name = r.take_str()
        dir_ = r.take_str()
        ext = r.take_str()
        cv_type = r.take("i")
        w, h = r.take("ii")
        if file_format >= 12:
            r.take("?")  # hasGop (always false; gop tables unsupported)
        color_streams.append(ColorStreamInfo(name, dir_, ext, cv_type, w, h))

    depth_streams = []
    for _ in range(r.take("i")):
        name = r.take_str()
        dir_ = r.take_str()
        t0 = r.take("i")
        ddesc = XformDesc.parse(r.take_str(), "Spatial" if t0 == XFORM_SPATIAL else "Depth")
        t1 = r.take("i")
        sdesc = XformDesc.parse(r.take_str(), "Spatial" if t1 == XFORM_SPATIAL else "Depth")
        w, h = r.take("ii")
        if file_format >= 13:
            r.take("?")  # hasGop
        ds = DepthStreamInfo(name, dir_, ddesc, sdesc, w, h)
        for _ in range(n):
            fi = DepthFrameInfo()
            if dp_format >= 3:
                fi.projection = r.take("i")
            fi.vfov = r.take("f")
            fi.hfov = r.take("f")
            if dp_format >= 3:
                fi.center_lat = r.take("f")
                fi.center_lon = r.take("f")
            fi.position = r.take("fff")
            fi.quaternion = r.take("ffff")
            if file_format >= 11:
                fi.enabled = r.take("?")
            d2, fi.depth_params = _read_xform(r)
            s2, fi.spatial_params = _read_xform(r)
            if d2.to_string() != ddesc.to_string():
                raise ValueError("inconsistent depth transform")
            ds.frames.append(fi)
        depth_streams.append(ds)

    duration = r.take("f")
    w, h = r.take("ii")
    r.take("ff")  # aspect, invAspect (recomputed)
    if r.take("I") != MAGIC:
        raise ValueError("missing magic marker at end of video.dat")
    return VideoDat(
        pts=pts,
        color_streams=color_streams,
        depth_streams=depth_streams,
        duration=duration,
        width=w,
        height=h,
    )
