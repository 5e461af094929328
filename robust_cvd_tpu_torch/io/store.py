"""VideoStore — a clip's result folder as numpy arrays on the host.

Port of robust_cvd_tpu/io/store.py (the reference's DepthVideo /
DepthStream / ColorStream containers, lib/DepthVideo.{h,cpp}). It keeps the
reference's on-disk contract (frame_%06d.raw, disparity-encoded depth .raw
files, flow/flow_%06d_%06d.raw, flow_mask/mask_%06d_%06d.png,
flow_list.json), so the two packages read and write the same folders.
Stage code moves what it needs to the device.

color_down and the depth streams are read as whole clips, and depth
streams written as whole clips, through the thread-pooled IO engine
(native/io_engine.cpp) where the JAX package uses it
(`read_f32_frames`, `write_f32_frames`).
"""

from __future__ import annotations

import json
import os
from os.path import join as pjoin
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..camera import CameraState
from . import raw
from .frames import VideoMeta, load_frames_txt


def read_f32_frames(paths) -> np.ndarray:
    """Same-shape float32 `.raw` files as one (N, rows, cols[, channels])
    array, through the IO engine; the first file's header sets the shape.
    A file of another type or shape, or a short one, raises IOError."""
    from .. import native

    rows, cols, cvt = native.read_raw_header(paths[0])
    if cvt & 7 != 5:  # CV_32F
        raise IOError(f"{paths[0]} is not float32 (cv type {cvt})")
    return native.read_raw_batch(paths, rows, cols, (cvt >> 3) + 1, np.float32)


def write_f32_frames(paths, frames: np.ndarray) -> None:
    """(N, rows, cols[, channels]) float32 as one `.raw` file a frame,
    through the IO engine (the bytes of raw.save_raw_float32_image)."""
    from .. import native

    native.write_raw_batch(paths, np.asarray(frames, np.float32))


def frame_name(i: int, ext: str) -> str:
    return f"frame_{i:06d}{ext}"


def flow_name(i: int, j: int) -> str:
    return f"flow_{i:06d}_{j:06d}.raw"


def mask_name(i: int, j: int) -> str:
    return f"mask_{i:06d}_{j:06d}.png"


def _exif_rotate(im):
    """EXIF orientation tag 274 -> counter-clockwise rotation, exactly the
    three cases the reference handles (utils/image_io.py:64-84: 8 -> 90,
    6 -> 270, 3 -> 180; the mirrored orientations are ignored there too)."""
    angle = {8: 90, 6: 270, 3: 180}.get(im.getexif().get(274, 1), 0)
    return im.rotate(angle, expand=True) if angle else im


def load_png_gray(path) -> np.ndarray:
    """Gray PNG as uint8, after the reference's EXIF rotations."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(_exif_rotate(im).convert("L"))


def save_png_gray(path, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.asarray(img, np.uint8), mode="L").save(path)


def save_png_color(path, img: np.ndarray) -> None:
    """img: (H, W, 3) float in [0, 1] (rounded to uint8) or uint8."""
    from PIL import Image

    if img.dtype != np.uint8:
        img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(img, mode="RGB").save(path)


def load_png_color_u8(path) -> np.ndarray:
    """RGB PNG as (H, W, 3) uint8, after the reference's EXIF rotations."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(_exif_rotate(im).convert("RGB"))


def load_png_color(path) -> np.ndarray:
    """RGB PNG as float32 in [0, 1], after the reference's EXIF rotations."""
    return load_png_color_u8(path).astype(np.float32) / 255.0


class VideoStore:
    """Per-clip data bound to a result folder. Color is RGB in [0, 1],
    channels-last. Depth streams hold DEPTH in memory; the .raw files hold
    disparity (reference convention)."""

    def __init__(self, base_dir: str, meta: VideoMeta):
        self.base_dir = base_dir
        self.meta = meta
        self.color_down: Optional[np.ndarray] = None  # (N, h, w, 3)
        self.color_full: Optional[np.ndarray] = None  # (N, H, W, 3)
        self.dynamic_mask: Optional[np.ndarray] = None  # (N, h, w) uint8
        self.depth_streams: Dict[str, np.ndarray] = {}  # name -> (N, h, w)
        self.flows: Dict[Tuple[int, int], np.ndarray] = {}
        self.flow_masks: Dict[Tuple[int, int], np.ndarray] = {}
        self.camera: Optional[CameraState] = None

    @classmethod
    def open(cls, base_dir: str) -> "VideoStore":
        return cls(base_dir, load_frames_txt(pjoin(base_dir, "frames.txt")))

    @property
    def num_frames(self) -> int:
        return self.meta.num_frames

    @property
    def aspect(self) -> float:
        return self.meta.aspect

    @property
    def inv_aspect(self) -> float:
        return self.meta.inv_aspect

    # -- observability -------------------------------------------------------

    def info_lines(self) -> List[str]:
        """Container summary (reference DepthVideo::printInfo,
        lib/DepthVideo.cpp:38-89): dimensions, frame count/duration, and the
        color/depth streams present in the result tree."""
        m = self.meta
        dur = m.pts[-1] if m.pts else 0.0
        lines = [
            f"Path: {self.base_dir}",
            f"Dimensions: {m.width} x {m.height} ({m.aspect:f} aspect ratio)",
            f"Frame count: {m.num_frames} ({dur:.2f}s duration)",
        ]
        color_dirs = [
            ("full", "color_full", ".png"),
            ("down", "color_down", ".raw"),
            ("down_png", "color_down_png", ".png"),
            ("flow", "color_flow", ".png"),
            ("dynamic_mask", "dynamic_mask", ".png"),
        ]
        present = [
            (n, d, e) for (n, d, e) in color_dirs
            if os.path.isdir(pjoin(self.base_dir, d))
        ]
        lines.append(f"Color streams: {len(present)}")
        for i, (name, d, ext) in enumerate(present):
            first = pjoin(self.base_dir, d, frame_name(0, ext))
            dims = "?"
            if os.path.exists(first):
                if ext == ".raw":
                    hdr = raw.read_raw_header(first)
                    if hdr:
                        dims = f"{hdr[1]} x {hdr[0]}"
                else:
                    from PIL import Image

                    with Image.open(first) as im:
                        dims = f"{im.width} x {im.height}"
            lines.append(f"  {i:2d}: {name} ({dims})")
            lines.append(f"      Path: {pjoin(self.base_dir, d)} ({ext})")
        depth_dirs = sorted(
            d for d in os.listdir(self.base_dir)
            if os.path.isdir(pjoin(self.base_dir, d, "depth"))
        )
        lines.append(f"Depth streams: {len(depth_dirs)}")
        for i, d in enumerate(depth_dirs):
            first = pjoin(self.base_dir, d, "depth", frame_name(0, ".raw"))
            dims = "?"
            if os.path.exists(first):
                hdr = raw.read_raw_header(first)
                if hdr:
                    dims = f"{hdr[1]} x {hdr[0]}"
            lines.append(f"  {i:2d}: {d} ({dims})")
            lines.append(f"      Path: {pjoin(self.base_dir, d, 'depth')}")
        return lines

    def print_info(self) -> None:
        for ln in self.info_lines():
            print(ln)

    # -- color ---------------------------------------------------------------

    def load_color_down(self) -> np.ndarray:
        if self.color_down is None:
            self.color_down = read_f32_frames([
                pjoin(self.base_dir, "color_down", frame_name(i, ".raw"))
                for i in range(self.num_frames)
            ])
        return self.color_down

    def load_color_full(self) -> np.ndarray:
        if self.color_full is None:
            self.color_full = np.stack(
                [
                    load_png_color(pjoin(self.base_dir, "color_full", frame_name(i, ".png")))
                    for i in range(self.num_frames)
                ]
            )
        return self.color_full

    def load_dynamic_mask(self) -> Optional[np.ndarray]:
        d = pjoin(self.base_dir, "dynamic_mask")
        if self.dynamic_mask is None and os.path.isdir(d):
            self.dynamic_mask = np.stack(
                [
                    load_png_gray(pjoin(d, frame_name(i, ".png")))
                    for i in range(self.num_frames)
                ]
            )
        return self.dynamic_mask

    # -- depth streams -------------------------------------------------------

    def depth_dir(self, stream: str) -> str:
        return pjoin(self.base_dir, stream, "depth")

    def load_depth_stream(self, stream: str) -> np.ndarray:
        if stream not in self.depth_streams:
            d = self.depth_dir(stream)
            disparity = read_f32_frames(
                [pjoin(d, frame_name(i, ".raw")) for i in range(self.num_frames)]
            )
            self.depth_streams[stream] = raw.disparity_to_depth(disparity)
        return self.depth_streams[stream]

    def save_depth_stream(self, stream: str, depth: np.ndarray) -> None:
        """depth: (N, h, w). Writes disparity .raw files
        (reference lib/DepthVideo.cpp:588-635 saveDepth)."""
        d = self.depth_dir(stream)
        os.makedirs(d, exist_ok=True)
        disparity = raw.depth_to_disparity(np.asarray(depth))
        write_f32_frames([pjoin(d, frame_name(i, ".raw")) for i in range(self.num_frames)],
                         disparity)
        self.depth_streams[stream] = np.asarray(depth)

    def duplicate_depth_stream(self, src: str, dst: str) -> None:
        """(reference pose_optimization.py:262-290)."""
        self.save_depth_stream(dst, self.load_depth_stream(src))

    # -- flow ----------------------------------------------------------------

    def flow_pairs(self) -> List[Tuple[int, int]]:
        """The (i, j) of every flow/flow_i_j.raw, sorted by name."""
        d = pjoin(self.base_dir, "flow")
        pairs = []
        if os.path.isdir(d):
            for name in sorted(os.listdir(d)):
                if name.startswith("flow_") and name.endswith(".raw"):
                    a, b = name[5:-4].split("_")
                    pairs.append((int(a), int(b)))
        return pairs

    def load_flow(self, i: int, j: int) -> np.ndarray:
        key = (i, j)
        if key not in self.flows:
            self.flows[key] = raw.load_raw_float32_image(
                pjoin(self.base_dir, "flow", flow_name(i, j))
            )
        return self.flows[key]

    def save_flow(self, i: int, j: int, flow: np.ndarray) -> None:
        d = pjoin(self.base_dir, "flow")
        os.makedirs(d, exist_ok=True)
        raw.save_raw_float32_image(pjoin(d, flow_name(i, j)), flow)
        self.flows[(i, j)] = np.asarray(flow, np.float32)

    def load_flow_mask(self, i: int, j: int) -> np.ndarray:
        key = (i, j)
        if key not in self.flow_masks:
            self.flow_masks[key] = (
                load_png_gray(pjoin(self.base_dir, "flow_mask", mask_name(i, j)))
                > 127
            )
        return self.flow_masks[key]

    def save_flow_mask(self, i: int, j: int, mask: np.ndarray) -> None:
        d = pjoin(self.base_dir, "flow_mask")
        os.makedirs(d, exist_ok=True)
        save_png_gray(pjoin(d, mask_name(i, j)), np.asarray(mask, np.uint8) * 255)
        self.flow_masks[(i, j)] = np.asarray(mask, bool)

    # -- flow_list.json (reference flow.py:53-74) ----------------------------

    def save_flow_list(self, entries: List[Tuple[int, int, float]]) -> None:
        data = [["frame0", "frame1", "mask_ratio"]] + [
            [int(i), int(j), float(r)] for (i, j, r) in entries
        ]
        with open(pjoin(self.base_dir, "flow_list.json"), "w") as f:
            json.dump(data, f)

    def load_flow_list(self) -> List[Tuple[int, int, float]]:
        with open(pjoin(self.base_dir, "flow_list.json")) as f:
            data = json.load(f)
        return [(int(i), int(j), float(r)) for i, j, r in data[1:]]
