"""COLMAP sparse-model IO: binary/text readers, writers, and conversion to
the pipeline's `metadata.npz` + `scales.csv` contract.

A copy of robust_cvd_tpu/io/colmap.py (numpy only), kept in the port so
that it imports nothing of the JAX package.

The reference ships the standard COLMAP parsing script plus a calibration
step (reference utils/load_colmap.py:60-228 read/convert,
utils/calibration.py:12-80 per-frame scale voting from sparse points); its
importer then consumes the derived `metadata.npz` + `scales.csv`
(reference lib/Importer.cpp:290-389). This module covers that whole chain:

    read_model(dir)                 -> cameras, images, points3D
    model_to_npz(dir, out, ...)     -> metadata.npz (w2c extrinsics +
                                       pixel intrinsics, importer contract)
    sparse_depth_scales(...)        -> per-frame depth-scale votes
    write_scales_csv(...)           -> scales.csv (Importer.cpp:240-288)

Binary layouts follow COLMAP's own `write_model` (little-endian):
cameras.bin / images.bin / points3D.bin.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from os.path import join as pjoin
from typing import Dict, List, Optional, Tuple

import numpy as np

# model_id -> (name, num_params); fx fy cx cy extraction per model below
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def fx_fy_cx_cy(self) -> Tuple[float, float, float, float]:
        p = self.params
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV"):
            return float(p[0]), float(p[0]), float(p[1]), float(p[2])
        return float(p[0]), float(p[1]), float(p[2]), float(p[3])


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) (qw, qx, qy, qz) COLMAP order, world-to-camera
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (P, 2)
    point3d_ids: np.ndarray  # (P,) int64, -1 = no 3D point

    def rotation(self) -> np.ndarray:
        """World-to-camera rotation matrix from the (w, x, y, z) qvec."""
        w, x, y, z = [float(v) for v in self.qvec]
        return np.asarray(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )


@dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2d_idxs: np.ndarray


def _read(f, fmt: str):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


# -- binary readers ----------------------------------------------------------


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.asarray(_read(f, f"<{num_params}d"))
            out[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return out


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            qvec = np.asarray(_read(f, "<4d"))
            tvec = np.asarray(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_pts,) = _read(f, "<Q")
            # Each point2D record is x:f64, y:f64, point3D_id:i64 ("ddq" —
            # reference utils/load_colmap.py:422-425; -1 == invalid id, which
            # is byte-identical to COLMAP's uint64 kInvalidPoint3DId).
            rec = np.frombuffer(
                f.read(24 * num_pts),
                dtype=np.dtype([("xy", "<f8", (2,)), ("pid", "<i8")]),
                count=num_pts,
            )
            out[iid] = ColmapImage(
                iid, qvec, tvec, cam_id, name.decode("utf-8"),
                rec["xy"].astype(np.float64).copy(),
                rec["pid"].astype(np.int64).copy(),
            )
    return out


def read_points3d_binary(path: str) -> Dict[int, ColmapPoint3D]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid = _read(f, "<Q")[0]
            xyz = np.asarray(_read(f, "<3d"))
            rgb = np.asarray(_read(f, "<3B"), np.uint8)
            (err,) = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            track = np.asarray(_read(f, f"<{2 * track_len}i")).reshape(track_len, 2)
            out[pid] = ColmapPoint3D(
                int(pid), xyz, rgb, float(err),
                track[:, 0].copy(), track[:, 1].copy(),
            )
    return out


# -- text readers ------------------------------------------------------------


def _text_lines(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    for line in _text_lines(path):
        toks = line.split()
        cid = int(toks[0])
        out[cid] = ColmapCamera(
            cid, toks[1], int(toks[2]), int(toks[3]),
            np.asarray([float(t) for t in toks[4:]]),
        )
    return out


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    out = {}
    lines = list(_text_lines(path))
    for i in range(0, len(lines), 2):
        toks = lines[i].split()
        iid = int(toks[0])
        qvec = np.asarray([float(t) for t in toks[1:5]])
        tvec = np.asarray([float(t) for t in toks[5:8]])
        cam_id = int(toks[8])
        name = toks[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        data = np.asarray([float(t) for t in pts]).reshape(-1, 3) if pts else np.zeros((0, 3))
        out[iid] = ColmapImage(
            iid, qvec, tvec, cam_id, name,
            data[:, :2].copy(), data[:, 2].astype(np.int64),
        )
    return out


def read_points3d_text(path: str) -> Dict[int, ColmapPoint3D]:
    out = {}
    for line in _text_lines(path):
        toks = line.split()
        pid = int(toks[0])
        xyz = np.asarray([float(t) for t in toks[1:4]])
        rgb = np.asarray([int(t) for t in toks[4:7]], np.uint8)
        err = float(toks[7])
        track = np.asarray([int(t) for t in toks[8:]]).reshape(-1, 2)
        out[pid] = ColmapPoint3D(
            pid, xyz, rgb, err, track[:, 0].copy(), track[:, 1].copy()
        )
    return out


def read_model(model_dir: str):
    """Auto-detect binary vs text model files in `model_dir`."""
    if os.path.exists(pjoin(model_dir, "cameras.bin")):
        return (
            read_cameras_binary(pjoin(model_dir, "cameras.bin")),
            read_images_binary(pjoin(model_dir, "images.bin")),
            read_points3d_binary(pjoin(model_dir, "points3D.bin")),
        )
    if os.path.exists(pjoin(model_dir, "cameras.txt")):
        return (
            read_cameras_text(pjoin(model_dir, "cameras.txt")),
            read_images_text(pjoin(model_dir, "images.txt")),
            read_points3d_text(pjoin(model_dir, "points3D.txt")),
        )
    raise FileNotFoundError(f"no COLMAP model (bin or txt) in {model_dir}")


# -- binary writers (export + test fixtures) ---------------------------------


def write_cameras_binary(cameras: Dict[int, ColmapCamera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for c in cameras.values():
            f.write(struct.pack("<iiQQ", c.id, CAMERA_MODEL_IDS[c.model],
                                c.width, c.height))
            f.write(struct.pack(f"<{len(c.params)}d", *c.params))


def write_images_binary(images: Dict[int, ColmapImage], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for (x, y), pid in zip(im.xys, im.point3d_ids):
                f.write(struct.pack("<ddq", x, y, int(pid)))


def write_points3d_binary(points: Dict[int, ColmapPoint3D], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<Q", p.id))
            f.write(struct.pack("<3d", *p.xyz))
            f.write(struct.pack("<3B", *p.rgb))
            f.write(struct.pack("<d", p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for iid, pidx in zip(p.image_ids, p.point2d_idxs):
                f.write(struct.pack("<ii", int(iid), int(pidx)))


# -- conversion to the importer contract -------------------------------------


def ordered_images(images: Dict[int, ColmapImage]) -> List[ColmapImage]:
    """Images sorted by file name (frame order)."""
    return sorted(images.values(), key=lambda im: im.name)


def model_to_npz(
    model_dir: str,
    out_path: str,
    dst_size: Optional[Tuple[int, int]] = None,
) -> Dict[str, np.ndarray]:
    """COLMAP model -> `metadata.npz` with `extrinsics` (M, 3, 4)
    world-to-camera f64 and `intrinsics` (M, 4) (fx, fy, cx, cy) px, ordered
    by image name (the contract import_colmap_recon consumes; reference
    utils/load_colmap.py:162-228 convert_calibration + Importer.cpp:317-340).

    dst_size (W, H): rescale pixel intrinsics from the reconstruction
    resolution to the pipeline's working resolution."""
    cameras, images, _ = read_model(model_dir)
    ims = ordered_images(images)
    extr = np.zeros((len(ims), 3, 4), np.float64)
    intr = np.zeros((len(ims), 4), np.float64)
    for k, im in enumerate(ims):
        extr[k, :, :3] = im.rotation()
        extr[k, :, 3] = im.tvec
        cam = cameras[im.camera_id]
        fx, fy, cx, cy = cam.fx_fy_cx_cy
        if dst_size is not None:
            sx = dst_size[0] / cam.width
            sy = dst_size[1] / cam.height
            fx, cx = fx * sx, cx * sx
            fy, cy = fy * sy, cy * sy
        intr[k] = (fx, fy, cx, cy)
    out = {"extrinsics": extr, "intrinsics": intr}
    np.savez(out_path, **out)
    return out


def sparse_depths(
    image: ColmapImage, points3d: Dict[int, ColmapPoint3D]
) -> Tuple[np.ndarray, np.ndarray]:
    """(xys (K, 2), depth (K,)) of the image's triangulated observations:
    depth = z of the world point in COLMAP camera coordinates (looking down
    +z; reference utils/calibration.py:50-70 uses -z in its flipped frame)."""
    has = image.point3d_ids >= 0
    ids = image.point3d_ids[has]
    xys = image.xys[has]
    keep = np.asarray([int(i) in points3d for i in ids], bool)
    ids = ids[keep]
    xys = xys[keep]
    if len(ids) == 0:
        return np.zeros((0, 2)), np.zeros((0,))
    world = np.stack([points3d[int(i)].xyz for i in ids])
    R = image.rotation()
    cam_pts = world @ R.T + image.tvec
    z = cam_pts[:, 2]
    pos = z > 1e-6
    return xys[pos], z[pos]


def vote_scale(scales: np.ndarray, lo: int = 10, hi: int = 90) -> float:
    """Percentile-trimmed mean (reference utils/calibration.py:37-47)."""
    if len(scales) == 0:
        return float("nan")
    m, M = np.percentile(scales, lo), np.percentile(scales, hi)
    sel = scales[(scales >= m) & (scales <= M)]
    return float(np.mean(sel)) if len(sel) else float("nan")


def sparse_depth_scales(
    model_dir: str,
    depth: np.ndarray,
    src_size: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Per-frame scale between the pipeline's depth maps and the COLMAP
    reconstruction: scale[i] = trimmed-mean of colmap_depth / our_depth at
    the frame's triangulated observations (reference
    utils/calibration.py:50-80 calibrate_frame_w_sparse_points).

    depth: (N, h, w) in image-name order; src_size (W, H) is the
    reconstruction resolution (defaults to the camera's)."""
    cameras, images, points3d = read_model(model_dir)
    ims = ordered_images(images)
    n, h, w = depth.shape
    out = np.full(min(n, len(ims)), np.nan)
    for k, im in enumerate(ims[: len(out)]):
        cam = cameras[im.camera_id]
        sw, sh = src_size if src_size is not None else (cam.width, cam.height)
        xys, z = sparse_depths(im, points3d)
        if len(z) < 2:
            continue
        xs = np.clip((xys[:, 0] / sw * w).astype(int), 0, w - 1)
        ys = np.clip((xys[:, 1] / sh * h).astype(int), 0, h - 1)
        ours = depth[k, ys, xs]
        ok = ours > 1e-6
        if ok.sum() < 2:
            continue
        out[k] = vote_scale(z[ok] / ours[ok])
    return out


def write_scales_csv(base_dir: str, scales: np.ndarray) -> str:
    """`scales.csv` rows `frame,scale` (consumed by io/importers.py::load_scale,
    reference Importer.cpp:240-288); NaN frames are skipped."""
    path = pjoin(base_dir, "scales.csv")
    with open(path, "w") as f:
        for i, s in enumerate(np.asarray(scales, float)):
            if np.isfinite(s):
                f.write(f"{i},{s}\n")
    return path


def _main(argv=None) -> int:
    """CLI: convert a COLMAP sparse model into the importer contract.

    python -m robust_cvd_tpu_torch.io.colmap <model_dir> <out.npz>
        [--depth-stream DIR] [--size WxH]

    With --depth-stream (a depth/ dir of .raw disparity frames), also
    computes per-frame sparse-depth scales and writes scales.csv next to
    the npz (the reference's calibration step).
    """
    import argparse

    p = argparse.ArgumentParser(description=_main.__doc__)
    p.add_argument("model_dir")
    p.add_argument("out_npz")
    p.add_argument("--depth-stream", default=None,
                   help="depth/ dir of .raw disparity frames for scale "
                        "calibration")
    p.add_argument("--size", default=None, help="WxH to rescale intrinsics to")
    args = p.parse_args(argv)
    dst = None
    if args.size:
        w, h = args.size.lower().split("x")
        dst = (int(w), int(h))
    out = model_to_npz(args.model_dir, args.out_npz, dst)
    print(f"wrote {args.out_npz}: {out['extrinsics'].shape[0]} frames")
    if args.depth_stream:
        from . import raw as raw_mod

        names = sorted(
            n for n in os.listdir(args.depth_stream) if n.endswith(".raw")
        )
        depth = np.stack(
            [
                raw_mod.disparity_to_depth(
                    raw_mod.load_raw_float32_image(pjoin(args.depth_stream, n))
                )
                for n in names
            ]
        )
        scales = sparse_depth_scales(args.model_dir, depth)
        base = os.path.dirname(os.path.abspath(args.out_npz))
        write_scales_csv(base, scales)
        ok = np.isfinite(scales)
        print(
            f"wrote {pjoin(base, 'scales.csv')}: {int(ok.sum())}/{len(scales)} "
            f"frames calibrated (mean scale "
            f"{np.nanmean(scales) if ok.any() else float('nan'):.4f})"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
