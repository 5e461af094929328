"""Video stage: frame extraction + multi-resolution downscaling.

A copy of robust_cvd_tpu/pipeline/video.py (which imports no JAX), so that
the port makes color_down and color_flow exactly as the JAX package does.

Reference video.py:32-182 shells out to ffprobe/ffmpeg; this environment has
no ffmpeg binary, so extraction uses imageio's ffmpeg plugin when available
and otherwise requires pre-extracted frames in `color_full/` (the stage is
idempotent either way — existing outputs are reused, reference
video.py:101-124).

Outputs (the downscale contract, reference video.py:154-182 + process.py):
  color_full/frame_%06d.png      original resolution
  color_down/frame_%06d.raw      long side `size` (default 384), align 32
  color_down_png/frame_%06d.png  same, png
  color_flow/frame_%06d.png      long side <= 1024, align 64
  frames.txt
"""

from __future__ import annotations

import os
from os.path import join as pjoin

import numpy as np

from ..io import raw
from ..io.frames import VideoMeta, load_frames_txt, save_frames_txt
from ..io.store import frame_name, load_png_color, save_png_color


def resize_to_target(image: np.ndarray, max_size: int, align: int = 1,
                     short_side_target: bool = False) -> np.ndarray:
    """Area-style resize with align rounding (reference
    utils/image_io.py:26-52). image: (H, W, 3) float [0,1]."""
    H, W = image.shape[:2]
    target = float(min(W, H)) if short_side_target else float(max(W, H))
    scale = min(1.0, max_size / target)
    rw, rh = int(W * scale), int(H * scale)
    if rw % align != 0:
        rw = align * round(rw / align)
    if rh % align != 0:
        rh = align * round(rh / align)
    # The reference's identical rounding (utils/image_io.py:36-44) emits a
    # 0-sized dimension when a side is at most align/2 (round-half-even) and
    # cv2.resize then asserts; clamp to the smallest aligned size instead so
    # degenerate-aspect inputs stay inside the pipeline's envelope.
    rw, rh = max(rw, align), max(rh, align)
    return _resize_area(image, (rh, rw))


def _resize_area(image: np.ndarray, out_hw) -> np.ndarray:
    """INTER_AREA-like resize: box-average for integer downscales, else
    bilinear (adequate stand-in for cv2.INTER_AREA)."""
    H, W = image.shape[:2]
    oh, ow = out_hw
    if (oh, ow) == (H, W):
        return image
    if H % oh == 0 and W % ow == 0:
        fh, fw = H // oh, W // ow
        return image.reshape(oh, fh, ow, fw, -1).mean(axis=(1, 3)).astype(np.float32)
    from PIL import Image

    im = Image.fromarray(np.clip(image * 255.0 + 0.5, 0, 255).astype(np.uint8))
    out = im.resize((ow, oh), Image.BILINEAR)
    return np.asarray(out, np.float32) / 255.0


def extract_container_pts(video_file: str):
    """Real per-frame presentation timestamps from the video container
    (reference video.py:62-84 shells out to ffprobe for packet pts and
    sorts them; lib/Importer.cpp:197-238 then remaps to zero and enforces
    monotonicity — our load_frames_txt applies the same rules).

    Uses PyAV when importable; returns a sorted list of seconds, or None
    when no container demuxer is available (caller falls back to synthetic
    pts and says so)."""
    try:
        import av  # not in the base image; gated
    except ImportError:
        return None
    try:
        with av.open(video_file) as container:
            stream = container.streams.video[0]
            tb = float(stream.time_base)
            pts = [
                float(p.pts) * tb
                for p in container.demux(stream)
                if p.pts is not None
            ]
    except (av.AVError, IndexError, OSError):
        return None
    if not pts:
        return None
    pts.sort()  # decode order != presentation order (B-frames)
    return pts


class VideoStage:
    def __init__(self, base_dir: str, video_file: str = ""):
        self.base_dir = base_dir
        self.video_file = video_file

    def extract_frames(self) -> VideoMeta:
        frames_txt = pjoin(self.base_dir, "frames.txt")
        full_dir = pjoin(self.base_dir, "color_full")
        if os.path.exists(frames_txt) and os.path.isdir(full_dir):
            return load_frames_txt(frames_txt)

        os.makedirs(full_dir, exist_ok=True)
        if not self.video_file:
            # accept pre-extracted frames without frames.txt
            names = sorted(
                n for n in os.listdir(full_dir) if n.endswith(".png")
            )
            if not names:
                raise FileNotFoundError(
                    "no video_file given and color_full/ is empty"
                )
            first = load_png_color(pjoin(full_dir, names[0]))
            pts = [i / 30.0 for i in range(len(names))]
            save_frames_txt(frames_txt, first.shape[1], first.shape[0], pts)
            return load_frames_txt(frames_txt)

        import imageio.v3 as iio

        n = 0
        w = h = None
        for i, frame in enumerate(iio.imiter(self.video_file)):
            if w is None:
                h, w = frame.shape[:2]
            save_png_color(pjoin(full_dir, frame_name(i, ".png")), frame)
            n += 1

        pts = extract_container_pts(self.video_file)
        if pts is None or len(pts) != n:
            import logging

            reason = (
                "no demuxer available (need PyAV)" if pts is None
                else f"packet count {len(pts)} != decoded frame count {n}"
            )
            logging.getLogger(__name__).warning(
                "container pts unusable for %s (%s); "
                "synthesizing 30 fps timestamps — variable-frame-rate "
                "inputs will carry wrong pts", self.video_file, reason,
            )
            pts = [i / 30.0 for i in range(n)]
        save_frames_txt(frames_txt, w, h, pts)
        return load_frames_txt(frames_txt)

    def downscale_frames(
        self, subdir: str, max_size: int, ext: str, align: int = 16,
        full_subdir: str = "color_full", short_side_target: bool = False,
    ):
        """(reference video.py:154-182)."""
        out_dir = pjoin(self.base_dir, subdir)
        os.makedirs(out_dir, exist_ok=True)
        meta = load_frames_txt(pjoin(self.base_dir, "frames.txt"))
        full_dir = pjoin(self.base_dir, full_subdir)
        shape = None
        for i in range(meta.num_frames):
            out = pjoin(out_dir, frame_name(i, ext))
            if os.path.exists(out):
                if shape is None:
                    img = (
                        raw.load_raw_float32_image(out)
                        if ext == ".raw"
                        else load_png_color(out)
                    )
                    shape = img.shape[:2]
                continue
            img = load_png_color(pjoin(full_dir, frame_name(i, ".png")))
            small = resize_to_target(img, max_size, align, short_side_target)
            shape = small.shape[:2]
            if ext == ".raw":
                raw.save_raw_float32_image(out, small)
            else:
                save_png_color(out, small)
        return shape
