"""Binary `.raw` image format — the interchange contract of the pipeline.

Byte layout (little-endian), matching the reference's OpenCV dump format
(reference lib/core/CvUtil.cpp:25-42 `freadim`/`fwriteim`, mirrored in
reference utils/image_io.py:105-173):

    [rows:int32][cols:int32][cv_type:int32][pixel_size:uint64][row-major data]

`cv_type` follows OpenCV's encoding: ``depth + ((channels - 1) << 3)`` with
depth codes CV_8U=0, CV_32F=5. `pixel_size` is bytes per pixel
(channels * itemsize).

Depth streams store **disparity** in these files; invalid (non-finite or <= 0)
values are written as 0 (reference lib/DepthVideo.cpp:588-635) and converted
back to depth (1/disparity, 0 -> 0) on load
(reference lib/DepthStream.cpp:193-232).
"""

from __future__ import annotations

import struct

import numpy as np

_CV_CN_SHIFT = 3
_CV_DEPTH_MAX = 1 << _CV_CN_SHIFT
_CV_8U = 0
_CV_32F = 5

_DTYPE_TO_CV_DEPTH = {
    np.dtype(np.uint8): _CV_8U,
    np.dtype(np.float32): _CV_32F,
}
_CV_DEPTH_TO_DTYPE = {v: k for k, v in _DTYPE_TO_CV_DEPTH.items()}

_HEADER = struct.Struct("<iiiQ")


def cv_type(dtype: np.dtype, channels: int) -> int:
    """OpenCV type code for a dtype + channel count."""
    depth = _DTYPE_TO_CV_DEPTH[np.dtype(dtype)]
    return depth + ((channels - 1) << _CV_CN_SHIFT)


def save_raw_image(path, image: np.ndarray) -> None:
    """Write an (H, W) or (H, W, C) array in the `.raw` container format."""
    image = np.ascontiguousarray(image)
    if image.ndim == 2:
        h, w = image.shape
        c = 1
    elif image.ndim == 3:
        h, w, c = image.shape
    else:
        raise ValueError(f"raw images must be 2D or 3D, got shape {image.shape}")
    if c > 512:
        raise ValueError("cannot save image with more than 512 channels")
    itemsize = image.dtype.itemsize
    header = _HEADER.pack(h, w, cv_type(image.dtype, c), c * itemsize)
    with open(path, "wb") as f:
        f.write(header)
        f.write(image.tobytes())


def read_raw_header(path):
    """(rows, cols, cv_type) from a `.raw` file without reading pixels."""
    with open(path, "rb") as f:
        h, w, cvt, _ = _HEADER.unpack(f.read(_HEADER.size))
    return h, w, cvt


def load_raw_image(path) -> np.ndarray:
    """Read a `.raw` container image as (H, W) or (H, W, C)."""
    with open(path, "rb") as f:
        h, w, cvt, pixel_size = _HEADER.unpack(f.read(_HEADER.size))
        depth_code = cvt & (_CV_DEPTH_MAX - 1)
        channels = (cvt >> _CV_CN_SHIFT) + 1
        try:
            dtype = _CV_DEPTH_TO_DTYPE[depth_code]
        except KeyError:
            raise ValueError(f"unsupported cv depth code {depth_code} in {path}")
        if pixel_size != channels * dtype.itemsize:
            raise ValueError(
                f"incompatible pixel_size({pixel_size}) and cv_type({cvt}) in {path}"
            )
        data = np.frombuffer(f.read(), dtype=dtype)
    expected = h * w * channels
    if data.size != expected:
        raise ValueError(f"{path}: expected {expected} values, got {data.size}")
    return data.reshape(h, w) if channels == 1 else data.reshape(h, w, channels)


def save_raw_float32_image(path, image: np.ndarray) -> None:
    """Float32 convenience wrapper (name-parity with the reference API)."""
    save_raw_image(path, np.asarray(image, dtype=np.float32))


def load_raw_float32_image(path) -> np.ndarray:
    img = load_raw_image(path)
    if img.dtype != np.float32:
        raise ValueError(f"{path} is not a float32 raw image")
    return img


def depth_to_disparity(depth: np.ndarray) -> np.ndarray:
    """Depth -> stored disparity, zeroing invalid values.

    Mirrors the write path of reference lib/DepthVideo.cpp:600-616.
    """
    depth = np.asarray(depth, dtype=np.float32)
    valid = np.isfinite(depth) & (depth > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        disp = np.where(valid, 1.0 / depth, 0.0)
    return disp.astype(np.float32)


def disparity_to_depth(disp: np.ndarray) -> np.ndarray:
    """Stored disparity -> depth, zeroing invalid values.

    Mirrors the load path of reference lib/DepthStream.cpp:193-232.
    """
    disp = np.asarray(disp, dtype=np.float32)
    valid = np.isfinite(disp) & (disp > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        depth = np.where(valid, 1.0 / disp, 0.0)
    return depth.astype(np.float32)
