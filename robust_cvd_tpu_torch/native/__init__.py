"""Host C++ helpers, loaded through ctypes: constraint building
(`sampling.cpp`) and the batched `.raw` IO engine (`io_engine.cpp`).

Both sources are copies of the JAX package's (robust_cvd_tpu/native/). Each
is built with g++ at first use into `_build/native/` (listed in
.gitignore). A failed build raises: the port has no Python fallback for
these loops, and a file the IO engine cannot read or write raises IOError.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "sampling.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build", "native")
_SO = os.path.join(_BUILD_DIR, "_sampling.so")
_IO_SRC = os.path.join(_DIR, "io_engine.cpp")
_IO_SO = os.path.join(_BUILD_DIR, "_io_engine.so")

_lib = None
_io_lib = None


def _build(src: str, so: str, *flags: str) -> ctypes.CDLL:
    """`src` compiled into the shared library `so` unless it is up to date,
    then opened."""
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", *flags, src, "-o", tmp],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"building {src} failed:\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    return ctypes.CDLL(so)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = _build(_SRC, _SO)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.build_pair_candidates.argtypes = [
        f32p, f32p, u8p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, f32p, ctypes.c_int64,
    ]
    lib.build_pair_candidates.restype = ctypes.c_int64
    lib.build_triplet_candidates.argtypes = [
        f32p, f32p, u8p, f32p, u8p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, f32p, f32p, ctypes.c_int64,
    ]
    lib.build_triplet_candidates.restype = ctypes.c_int64
    lib.stamp_disks.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, u8p,
    ]
    lib.stamp_disks.restype = None
    lib.greedy_sample.argtypes = list(lib.stamp_disks.argtypes)
    lib.greedy_sample.restype = None
    _lib = lib
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _sample_cap(w: int, h: int, radius: int) -> int:
    """Generous upper bound on how many disk-separated samples fit."""
    r = max(int(radius), 1)
    return 4 * (w // r + 2) * (h // r + 2)


def _check(name, a: np.ndarray, shape) -> None:
    if a.shape != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {a.shape}")


def build_pair_candidates(corner, flow, mask, radius: int):
    """Mask/bounds filter + stable corner sort + greedy disk suppression for
    one flow pair (reference lib/FlowConstraints.cpp:401-465) in one native
    call. Returns (xy int32 (C, 2), flow-target f32 (C, 2))."""
    h, w = corner.shape
    corner = np.ascontiguousarray(corner, np.float32)
    flow = np.ascontiguousarray(flow, np.float32)
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    _check("flow", flow, (h, w, 2))
    _check("mask", mask, (h, w))
    cap = _sample_cap(w, h, radius)
    out_xy = np.empty((cap, 2), np.int32)
    out_f = np.empty((cap, 2), np.float32)
    n = _load().build_pair_candidates(
        _ptr(corner, ctypes.c_float), _ptr(flow, ctypes.c_float),
        _ptr(mask, ctypes.c_uint8), w, h, radius,
        _ptr(out_xy, ctypes.c_int32), _ptr(out_f, ctypes.c_float), cap,
    )
    return out_xy[:n], out_f[:n]


def build_triplet_candidates(corner, flow10, mask10, flow12, mask12, radius: int):
    """Triplet variant of build_pair_candidates (reference
    lib/FlowConstraints.cpp:467-550). Returns (xy (C, 2) int32,
    backward targets (C, 2) f32, forward targets (C, 2) f32)."""
    h, w = corner.shape
    corner = np.ascontiguousarray(corner, np.float32)
    flow10 = np.ascontiguousarray(flow10, np.float32)
    flow12 = np.ascontiguousarray(flow12, np.float32)
    mask10 = np.ascontiguousarray(mask10.astype(np.uint8))
    mask12 = np.ascontiguousarray(mask12.astype(np.uint8))
    for name, a, shape in (
        ("flow10", flow10, (h, w, 2)), ("flow12", flow12, (h, w, 2)),
        ("mask10", mask10, (h, w)), ("mask12", mask12, (h, w)),
    ):
        _check(name, a, shape)
    cap = _sample_cap(w, h, radius)
    out_xy = np.empty((cap, 2), np.int32)
    out_f0 = np.empty((cap, 2), np.float32)
    out_f2 = np.empty((cap, 2), np.float32)
    n = _load().build_triplet_candidates(
        _ptr(corner, ctypes.c_float), _ptr(flow10, ctypes.c_float),
        _ptr(mask10, ctypes.c_uint8), _ptr(flow12, ctypes.c_float),
        _ptr(mask12, ctypes.c_uint8), w, h, radius,
        _ptr(out_xy, ctypes.c_int32), _ptr(out_f0, ctypes.c_float),
        _ptr(out_f2, ctypes.c_float), cap,
    )
    return out_xy[:n], out_f0[:n], out_f2[:n]


def greedy_sample(xs: np.ndarray, ys: np.ndarray, w: int, h: int, radius: int) -> np.ndarray:
    """Greedy disk suppression over candidates in priority order: bool (n,)
    of the kept ones; a candidate within `radius` of a kept one, or out of
    bounds, is dropped (reference lib/FlowConstraints.cpp:352-397)."""
    xs = np.ascontiguousarray(xs, np.int32)
    ys = np.ascontiguousarray(ys, np.int32)
    if xs.shape != ys.shape or xs.ndim != 1:
        raise ValueError(f"xs {xs.shape} and ys {ys.shape} must be one equal-length vector")
    out = np.zeros(xs.shape[0], np.uint8)
    _load().greedy_sample(
        _ptr(xs, ctypes.c_int32), _ptr(ys, ctypes.c_int32), xs.shape[0], w, h, radius,
        _ptr(out, ctypes.c_uint8),
    )
    return out.astype(bool)


def stamp_disks(xs: np.ndarray, ys: np.ndarray, w: int, h: int, radius: int) -> np.ndarray:
    """Union of the disks of `radius` centred at the pixels (xs, ys) ->
    bool (h, w) (reference lib/FlowConstraints.cpp:662-709)."""
    xs = np.ascontiguousarray(xs, np.int32)
    ys = np.ascontiguousarray(ys, np.int32)
    if xs.shape != ys.shape or xs.ndim != 1:
        raise ValueError(f"xs {xs.shape} and ys {ys.shape} must be one equal-length vector")
    out = np.zeros((h, w), np.uint8)
    _load().stamp_disks(
        _ptr(xs, ctypes.c_int32), _ptr(ys, ctypes.c_int32), xs.shape[0], w, h, radius,
        _ptr(out, ctypes.c_uint8),
    )
    return out.astype(bool)


# -- the batched .raw IO engine (io_engine.cpp) ---------------------------------


def _load_io() -> ctypes.CDLL:
    global _io_lib
    if _io_lib is not None:
        return _io_lib
    lib = _build(_IO_SRC, _IO_SO, "-pthread")
    c = ctypes
    u8p, i64p, i32p = c.POINTER(c.c_uint8), c.POINTER(c.c_int64), c.POINTER(c.c_int32)
    lib.read_raw_batch.argtypes = [
        c.POINTER(c.c_char_p), c.c_int64, c.c_int32, c.c_int32, c.c_int32,
        u8p, c.c_int64, c.c_int32, i64p,
    ]
    lib.read_raw_batch.restype = c.c_int
    lib.write_raw_batch.argtypes = [
        c.POINTER(c.c_char_p), c.c_int64, c.c_int32, c.c_int32, c.c_int32,
        c.c_uint64, u8p, c.c_int64, c.c_int32, i64p,
    ]
    lib.write_raw_batch.restype = c.c_int
    lib.read_raw_header.argtypes = [c.c_char_p, i32p, i32p, i32p]
    lib.read_raw_header.restype = c.c_int
    _io_lib = lib
    return lib


def _paths_array(paths):
    enc = [os.fsencode(p) for p in paths]
    return (ctypes.c_char_p * len(enc))(*enc), enc  # `enc` keeps the bytes alive


def _threads(nthreads: int) -> int:
    return nthreads if nthreads > 0 else min(16, os.cpu_count() or 1)


def _batch(fn, verb: str, paths, *args) -> None:
    """One thread-pooled engine call over `paths`; IOError names the first
    file it failed on."""
    arr, _keep = _paths_array(paths)
    bad = ctypes.c_int64(-1)
    if fn(arr, len(paths), *args, ctypes.byref(bad)) != 0:
        idx = int(bad.value)
        name = paths[idx] if 0 <= idx < len(paths) else "?"
        raise IOError(f"native raw batch {verb} failed at {name}")


def read_raw_batch(paths, rows: int, cols: int, channels: int, dtype=np.float32,
                   nthreads: int = 0) -> np.ndarray:
    """Thread-pooled read of same-shape `.raw` files into one contiguous
    (N, rows, cols[, channels]) array. A missing, short or mismatched file
    raises IOError."""
    from ..io.raw import cv_type

    dtype = np.dtype(dtype)
    shape = (len(paths), rows, cols) + (() if channels == 1 else (channels,))
    out = np.empty(shape, dtype)
    if paths:
        _batch(_load_io().read_raw_batch, "read", paths, rows, cols,
               cv_type(dtype, channels), _ptr(out, ctypes.c_uint8),
               rows * cols * channels * dtype.itemsize, _threads(nthreads))
    return out


def write_raw_batch(paths, data: np.ndarray, nthreads: int = 0) -> None:
    """Thread-pooled write of (N, rows, cols[, channels]) as one `.raw`
    file a frame, byte for byte what io/raw.py's save_raw_image writes. A
    file that cannot be written raises IOError."""
    from ..io.raw import cv_type

    data = np.ascontiguousarray(data)
    n, rows, cols = data.shape[:3]
    channels = 1 if data.ndim == 3 else data.shape[3]
    if n != len(paths):
        raise ValueError(f"{n} frames for {len(paths)} paths")
    pixel = channels * data.dtype.itemsize
    if paths:
        _batch(_load_io().write_raw_batch, "write", paths, rows, cols,
               cv_type(data.dtype, channels), pixel, _ptr(data, ctypes.c_uint8),
               rows * cols * pixel, _threads(nthreads))


def read_raw_header(path):
    """(rows, cols, cv_type) of one `.raw` file; IOError where it has none."""
    r, c, t = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    if _load_io().read_raw_header(os.fsencode(path), ctypes.byref(r), ctypes.byref(c),
                                  ctypes.byref(t)) != 0:
        raise IOError(f"cannot read raw header of {path}")
    return int(r.value), int(c.value), int(t.value)
