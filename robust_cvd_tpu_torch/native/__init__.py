"""Host C++ helpers for constraint building, loaded through ctypes.

`sampling.cpp` is a copy of robust_cvd_tpu/native/sampling.cpp. It is built
with g++ at first use into `_build/native/` (listed in .gitignore). A failed
build raises: the port has no Python fallback for these loops.
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

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{_SO}.{os.getpid()}.tmp"
        proc = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"building {_SRC} failed:\n{proc.stderr}")
        os.replace(tmp, _SO)  # atomic: a concurrent build never sees half a file
    lib = ctypes.CDLL(_SO)
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
