"""Corner response (min eigenvalue of the 3x3 structure tensor).

`corner_min_eigenval` is the port of the Pallas TPU kernel
robust_cvd_tpu/ops/pallas_kernels.py::corner_min_eigenval_fused. A CUDA
tensor goes to the hand-written Hopper kernel in
csrc/corner_min_eigenval.cu; a CPU tensor goes to `corner_min_eigenval_plain`,
the plain PyTorch version that the tests and chip_smoke.py hold the kernel
against. A failed build or launch raises: there is no fallback from the
kernel to the plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import load_cuda_library


def corner_min_eigenval_plain(gray: torch.Tensor) -> torch.Tensor:
    """(N, H, W) float32 -> (N, H, W). Reflect-101 padding plus shifted
    adds, in the order of robust_cvd_tpu/solver/constraints.py
    ::corner_min_eigenval."""
    h, w = gray.shape[1:]
    pad = F.pad(gray[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]

    def conv3(kern):
        out = torch.zeros_like(gray)
        for dy in range(3):
            for dx in range(3):
                k = kern[dy][dx]
                if k != 0.0:
                    out = out + k * pad[:, dy : dy + h, dx : dx + w]
        return out

    sobel_x = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
    sobel_y = tuple(zip(*sobel_x))
    dx = conv3(sobel_x)
    dy = conv3(sobel_y)

    def box3(img):
        p = F.pad(img[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]
        out = torch.zeros_like(img)
        for oy in range(3):
            for ox in range(3):
                out = out + p[:, oy : oy + h, ox : ox + w]
        return out

    a = box3(dx * dx)
    b = box3(dx * dy)
    c = box3(dy * dy)
    return 0.5 * ((a + c) - torch.sqrt((a - c) ** 2 + 4.0 * b * b))


def _kernel():
    lib = load_cuda_library("corner_min_eigenval")
    fn = lib.corner_min_eigenval_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def corner_min_eigenval(gray: torch.Tensor) -> torch.Tensor:
    """Corner response of an (N, H, W) float32 gray stack, H, W >= 2.

    On a CUDA tensor this launches the Hopper kernel (and counts the launch
    in `corner_min_eigenval.launches`); on a CPU tensor it computes the
    plain version."""
    if gray.dim() != 3 or gray.dtype != torch.float32:
        raise ValueError(
            f"expected an (N, H, W) float32 tensor, got {tuple(gray.shape)} "
            f"{gray.dtype}"
        )
    n, h, w = gray.shape
    if h < 2 or w < 2:
        raise ValueError(f"reflect-101 borders need H, W >= 2, got {h}x{w}")
    if gray.device.type == "cpu":
        return corner_min_eigenval_plain(gray)
    if gray.device.type != "cuda":
        raise ValueError(f"no corner kernel for device {gray.device}")
    gray = gray.contiguous()
    out = torch.empty_like(gray)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(gray.device).cuda_stream
    with torch.cuda.device(gray.device):
        err = _kernel()(gray.data_ptr(), out.data_ptr(), n, h, w, stream)
    if err != 0:
        raise RuntimeError(f"corner_min_eigenval kernel launch failed: CUDA error {err}")
    corner_min_eigenval.launches += 1
    return out


corner_min_eigenval.launches = 0
