"""Fused Adam update over flat float32 buffers.

`adam_update` is the port of the Pallas TPU kernel
tools/probe_adam_bw.py::adam_pl (one Adam step without bias correction
over the flat MiDaS parameter vector); with `bias_correction=True` it is
the update optax.adam(lr) makes on the JAX package's fine-tune path
(robust_cvd_tpu/training/fine_tune.py:486-494). A CUDA buffer goes to the
hand-written Hopper kernel in csrc/adam.cu; a CPU buffer goes to
`adam_update_plain`, the plain PyTorch version that the tests and
chip_smoke.py hold the kernel against. A failed build or launch raises:
there is no fallback from the kernel to the plain version.

Both update p, mu and nu in place and leave them bitwise unchanged where
the device bool `ok` is false (the step's non-finite guard). Neither writes
the int32 step `count`; the caller adds `ok` to it after the update.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_cuda_library


def adam_update_plain(p, g, mu, nu, count, ok, lr: float, b1: float = 0.9,
                      b2: float = 0.999, eps: float = 1e-8,
                      bias_correction: bool = True) -> None:
    """The kernel's arithmetic in torch ops (see csrc/adam.cu)."""
    if bias_correction:
        m = (1 - b1) * g + b1 * mu
        v = (1 - b2) * (g * g) + b2 * nu
        # 1 - b^t with b^t correctly rounded to the buffers' type, as XLA
        # computes optax's bias correction; t = count + 1 (optax's safe
        # increment)
        t = torch.where(count < 2**31 - 1, count + 1, count).double()

        def correction(b):
            base = torch.tensor(b, dtype=p.dtype).double()
            return 1 - torch.pow(base, t).to(p.dtype)

        bc1, bc2 = correction(b1), correction(b2)
        new_p = p + (-lr) * ((m / bc1) / (torch.sqrt(v / bc2) + eps))
    else:  # adam_kernel, tools/probe_adam_bw.py:105-111
        m = b1 * mu + (1 - b1) * g
        v = b2 * nu + (1 - b2) * g * g
        new_p = p - lr * (m / (torch.sqrt(v) + eps))
    p.copy_(torch.where(ok, new_p, p))
    mu.copy_(torch.where(ok, m, mu))
    nu.copy_(torch.where(ok, v, nu))


def _kernel():
    lib = load_cuda_library("adam")
    fn = lib.adam_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(p, g, mu, nu, count, ok) -> None:
    # the kernel takes float32; the plain version float64 too (the tests
    # compare a step in float64)
    dtypes = (torch.float32,) if p.device.type == "cuda" else (torch.float32, torch.float64)
    for name, t in (("p", p), ("g", g), ("mu", mu), ("nu", nu)):
        if t.dtype not in dtypes or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous 1-d buffer of {dtypes}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.shape != p.shape or t.dtype != p.dtype or t.device != p.device:
            raise ValueError(f"{name}: {tuple(t.shape)} on {t.device} does not "
                             f"match p {tuple(p.shape)} on {p.device}")
    if count.dtype != torch.int32 or count.numel() != 1 or count.device != p.device:
        raise ValueError("count: expected one int32 on the buffers' device")
    if ok.dtype != torch.bool or ok.numel() != 1 or ok.device != p.device:
        raise ValueError("ok: expected one bool on the buffers' device")


def adam_update(p, g, mu, nu, count, ok, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                bias_correction: bool = True) -> None:
    """One guarded Adam step on flat float32 buffers, in place.

    On CUDA buffers this launches the Hopper kernel (and counts the launch
    in `adam_update.launches`); on CPU buffers it computes the plain
    version."""
    _check(p, g, mu, nu, count, ok)
    if p.device.type == "cpu":
        adam_update_plain(p, g, mu, nu, count, ok, lr, b1, b2, eps, bias_correction)
        return
    if p.device.type != "cuda":
        raise ValueError(f"no Adam kernel for device {p.device}")
    for name, t in (("p", p), ("g", g), ("mu", mu), ("nu", nu)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel's float4 loads need 16-byte alignment")
    stream = torch.cuda.current_stream(p.device).cuda_stream
    with torch.cuda.device(p.device):
        err = _kernel()(
            p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), p.numel(),
            lr, b1, b2, eps, int(bias_correction), count.data_ptr(), ok.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"adam kernel launch failed: CUDA error {err}")
    adam_update.launches += 1


adam_update.launches = 0
