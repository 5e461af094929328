"""Fused Adam update over flat float32 buffers.

`adam_update` is the port of the Pallas TPU kernel
tools/probe_adam_bw.py::adam_pl (one Adam step without bias correction
over the flat MiDaS parameter vector); with `bias_correction=True` it is
the update optax.adam(lr) makes on the JAX package's fine-tune path
(robust_cvd_tpu/training/fine_tune.py:486-494), with `rectified=True`
optax.radam(lr)'s and with a bfloat16 `mu` that of
optax.adam(lr, mu_dtype=jnp.bfloat16). A CUDA buffer goes to the
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


def _mode(mu, bias_correction: bool, rectified: bool) -> int:
    """The kernel's mode (csrc/adam.cu): 0 adam_pl, 1 optax.adam, 2
    optax.radam, 3 optax.adam with a bf16 first moment."""
    if mu.dtype == torch.bfloat16:
        if rectified or not bias_correction:
            raise ValueError("a bf16 first moment is optax.adam's (bias correction, "
                             "not rectified)")
        return 3
    if rectified:
        if not bias_correction:
            raise ValueError("RAdam is optax's, with bias correction")
        return 2
    return int(bias_correction)


def adam_update_plain(p, g, mu, nu, count, ok, lr: float, b1: float = 0.9,
                      b2: float = 0.999, eps: float = 1e-8,
                      bias_correction: bool = True, rectified: bool = False) -> None:
    """The kernel's arithmetic in torch ops (see csrc/adam.cu)."""
    mode = _mode(mu, bias_correction, rectified)
    if mode == 0:  # adam_kernel, tools/probe_adam_bw.py:105-111
        m = b1 * mu + (1 - b1) * g
        v = b2 * nu + (1 - b2) * g * g
        new_p = p - lr * (m / (torch.sqrt(v) + eps))
    else:
        if mode == 3:
            # b1 in mu's type, as JAX's weakly typed scalar is there
            b1_mu = torch.tensor(b1, dtype=torch.bfloat16).item()
            m = (1 - b1) * g + b1_mu * mu.to(g.dtype)
        else:
            m = (1 - b1) * g + b1 * mu
        v = (1 - b2) * (g * g) + b2 * nu
        # b^t correctly rounded to the buffers' type from the double power;
        # t = count + 1 (optax's safe increment)
        t = torch.where(count < 2**31 - 1, count + 1, count)

        def power(b):
            base = torch.tensor(b, dtype=p.dtype).double()
            return torch.pow(base, t.double()).to(p.dtype)

        b2t = power(b2)
        bc1, bc2 = 1 - power(b1), 1 - b2t
        mu_hat = m / bc1
        denom = torch.sqrt(v / bc2) + eps
        if mode == 2:  # optax.scale_by_radam, threshold 5, in the buffers' type
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            ro = ro_inf - (2 * t).to(p.dtype) * b2t / bc2
            r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                           / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
            u = torch.where(ro >= 5.0, r * mu_hat / denom, mu_hat)
        else:
            u = mu_hat / denom
        new_p = p + (-lr) * u
    p.copy_(torch.where(ok, new_p, p))
    mu.copy_(torch.where(ok, m.to(mu.dtype), mu))
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
    # the kernel takes float32 (and a bf16 mu); the plain version float64
    # too (the tests compare a step in float64)
    dtypes = (torch.float32,) if p.device.type == "cuda" else (torch.float32, torch.float64)
    for name, t in (("p", p), ("g", g), ("mu", mu), ("nu", nu)):
        want = (torch.bfloat16,) if name == "mu" and mu.dtype == torch.bfloat16 else dtypes
        if t.dtype not in want or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous 1-d buffer of {want}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.shape != p.shape or t.device != p.device or (
                t.dtype != p.dtype and t is not mu):
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device} does not "
                             f"match p {tuple(p.shape)} {p.dtype} on {p.device}")
    if count.dtype != torch.int32 or count.numel() != 1 or count.device != p.device:
        raise ValueError("count: expected one int32 on the buffers' device")
    if ok.dtype != torch.bool or ok.numel() != 1 or ok.device != p.device:
        raise ValueError("ok: expected one bool on the buffers' device")


def adam_update(p, g, mu, nu, count, ok, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                bias_correction: bool = True, rectified: bool = False) -> None:
    """One guarded Adam (or, `rectified`, RAdam) step on flat float32
    buffers, in place; `mu` may be bfloat16 (optax.adam's mu_dtype).

    On CUDA buffers this launches the Hopper kernel (and counts the launch
    in `adam_update.launches` and, by the kernel's mode,
    `adam_update.launches_by_mode`); on CPU buffers it computes the plain
    version."""
    _check(p, g, mu, nu, count, ok)
    mode = _mode(mu, bias_correction, rectified)
    if p.device.type == "cpu":
        adam_update_plain(p, g, mu, nu, count, ok, lr, b1, b2, eps, bias_correction, rectified)
        return
    if p.device.type != "cuda":
        raise ValueError(f"no Adam kernel for device {p.device}")
    for name, t in (("p", p), ("g", g), ("mu", mu), ("nu", nu)):
        if t.data_ptr() % (8 if t.dtype == torch.bfloat16 else 16):
            raise ValueError(f"{name}: the kernel's vector loads need 16-byte "
                             f"(a bf16 mu 8-byte) alignment")
    stream = torch.cuda.current_stream(p.device).cuda_stream
    with torch.cuda.device(p.device):
        err = _kernel()(
            p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), p.numel(),
            lr, b1, b2, eps, mode, count.data_ptr(), ok.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"adam kernel launch failed: CUDA error {err}")
    adam_update.launches += 1
    adam_update.launches_by_mode[MODES[mode]] += 1


MODES = ("adam_pl", "adam", "radam", "adam_mu_bf16")  # the kernel's modes 0-3
adam_update.launches = 0
adam_update.launches_by_mode = dict.fromkeys(MODES, 0)
