"""Device choice for the port's entry points."""

from __future__ import annotations

import functools
from contextlib import contextmanager

import torch


def resolve_device(device) -> torch.device:
    """The torch.device an entry point runs on. Entry points default to
    "cuda"; without a card that raises, and the caller has to ask for the
    CPU explicitly (device="cpu") — the port never drops to the CPU on its
    own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


@functools.lru_cache(maxsize=None)
def constant(values: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The 1-d tensor of `values` on `device`, made once and then shared.
    Building a tensor from host numbers on a card copies them through a
    host sync each time, which stalls the host behind the card and cannot
    be captured in a CUDA graph. Never write into it."""
    return torch.tensor(values, dtype=dtype, device=device)


@contextmanager
def float32_precision(cudnn_tf32: bool, matmul_tf32: bool = False):
    """Run float32 matrix products in full float32 ("highest"), or in TF32
    ("high") with `matmul_tf32`, and cuDNN convolutions in TF32 or not,
    restoring the caller's settings after."""
    old = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high" if matmul_tf32 else "highest")
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old[0])
        torch.backends.cudnn.allow_tf32 = old[1]
