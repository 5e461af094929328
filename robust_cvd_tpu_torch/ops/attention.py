"""Multi-head attention of the ViT encoder, softmax(q k^T / sqrt(d)) v,
read straight out of the qkv projection.

`vit_attention(qkv)` takes the projection's output as it lies, (B, N, 3, H,
d), and returns (B, N, H, d), so that the output projection reads a view.
A CUDA float32 input with d = 64 (DPT-Large, DPT-Hybrid, ViT-B/L) goes to
the hand-written Hopper kernels of csrc/vit_attention.cu, forward and
backward, through a torch.autograd.Function; a CPU input goes to
`attention_plain`, the written-out softmax in the input's type, which the
tests and chip_smoke.py hold the kernels against. Any other CUDA input
raises: there is no fallback from the kernel to the plain version. No
TPU kernel is replaced (the JAX package has no attention kernel); the
kernels take the place of F.scaled_dot_product_attention's float32 CUTLASS
kernels, with the same arithmetic class (3xTF32 products, float32
softmax).

`vit_attention.launches` and `vit_attention.backward_launches` count the
kernel calls (each a pre-pass and the main kernels). Under a CUDA graph's
replay they do not advance: Python does not run.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import load_cuda_library

HEAD_WIDTH = 64  # the kernel's


def attention_plain(qkv: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v of each (frame, head), written out in the
    input's type: (B, N, 3, H, d) -> (B, N, H, d)."""
    q, k, v = qkv.unbind(2)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(qkv.shape[-1])
    return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, dim=-1), v)


def check_kernel_input(qkv: torch.Tensor) -> None:
    """Raises unless the kernel takes `qkv` (its device aside): float32,
    contiguous, (B, N, 3, H, 64) with B, N, H >= 1."""
    if qkv.dtype != torch.float32:
        raise ValueError(f"vit_attention: the kernel takes float32, got {qkv.dtype}")
    if qkv.dim() != 5 or qkv.shape[2] != 3 or qkv.shape[4] != HEAD_WIDTH:
        raise ValueError(f"vit_attention: the kernel takes (B, N, 3, H, {HEAD_WIDTH}), "
                         f"got {tuple(qkv.shape)}")
    if min(qkv.shape) < 1:
        raise ValueError(f"vit_attention: empty input {tuple(qkv.shape)}")
    if not qkv.is_contiguous():
        raise ValueError("vit_attention: the kernel takes a contiguous qkv")


@functools.cache
def _library():
    lib = load_cuda_library("vit_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, args, res in (
            ("vit_attention_scratch_bytes", [i32] * 4, ctypes.c_longlong),
            ("vit_attention_lse_stride", [i32], i32),
            ("vit_attention_forward", [ptr] * 4 + [i32] * 3 + [ptr], i32),
            ("vit_attention_backward", [ptr] * 6 + [i32] * 3 + [ptr], i32),
            ("vit_attention_kernel_info", [i32] + [ptr] * 3, i32)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def _scratch(lib, qkv, backward: bool) -> torch.Tensor:
    b, n, _, h, _ = qkv.shape
    nbytes = lib.vit_attention_scratch_bytes(b, n, h, int(backward))
    return torch.empty(nbytes, dtype=torch.uint8, device=qkv.device)


def _raise(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"vit_attention {what} launch failed: CUDA error {err}")


def forward_kernel(qkv: torch.Tensor):
    """The forward kernels on a checked CUDA qkv: (out (B, N, H, 64), lse2
    (B H, padded N), each row's base-2 log-sum-exp of the scaled scores)."""
    lib = _library()
    b, n, _, h, d = qkv.shape
    out = torch.empty((b, n, h, d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b * h, lib.vit_attention_lse_stride(n)), dtype=torch.float32,
                      device=qkv.device)
    scratch = _scratch(lib, qkv, backward=False)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    _raise(lib.vit_attention_forward(qkv.data_ptr(), out.data_ptr(), lse.data_ptr(),
                                     scratch.data_ptr(), b, n, h, stream), "forward")
    vit_attention.launches += 1
    return out, lse


def backward_kernel(qkv, out, lse, dout) -> torch.Tensor:
    """The backward kernels: the gradient of qkv, (B, N, 3, H, 64)."""
    lib = _library()
    b, n, _, h, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    scratch = _scratch(lib, qkv, backward=True)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    _raise(lib.vit_attention_backward(qkv.data_ptr(), out.data_ptr(), lse.data_ptr(),
                                      dout.data_ptr(), dqkv.data_ptr(), scratch.data_ptr(),
                                      b, n, h, stream), "backward")
    vit_attention.backward_launches += 1
    return dqkv


class _VitAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv):
        with torch.cuda.device(qkv.device):
            out, lse = forward_kernel(qkv)
        ctx.save_for_backward(qkv, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        with torch.cuda.device(qkv.device):
            return backward_kernel(qkv, out, lse, dout.contiguous())


def vit_attention(qkv: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v from the qkv projection's (B, N, 3, H, d)
    output: (B, N, H, d). The Hopper kernels on a CUDA float32 input with
    d = 64 (any other CUDA input raises), the plain version on the CPU."""
    if qkv.device.type == "cpu":
        return attention_plain(qkv)
    if qkv.device.type != "cuda":
        raise ValueError(f"vit_attention: no kernel for device {qkv.device}")
    check_kernel_input(qkv)
    return _VitAttention.apply(qkv)


vit_attention.launches = 0
vit_attention.backward_launches = 0
