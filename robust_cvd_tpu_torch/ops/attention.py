"""Multi-head attention of the ViT encoder, softmax(q k^T / sqrt(d) + B) v,
read straight out of the qkv projection; B is BEiT's relative-position
bias, or none.

`vit_attention(qkv, rel_table=None, grid=None)` takes the projection's
output as it lies, (B, N, 3, H, d), and returns (B, N, H, d), so that the
output projection reads a view. With `rel_table` (H, (2 Wh - 1)(2 Ww - 1)
+ 3) and `grid` (Wh, Ww), N = 1 + Wh Ww and B[h, i, j] = rel_table[h,
idx(i, j)] with `relative_position_index` (timm's); the gradient flows to
both qkv and the table. A CUDA float32 input with d = 64 (DPT-Large,
DPT-Hybrid, ViT-B/L, BEiT-L) goes to the hand-written Hopper kernels of
csrc/vit_attention.cu, forward and backward, through a
torch.autograd.Function (the bias path through the kernels' *_bias
variants, which gather the bias from the table and write its gradient); a
CPU input goes to `attention_plain`, the written-out softmax in the
input's type, which the tests and chip_smoke.py hold the kernels against.
Any other CUDA input raises: there is no fallback from the kernel to the
plain version. No TPU kernel is replaced (the JAX package has no attention
kernel); the kernels take the place of F.scaled_dot_product_attention's
float32 CUTLASS kernels, with the same arithmetic class (3xTF32 products,
float32 softmax).

`dt_windows` states the dq pass's window of table indices for each block
of 128 query rows, the part of the table its copies of the gradient hold
(the kernels compute it apart; a card test holds the two together).

`vit_attention.launches` and `vit_attention.backward_launches` count the
kernel calls without a bias, `.bias_launches` and `.bias_backward_launches`
those with one (each a pre-pass and the main kernels). Under a CUDA
graph's replay they do not advance: Python does not run.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import load_cuda_library

HEAD_WIDTH = 64  # the kernel's


def relative_position_index(grid) -> torch.Tensor:
    """timm's gen_relative_position_index on a (Wh, Ww) token grid: (N, N)
    indices into a table of (2 Wh - 1)(2 Ww - 1) + 3 entries, N = 1 + Wh Ww.
    Patch tokens i, j at (y, x) take (y_i - y_j + Wh - 1)(2 Ww - 1) + x_i
    - x_j + Ww - 1; the class token's row, column and diagonal take the
    last three entries."""
    wh, ww = grid
    r = (2 * wh - 1) * (2 * ww - 1) + 3
    y, x = torch.meshgrid(torch.arange(wh), torch.arange(ww), indexing="ij")
    y, x = y.flatten(), x.flatten()
    idx = torch.empty((1 + wh * ww,) * 2, dtype=torch.long)
    idx[1:, 1:] = ((y[:, None] - y[None, :] + wh - 1) * (2 * ww - 1)
                   + x[:, None] - x[None, :] + ww - 1)
    idx[0, :] = r - 3
    idx[:, 0] = r - 2
    idx[0, 0] = r - 1
    return idx


ROWS_PER_CTA = 128  # the kernels' query rows a block


def dt_windows(grid) -> list:
    """The dq pass's window of table indices for each block of 128 query
    rows on a (Wh, Ww) grid (csrc/vit_attention.cu, dq_body): (lo, hi) with
    lo = c of the block's first patch token and hi = K0 + c of its last,
    c = y (2 Ww - 1) + x of a patch token at (y, x), K0 = (Wh - 1)(2 Ww - 1)
    + Ww - 1; None for a block without one (the class token alone). Every
    index of a patch-token row and a patch-token key lies in its row's
    block's window; the class token's three lie after every window."""
    wh, ww = grid
    n = 1 + wh * ww
    k0 = (wh - 1) * (2 * ww - 1) + ww - 1

    def c(token):
        y, x = divmod(token - 1, ww)
        return y * (2 * ww - 1) + x

    out = []
    for first in range(0, n, ROWS_PER_CTA):
        f, last = max(first, 1), min(first + ROWS_PER_CTA - 1, n - 1)
        out.append((c(f), k0 + c(last)) if f <= last else None)
    return out


def dq_bias_copy(grid) -> int:
    """Floats of each of the dq pass's two copies of the table's gradient
    on `grid`: the class token's three entries and the longest window,
    rounded up to 4 (the kernels' vit_attention_dq_bias_copy)."""
    longest = max([w[1] - w[0] + 1 for w in dt_windows(grid) if w], default=0)
    return (3 + longest + 3) // 4 * 4


def attention_plain(qkv: torch.Tensor, rel_table: torch.Tensor | None = None,
                    grid=None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + B) v of each (frame, head), written out in
    the input's type: (B, N, 3, H, d) -> (B, N, H, d); B is gathered from
    `rel_table` (H, R) by relative_position_index(grid), or 0."""
    q, k, v = qkv.unbind(2)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(qkv.shape[-1])
    if rel_table is not None:
        idx = relative_position_index(grid).to(rel_table.device)
        s = s + rel_table[:, idx]
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
    return bind_library(load_cuda_library("vit_attention"))


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument and result types of csrc/vit_attention.cu's C
    functions on a loaded build of it (of those it has: an older build
    lacks the newer functions)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, args, res in (
            ("vit_attention_scratch_bytes", [i32] * 4, ctypes.c_longlong),
            ("vit_attention_lse_stride", [i32], i32),
            ("vit_attention_forward", [ptr] * 4 + [i32] * 3 + [ptr], i32),
            ("vit_attention_backward", [ptr] * 6 + [i32] * 3 + [ptr], i32),
            ("vit_attention_kernel_info", [i32] + [ptr] * 3, i32),
            ("vit_attention_max_table", [], i32),
            ("vit_attention_pos_length", [i32], i32),
            ("vit_attention_dq_bias_copy", [i32, i32], i32),
            ("vit_attention_forward_bias", [ptr] * 6 + [i32] * 5 + [ptr], i32),
            ("vit_attention_backward_bias", [ptr] * 9 + [i32] * 5 + [ptr], i32)):
        fn = getattr(lib, name, None)
        if fn is not None:
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


def check_bias_input(qkv: torch.Tensor, rel_table: torch.Tensor, grid) -> None:
    """Raises unless the bias kernels take `rel_table` and `grid` with the
    checked `qkv`: (H, (2 Wh - 1)(2 Ww - 1) + 3) float32, contiguous, on
    qkv's device, N = 1 + Wh Ww."""
    wh, ww = grid
    if qkv.shape[1] != 1 + wh * ww:
        raise ValueError(f"vit_attention: {qkv.shape[1]} tokens on a {wh}x{ww} grid")
    want = (qkv.shape[3], (2 * wh - 1) * (2 * ww - 1) + 3)
    if tuple(rel_table.shape) != want:
        raise ValueError(f"vit_attention: the table is {tuple(rel_table.shape)}, "
                         f"the grid needs {want}")
    if rel_table.dtype != torch.float32 or rel_table.device != qkv.device:
        raise ValueError("vit_attention: the table must be float32 on qkv's device")
    if not rel_table.is_contiguous():
        raise ValueError("vit_attention: the kernel takes a contiguous table")


_POS: dict = {}


def grid_offsets(grid, device) -> torch.Tensor:
    """The kernels' pos for a (Wh, Ww) grid: int32 c_n = y (2 Ww - 1) + x of
    each patch token n at (y, x), -1 for the class token, padded with 0 to
    past the kernels' tiles. Kept per grid and device (not while a CUDA graph is
    being captured, whose pool would own it)."""
    key = (tuple(grid), str(device))
    pos = _POS.get(key)
    if pos is None:
        wh, ww = grid
        n = 1 + wh * ww
        c = torch.zeros(_library().vit_attention_pos_length(n), dtype=torch.int32)
        y, x = torch.meshgrid(torch.arange(wh), torch.arange(ww), indexing="ij")
        c[0] = -1
        c[1:n] = (y * (2 * ww - 1) + x).flatten().to(torch.int32)
        pos = c.to(device)
        if not torch.cuda.is_current_stream_capturing():
            _POS[key] = pos
    return pos


def forward_bias_kernel(qkv: torch.Tensor, rel_table: torch.Tensor, grid):
    """The bias kernels' forward on checked inputs: (out, lse2), as
    forward_kernel's, the scores biased."""
    lib = _library()
    b, n, _, h, d = qkv.shape
    wh, ww = grid
    out = torch.empty((b, n, h, d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b * h, lib.vit_attention_lse_stride(n)), dtype=torch.float32,
                      device=qkv.device)
    scratch = _scratch(lib, qkv, backward=False)
    pos = grid_offsets(grid, qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    _raise(lib.vit_attention_forward_bias(
        qkv.data_ptr(), rel_table.data_ptr(), pos.data_ptr(), out.data_ptr(), lse.data_ptr(),
        scratch.data_ptr(), b, n, h, wh, ww, stream), "forward (bias)")
    vit_attention.bias_launches += 1
    return out, lse


def backward_bias_kernel(qkv, rel_table, grid, out, lse, dout):
    """The bias kernels' backward: the gradients of qkv and of the table."""
    lib = _library()
    b, n, _, h, _ = qkv.shape
    wh, ww = grid
    dqkv = torch.empty_like(qkv)
    dtable = torch.zeros_like(rel_table)
    scratch = _scratch(lib, qkv, backward=True)
    pos = grid_offsets(grid, qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    _raise(lib.vit_attention_backward_bias(
        qkv.data_ptr(), rel_table.data_ptr(), pos.data_ptr(), out.data_ptr(), lse.data_ptr(),
        dout.data_ptr(), dqkv.data_ptr(), dtable.data_ptr(), scratch.data_ptr(), b, n, h, wh, ww,
        stream), "backward (bias)")
    vit_attention.bias_backward_launches += 1
    return dqkv, dtable


class _VitAttentionBias(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, rel_table, grid):
        with torch.cuda.device(qkv.device):
            out, lse = forward_bias_kernel(qkv, rel_table, grid)
        ctx.grid = grid
        ctx.save_for_backward(qkv, rel_table, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, rel_table, out, lse = ctx.saved_tensors
        with torch.cuda.device(qkv.device):
            dqkv, dtable = backward_bias_kernel(qkv, rel_table, ctx.grid, out, lse,
                                                dout.contiguous())
        return dqkv, dtable, None


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


def vit_attention(qkv: torch.Tensor, rel_table: torch.Tensor | None = None,
                  grid=None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + B) v from the qkv projection's (B, N, 3, H,
    d) output: (B, N, H, d); B from `rel_table` on the token `grid`, or
    none. The Hopper kernels on a CUDA float32 input with d = 64 (any other
    CUDA input raises), the plain version on the CPU."""
    if rel_table is not None:
        grid = (int(grid[0]), int(grid[1]))
    if qkv.device.type == "cpu":
        return attention_plain(qkv, rel_table, grid)
    if qkv.device.type != "cuda":
        raise ValueError(f"vit_attention: no kernel for device {qkv.device}")
    check_kernel_input(qkv)
    if rel_table is None:
        return _VitAttention.apply(qkv)
    check_bias_input(qkv, rel_table, grid)
    if rel_table.shape[1] > _library().vit_attention_max_table():
        raise ValueError(f"vit_attention: a {grid[0]}x{grid[1]} grid's table of "
                         f"{rel_table.shape[1]} entries is more than the kernels' "
                         f"{_library().vit_attention_max_table()}")
    return _VitAttentionBias.apply(qkv, rel_table, grid)


vit_attention.launches = 0
vit_attention.backward_launches = 0
vit_attention.bias_launches = 0
vit_attention.bias_backward_launches = 0
