"""Multi-head attention of the ViT encoders, softmax(q k^T / sqrt(d) + B) v,
read straight out of the qkv projection; B is BEiT's relative-position
bias, or none; and Swin V2's window attention, softmax(q k^T + B + M) v.

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

`window_attention(qkv, table, window, region=None)` is Swin V2's
(models/swin2.py): the frames are windows of Wh x Ww tokens (N = Wh Ww, no
class token), the scores at scale 1 (the caller folds the cosine
attention's temperature into q), the bias gathered from `table` (H, (2 Wh
- 1)(2 Ww - 1)) by the same index without the class token's entries, and,
with `region` (nW, N) int32, the shift mask M = -100 between tokens of
different region codes, window b taking row b mod nW. It shares the bias
path's autograd Function and launchers: on the card the kernels' d = 32
instantiation (`*_window`, `*_window_mask`), on the CPU `attention_plain`
with `window=True`.

`dt_windows` states the dq pass's window of table indices for each block
of 128 query rows, the part of the table its copies of the gradient hold
(the kernels compute it apart; a card test holds the two together).

`vit_attention.launches` and `vit_attention.backward_launches` count the
kernel calls without a bias, `.bias_launches` and `.bias_backward_launches`
those with one and a class token, `.window_launches` and
`.window_backward_launches` the windows' (each a pre-pass and the main
kernels). Under a CUDA graph's replay they do not advance: Python does not
run.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import load_cuda_library

HEAD_WIDTH = 64  # the kernels' with a class token (ViT, BEiT)
WINDOW_HEAD_WIDTH = 32  # the window kernels' (Swin V2)
MASK_VALUE = -100.0  # Swin's shift mask between regions


def relative_position_index(grid, cls: bool = True) -> torch.Tensor:
    """timm's gen_relative_position_index on a (Wh, Ww) token grid: (N, N)
    indices into a table of (2 Wh - 1)(2 Ww - 1) + 3 entries, N = 1 + Wh Ww
    (`cls`: BEiT's, a class token first), or of (2 Wh - 1)(2 Ww - 1)
    entries, N = Wh Ww (Swin's window). Patch tokens i, j at (y, x) take
    (y_i - y_j + Wh - 1)(2 Ww - 1) + x_i - x_j + Ww - 1; the class token's
    row, column and diagonal take the last three entries."""
    wh, ww = grid
    r = (2 * wh - 1) * (2 * ww - 1) + 3
    y, x = torch.meshgrid(torch.arange(wh), torch.arange(ww), indexing="ij")
    y, x = y.flatten(), x.flatten()
    patches = ((y[:, None] - y[None, :] + wh - 1) * (2 * ww - 1)
               + x[:, None] - x[None, :] + ww - 1)
    if not cls:
        return patches
    idx = torch.empty((1 + wh * ww,) * 2, dtype=torch.long)
    idx[1:, 1:] = patches
    idx[0, :] = r - 3
    idx[:, 0] = r - 2
    idx[0, 0] = r - 1
    return idx


ROWS_PER_CTA = 128  # the kernels' query rows a block


def dt_windows(grid, cls: bool = True) -> list:
    """The dq pass's window of table indices for each block of 128 query
    rows on a (Wh, Ww) grid (csrc/vit_attention.cu, dq_body), with a class
    token first (`cls`) or none: (lo, hi) with lo = c of the block's first
    patch token and hi = K0 + c of its last, c = y (2 Ww - 1) + x of a patch
    token at (y, x), K0 = (Wh - 1)(2 Ww - 1) + Ww - 1; None for a block
    without one (the class token alone). Every index of a patch-token row
    and a patch-token key lies in its row's block's window; the class
    token's three lie after every window."""
    wh, ww = grid
    first_patch = int(cls)
    n = first_patch + wh * ww
    k0 = (wh - 1) * (2 * ww - 1) + ww - 1

    def c(token):
        y, x = divmod(token - first_patch, ww)
        return y * (2 * ww - 1) + x

    out = []
    for first in range(0, n, ROWS_PER_CTA):
        f, last = max(first, first_patch), min(first + ROWS_PER_CTA - 1, n - 1)
        out.append((c(f), k0 + c(last)) if f <= last else None)
    return out


def dq_bias_copy(grid, cls: bool = True) -> int:
    """Floats of each of the dq pass's two copies of the table's gradient
    on `grid`: the class token's three entries (kept without one) and the
    longest window, rounded up to 4 (the kernels' dq_bias_copy)."""
    longest = max([w[1] - w[0] + 1 for w in dt_windows(grid, cls) if w], default=0)
    return (3 + longest + 3) // 4 * 4


def attention_plain(qkv: torch.Tensor, rel_table: torch.Tensor | None = None,
                    grid=None, region: torch.Tensor | None = None,
                    window: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + B) v of each (frame, head), written out in
    the input's type: (B, N, 3, H, d) -> (B, N, H, d); B is gathered from
    `rel_table` (H, R) by relative_position_index(grid), or 0. `window`:
    Swin V2's form, softmax(q k^T + B + M) v, the index without a class
    token and M = -100 between tokens whose codes in `region` (nW, N)
    differ (window b takes row b mod nW), or 0."""
    q, k, v = qkv.unbind(2)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k)
    if not window:
        s = s / math.sqrt(qkv.shape[-1])
    if rel_table is not None:
        idx = (relative_position_index(grid, cls=False) if window
               else relative_position_index(grid)).to(rel_table.device)
        s = s + rel_table[:, idx]
    if region is not None:
        other = region[:, :, None] != region[:, None, :]
        mask = torch.where(other, MASK_VALUE, 0.0).to(s.dtype)
        s = s + mask.repeat(qkv.shape[0] // region.shape[0], 1, 1)[:, None]
    return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, dim=-1), v)


def check_kernel_input(qkv: torch.Tensor, width: int = HEAD_WIDTH) -> None:
    """Raises unless the kernel takes `qkv` (its device aside): float32,
    contiguous, (B, N, 3, H, width) with B, N, H >= 1."""
    if qkv.dtype != torch.float32:
        raise ValueError(f"vit_attention: the kernel takes float32, got {qkv.dtype}")
    if qkv.dim() != 5 or qkv.shape[2] != 3 or qkv.shape[4] != width:
        raise ValueError(f"vit_attention: the kernel takes (B, N, 3, H, {width}), "
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
            ("vit_attention_scratch_bytes_width", [i32] * 5, ctypes.c_longlong),
            ("vit_attention_lse_stride", [i32], i32),
            ("vit_attention_forward", [ptr] * 4 + [i32] * 3 + [ptr], i32),
            ("vit_attention_backward", [ptr] * 6 + [i32] * 3 + [ptr], i32),
            ("vit_attention_kernel_info", [i32] + [ptr] * 3, i32),
            ("vit_attention_max_table", [], i32),
            ("vit_attention_pos_length", [i32], i32),
            ("vit_attention_dq_bias_copy_cls", [i32] * 3, i32),
            ("vit_attention_forward_biased", [ptr] * 7 + [i32] * 8 + [ptr], i32),
            ("vit_attention_backward_biased", [ptr] * 10 + [i32] * 8 + [ptr], i32)):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = args, res
    return lib


def _scratch(lib, qkv, backward: bool) -> torch.Tensor:
    b, n, _, h, d = qkv.shape
    nbytes = lib.vit_attention_scratch_bytes_width(b, n, h, d, int(backward))
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


def check_bias_input(qkv: torch.Tensor, rel_table: torch.Tensor, grid,
                     cls: bool = True) -> None:
    """Raises unless the bias kernels take `rel_table` and `grid` with the
    checked `qkv`: (H, (2 Wh - 1)(2 Ww - 1) + 3) float32, contiguous, on
    qkv's device, N = 1 + Wh Ww (`cls`); without a class token (H, (2 Wh -
    1)(2 Ww - 1)) and N = Wh Ww."""
    wh, ww = grid
    if qkv.shape[1] != int(cls) + wh * ww:
        raise ValueError(f"vit_attention: {qkv.shape[1]} tokens on a {wh}x{ww} grid")
    want = (qkv.shape[3], (2 * wh - 1) * (2 * ww - 1) + 3 * int(cls))
    if tuple(rel_table.shape) != want:
        raise ValueError(f"vit_attention: the table is {tuple(rel_table.shape)}, "
                         f"the grid needs {want}")
    if rel_table.dtype != torch.float32 or rel_table.device != qkv.device:
        raise ValueError("vit_attention: the table must be float32 on qkv's device")
    if not rel_table.is_contiguous():
        raise ValueError("vit_attention: the kernel takes a contiguous table")


def check_region_input(qkv: torch.Tensor, region: torch.Tensor) -> None:
    """Raises unless the window kernels take the region codes `region`:
    (nW, N) int32 on qkv's device, nW dividing the frames."""
    nw = region.shape[0] if region.dim() == 2 else 0
    if region.dim() != 2 or region.shape[1] != qkv.shape[1] or nw < 1 or qkv.shape[0] % nw:
        raise ValueError(f"vit_attention: region codes {tuple(region.shape)} for "
                         f"{tuple(qkv.shape[:2])} windows and tokens")
    if region.dtype != torch.int32 or region.device != qkv.device:
        raise ValueError("vit_attention: the region codes must be int32 on qkv's device")


_POS: dict = {}


def grid_offsets(grid, device, cls: bool = True) -> torch.Tensor:
    """The kernels' pos for a (Wh, Ww) grid: int32 c_n = y (2 Ww - 1) + x of
    each patch token n at (y, x), -1 for the class token (`cls`), padded
    with 0 to past the kernels' tiles. Kept per grid and device (not while a
    CUDA graph is being captured, whose pool would own it)."""
    key = (tuple(grid), str(device), cls)
    pos = _POS.get(key)
    if pos is None:
        wh, ww = grid
        first = int(cls)
        n = first + wh * ww
        c = torch.zeros(_library().vit_attention_pos_length(n), dtype=torch.int32)
        y, x = torch.meshgrid(torch.arange(wh), torch.arange(ww), indexing="ij")
        if cls:
            c[0] = -1
        c[first:n] = (y * (2 * ww - 1) + x).flatten().to(torch.int32)
        pos = c.to(device)
        if not torch.cuda.is_current_stream_capturing():
            _POS[key] = pos
    return pos


def _padded_region(region: torch.Tensor | None, n: int):
    """The region codes padded with 0 to the kernels' row length, or None."""
    if region is None:
        return None
    extra = _library().vit_attention_pos_length(n) - n
    return torch.nn.functional.pad(region, (0, extra)).contiguous()


def forward_bias_kernel(qkv: torch.Tensor, rel_table: torch.Tensor, grid,
                        region: torch.Tensor | None = None, cls: bool = True):
    """The bias kernels' forward on checked inputs: (out, lse2), as
    forward_kernel's, the scores biased; without `cls` Swin V2's windows
    (scale 1, the shift mask from `region`)."""
    lib = _library()
    b, n, _, h, d = qkv.shape
    wh, ww = grid
    out = torch.empty((b, n, h, d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b * h, lib.vit_attention_lse_stride(n)), dtype=torch.float32,
                      device=qkv.device)
    scratch = _scratch(lib, qkv, backward=False)
    pos = grid_offsets(grid, qkv.device, cls)
    reg = _padded_region(region, n)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    _raise(lib.vit_attention_forward_biased(
        qkv.data_ptr(), rel_table.data_ptr(), pos.data_ptr(),
        None if reg is None else reg.data_ptr(), out.data_ptr(), lse.data_ptr(),
        scratch.data_ptr(), b, n, h, d, wh, ww, int(cls),
        1 if region is None else region.shape[0], stream), "forward (bias)")
    if cls:
        vit_attention.bias_launches += 1
    else:
        vit_attention.window_launches += 1
    return out, lse


def backward_bias_kernel(qkv, rel_table, grid, out, lse, dout, region=None, cls: bool = True):
    """The bias kernels' backward: the gradients of qkv and of the table."""
    lib = _library()
    b, n, _, h, d = qkv.shape
    wh, ww = grid
    dqkv = torch.empty_like(qkv)
    dtable = torch.zeros_like(rel_table)
    scratch = _scratch(lib, qkv, backward=True)
    pos = grid_offsets(grid, qkv.device, cls)
    reg = _padded_region(region, n)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    _raise(lib.vit_attention_backward_biased(
        qkv.data_ptr(), rel_table.data_ptr(), pos.data_ptr(),
        None if reg is None else reg.data_ptr(), out.data_ptr(), lse.data_ptr(),
        dout.data_ptr(), dqkv.data_ptr(), dtable.data_ptr(), scratch.data_ptr(), b, n, h, d, wh,
        ww, int(cls), 1 if region is None else region.shape[0], stream), "backward (bias)")
    if cls:
        vit_attention.bias_backward_launches += 1
    else:
        vit_attention.window_backward_launches += 1
    return dqkv, dtable


class _VitAttentionBias(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, rel_table, grid, region, cls):
        with torch.cuda.device(qkv.device):
            out, lse = forward_bias_kernel(qkv, rel_table, grid, region, cls)
        ctx.grid, ctx.cls = grid, cls
        ctx.save_for_backward(qkv, rel_table, region, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, rel_table, region, out, lse = ctx.saved_tensors
        with torch.cuda.device(qkv.device):
            dqkv, dtable = backward_bias_kernel(qkv, rel_table, ctx.grid, out, lse,
                                                dout.contiguous(), region, ctx.cls)
        return dqkv, dtable, None, None, None


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
    return _VitAttentionBias.apply(qkv, rel_table, grid, None, True)


def window_attention(qkv: torch.Tensor, table: torch.Tensor, window,
                     region: torch.Tensor | None = None) -> torch.Tensor:
    """Swin V2's softmax(q k^T + B + M) v over windows of `window` (Wh, Ww)
    tokens, from the (B, N, 3, H, d) q, k and v of the windows of every
    image in order (N = Wh Ww): (B, N, H, d); B gathered from `table` (H,
    (2 Wh - 1)(2 Ww - 1)), M the shift mask of the region codes `region`
    (nW, N) int32, or none. The Hopper kernels on a CUDA float32 input with
    d = 32 (any other CUDA input raises), the plain version on the CPU; the
    gradient flows to qkv and the table."""
    window = (int(window[0]), int(window[1]))
    if qkv.device.type == "cpu":
        return attention_plain(qkv, table, window, region, window=True)
    if qkv.device.type != "cuda":
        raise ValueError(f"vit_attention: no kernel for device {qkv.device}")
    check_kernel_input(qkv, WINDOW_HEAD_WIDTH)
    check_bias_input(qkv, table, window, cls=False)
    if region is not None:
        check_region_input(qkv, region)
    return _VitAttentionBias.apply(qkv, table, window, region, False)


vit_attention.launches = 0
vit_attention.backward_launches = 0
vit_attention.bias_launches = 0
vit_attention.bias_backward_launches = 0
vit_attention.window_launches = 0
vit_attention.window_backward_launches = 0
