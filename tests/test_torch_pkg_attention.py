"""The ViT encoder's attention (robust_cvd_tpu_torch/ops/attention.py).

On the CPU (the plain version, which the CUDA kernels are held to):
- `attention_plain` in float32 equals softmax(q k^T / 8) v computed in
  float64 with numpy, within 2e-6 of the largest output (float32 sums of up
  to 1,009 products), at N in {1, 63, 64, 65, 1009} (one frame, two heads).
- DPT's `Attention.forward`, which now reads q, k and v straight out of the
  qkv projection, equals the path it replaced (permute, then
  F.scaled_dot_product_attention, then transpose and reshape, then the
  output projection): the output within 1e-5 and the gradient of the
  projection's output within 1e-5 of their largest magnitudes, in float32
  (two float32 orders of the same sums); in float64 within 1e-12.
- The kernel's checker refuses every input the kernel cannot take (a head
  width other than 64, another type, a wrong shape, a non-contiguous or an
  empty tensor) without a card; a CPU input takes the plain version and
  launches nothing; a device that is neither raises.

With BEiT's relative-position bias, on the CPU: the bias checker refuses
a table of the wrong shape, type or device and a token count that is not
the grid's, and a CPU call with a table takes the plain version (its
gradient reaching the table) and launches nothing. The dq pass's window
of table indices a block of 128 query rows (attention.dt_windows) holds
every index of the block's patch-token rows, at the 32x56, 8x8, 24x24 and
7x13 grids, and at most 3/4 (R - 3) + 128 entries over grids up to 96x96.

On the card (marked `cuda`, skipped without one; this file imports no JAX):
- The kernels against the plain version in float64, the output and each of
  dq, dk, dv, at the DPT cell's shape (4, 1009, 3, 16, 64) and at N in
  {1, 65, 577}: each error at most twice F.scaled_dot_product_attention's in
  float32 on the same input (or 2^-24 of the largest value where SDPA's is
  below that; both printed).
- A CUDA graph of the forward and backward, replayed, equals its eager run
  within the kernel's error against float64.
- One DPT train step on the card (24 blocks, heads of 64) advances
  `vit_attention.launches` and `.backward_launches` by 24 each.
- The bias kernels against the plain version in float64 at N 1, 65, 577,
  BEiT's cell shape (4, 1793, 16) on its 32x56 grid, a 7x13 grid (N 92: a
  width dividing neither 32 nor 64, a ragged last key tile) and the 40x81
  grid (the largest table the kernels take): out, dq, dk, dv
  and the table's gradient each, at its largest over three inputs, no
  worse than (at its largest over the same inputs) the bias gathered into a
  float32 mask through F.scaled_dot_product_attention (at N = 1, where the
  exact dq, dk and dT are 0 and both sides are the rounding of dP - D,
  within twice its error: chip_smoke.bias_error_limit); a graph replay of
  the bias path equals its eager run; one BEiT train step (24 blocks)
  advances `.bias_launches` and `.bias_backward_launches` by 24 each and
  leaves the counters without a bias alone; two backward calls give dq,
  dk and dv bit for bit; the kernels' copy of the window is the Python
  rule's.

Swin V2's window form (ops/attention.py::window_attention), on the CPU: the
checkers refuse a head width other than 32, a token count that is not the
window's, a table with class entries and region codes of the wrong shape;
a CPU call takes the plain window form (the gradient reaching the table,
the mask moving the output, the index Swin's) and launches nothing; the
dq pass's window rule without a class token holds every index of a block.
On the card: the window kernels against float64 at chip_smoke.
WINDOW_CHECKS and stage 0's shifted shape (out, dq, dk, dv, dT within
twice SDPA's float32 error with the bias and mask in a float32 mask), dq,
dk and dv bit for bit over two backward calls, and one train step of a
Swin V2 of head width 32 advancing `.window_launches` and
`.window_backward_launches` by its 8 blocks.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from torch_pkg_threads import one_torch_thread  # noqa: F401

from robust_cvd_tpu_torch.models import dpt
from robust_cvd_tpu_torch.ops import attention


def _qkv(b, n, h, d, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(0, 1, (b, n, 3, h, d))).to(dtype)


def _float64_attention(qkv: np.ndarray) -> np.ndarray:
    """softmax(q k^T / sqrt(d)) v of each frame and head, in float64."""
    b, n, _, h, d = qkv.shape
    out = np.empty((b, n, h, d))
    for i in range(b):
        for j in range(h):
            q, k, v = (qkv[i, :, s, j].astype(np.float64) for s in range(3))
            s = q @ k.T / np.sqrt(d)
            p = np.exp(s - s.max(axis=1, keepdims=True))
            out[i, :, j] = (p / p.sum(axis=1, keepdims=True)) @ v
    return out


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1009])
def test_plain_matches_a_float64_softmax(n):
    qkv = _qkv(1, n, 2, 64, seed=n)
    got = attention.attention_plain(qkv)
    assert got.dtype == torch.float32 and got.shape == (1, n, 2, 64)
    want = _float64_attention(qkv.numpy())
    assert np.abs(got.numpy() - want).max() <= 2e-6 * np.abs(want).max()


def _old_forward(module, qkv):
    """models/dpt.py::Attention.forward before the kernel: permuted views of
    the projection's output through F.scaled_dot_product_attention."""
    b, n = qkv.shape[:2]
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    y = F.scaled_dot_product_attention(q, k, v)
    return module.proj(y.transpose(1, 2).reshape(b, n, -1))


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("heads, width, n", [(4, 16, 25), (2, 64, 65), (16, 64, 33)])
def test_attention_forward_equals_the_sdpa_path(heads, width, n, dtype, tol):
    torch.manual_seed(heads * n)
    module = dpt.Attention(heads * width, heads).to(dtype)
    x = torch.randn(2, n, heads * width, dtype=dtype)
    qkv_out = module.qkv(x).detach()
    dy = torch.randn(2, n, heads * width, dtype=dtype)
    results = []
    for fn in (lambda t: module.proj(attention.vit_attention(t).reshape(2, n, -1)),
               lambda t: _old_forward(module, t)):
        t = qkv_out.clone().reshape(2, n, 3, heads, width).requires_grad_(True)
        y = fn(t)
        y.backward(dy)
        results.append((y.detach(), t.grad))
    (y_new, g_new), (y_old, g_old) = results
    assert (y_new - y_old).abs().max() <= tol * y_old.abs().max()
    assert (g_new - g_old).abs().max() <= tol * g_old.abs().max()
    with torch.no_grad():  # the module end to end
        assert (module(x) - y_old).abs().max() <= tol * y_old.abs().max()


@pytest.mark.parametrize("shape, dtype, why", [
    ((1, 5, 3, 4, 16), torch.float32, "head width 16"),
    ((1, 5, 3, 2, 128), torch.float32, "head width 128"),
    ((1, 5, 3, 2, 64), torch.float64, "float64"),
    ((1, 5, 3, 2, 64), torch.bfloat16, "bfloat16"),
    ((1, 5, 2, 2, 64), torch.float32, "no v"),
    ((5, 3, 2, 64), torch.float32, "no frame axis"),
    ((1, 0, 3, 2, 64), torch.float32, "no tokens"),
])
def test_the_kernels_checker_refuses(shape, dtype, why):
    with pytest.raises(ValueError):
        attention.check_kernel_input(torch.zeros(shape, dtype=dtype))


def test_the_checker_takes_the_kernels_inputs_only():
    attention.check_kernel_input(torch.zeros((4, 1009, 3, 16, 64)))
    with pytest.raises(ValueError, match="contiguous"):
        attention.check_kernel_input(torch.zeros((4, 3, 9, 16, 64)).transpose(1, 2))
    with pytest.raises(ValueError, match="no kernel for device"):
        attention.vit_attention(torch.zeros((1, 5, 3, 2, 64), device="meta"))


def test_a_cpu_input_takes_the_plain_version():
    qkv = _qkv(2, 9, 3, 64, seed=1)
    before = (attention.vit_attention.launches, attention.vit_attention.backward_launches)
    x = qkv.clone().requires_grad_(True)
    out = attention.vit_attention(x)
    out.sum().backward()
    assert torch.equal(out, attention.attention_plain(qkv))
    assert (attention.vit_attention.launches,
            attention.vit_attention.backward_launches) == before


@pytest.mark.parametrize("grid, table_shape, dtype, why", [
    ((2, 3), (2, 18), torch.float32, "tokens not the grid's"),
    ((3, 3), (2, 27), torch.float32, "table of another grid"),
    ((3, 3), (3, 28), torch.float32, "table of another head count"),
    ((3, 3), (2, 28), torch.float64, "float64 table"),
])
def test_the_bias_checker_refuses(grid, table_shape, dtype, why):
    qkv = torch.zeros((1, 10, 3, 2, 64))
    with pytest.raises(ValueError):
        attention.check_bias_input(qkv, torch.zeros(table_shape, dtype=dtype), grid)


def test_a_cpu_input_with_a_table_takes_the_plain_version():
    qkv = _qkv(2, 13, 2, 64, seed=2)
    table = torch.randn((2, 5 * 7 + 3), generator=torch.Generator().manual_seed(0))
    attention.check_bias_input(qkv, table, (3, 4))
    before = (attention.vit_attention.bias_launches, attention.vit_attention.bias_backward_launches)
    t = table.clone().requires_grad_(True)
    out = attention.vit_attention(qkv, t, (3, 4))
    out.square().sum().backward()
    assert torch.equal(out, attention.attention_plain(qkv, table, (3, 4)))
    assert t.grad is not None and t.grad.abs().max() > 0
    assert (attention.vit_attention.bias_launches,
            attention.vit_attention.bias_backward_launches) == before


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 2), (2, 65, 3), (1, 577, 4), (4, 1009, 16)])
def test_kernels_match_float64_within_twice_sdpas_error(shape):
    _card()
    errs = chip_smoke.attention_errors(*shape, seed=5)
    print(shape, errs)
    for k, v in errs["kernel"].items():
        assert v <= max(2 * errs["sdpa"][k], 2.0 ** -24), (k, v, errs["sdpa"][k])


@pytest.mark.cuda
def test_a_graph_replay_equals_the_eager_run():
    _card()
    g = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.randn((2, 577, 3, 4, 64), generator=g, device="cuda")
    dout = torch.randn((2, 577, 4, 64), generator=g, device="cuda")

    def step():
        out, lse = attention.forward_kernel(qkv)
        return out, attention.backward_kernel(qkv, out, lse, dout)

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = step()
    graph.replay()
    torch.cuda.synchronize()
    tol = max(chip_smoke.attention_errors(2, 577, 4, seed=3)["kernel"].values())
    for a, b in zip(static, eager):
        assert (a - b).abs().max() <= tol * b.abs().max()


@pytest.mark.cuda
def test_a_dpt_train_step_runs_the_kernels_in_every_block():
    _card()
    import test_torch_pkg_dpt as tdpt

    net = dpt.DPTDepthNet(hidden=128, heads=2, blocks=24, mlp=256, patch=16, pos_grid=4,
                          hooks=(5, 11, 17, 23), widths=(16, 32, 64, 64), features=32,
                          classes=10)
    tuner, _ = tdpt._tuner(dtype=torch.float32, adapter=dpt.DPTLargeAdapter(net),
                           device="cuda")
    before = (attention.vit_attention.launches, attention.vit_attention.backward_launches)
    loss, _, ok = tuner.train_step(torch.tensor([0, 2], device="cuda"))
    torch.cuda.synchronize()
    assert bool(ok) and torch.isfinite(loss)
    assert attention.vit_attention.launches == before[0] + 24
    assert attention.vit_attention.backward_launches == before[1] + 24


@pytest.mark.cuda
@pytest.mark.parametrize("b, grid, h", chip_smoke.ATTENTION_BIAS_CHECKS)
def test_bias_kernels_match_float64_no_worse_than_sdpa(b, grid, h):
    """The largest error of each part over three inputs: on one input the
    two float32 errors can fall either way by a few percent
    (chip_smoke.attention_bias_errors_max)."""
    _card()
    errs = chip_smoke.attention_bias_errors_max(b, grid, h)
    print(b, grid, h, errs)
    n = 1 + grid[0] * grid[1]
    for k, v in errs["kernel"].items():
        assert v <= chip_smoke.bias_error_limit(errs, k, n), (k, v, errs["sdpa"][k])


@pytest.mark.cuda
@pytest.mark.parametrize("b, grid, h", [chip_smoke.ATTENTION_BIAS_SHAPE, (2, (7, 13), 3)])
def test_the_bias_backward_gives_dq_dk_dv_bit_for_bit(b, grid, h):
    """dq, dk and dv are summed in a fixed order (only dT takes device
    atomics): two backward calls on one input agree bit for bit."""
    _card()
    qkv, table, dout = chip_smoke._bias_inputs(b, grid, h, seed=4)
    out, lse = attention.forward_bias_kernel(qkv, table, grid)
    first = attention.backward_bias_kernel(qkv, table, grid, out, lse, dout)
    second = attention.backward_bias_kernel(qkv, table, grid, out, lse, dout)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert (first[1] - second[1]).abs().max() <= 1e-5 * first[1].abs().max()


@pytest.mark.cuda
def test_the_kernels_window_is_the_plain_rule():
    """The dq pass's copy of dT holds the longest window of
    attention.dt_windows (the C side computes it apart), with a class token
    and, at Swin V2's windows, without; the checks' largest
    grid is the widest of its height whose table the kernels take, past the
    12,224 entries they took before."""
    _card()
    lib = attention._library()
    for _, grid, _ in chip_smoke.ATTENTION_BIAS_CHECKS + (chip_smoke.ATTENTION_BIAS_SHAPE,):
        assert lib.vit_attention_dq_bias_copy_cls(*grid, 1) == attention.dq_bias_copy(
            grid), grid
    # Swin V2's windows, without a class token
    for _, w, _, _, _ in chip_smoke.WINDOW_CHECKS + (chip_smoke.WINDOW_STAGE2,):
        assert lib.vit_attention_dq_bias_copy_cls(w, w, 0) == attention.dq_bias_copy(
            (w, w), cls=False), w
    wh, ww = chip_smoke.ATTENTION_BIAS_MAX_GRID
    top = lib.vit_attention_max_table()
    assert 12224 < (2 * wh - 1) * (2 * ww - 1) + 3 <= top < (2 * wh - 1) * (2 * ww + 1) + 3


@pytest.mark.cuda
def test_a_graph_replay_of_the_bias_path_equals_the_eager_run():
    _card()
    grid = (24, 24)
    qkv, table, dout = chip_smoke._bias_inputs(2, grid, 4, seed=3)

    def step():
        out, lse = attention.forward_bias_kernel(qkv, table, grid)
        return (out,) + attention.backward_bias_kernel(qkv, table, grid, out, lse, dout)

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = step()
    graph.replay()
    torch.cuda.synchronize()
    tol = max(chip_smoke.attention_bias_errors(2, grid, 4, seed=3)["kernel"].values())
    for a, b in zip(static, eager):
        assert (a - b).abs().max() <= tol * b.abs().max()


@pytest.mark.cuda
def test_a_beit_train_step_runs_the_bias_kernels_in_every_block():
    _card()
    import test_torch_pkg_dpt as tdpt

    from robust_cvd_tpu_torch.models import beit

    net = beit.BeitDepthNet(hidden=128, heads=2, blocks=24, mlp=256, patch=16, table_grid=4,
                            hooks=(5, 11, 17, 23), widths=(16, 32, 64, 64), features=32,
                            classes=10)
    tuner, _ = tdpt._tuner(dtype=torch.float32, adapter=beit.DPTBeitLargeAdapter(net),
                           device="cuda")
    va = attention.vit_attention
    before = (va.launches, va.backward_launches, va.bias_launches, va.bias_backward_launches)
    loss, _, ok = tuner.train_step(torch.tensor([0, 2], device="cuda"))
    torch.cuda.synchronize()
    assert bool(ok) and torch.isfinite(loss)
    assert (va.launches, va.backward_launches, va.bias_launches,
            va.bias_backward_launches) == (before[0], before[1], before[2] + 24, before[3] + 24)


@pytest.mark.parametrize("grid", [(32, 56), (8, 8), (24, 24), (7, 13)])
def test_every_index_of_a_query_block_lies_in_its_window(grid):
    """The dq pass sums dT into a copy of each CTA's window of the table
    (attention.dt_windows, the kernel's rule): every index of a block's
    patch-token rows against the patch-token keys lies in it, and the
    class token's three entries lie after it."""
    idx = attention.relative_position_index(grid)
    n, r = idx.shape[0], idx.max().item() + 1
    windows = attention.dt_windows(grid)
    assert len(windows) == -(-n // attention.ROWS_PER_CTA)
    for k, window in enumerate(windows):
        first = max(k * attention.ROWS_PER_CTA, 1)
        block = idx[first:(k + 1) * attention.ROWS_PER_CTA, 1:]
        lo, hi = window
        assert lo == block.min().item() and block.max().item() == hi
        assert hi < r - 3
    assert (idx[0] >= r - 3).all() and (idx[:, 0] >= r - 3).all()
    longest = max(hi - lo + 1 for lo, hi in windows)
    assert attention.dq_bias_copy(grid) == (longest + 6) // 4 * 4


def test_a_window_is_at_most_three_quarters_of_the_table():
    """The kernels' largest table rests on a CTA's window holding at most
    3/4 (R - 3) + 128 entries: over grids of every shape up to 96 x 96."""
    for wh in range(1, 97, 5):
        for ww in range(1, 97, 3):
            r = (2 * wh - 1) * (2 * ww - 1) + 3
            longest = max(hi - lo + 1 for lo, hi in filter(None, attention.dt_windows((wh, ww))))
            assert longest <= 0.75 * (r - 3) + 128, (wh, ww)


# Swin V2's windows (models/swin2.py): head width 32, no class token, the
# scores at scale 1, the shift mask from region codes.


@pytest.mark.parametrize("shape, table_shape, region_shape, why", [
    ((4, 16, 3, 2, 64), (2, 49), None, "head width 64"),
    ((4, 17, 3, 2, 32), (2, 49), None, "tokens not the window's"),
    ((4, 16, 3, 2, 32), (2, 52), None, "a class token's table"),
    ((4, 16, 3, 2, 32), (2, 49), (3, 16), "windows not dividing the frames"),
    ((4, 16, 3, 2, 32), (2, 49), (2, 9), "codes of another window"),
])
def test_the_window_checkers_refuse(shape, table_shape, region_shape, why):
    qkv = torch.zeros(shape)
    table = torch.zeros(table_shape)

    def check(qkv, table, region):
        attention.check_kernel_input(qkv, attention.WINDOW_HEAD_WIDTH)
        attention.check_bias_input(qkv, table, (4, 4), cls=False)
        if region is not None:
            attention.check_region_input(qkv, region)

    check(torch.zeros((4, 16, 3, 2, 32)), torch.zeros((2, 49)),
          torch.zeros((2, 16), dtype=torch.int32))
    region = None if region_shape is None else torch.zeros(region_shape, dtype=torch.int32)
    with pytest.raises(ValueError):
        check(qkv, table, region)


def test_a_cpu_window_input_takes_the_plain_version():
    """Without a class token the index is Swin's (no class entries); the
    gradient reaches the table; the mask moves the output; no kernel is
    launched."""
    from robust_cvd_tpu_torch.models import swin2

    w = 4
    qkv = _qkv(8, w * w, 2, 32, seed=3)
    table = torch.randn((2, (2 * w - 1) ** 2), generator=torch.Generator().manual_seed(1))
    region = swin2.region_codes(8, w, 2)
    va = attention.vit_attention
    before = (va.window_launches, va.window_backward_launches)
    t = table.clone().requires_grad_(True)
    out = attention.window_attention(qkv, t, (w, w), region)
    out.square().sum().backward()
    assert torch.equal(out, attention.attention_plain(qkv, table, (w, w), region, window=True))
    assert t.grad is not None and t.grad.abs().max() > 0
    assert (attention.attention_plain(qkv, table, (w, w), window=True) - out).abs().max() > 0.1
    idx = attention.relative_position_index((w, w), cls=False)
    assert idx.shape == (w * w, w * w) and idx.max() == (2 * w - 1) ** 2 - 1
    assert torch.equal(idx, attention.relative_position_index((w, w))[1:, 1:])
    assert (va.window_launches, va.window_backward_launches) == before


@pytest.mark.parametrize("grid", [(24, 24), (12, 12), (4, 4), (7, 13)])
def test_every_index_of_a_window_block_lies_in_its_window(grid):
    """Without a class token the dq pass's window rule holds every index of
    a block's rows."""
    idx = attention.relative_position_index(grid, cls=False)
    windows = attention.dt_windows(grid, cls=False)
    assert len(windows) == -(-idx.shape[0] // attention.ROWS_PER_CTA)
    for k, (lo, hi) in enumerate(windows):
        block = idx[k * attention.ROWS_PER_CTA:(k + 1) * attention.ROWS_PER_CTA]
        assert lo == block.min().item() and block.max().item() == hi
    longest = max(hi - lo + 1 for lo, hi in windows)
    assert attention.dq_bias_copy(grid, cls=False) == (longest + 6) // 4 * 4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", chip_smoke.WINDOW_CHECKS + (chip_smoke.WINDOW_STAGE0,))
def test_window_kernels_match_float64_within_twice_sdpas_error(shape):
    """out, dq, dk, dv and dT at their largest over three inputs, within
    twice SDPA's error with the bias and mask in a float32 mask
    (chip_smoke.window_attention_errors_max, window_error_limit)."""
    _card()
    errs = chip_smoke.window_attention_errors_max(*shape)
    print(shape, errs)
    for k, v in errs["kernel"].items():
        assert v <= chip_smoke.window_error_limit(errs, k), (k, v, errs["sdpa"][k])


@pytest.mark.cuda
def test_the_window_backward_gives_dq_dk_dv_bit_for_bit():
    _card()
    qkv, table, region, dout = chip_smoke._window_inputs(16, 24, 2, 16, True, seed=4)
    out, lse = attention.forward_bias_kernel(qkv, table, (24, 24), region, cls=False)
    first = attention.backward_bias_kernel(qkv, table, (24, 24), out, lse, dout, region,
                                           cls=False)
    second = attention.backward_bias_kernel(qkv, table, (24, 24), out, lse, dout, region,
                                            cls=False)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert (first[1] - second[1]).abs().max() <= 1e-5 * first[1].abs().max()


@pytest.mark.cuda
def test_a_swin2_train_step_runs_the_window_kernels_in_every_block():
    """A Swin V2 of head width 32 throughout (embed 32, one head a stage
    width's 32): each of its 8 blocks runs the window kernels once forward
    and once backward, the shifted ones with the mask; the other counters
    stay."""
    _card()
    import test_torch_pkg_dpt as tdpt

    from robust_cvd_tpu_torch.models import swin2

    net = swin2.Swin2DepthNet(image=64, patch=4, embed=32, depths=(2, 2, 2, 2),
                              heads=(1, 2, 4, 8), window=4, pretrained_windows=(3, 3, 3, 2),
                              hooks=(1, 1, 1, 1), features=32, classes=10)
    tuner, _ = tdpt._tuner(dtype=torch.float32, adapter=swin2.DPTSwin2LargeAdapter(net),
                           device="cuda")
    va = attention.vit_attention
    names = ("launches", "backward_launches", "bias_launches", "bias_backward_launches",
             "window_launches", "window_backward_launches")
    before = [getattr(va, k) for k in names]
    loss, _, ok = tuner.train_step(torch.tensor([0, 2], device="cuda"))
    torch.cuda.synchronize()
    assert bool(ok) and torch.isfinite(loss)
    assert [getattr(va, k) - b for k, b in zip(names, before)] == [0, 0, 0, 0, 8, 8]
