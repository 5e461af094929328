"""BEiT-L/16-512 under DPT's decoder (robust_cvd_tpu_torch/models/beit.py,
MiDaS v3.1's dpt_beit_large_512) on the CPU against the plain reference
tests/plain_beit.py, at a small size: hidden 64, 4 heads of 16, 4 blocks
hooked at 0-3, an MLP of 256, reassembly widths 16/32/64/64, features 32,
tables published for a 4x4 grid and resized to a 64x96 input's 4x6 grid.
Seeded weights (plain_beit.seeded_state_dict: LayerScale's gammas near 1
and tables of N(0, 0.5), so that the attention and the bias show) load
into both nets by the checkpoint's keys.

- The forward agrees in float64 within 1e-12 of the largest depth (two
  float64 orders of the same sums), the raw disparity too.
- One FineTuner.train_step in float64 agrees with the plain step: the loss
  within 1e-10 relative, every gradient, the 4 tables' included, within
  1e-9 of the largest (the fine-tune test of DPT-Large's limits).
- timm's relative position index on a 2x3 grid, written out by hand; the
  tables' resize is the identity at the published grid and equals MiDaS's
  reshape and interpolation on a non-square one; `attention_plain` with a
  bias equals a float64 softmax with the bias materialised (2e-6 of the
  largest output in float32).
- Each planted fault moves the port off the plain reference: the bias left
  out, the index transposed, LayerScale left out, and a non-zero k bias
  (which the softmax cancels exactly: caught in the qkv projection).
- DPT-Large's outputs and gradients are bit for bit what its code gave
  before the encoder was made an argument.
- The state-dict keys are MiDaS v3.1's with BEiT-L's shapes, 345,014,441
  parameters; the registry, the spans and the CLI run
  `--model_type dpt_beit_large_512`.
"""

import functools
import os

import numpy as np
import pytest
import torch

import plain_beit
import test_torch_pkg_dpt as tdpt
from torch_pkg_threads import one_torch_thread  # noqa: F401

from robust_cvd_tpu_torch.models import beit, depth_model, dpt, registry
from robust_cvd_tpu_torch.ops import attention
from robust_cvd_tpu_torch.training import fine_tune
from robust_cvd_tpu_torch.utils import spans

SMALL = dict(hidden=64, heads=4, blocks=4, mlp=256, patch=16, table_grid=4, hooks=(0, 1, 2, 3),
             widths=(16, 32, 64, 64), features=32, classes=10)
N, H, W = tdpt.N, tdpt.H, tdpt.W


def _nets(seed=3, dtype=torch.float64, head_scale=True):
    ref = plain_beit.DPTBeit(**SMALL)
    sd = plain_beit.seeded_state_dict(ref, seed)
    if not head_scale:  # the head's raw output, not 2 + 0.01 of it
        sd["scratch.output_conv.4.weight"].mul_(100.0)
        sd["scratch.output_conv.4.bias"].zero_()
    ref.load_state_dict(sd)
    port = beit.BeitDepthNet(**SMALL)
    port.load_state_dict(sd)
    return port.to(dtype).eval(), ref.to(dtype).eval()


def _gap(port, ref, x):
    with torch.no_grad():
        want = ref(x)
        return float((port(x) - want).abs().max() / want.abs().max()), float(want.std())


def _input():
    return plain_beit.normalize(tdpt._images(torch.float64))


def test_forward_matches_the_plain_reference():
    port, ref = _nets()
    x = tdpt._images(torch.float64)
    with torch.no_grad():
        want = plain_beit.depth(ref, x)
        got = depth_model.depth_apply(port, x)
    assert got.shape == (2, H, W) and (got - want).abs().max() <= 1e-12 * want.abs().max()
    gap, spread = _gap(*_nets(head_scale=False), _input())
    assert spread > 0.1 and gap <= 1e-12


def test_one_train_step_matches_the_plain_step():
    """FineTuner.train_step (the adapter's normalisation, FlatAdam) in
    float64 against the plain net and the same joint loss."""
    port, ref = _nets()
    tuner, _ = tdpt._tuner(adapter=beit.DPTBeitLargeAdapter(port))
    ids = torch.tensor([0, 2])
    frames, images, meta = fine_tune._batch(ids, tuner.clip, tuner.pose_state, False)
    b, k = frames.shape
    ref.train()
    d = plain_beit.depth(ref, images.reshape(b * k, H, W, 3)).reshape(b, k, H, W)
    d = d * tuner.pose_state.scales[frames]
    want, _ = fine_tune.losses.joint_loss(tuner.cfg.loss, images, tuner.clip.depth_orig[frames],
                                          d, meta)
    want.backward()
    want = float(want.detach())
    grads = {n: p.grad for n, p in ref.named_parameters()}
    loss, _, ok = tuner.train_step(ids)
    assert bool(ok) and abs(float(loss) - want) <= 1e-10 * abs(want)
    opt = tuner.optimizer
    got = opt.named_views(opt.grad)
    top = max(float(g.abs().max()) for g in grads.values() if g is not None)
    # the classifier's fc_norm and head are not run; refinenet4 takes no skip
    assert {n for n, g in grads.items() if g is None} == {
        n for n in grads if n.startswith(("pretrained.model.fc_norm.", "pretrained.model.head.",
                                          "scratch.refinenet4.resConfUnit1."))}
    tables = [n for n in grads if n.endswith("relative_position_bias_table")]
    assert len(tables) == 4 and all(float(grads[n].abs().max()) > 1e-6 * top for n in tables)
    for n, g in grads.items():
        g = torch.zeros_like(got[n]) if g is None else g
        assert (got[n] - g).abs().max() <= 1e-9 * top, n


def test_relative_position_index_on_a_2x3_grid():
    """Tokens (y, x) on a 2x3 grid after the class token; R = 3 * 5 + 3 =
    18 entries: patch pairs at (y_i - y_j + 1) * 5 + (x_i - x_j + 2), the
    class token's row 15, its column 16, its diagonal 17."""
    want = torch.tensor([
        [17, 15, 15, 15, 15, 15, 15],
        [16, 7, 6, 5, 2, 1, 0],
        [16, 8, 7, 6, 3, 2, 1],
        [16, 9, 8, 7, 4, 3, 2],
        [16, 12, 11, 10, 7, 6, 5],
        [16, 13, 12, 11, 8, 7, 6],
        [16, 14, 13, 12, 9, 8, 7]])
    assert torch.equal(attention.relative_position_index((2, 3)), want)
    assert torch.equal(plain_beit.gen_relative_position_index((2, 3)), want)
    for grid in ((3, 2), (4, 6), (32, 56)):
        assert torch.equal(attention.relative_position_index(grid),
                           plain_beit.gen_relative_position_index(grid))


def test_the_table_resize_is_midas_v31s():
    """The identity at the published grid (32x32 tables, bitwise); at a
    non-square grid the plain reference's resized table, entry for entry."""
    g = torch.Generator().manual_seed(0)
    table = torch.randn((63 * 63 + 3, 16), generator=g)
    assert torch.equal(beit.resize_table(table, 32, (32, 32)), table)
    att = plain_beit.Attention(64, 4, (4, 4))
    with torch.no_grad():
        att.relative_position_bias_table.copy_(torch.randn((52, 4), generator=g))
        for grid in ((4, 6), (6, 3), (2, 2)):
            want = att._get_rel_pos_bias(grid)[0]  # (H, N, N), gathered
            got = beit.resize_table(att.relative_position_bias_table, 4, grid)
            idx = attention.relative_position_index(grid)
            assert got.shape == ((2 * grid[0] - 1) * (2 * grid[1] - 1) + 3, 4)
            torch.testing.assert_close(got.t()[:, idx], want, rtol=0, atol=1e-6)


def test_attention_plain_with_a_bias_matches_a_float64_softmax():
    grid, heads = (4, 6), 2
    n, r = 1 + 24, 7 * 11 + 3
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.normal(0, 1, (2, n, 3, heads, 64))).float()
    table = torch.from_numpy(rng.normal(0, 1, (heads, r))).float()
    got = attention.attention_plain(qkv, table, grid)
    idx = plain_beit.gen_relative_position_index(grid).numpy()
    q, k, v = (qkv[:, :, s].double().numpy() for s in range(3))
    s = np.einsum("bnhd,bmhd->bhnm", q, k) / 8 + table.double().numpy()[:, idx][None]
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhnm,bmhd->bnhd", p / p.sum(-1, keepdims=True), v)
    assert np.abs(got.numpy() - want).max() <= 2e-6 * np.abs(want).max()
    # the bias moves the output: without it the same inputs differ
    assert (attention.attention_plain(qkv) - got).abs().max() > 0.1


@pytest.mark.parametrize("fault", ["bias_left_out", "index_transposed", "gamma_left_out"])
def test_each_planted_fault_moves_the_output(fault, monkeypatch):
    port, ref = _nets(head_scale=False)
    x = _input()
    assert _gap(port, ref, x)[0] <= 1e-12
    if fault == "bias_left_out":
        monkeypatch.setattr(beit, "vit_attention", lambda qkv, table, grid: attention
                            .vit_attention(qkv))
    elif fault == "index_transposed":
        orig = attention.relative_position_index
        monkeypatch.setattr(attention, "relative_position_index", lambda g: orig(g).t())
    else:
        monkeypatch.setattr(beit.Block, "forward", lambda self, x, table, grid: (
            lambda y: y + self.mlp(self.norm2(y)))(x + self.attn(self.norm1(x), table, grid)))
    assert _gap(port, ref, x)[0] > 1e-3


def test_a_k_bias_is_caught_in_the_projection(monkeypatch):
    """BEiT's k bias is 0. A constant added to every key adds q.c to a
    row's scores, which the softmax cancels: the output cannot show a
    non-zero k bias (it moves within float64 rounding), so the check holds
    each block's qkv projection to the plain reference's."""
    port, ref = _nets(head_scale=False)
    x = _input()
    seen, want = [], []
    orig = attention.vit_attention
    monkeypatch.setattr(beit, "vit_attention",
                        lambda qkv, table, grid: seen.append(qkv.flatten(2)) or orig(qkv, table,
                                                                                     grid))
    plain_forward = plain_beit.Attention.forward

    def record(self, y, resolution):
        want.append(torch.nn.functional.linear(
            y, self.qkv.weight, torch.cat((self.q_bias, self.k_bias, self.v_bias))))
        return plain_forward(self, y, resolution)

    monkeypatch.setattr(plain_beit.Attention, "forward", record)

    def projection_gap():
        seen.clear()
        with torch.no_grad():
            port(x)
        return max(float((s - w).abs().max() / w.abs().max()) for s, w in zip(seen, want))

    with torch.no_grad():
        ref(x)
    assert len(want) == 4 and projection_gap() <= 1e-12
    for blk in port.pretrained.model.blocks:
        blk.attn.k_bias.fill_(0.5)
    assert _gap(port, ref, x)[0] <= 1e-9  # the softmax cancels it
    assert projection_gap() > 0.05


def _old_dpt_forward(net, x):
    """models/dpt.py::DPTDepthNet.forward before the encoder was made an
    argument."""
    b, _, h, w = x.shape
    vit, p, s = net.pretrained.model, net.pretrained, net.scratch
    gh, gw = h // vit.patch, w // vit.patch
    t = vit.embed(x)
    hooked = []
    for i, blk in enumerate(vit.blocks[: net.hooks[-1] + 1]):
        t = blk(t)
        if i in net.hooks:
            hooked.append(t)
    layers = []
    for level, t in enumerate(hooked, 1):
        post = getattr(p, f"act_postprocess{level}")
        y = post[0](t)
        y = y.transpose(1, 2).reshape(b, y.shape[-1], gh, gw)
        for m in post[3:]:
            y = m(y)
        layers.append(y)
    l1, l2, l3, l4 = (getattr(s, f"layer{k}_rn")(y) for k, y in enumerate(layers, 1))
    p4 = s.refinenet4(l4)
    p3 = s.refinenet3(p4, l3)
    p2 = s.refinenet2(p3, l2)
    p1 = s.refinenet1(p2, l1)
    return s.output_conv(p1)[:, 0]


def test_dpt_large_is_bit_for_bit_unchanged():
    net = tdpt._nets(dtype=torch.float32, head_scale=False)[0].train()
    x = dpt.normalize_images(tdpt._images()).permute(0, 3, 1, 2).contiguous()
    runs = []
    for fwd in (net, functools.partial(_old_dpt_forward, net)):
        net.zero_grad()
        y = fwd(x)
        y.square().mean().backward()
        runs.append([y.detach()] + [q.grad.clone() for q in net.parameters() if q.grad is not None])
    assert len(runs[0]) == len(runs[1]) > 100
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_state_dict_keys_and_parameter_count_are_midas_v31s():
    with torch.device("meta"):
        net = beit.BeitDepthNet()
    sd = net.state_dict()
    per_block = {"gamma_1": (1024,), "gamma_2": (1024,), "norm1.weight": (1024,),
                 "norm1.bias": (1024,), "attn.q_bias": (1024,), "attn.v_bias": (1024,),
                 "attn.relative_position_bias_table": (63 * 63 + 3, 16),
                 "attn.qkv.weight": (3072, 1024), "attn.proj.weight": (1024, 1024),
                 "attn.proj.bias": (1024,), "norm2.weight": (1024,), "norm2.bias": (1024,),
                 "mlp.fc1.weight": (4096, 1024), "mlp.fc1.bias": (4096,),
                 "mlp.fc2.weight": (1024, 4096), "mlp.fc2.bias": (1024,)}
    enc = {k for k in sd if k.startswith("pretrained.model.")}
    want = {f"pretrained.model.blocks.{i}.{k}" for i in range(24) for k in per_block}
    want |= {"pretrained.model." + k for k in (
        "cls_token", "patch_embed.proj.weight", "patch_embed.proj.bias", "fc_norm.weight",
        "fc_norm.bias", "head.weight", "head.bias")}
    assert enc == want
    for k, shape in per_block.items():
        assert tuple(sd[f"pretrained.model.blocks.23.{k}"].shape) == shape, k
    # the reassembly and the decoder are DPT-Large's, key for key
    with torch.device("meta"):
        large = dpt.DPTDepthNet()
    rest = {k: v.shape for k, v in large.state_dict().items()
            if not k.startswith("pretrained.model.")}
    assert {k: v.shape for k, v in sd.items() if k not in enc} == rest
    assert sum(p.numel() for p in net.parameters()) == 345_014_441
    assert sorted(beit.BeitDepthNet(**SMALL).state_dict()) == sorted(
        plain_beit.DPTBeit(**SMALL).state_dict())


def test_the_registry_spans_and_checkpoint(tmp_path):
    a = registry.get_depth_model("dpt_beit_large_512")
    assert a is beit.DPTBeitLargeAdapter and a.matmul_tf32
    assert (a.align, a.learning_rate, a.lambda_view_baseline) == (32, 1e-6, 1e-4)
    assert (a.checkpoint, a.checkpoint_env) == ("dpt_beit_large_512.pt", "DPT_BEIT_CHECKPOINT")
    assert beit.BeitDepthNet(**SMALL).normalize is dpt.normalize_images
    # a stored relative_position_index (older timm) is dropped on load
    port = _nets(dtype=torch.float32)[0]
    blob = dict(port.state_dict())
    blob["pretrained.model.blocks.0.attn.relative_position_index"] = torch.zeros(3, 3)
    torch.save({"model": blob}, tmp_path / "w.pt")
    assert "pretrained.model.blocks.0.attn.relative_position_index" not in a.read_checkpoint(
        str(tmp_path / "w.pt"))
    tuner, _ = tdpt._tuner(dtype=torch.float32, adapter=a(port))
    tuner.train_step(torch.tensor([0, 1]))
    (step,) = spans.recent("train.step", 1)
    (fwd,) = [c for c in step["children"] if c["name"] == "train.forward"]
    assert [c["name"] for c in fwd["children"]] == [
        "beit.embed", "beit.relpos", "beit.encoder", "dpt.reassemble", "dpt.decoder"]
    assert fwd["children"][2]["attrs"] == {"tokens": 1 + (H // 16) * (W // 16), "frames": 4,
                                           "grid": [H // 16, W // 16]}


def test_the_cli_runs_dpt_beit_large_512(tmp_path, monkeypatch):
    """python -m robust_cvd_tpu_torch --model_type dpt_beit_large_512 on a
    6-frame 64x96 clip, as test_torch_pkg_dpt.py's CLI test runs dpt_large:
    the registry's adapter takes the initial depth and the fine-tune."""
    from robust_cvd_tpu_torch.io.store import VideoStore
    from robust_cvd_tpu_torch.main import main

    base = tdpt.cli_clip(tmp_path, monkeypatch, 6)
    torch.save(_nets(dtype=torch.float32)[0].state_dict(),
               os.path.join(base, "models", beit.DPTBeitLargeAdapter.checkpoint))
    monkeypatch.setattr(beit, "BeitDepthNet", functools.partial(beit.BeitDepthNet, **SMALL))
    proc = main(["--path", base, "--model_type", "dpt_beit_large_512", "--size", str(W),
                 "--num_epochs", "1", "--save_tensorboard", "false",
                 "--opt.num_steps", "2", "--opt.ctf_long", "3", "--opt.ctf_short", "2",
                 "--opt.lm_max_outer", "4", "--opt.lm_cg_iters", "8"], device="cpu")
    assert isinstance(proc.tuner.adapter, beit.DPTBeitLargeAdapter)
    assert len(proc.tuner.history) == 1 and proc.tuner.history[0]["skipped"] == 0
    assert os.path.basename(proc.out_dir(6)).endswith("_dpt_beit_large_512")
    depth0 = VideoStore.open(base).load_depth_stream("depth_dpt_beit_large_512")
    assert depth0.shape == (6, H, W) and np.isfinite(depth0).all() and depth0.min() > 0
