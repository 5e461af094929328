"""SwinV2-L/24-384 under DPT's decoder (robust_cvd_tpu_torch/models/swin2.py,
MiDaS v3.1's dpt_swin2_large_384) on the CPU against the plain reference
tests/plain_swin2.py, at a small size: embed 16, depths (2, 2, 2, 2), heads
(1, 2, 2, 4) (head widths 16, 16, 32, 32), window 4 on a 64x64 squash (a
16x16 token map: stages 0 and 1 shift by 2 and mask their second block,
stage 2's 4x4 map is one window, stage 3 a 2x2 window), pretrained
windows (3, 3, 3, 2), features 32. Seeded weights (plain_swin2.
seeded_state_dict: temperatures near 10 and a continuous position bias
that varies across each row) load into both nets by the checkpoint's keys.

- The forward agrees in float64 within 1e-12 of the largest depth, from a
  64x96 frame through the squash and back, the raw disparity too.
- One FineTuner.train_step in float64 agrees with the plain step: the loss
  within 1e-10 relative, every gradient (the CPB MLPs' and temperatures'
  included) within 1e-9 of the largest.
- The region codes are timm's slice-built mask's; the CPB coordinates at a
  pretrained window other than the window and the merge's neighbour order
  are timm's; `attention_plain`'s window form equals a float64 softmax with
  the bias and mask materialised.
- Each planted fault moves the port off the plain reference: the bias left
  out, the mask left out, the shift left out, dot-product attention in the
  cosine attention's place.
- DPT-Large and BEiT are bit for bit what the decoder gave before it took
  its backbone (models/dpt.py::ViTBackbone) as an argument.
- The state-dict keys are MiDaS v3.1's with SwinV2-L's shapes, 213,411,869
  parameters; the registry, the spans and the CLI run
  `--model_type dpt_swin2_large_384`.
"""

import functools
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import plain_swin2
import test_torch_pkg_dpt as tdpt
from torch_pkg_threads import one_torch_thread  # noqa: F401

from robust_cvd_tpu_torch.models import beit, depth_model, dpt, registry, swin2
from robust_cvd_tpu_torch.ops import attention
from robust_cvd_tpu_torch.training import fine_tune
from robust_cvd_tpu_torch.utils import spans

SMALL = dict(image=64, patch=4, embed=16, depths=(2, 2, 2, 2), heads=(1, 2, 2, 4), window=4,
             pretrained_windows=(3, 3, 3, 2), mlp_ratio=4, hooks=(1, 1, 1, 1), features=32,
             classes=10)
H, W = tdpt.H, tdpt.W


def _nets(seed=3, dtype=torch.float64, head_scale=True):
    ref = plain_swin2.DPTSwin2(**SMALL)
    sd = plain_swin2.seeded_state_dict(ref, seed)
    if not head_scale:  # the head's raw output, not 2 + 0.01 of it
        sd["scratch.output_conv.4.weight"].mul_(100.0)
        sd["scratch.output_conv.4.bias"].zero_()
    ref.load_state_dict(sd)
    port = swin2.Swin2DepthNet(**SMALL)
    port.load_state_dict(sd)
    return port.to(dtype).eval(), ref.to(dtype).eval()


def _gap(port, ref, x):
    with torch.no_grad():
        want = ref(x)
        return float((port(x) - want).abs().max() / want.abs().max()), float(want.std())


def _input():
    return plain_swin2.normalize(tdpt._images(torch.float64))


def test_forward_matches_the_plain_reference():
    port, ref = _nets()
    x = tdpt._images(torch.float64)
    with torch.no_grad():
        want = plain_swin2.depth(ref, x)
        got = depth_model.depth_apply(port, x)
    assert got.shape == (2, H, W) and (got - want).abs().max() <= 1e-12 * want.abs().max()
    gap, spread = _gap(*_nets(head_scale=False), _input())
    assert spread > 0.1 and gap <= 1e-12


def test_one_train_step_matches_the_plain_step():
    """FineTuner.train_step (the adapter's normalisation, FlatAdam) in
    float64 against the plain net and the same joint loss."""
    port, ref = _nets()
    tuner, _ = tdpt._tuner(adapter=swin2.DPTSwin2LargeAdapter(port))
    ids = torch.tensor([0, 2])
    frames, images, meta = fine_tune._batch(ids, tuner.clip, tuner.pose_state, False)
    b, k = frames.shape
    ref.train()
    d = plain_swin2.depth(ref, images.reshape(b * k, H, W, 3)).reshape(b, k, H, W)
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
    # the encoder's final norm and head are not run; refinenet4 takes no skip
    assert {n for n, g in grads.items() if g is None} == {
        n for n in grads if n.startswith(("pretrained.model.norm.", "pretrained.model.head.",
                                          "scratch.refinenet4.resConfUnit1."))}
    cpb = [n for n in grads if ".cpb_mlp." in n or n.endswith("logit_scale")]
    assert len(cpb) == 8 * 4 and all(float(grads[n].abs().max()) > 1e-8 * top for n in cpb)
    for n, g in grads.items():
        g = torch.zeros_like(got[n]) if g is None else g
        assert (got[n] - g).abs().max() <= 1e-9 * top, n


@pytest.mark.parametrize("r, w, s", [(16, 4, 2), (8, 4, 2), (96, 24, 12), (48, 24, 12)])
def test_region_codes_are_timms_mask(r, w, s):
    """The codes' inequality is timm's attn_mask (-100 where they differ):
    the same windows and pairs masked."""
    codes = swin2.region_codes(r, w, s)
    want = plain_swin2.timm_mask_regions(r, w, s)
    assert codes.dtype == torch.int32 and codes.shape == ((r // w) ** 2, w * w)
    assert torch.equal(codes[:, :, None] != codes[:, None, :], want[:, :, None] != want[:, None, :])
    # the port's blocks carry them where they shift, and only there
    blk = swin2.SwinBlock(8, r, 1, w, True, w, 4)
    assert blk.shift == (s if r > w else 0) and torch.equal(blk.region, codes)
    assert swin2.SwinBlock(8, r, 1, w, False, w, 4).region is None


@pytest.mark.parametrize("window, pretrained", [(4, 3), (24, 12), (12, 6), (4, 4)])
def test_cpb_coordinates_are_timms(window, pretrained):
    got = swin2.relative_coords_table(window, pretrained)
    att = plain_swin2.WindowAttention(8, (window, window), 2, (pretrained, pretrained))
    assert torch.equal(got, att.relative_coords_table.reshape(-1, 2))
    assert torch.equal(attention.relative_position_index((window, window), cls=False),
                       att.relative_position_index)


def test_patch_merging_takes_timms_order():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 16, 6), generator=g, dtype=torch.float64)
    port = swin2.PatchMerging(6).double()
    ref = plain_swin2.PatchMerging((4, 4), 6).double()
    ref.load_state_dict(port.state_dict())
    assert torch.equal(port(x, 4), ref(x))
    # a permuted order gives another result
    v = x.view(2, 4, 4, 6)
    other = torch.cat([v[:, 0::2, 0::2], v[:, 0::2, 1::2], v[:, 1::2, 0::2], v[:, 1::2, 1::2]], -1)
    assert not torch.allclose(port.norm(port.reduction(other.view(2, -1, 24))), ref(x))


def test_attention_plain_window_form_matches_a_float64_softmax():
    heads, w = 2, 4
    n = w * w
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.normal(0, 1, (8, n, 3, heads, 32))).float()
    table = torch.from_numpy(rng.normal(0, 3, (heads, (2 * w - 1) ** 2))).float()
    region = swin2.region_codes(8, w, 2)
    got = attention.attention_plain(qkv, table, (w, w), region, window=True)
    idx = plain_swin2.WindowAttention(8, (w, w), 1, (w, w)).relative_position_index.numpy()
    mask = plain_swin2.timm_mask_regions(8, w, 2).numpy()
    mask = np.where(mask[:, :, None] != mask[:, None, :], -100.0, 0.0)
    q, k, v = (qkv[:, :, s].double().numpy() for s in range(3))
    s = (np.einsum("bnhd,bmhd->bhnm", q, k) + table.double().numpy()[:, idx][None]
         + np.tile(mask, (2, 1, 1))[:, None])
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhnm,bmhd->bnhd", p / p.sum(-1, keepdims=True), v)
    assert np.abs(got.numpy() - want).max() <= 2e-6 * np.abs(want).max()
    # the mask moves the output: without it the same inputs differ
    assert (attention.attention_plain(qkv, table, (w, w), window=True) - got).abs().max() > 0.1


def _cosine_left_out(self, x, table, region):
    """Dot-product attention at 1 / sqrt(d) in the cosine attention's place."""
    b, n, c = x.shape
    bias = torch.cat([self.q_bias, torch.zeros_like(self.v_bias), self.v_bias])
    qkv = F.linear(x, self.qkv.weight, bias).reshape(b, n, 3, self.heads, c // self.heads)
    q, k, v = qkv.unbind(2)
    qkv = torch.stack([q / math.sqrt(c // self.heads), k, v], 2)
    y = attention.window_attention(qkv, table, (self.window, self.window), region)
    return self.proj(y.reshape(b, n, c))


@pytest.mark.parametrize("fault", ["bias_left_out", "mask_left_out", "shift_left_out",
                                   "dot_product"])
def test_each_planted_fault_moves_the_output(fault, monkeypatch):
    port, ref = _nets(head_scale=False)
    x = _input()
    assert _gap(port, ref, x)[0] <= 1e-12
    if fault == "bias_left_out":
        monkeypatch.setattr(swin2, "window_attention", lambda qkv, table, window, region:
                            attention.window_attention(qkv, torch.zeros_like(table), window,
                                                       region))
    elif fault == "mask_left_out":
        monkeypatch.setattr(swin2, "window_attention", lambda qkv, table, window, region:
                            attention.window_attention(qkv, table, window))
    elif fault == "shift_left_out":
        for layer in port.pretrained.model.layers:
            for blk in layer.blocks:
                blk.shift = 0
                blk.region = None
    else:
        monkeypatch.setattr(swin2.WindowAttention, "forward", _cosine_left_out)
    assert _gap(port, ref, x)[0] > 1e-3


def _old_decoder_forward(net, x):
    """models/dpt.py::DPTDepthNet.forward before DPT's decoder took its
    backbone as an argument."""
    b, _, h, w = x.shape
    vit, p, s = net.pretrained.model, net.pretrained, net.scratch
    gh, gw = h // vit.patch, w // vit.patch
    hooked = vit.hooked(x, net.hooks)
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


@pytest.mark.parametrize("model", ["dpt_large", "beit"])
def test_dpt_and_beit_are_bit_for_bit_unchanged(model):
    if model == "dpt_large":
        net = tdpt._nets(dtype=torch.float32, head_scale=False)[0].train()
    else:
        import test_torch_pkg_beit as tbeit

        net = tbeit._nets(dtype=torch.float32, head_scale=False)[0].train()
    x = dpt.normalize_images(tdpt._images()).permute(0, 3, 1, 2).contiguous()
    runs = []
    for fwd in (net, functools.partial(_old_decoder_forward, net)):
        net.zero_grad()
        y = fwd(x)
        y.square().mean().backward()
        runs.append([y.detach()] + [q.grad.clone() for q in net.parameters() if q.grad is not None])
    assert len(runs[0]) == len(runs[1]) > 100
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_state_dict_keys_and_parameter_count_are_midas_v31s():
    with torch.device("meta"):
        net = swin2.Swin2DepthNet()
    sd = net.state_dict()
    per_block = {"attn.logit_scale": None, "attn.q_bias": None, "attn.v_bias": None,
                 "attn.qkv.weight": None, "attn.cpb_mlp.0.weight": (512, 2),
                 "attn.cpb_mlp.0.bias": (512,), "attn.cpb_mlp.2.weight": None,
                 "attn.proj.weight": None, "attn.proj.bias": None, "norm1.weight": None,
                 "norm1.bias": None, "mlp.fc1.weight": None, "mlp.fc1.bias": None,
                 "mlp.fc2.weight": None, "mlp.fc2.bias": None, "norm2.weight": None,
                 "norm2.bias": None}
    want = {"pretrained.model." + k for k in (
        "patch_embed.proj.weight", "patch_embed.proj.bias", "patch_embed.norm.weight",
        "patch_embed.norm.bias", "norm.weight", "norm.bias", "head.weight", "head.bias")}
    for s, depth in enumerate((2, 2, 18, 2)):
        want |= {f"pretrained.model.layers.{s}.blocks.{j}.{k}" for j in range(depth)
                 for k in per_block}
        if s < 3:
            want |= {f"pretrained.model.layers.{s}.downsample.{k}" for k in (
                "reduction.weight", "norm.weight", "norm.bias")}
    enc = {k for k in sd if k.startswith("pretrained.")}
    assert enc == want
    b = "pretrained.model.layers.2.blocks.17."
    assert tuple(sd[b + "attn.qkv.weight"].shape) == (3 * 768, 768)
    assert tuple(sd[b + "attn.logit_scale"].shape) == (24, 1, 1)
    assert tuple(sd[b + "attn.cpb_mlp.2.weight"].shape) == (24, 512)
    assert tuple(sd["pretrained.model.layers.0.downsample.reduction.weight"].shape) == (384, 768)
    assert tuple(sd["scratch.layer4_rn.weight"].shape) == (256, 1536, 3, 3)
    # the decoder is DPT-Large's, key for key, less the reassembly
    with torch.device("meta"):
        large = dpt.DPTDepthNet()
    rest = {k for k in large.state_dict() if k.startswith("scratch.")}
    assert {k for k in sd if not k.startswith("pretrained.")} == rest
    enc_count = sum(p.numel() for n, p in net.named_parameters() if n.startswith("pretrained."))
    assert enc_count == 196_739_932
    assert sum(p.numel() for p in net.parameters()) == 213_411_869
    blocks = [blk for layer in net.pretrained.model.layers for blk in layer.blocks]
    assert [(blk.window, blk.shift) for blk in blocks if blk.shift] == [(24, 12), (24, 12)]
    assert {blk.window for blk in blocks[4:22]} == {24} and blocks[-1].window == 12
    assert {blk.attn.heads for blk in blocks} == {6, 12, 24, 48}
    assert sorted(swin2.Swin2DepthNet(**SMALL).state_dict()) == sorted(
        plain_swin2.DPTSwin2(**SMALL).state_dict())


def test_the_registry_spans_and_checkpoint(tmp_path):
    a = registry.get_depth_model("dpt_swin2_large_384")
    assert a is swin2.DPTSwin2LargeAdapter and a.matmul_tf32
    assert (a.align, a.learning_rate, a.lambda_view_baseline) == (32, 1e-6, 1e-4)
    assert (a.checkpoint, a.checkpoint_env) == ("dpt_swin2_large_384.pt", "DPT_SWIN2_CHECKPOINT")
    assert "dpt_swin2_large_384" in registry.get_depth_model_list()
    assert swin2.Swin2DepthNet(**SMALL).normalize is dpt.normalize_images
    # stored buffers (older timm) are dropped on load
    port = _nets(dtype=torch.float32)[0]
    blob = dict(port.state_dict())
    for k in ("relative_coords_table", "relative_position_index", "attn_mask"):
        blob[f"pretrained.model.layers.0.blocks.1.attn.{k}"] = torch.zeros(3, 3)
    torch.save({"model": blob}, tmp_path / "w.pt")
    assert set(a.read_checkpoint(str(tmp_path / "w.pt"))) == set(port.state_dict())
    tuner, _ = tdpt._tuner(dtype=torch.float32, adapter=a(port))
    tuner.train_step(torch.tensor([0, 1]))
    (step,) = spans.recent("train.step", 1)
    (fwd,) = [c for c in step["children"] if c["name"] == "train.forward"]
    names = [c["name"] for c in fwd["children"]]
    assert names == ["swin2.resize", "swin2.embed", "swin2.cpb", "swin2.stage", "swin2.merge",
                     "swin2.stage", "swin2.merge", "swin2.stage", "swin2.merge", "swin2.stage",
                     "dpt.decoder", "swin2.resize"]
    stages = [c["attrs"] for c in fwd["children"] if c["name"] == "swin2.stage"]
    assert stages == [
        {"stage": 0, "tokens": 256, "windows": 64, "heads": 1, "window": 4, "shift": 2},
        {"stage": 1, "tokens": 64, "windows": 16, "heads": 2, "window": 4, "shift": 2},
        {"stage": 2, "tokens": 16, "windows": 4, "heads": 2, "window": 4, "shift": 0},
        {"stage": 3, "tokens": 4, "windows": 4, "heads": 4, "window": 2, "shift": 0}]


def test_the_cli_runs_dpt_swin2_large_384(tmp_path, monkeypatch):
    """python -m robust_cvd_tpu_torch --model_type dpt_swin2_large_384 on a
    6-frame 64x96 clip, as test_torch_pkg_dpt.py's CLI test runs dpt_large:
    the registry's adapter takes the initial depth and the fine-tune."""
    from robust_cvd_tpu_torch.io.store import VideoStore
    from robust_cvd_tpu_torch.main import main

    base = tdpt.cli_clip(tmp_path, monkeypatch, 6)
    torch.save(_nets(dtype=torch.float32)[0].state_dict(),
               os.path.join(base, "models", swin2.DPTSwin2LargeAdapter.checkpoint))
    monkeypatch.setattr(swin2, "Swin2DepthNet", functools.partial(swin2.Swin2DepthNet, **SMALL))
    proc = main(["--path", base, "--model_type", "dpt_swin2_large_384", "--size", str(W),
                 "--num_epochs", "1", "--save_tensorboard", "false",
                 "--opt.num_steps", "2", "--opt.ctf_long", "3", "--opt.ctf_short", "2",
                 "--opt.lm_max_outer", "4", "--opt.lm_cg_iters", "8"], device="cpu")
    assert isinstance(proc.tuner.adapter, swin2.DPTSwin2LargeAdapter)
    assert len(proc.tuner.history) == 1 and proc.tuner.history[0]["skipped"] == 0
    assert os.path.basename(proc.out_dir(6)).endswith("_dpt_swin2_large_384")
    depth0 = VideoStore.open(base).load_depth_stream("depth_dpt_swin2_large_384")
    assert depth0.shape == (6, H, W) and np.isfinite(depth0).all() and depth0.min() > 0
