"""The `swin2_train` stage on the CPU at a tiny size (Swin V2 with embed 16,
depths (2, 2, 2, 2), heads (1, 2, 2, 4), window 4 on a 64x64 squash, so
that stages 0 and 1 shift and mask; an 8-frame 64x96 clip): the cell's
files resolve, a run prints the contract's result, the check passes on the
port and fails on each fault the cell can have (a state left unchanged,
half a batch left out, the continuous position bias left out, the shift
mask left out, the shift left out, dot-product attention in the cosine
attention's place) and on the bf16 control, the frozen reference agrees
with the port, the step's operation count and the attention's match
closed forms, and the cell's per-layer readers read a traced run."""

import copy
import json
import math
import time

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from conftest import ROOT, tiny_mix

from cvd_bench import core

CELL = "dpt_swin2_large-672.train"
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
TINY_MODEL = dict(image=64, patch=4, embed=16, depths=[2, 2, 2, 2], heads=[1, 2, 2, 4], window=4,
                  pretrained_windows=[3, 3, 3, 2], hooks=[1, 1, 1, 1], features=32, classes=10)


def tiny_config():
    cfg = copy.deepcopy(core.load_json(core.config_path("dpt_swin2_large-672")))
    cfg["model"].update(TINY_MODEL)
    cfg["clip"]["frames"] = 8
    cfg["clip"]["down_hw"] = [64, 96]
    return cfg


def run(tmp_path, trace=False, seed=2**33 + 17):
    return core.run_cell(CELL, seed, 0.5, trace, ROOT, time.perf_counter(), str(tmp_path),
                         device="cpu", config_override=tiny_config(),
                         mix_override=tiny_mix("swin2_train"))


def test_the_cells_files_resolve():
    cell = core.resolve(core.load_benchmark(ROOT), CELL)
    assert cell["cell"]["chips"] == 1 and cell["mix"]["stage"] == "swin2_train"
    assert cell["config"]["model"]["parameters"] == 213_411_869
    assert [m["name"] for m in cell["end_to_end"]] == ["train_step_ms", "setup_s"]
    assert {m["name"] for m in cell["per_layer"]} == {
        "swin2.attention_roofline", "swin2_train.mfu", "swin2_train.device_ms"}
    assert set(core.load_json(core.limits_path(CELL))) == {"loss", "grad", "change"}


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_prints_the_contracts_last_line(trace, tmp_path, capsys):
    core.emit(run(tmp_path, trace))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == KEYS | ({"breakdown"} if trace and "breakdown" in out else set())
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 3
    if not trace:
        assert set(out["metrics"]) == {"train_step_ms", "setup_s"}
    else:
        assert out["metrics"]["swin2_train.mfu"]["value"] > 0
    assert set(out["checks"]) == {"loss", "grad", "change"}


def _dot_product(self, x, table, region):
    """Dot-product attention at 1 / sqrt(d) in the cosine attention's place."""
    from robust_cvd_tpu_torch.ops import attention

    b, n, c = x.shape
    bias = torch.cat([self.q_bias, torch.zeros_like(self.v_bias), self.v_bias])
    qkv = F.linear(x, self.qkv.weight, bias).reshape(b, n, 3, self.heads, c // self.heads)
    q, k, v = qkv.unbind(2)
    qkv = torch.stack([q / math.sqrt(c // self.heads), k, v], 2)
    y = attention.window_attention(qkv, table, (self.window, self.window), region)
    return self.proj(y.reshape(b, n, c))


def _fault(monkeypatch, kind):
    from robust_cvd_tpu_torch.models import swin2
    from robust_cvd_tpu_torch.ops import attention
    from robust_cvd_tpu_torch.training import fine_tune, optimizer

    if kind == "state_unchanged":
        monkeypatch.setattr(optimizer.FlatAdam, "step",
                            lambda self, loss: torch.zeros((), dtype=torch.bool))
    elif kind == "half_batch":
        orig = fine_tune.train_step

        def half(net, opt, loss_opt, batch_ids, *a, **k):
            return orig(net, opt, loss_opt, batch_ids[: max(1, len(batch_ids) // 2)], *a, **k)

        monkeypatch.setattr(fine_tune, "train_step", half)
    elif kind == "bias_left_out":
        monkeypatch.setattr(swin2, "window_attention", lambda qkv, table, window, region:
                            attention.window_attention(qkv, 0 * table, window, region))
    elif kind == "mask_left_out":
        monkeypatch.setattr(swin2, "window_attention", lambda qkv, table, window, region:
                            attention.window_attention(qkv, table, window))
    elif kind == "shift_left_out":
        init = swin2.SwinBlock.__init__

        def no_shift(self, *a, **k):
            init(self, *a, **k)
            self.shift, self.region = 0, None

        monkeypatch.setattr(swin2.SwinBlock, "__init__", no_shift)
    elif kind == "dot_product":
        monkeypatch.setattr(swin2.WindowAttention, "forward", _dot_product)


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch", "bias_left_out",
                                  "mask_left_out", "shift_left_out", "dot_product"])
def test_each_fault_makes_the_run_incorrect(kind, monkeypatch, tmp_path):
    _fault(monkeypatch, kind)
    assert run(tmp_path)["correct"] is False


def test_the_control_fails_the_check():
    """The reference under bf16 autocast in the port's place and each
    planted fault read above a limit; the port reads within them, and no
    CPB or temperature leaf's gradient is negligible."""
    from cvd_bench.stages import swin2_train

    ctx = core.Ctx(workload=CELL, config=tiny_config(), mix=tiny_mix("swin2_train"), seed=5,
                   device="cpu", tmpdir="", trace=False,
                   limits=core.load_json(core.limits_path(CELL)))
    st = swin2_train.setup(ctx)
    core.run_window(swin2_train, st, "cpu", 0.0, max_units=swin2_train.min_units(st))
    got = swin2_train.control(st)
    limits = [ctx.limits[k] for k in ("loss", "grad", "change")]
    assert all(p <= lim for p, lim in zip(got["port"], limits))
    faults = ["control_bf16", "fault_half_batch"] + list(swin2_train.FAULTS)
    for k in faults:
        assert any(c > lim for c, lim in zip(got[k], limits)), k
    assert min(got["cpb_over_median"]) >= 1e-3


def test_the_frozen_reference_agrees_with_the_port():
    """Same seeded weights (weights_swin2.py) and keys: the reference's
    depth equals the port's within float32 rounding, and the registry's
    adapter normalises as the reference does; each planted fault moves
    the reference."""
    from robust_cvd_tpu_torch.models import depth_model
    from robust_cvd_tpu_torch.models.registry import get_depth_model
    from robust_cvd_tpu_torch.models.swin2 import Swin2DepthNet

    from cvd_bench import clip, weights_swin2
    from cvd_bench.reference import swin2 as ref_swin2

    m = tiny_config()["model"]
    port = weights_swin2.seed_swin2_(Swin2DepthNet(**{k: m[k] for k in ref_swin2.NET_KEYS}), 3)
    ref = weights_swin2.seed_swin2_(ref_swin2.build(m), 3)
    assert port.state_dict().keys() == ref.state_dict().keys()
    for k, v in ref.state_dict().items():
        assert torch.equal(port.state_dict()[k], v), k
    adapter = get_depth_model("dpt_swin2_large_384")(port)
    images = torch.from_numpy(clip.panning_frames(4, 64, 96, 4, 3))
    with torch.no_grad():
        want = ref_swin2.depth(ref.eval(), images)
        torch.testing.assert_close(depth_model.depth_apply(port.eval(), images), want)
        torch.testing.assert_close(adapter.estimate_depth(images), want)
        for fault in ({"bias": False}, {"mask": False}, {"shift": False}, {"dot_product": True}):
            other = weights_swin2.seed_swin2_(ref_swin2.build(m, **fault), 3)
            assert (ref_swin2.depth(other.eval(), images) - want).abs().max() > 0, fault


def test_the_counts_match_closed_forms():
    """The attention's closed form by hand at the published shapes (0.370
    TFLOP a step); the step's count: forward 2*MACs of every convolution,
    linear layer and attention product, backward twice that for each but
    the patch embedding and the CPB MLPs' first layers (their weight
    gradients only), plus the loss's own products, counted alone."""
    from torch.utils.flop_counter import FlopCounterMode

    from cvd_bench.counts import swin2_train
    from cvd_bench.reference import losses, swin2

    big = core.load_json(core.config_path("dpt_swin2_large-672"))["model"]
    by_hand = 4 * 12 * 576 ** 2 * (2 * 16 * 192 + 2 * 4 * 384 + 18 * 768) + 4 * 12 * 144 ** 2 * 2 * 1536
    assert swin2_train.attention_flops(big, 4) == by_hand == 369_975_361_536
    assert swin2_train.tokens(big) == 9216 and swin2_train.windows(big, 4) == 64
    cfg = tiny_config()
    m = cfg["model"]
    h, w = cfg["clip"]["down_hw"]
    net = swin2.build(m)
    macs = {}

    def hook(mod, inp, out):
        if isinstance(mod, nn.Conv2d):
            macs[mod] = out.numel() * mod.weight[0].numel()
        else:
            macs[mod] = out.numel() * mod.in_features

    for mod in net.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            mod.register_forward_hook(hook)
    frames = 4
    net(torch.zeros((frames, 3, h, w)))
    # the qkv projections run as F.linear on their weight (no hook fires)
    for layer, (side, win, nw, width, _) in zip(net.pretrained.model.layers,
                                                swin2_train.stages(m)):
        for blk in layer.blocks:
            macs[blk.attn.qkv] = frames * side * side * 3 * width * width
    # the patch embedding's and the CPB MLPs' first layers take inputs that
    # need no gradient (the images, the coordinates): weight gradients only
    firsts = [net.pretrained.model.patch_embed.proj] + [
        mod.cpb_mlp[0] for mod in net.modules() if isinstance(mod, swin2.WindowAttention)]
    want = sum(2 * v * 3 for v in macs.values()) - sum(2 * macs[f] for f in firsts)
    want += swin2_train.attention_flops(m, frames)
    b = frames // 2
    d = torch.ones((b, 2, h, w), requires_grad=True)
    with FlopCounterMode(display=False) as loss_count:
        losses.joint(None, torch.ones((b, 2, h, w)), d, torch.zeros((b, 2, 3, 4)),
                     torch.ones((b, 2, 4)), torch.zeros((b, 2, h, w, 2)),
                     torch.zeros((b, 2, h, w, 2)), torch.ones((b, 2, h, w)),
                     cfg["loss"]).backward()
    want += loss_count.get_total_flops()
    assert swin2_train.train_step_flops(m, frames, h, w, cfg["loss"]) == want


def test_the_per_layer_readers_read_a_traced_run():
    """The device-trace readers on a trace of the harness's form: the
    window kernels and their pre-passes are the attention's; a trace
    without them gives nothing."""
    from cvd_bench.counts import peaks, swin2_train

    cfg = tiny_config()
    trace = {"busy_s": 0.3, "window_s": 0.5,
             "kernels": {"_anonymous_namespace_::flash_attention_bwd_dq_window_mask": 0.02,
                         "_anonymous_namespace_::flash_attention_fwd_prep32": 0.01,
                         "_anonymous_namespace_::flash_attention_fwd_window": 0.01,
                         "sm90_xmma_gemm_tf32": 0.2}}
    fake = {"trace": trace, "units": 10, "config": cfg, "counters": {"parameters": 1},
            "pace": {"units": 5, "seconds": 2.0}}
    assert core.read_metric("swin2_train.device_ms", fake) == pytest.approx(30.0)
    att = swin2_train.attention_flops(cfg["model"], 4)
    assert core.read_metric("swin2.attention_roofline", fake) == pytest.approx(
        100.0 * att / peaks.TF32_FLOPS / 0.004)
    h, w = cfg["clip"]["down_hw"]
    step = swin2_train.train_step_flops(cfg["model"], 4, h, w, cfg["loss"])
    assert core.read_metric("swin2_train.mfu", fake) == pytest.approx(
        100.0 * step * 5 / 2.0 / peaks.TF32_FLOPS)
    trace["kernels"] = {"sm90_xmma_gemm_tf32": 0.2}
    assert core.read_metric("swin2.attention_roofline", fake) is None
