"""The `beit_train` stage on the CPU at a tiny size (BEiT with hidden 64, 4
heads, 4 blocks, tables published for a 4x4 grid, an 8-frame 64x96 clip):
the cell's files resolve, a run prints the contract's result, the check
passes on the port and fails on each fault the cell can have (a state left
unchanged, half a batch left out, the relative-position bias left out) and
on the bf16 control, the frozen reference agrees with the port, the step's
operation count matches a closed form, and the cell's per-layer readers
read a traced run."""

import copy
import json
import time

import pytest
import torch
import torch.nn as nn

from conftest import ROOT, tiny_mix

from cvd_bench import core

CELL = "dpt_beit_large-896.train"
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
TINY_MODEL = dict(hidden=64, heads=4, blocks=4, mlp=256, table_grid=4, hooks=[0, 1, 2, 3],
                  widths=[16, 32, 64, 64], features=32, classes=10)


def tiny_config():
    cfg = copy.deepcopy(core.load_json(core.config_path("dpt_beit_large-896")))
    cfg["model"].update(TINY_MODEL)
    cfg["clip"]["frames"] = 8
    cfg["clip"]["down_hw"] = [64, 96]
    return cfg


def run(tmp_path, trace=False, seed=2**33 + 17):
    return core.run_cell(CELL, seed, 0.5, trace, ROOT, time.perf_counter(), str(tmp_path),
                         device="cpu", config_override=tiny_config(),
                         mix_override=tiny_mix("beit_train"))


def test_the_cells_files_resolve():
    cell = core.resolve(core.load_benchmark(ROOT), CELL)
    assert cell["cell"]["chips"] == 1 and cell["mix"]["stage"] == "beit_train"
    assert cell["config"]["model"]["parameters"] == 345_014_441
    assert [m["name"] for m in cell["end_to_end"]] == ["train_step_ms", "setup_s"]
    assert {m["name"] for m in cell["per_layer"]} == {
        "beit.attention_roofline", "beit_train.mfu", "beit_train.device_ms"}
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
        assert out["metrics"]["beit_train.mfu"]["value"] > 0
    assert set(out["checks"]) == {"loss", "grad", "change"}


def _fault(monkeypatch, kind):
    from robust_cvd_tpu_torch.models import beit
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
        monkeypatch.setattr(beit, "vit_attention",
                            lambda qkv, table, grid: attention.vit_attention(qkv))


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch", "bias_left_out"])
def test_each_fault_makes_the_run_incorrect(kind, monkeypatch, tmp_path):
    _fault(monkeypatch, kind)
    assert run(tmp_path)["correct"] is False


def test_the_control_fails_the_check():
    """The reference under bf16 autocast in the port's place, a half batch
    and the bias left out read above a limit; the port reads within them,
    and no table's gradient is negligible."""
    from cvd_bench.stages import beit_train

    ctx = core.Ctx(workload=CELL, config=tiny_config(), mix=tiny_mix("beit_train"), seed=5,
                   device="cpu", tmpdir="", trace=False,
                   limits=core.load_json(core.limits_path(CELL)))
    st = beit_train.setup(ctx)
    core.run_window(beit_train, st, "cpu", 0.0, max_units=beit_train.min_units(st))
    got = beit_train.control(st)
    limits = [ctx.limits[k] for k in ("loss", "grad", "change")]
    assert all(p <= lim for p, lim in zip(got["port"], limits))
    for k in ("control_bf16", "fault_half_batch", "fault_no_bias"):
        assert any(c > lim for c, lim in zip(got[k], limits)), k
    assert min(got["tables_over_median"]) >= 1e-3


def test_the_frozen_reference_agrees_with_the_port():
    """Same seeded weights (weights_beit.py) and keys: the reference's
    depth equals the port's within float32 rounding, and the registry's
    adapter normalises as the reference does."""
    from robust_cvd_tpu_torch.models import depth_model
    from robust_cvd_tpu_torch.models.beit import BeitDepthNet
    from robust_cvd_tpu_torch.models.registry import get_depth_model

    from cvd_bench import clip, weights_beit
    from cvd_bench.reference import beit as ref_beit

    m = tiny_config()["model"]
    port = weights_beit.seed_beit_(BeitDepthNet(**{k: m[k] for k in ref_beit.NET_KEYS}), 3)
    ref = weights_beit.seed_beit_(ref_beit.build(m), 3)
    assert port.state_dict().keys() == ref.state_dict().keys()
    for k, v in ref.state_dict().items():
        assert torch.equal(port.state_dict()[k], v), k
    adapter = get_depth_model("dpt_beit_large_512")(port)
    images = torch.from_numpy(clip.panning_frames(4, 64, 96, 5, 3))
    with torch.no_grad():
        want = ref_beit.depth(ref.eval(), images)
        torch.testing.assert_close(depth_model.depth_apply(port.eval(), images), want)
        torch.testing.assert_close(adapter.estimate_depth(images), want)
        # the seeded bias moves the depth: without it the reference differs
        nobias = ref_beit.depth(ref_beit.build(m, bias=False).eval(), images)
        assert (nobias - want).abs().max() > 0


def test_the_step_count_matches_a_closed_form():
    """FLOPs of a train step: forward 2*MACs of every convolution (the
    transposed ones over their input), linear layer and attention product,
    backward twice that for each but the patch embedding (the images need
    no gradient: its weight gradient only); plus the loss's own products,
    counted alone. The attention's share is its closed form."""
    from torch.utils.flop_counter import FlopCounterMode

    from cvd_bench.counts import beit_train
    from cvd_bench.reference import beit, losses

    cfg = tiny_config()
    m = cfg["model"]
    h, w = cfg["clip"]["down_hw"]
    net = beit.build(m)
    macs = {}

    def hook(mod, inp, out):
        if isinstance(mod, nn.ConvTranspose2d):
            macs[mod] = inp[0].numel() * mod.weight[0].numel()
        elif isinstance(mod, nn.Conv2d):
            macs[mod] = out.numel() * mod.weight[0].numel()
        else:
            macs[mod] = out.numel() * mod.in_features

    for mod in net.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            mod.register_forward_hook(hook)
    frames = 4
    net(torch.zeros((frames, 3, h, w)))
    t = beit_train.tokens(m, h, w)
    assert t == 1 + (h // 16) * (w // 16)
    # the qkv projections run as F.linear on their weight (no hook fires)
    for blk in net.pretrained.model.blocks:
        macs[blk.attn.qkv] = frames * t * 3 * m["hidden"] * m["hidden"]
    first = net.pretrained.model.patch_embed.proj
    want = sum(2 * v * 3 for v in macs.values()) - 2 * macs[first]
    attention = beit_train.attention_flops(m, frames, h, w)
    assert attention == 3 * frames * len(m["hooks"]) * 2 * (2 * t * t * m["hidden"])
    want += attention
    b = frames // 2
    d = torch.ones((b, 2, h, w), requires_grad=True)
    with FlopCounterMode(display=False) as loss_count:
        losses.joint(None, torch.ones((b, 2, h, w)), d, torch.zeros((b, 2, 3, 4)),
                     torch.ones((b, 2, 4)), torch.zeros((b, 2, h, w, 2)),
                     torch.zeros((b, 2, h, w, 2)), torch.ones((b, 2, h, w)),
                     cfg["loss"]).backward()
    want += loss_count.get_total_flops()
    assert beit_train.train_step_flops(m, frames, h, w, cfg["loss"]) == want


def test_the_per_layer_readers_read_a_traced_run():
    """The device-trace readers on a trace of the harness's form: the bias
    kernels and their pre-passes are the attention's; a trace without them
    gives nothing."""
    from cvd_bench.counts import beit_train, peaks

    cfg = tiny_config()
    trace = {"busy_s": 0.3, "window_s": 0.5,
             "kernels": {"_anonymous_namespace_::flash_attention_bwd_dq_bias_float": 0.02,
                         "_anonymous_namespace_::flash_attention_fwd_prep_float": 0.01,
                         "_anonymous_namespace_::flash_attention_fwd_bias_float": 0.01,
                         "sm90_xmma_gemm_tf32": 0.2}}
    fake = {"trace": trace, "units": 10, "config": cfg, "counters": {"parameters": 1},
            "pace": {"units": 5, "seconds": 2.0}}
    assert core.read_metric("beit_train.device_ms", fake) == pytest.approx(30.0)
    h, w = cfg["clip"]["down_hw"]
    att = beit_train.attention_flops(cfg["model"], 4, h, w)
    assert core.read_metric("beit.attention_roofline", fake) == pytest.approx(
        100.0 * att / peaks.TF32_FLOPS / 0.004)
    step = beit_train.train_step_flops(cfg["model"], 4, h, w, cfg["loss"])
    assert core.read_metric("beit_train.mfu", fake) == pytest.approx(
        100.0 * step * 5 / 2.0 / peaks.TF32_FLOPS)
    trace["kernels"] = {"sm90_xmma_gemm_tf32": 0.2}
    assert core.read_metric("beit.attention_roofline", fake) is None
