"""The `train` stage on the CPU at a tiny size: a run prints the
contract's result, the check passes on the port and fails on each fault a
train cell can have, the control fails it too, the frozen reference agrees
with the port, and the step's operation count matches a closed form."""

import json
import time

import pytest
import torch

from conftest import ROOT, tiny_config, tiny_mix

from cvd_bench import core

CELL = "midas_v2-384.train"
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def run(tmp_path, trace=False, seed=2**33 + 7):
    return core.run_cell(CELL, seed, 0.5, trace, ROOT, time.perf_counter(), str(tmp_path),
                         device="cpu", config_override=tiny_config("midas_v2-384"),
                         mix_override=tiny_mix("train"))


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_prints_the_contracts_last_line(trace, tmp_path, capsys):
    core.emit(run(tmp_path, trace))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == KEYS | ({"breakdown"} if trace and "breakdown" in out else set())
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    if not trace:
        assert set(out["metrics"]) == {"train_step_ms", "setup_s"}
    assert set(out["checks"]) == {"loss", "grad", "change"}


def _fault(monkeypatch, kind):
    from robust_cvd_tpu_torch.training import fine_tune, optimizer

    if kind == "state_unchanged":
        monkeypatch.setattr(optimizer.FlatAdam, "step",
                            lambda self, loss: torch.zeros((), dtype=torch.bool))
    elif kind == "half_batch":
        orig = fine_tune.train_step

        def half(net, opt, loss_opt, batch_ids, *a, **k):
            return orig(net, opt, loss_opt, batch_ids[: max(1, len(batch_ids) // 2)], *a, **k)

        monkeypatch.setattr(fine_tune, "train_step", half)


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch"])
def test_each_fault_makes_the_run_incorrect(kind, monkeypatch, tmp_path):
    _fault(monkeypatch, kind)
    assert run(tmp_path)["correct"] is False


def test_a_fault_that_begins_after_the_warm_up_makes_the_run_incorrect(monkeypatch, tmp_path):
    """The check reads the window's own steps: a step that returns its
    state unchanged only once the warm-up is over is caught."""
    from robust_cvd_tpu_torch.training import optimizer

    warm = tiny_mix("train")["warmup_steps"]
    orig = optimizer.FlatAdam.step
    calls = []

    def late(self, loss):
        calls.append(1)
        if len(calls) <= warm:
            return orig(self, loss)
        return torch.zeros((), dtype=torch.bool)

    monkeypatch.setattr(optimizer.FlatAdam, "step", late)
    assert run(tmp_path)["correct"] is False
    assert len(calls) > warm


def test_the_control_fails_the_check():
    """The reference in bfloat16 in the port's place reads above a limit."""
    from cvd_bench.stages import train

    ctx = core.Ctx(workload=CELL, config=tiny_config("midas_v2-384"),
                   mix=tiny_mix("train"), seed=5, device="cpu",
                   tmpdir="", trace=False, limits=core.load_json(core.limits_path(CELL)))
    st = train.setup(ctx)
    core.run_window(train, st, "cpu", 0.0, max_units=train.min_units(st))
    got = train.control(st)
    limits = [ctx.limits[k] for k in ("loss", "grad", "change")]
    assert all(p <= lim for p, lim in zip(got["port"], limits))
    assert any(c > lim for c, lim in zip(got["control_bf16"], limits))
    assert any(c > lim for c, lim in zip(got["fault_half_batch"], limits))


def test_the_frozen_reference_agrees_with_the_port():
    """Same weights: the reference's eval depth, train-mode depth, loss and
    first Adam step equal the port's within float32 rounding."""
    from robust_cvd_tpu_torch.config import LossParams
    from robust_cvd_tpu_torch.models import midas as port_midas
    from robust_cvd_tpu_torch.ops.adam import adam_update_plain
    from robust_cvd_tpu_torch.training import losses as port_losses

    from cvd_bench import clip, weights
    from cvd_bench.reference import losses as ref_losses
    from cvd_bench.reference import midas as ref_midas

    cfg = tiny_config("midas_v2-384")
    m = cfg["model"]
    port = weights.seed_midas_(port_midas.MidasNet(m["features"], m["backbone_layers"]), 3)
    ref = weights.seed_midas_(ref_midas.MidasNet(m["features"], m["backbone_layers"]), 3)
    assert port.state_dict().keys() == ref.state_dict().keys()
    images = torch.from_numpy(clip.panning_frames(4, 32, 64, 2, 3))
    with torch.no_grad():
        torch.testing.assert_close(ref_midas.depth(ref.eval(), images),
                                   port_midas.depth_apply(port.eval(), images))
    pairs = [(0, 1), (2, 3)]
    flows, masks = clip.exact_flows(pairs, 32, 64, 2, "cpu")
    ext, intr, scales, warp = clip.camera_path(4, 32, 64, 3, "cpu")
    fr = torch.tensor(pairs)
    d0 = port_midas.depth_apply(port.eval(), images).detach()[fr]
    port.train(), ref.train()
    dp = port_midas.depth_apply(port, images.reshape(-1, 32, 64, 3))[fr] * scales[fr]
    dr = ref_midas.depth(ref, images)[fr] * scales[fr]
    torch.testing.assert_close(dr, dp)
    meta = port_losses.LossMeta(extrinsics=ext[fr], intrinsics=intr[fr], flows=flows,
                                masks=masks, warp=warp[fr])
    lp, _ = port_losses.joint_loss(LossParams(**cfg["loss"]), images[fr], d0, dp, meta)
    lr_ = ref_losses.joint(None, d0, dr, ext[fr], intr[fr], warp[fr], flows, masks, cfg["loss"])
    torch.testing.assert_close(lr_, lp)
    p = torch.randn(1000)
    g = torch.randn(1000)
    mu, nu = torch.zeros(1000), torch.zeros(1000)
    q = p.clone()
    adam_update_plain(q, g, mu, nu, torch.zeros((), dtype=torch.int32), torch.tensor(True), 1e-3)
    m1, v1 = 0.1 * g, 0.001 * g * g
    want = p - 1e-3 * (m1 / 0.1) / (torch.sqrt(v1 / 0.001) + 1e-8)
    torch.testing.assert_close(q, want)


def test_the_step_count_matches_a_closed_form():
    """Convolution FLOPs of a train step: forward 2*MACs for every
    convolution, backward 2*MACs for every weight gradient and every input
    gradient but the first layer's (the images need none); plus the loss's
    small per-pixel 3x3 rotations, counted alone."""
    from torch.utils.flop_counter import FlopCounterMode

    from cvd_bench.reference import losses
    import torch.nn as nn

    from cvd_bench.counts import midas_train
    from cvd_bench.reference import midas

    cfg = tiny_config("midas_v2-384")
    m = cfg["model"]
    h, w = cfg["clip"]["down_hw"]
    net = midas.MidasNet(m["features"], m["backbone_layers"])
    macs = {}

    def hook(mod, inp, out):
        k = mod.weight[0].numel()
        macs[mod] = out.numel() * k

    for mod in net.modules():
        if isinstance(mod, nn.Conv2d):
            mod.register_forward_hook(hook)
    x = torch.zeros((4, 3, h, w))
    net(x)
    first = net.pretrained.layer1[0]
    # refinenet4's first unit takes no skip: it never runs
    want = sum(2 * v * 3 for v in macs.values()) - 2 * macs[first]
    b = 2
    d = torch.ones((b, 2, h, w), requires_grad=True)
    with FlopCounterMode(display=False) as loss_count:
        losses.joint(None, torch.ones((b, 2, h, w)), d, torch.zeros((b, 2, 3, 4)),
                     torch.ones((b, 2, 4)), torch.zeros((b, 2, h, w, 2)),
                     torch.zeros((b, 2, h, w, 2)), torch.ones((b, 2, h, w)),
                     cfg["loss"]).backward()
    want += loss_count.get_total_flops()
    assert midas_train.train_step_flops(m, 4, h, w, cfg["loss"]) == want
