"""The `flow` stage on the CPU at a tiny size: a run prints the
contract's result, the check passes on the port and fails on each fault a
flow cell can have, the fp8 control reads above the limit, the frozen
reference agrees with the port, and the pair's operation count matches a
closed form."""

import json
import time

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny_config, tiny_mix

from cvd_bench import core

CELL = "raft_things-1024.flow"
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def run(tmp_path, trace=False, seed=2**33 + 11):
    return core.run_cell(CELL, seed, 0.5, trace, ROOT, time.perf_counter(),
                         str(tmp_path), device="cpu", config_override=tiny_config("raft_things-1024"),
                         mix_override=tiny_mix("flow"))


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_prints_the_contracts_last_line(trace, tmp_path, capsys):
    core.emit(run(tmp_path, trace))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == KEYS | ({"breakdown"} if "breakdown" in out else set())
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] >= 4
    want = {"flow_ms_per_pair", "setup_s"} if not trace else {"flow.load_ms", "flow.chunk_ms"}
    assert want <= set(out["metrics"])
    assert not list(tmp_path.iterdir())  # the clip and its passes are gone


def _fault(monkeypatch, kind):
    from robust_cvd_tpu_torch.pipeline import flow

    orig = flow.FlowStage.flow_chunk
    if kind == "answer_altered":
        def shifted(self, im1, im2, out_hw):
            flows, hs = orig(self, im1, im2, out_hw)
            return flows + 0.25, hs

        monkeypatch.setattr(flow.FlowStage, "flow_chunk", shifted)
    elif kind == "half_batch":
        orig_compute = flow.FlowStage._compute_flow

        def half(self, missing):
            return orig_compute(self, missing[: max(1, len(missing) // 2)])

        monkeypatch.setattr(flow.FlowStage, "_compute_flow", half)


@pytest.mark.parametrize("kind", ["answer_altered", "half_batch"])
def test_each_fault_makes_the_run_incorrect(kind, tmp_path, monkeypatch):
    _fault(monkeypatch, kind)
    assert run(tmp_path)["correct"] is False


def test_the_control_fails_the_check(tmp_path):
    from cvd_bench.stages import flow

    cfg = tiny_config("raft_things-1024")
    mix = tiny_mix("flow")
    ctx = core.Ctx(workload=CELL, config=cfg, mix=mix, seed=5, device="cpu",
                   tmpdir=str(tmp_path), trace=False,
                   limits=core.load_json(core.limits_path(CELL)))
    st = flow.setup(ctx)
    core.run_window(flow, st, "cpu", 0.0, max_units=len(st.chunks))
    got = flow.control(st)
    assert got["port"][0] <= ctx.limits["flow_px"] < got["control_fp8"][0]


def test_the_frozen_reference_agrees_with_the_port():
    """Float32 on both sides: registration, RAFT and the un-warp agree."""
    from robust_cvd_tpu_torch.models import raft as port_raft
    from robust_cvd_tpu_torch.ops import homography
    from robust_cvd_tpu_torch.pipeline.flow import _postproc

    from cvd_bench import clip, weights
    from cvd_bench.reference import raft as ref_raft
    from cvd_bench.reference import registration

    frames = torch.from_numpy(clip.panning_frames(4, 96, 128, 3, 1))
    im1, im2 = frames[:2], frames[2:]
    h_p, w_p = homography.register_pairs(im1, im2)
    h_r, w_r = registration.register(im1, im2)
    torch.testing.assert_close(h_r, h_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(w_r, w_p, rtol=1e-4, atol=1e-4)
    port = weights.seed_raft_(port_raft.RAFT(iters=3, dtype=torch.float32), 2)
    ref = weights.seed_raft_(ref_raft.RAFT(iters=3), 2)
    with torch.no_grad():
        a = port(im1.permute(0, 3, 1, 2) * 255, w_p.permute(0, 3, 1, 2) * 255)
        b = ref(im1.permute(0, 3, 1, 2) * 255, w_p.permute(0, 3, 1, 2) * 255)
    torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)
    f = a.permute(0, 2, 3, 1)
    torch.testing.assert_close(registration.unwarp_and_resize(f, h_p, (48, 64)),
                               _postproc(f, h_p, (48, 64), True), rtol=1e-4, atol=1e-4)


def test_the_pair_count_matches_a_closed_form():
    """RAFT's convolutions (2*MACs each) plus the correlation volume's
    products and the registration's, at a tiny size."""
    import torch.nn as nn

    from cvd_bench.counts import raft_flow
    from cvd_bench.reference import raft

    cfg = tiny_config("raft_things-1024")
    h, w = cfg["clip"]["flow_hw"]
    r = cfg["raft"]
    net = raft.RAFT(r["iters"])
    macs = []
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            m.register_forward_hook(lambda mod, i, o: macs.append(o.numel() * mod.weight[0].numel()))
    im = torch.zeros((1, 3, h, w))
    with torch.no_grad():
        net(im, im)
    q = (h // 8) * (w // 8)
    want = sum(2 * m for m in macs) + 2 * q * q * r["feature_dim"]
    want += 2 * 1024 * 1024 * 225 + 256 * 1024 * 2 * 9
    assert raft_flow.pair_flops(cfg) == want
