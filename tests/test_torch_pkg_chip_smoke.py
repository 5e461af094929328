"""chip_smoke.py rehearsed on the CPU.

The card-only phases (kernel builds, kernel comparisons and timing, the
card-vs-CPU checks, the profiles) cannot run here; the pose path, the
fine-tune path, the processor ops, the new optimizers' epochs, the flow
path and the whole pipeline through the CLI with the post filter can,
with the CPU device, small nets, a small frame size and one epoch, and they
raise on any failed check (finite depth, constraints, parameters and
losses, cold solves lowering their cost and warm ones not raising it, the
fine-tuned stream and video.dat written, parameters moved). Without CUDA
the script must exit non-zero and print no result.
"""

import functools
import json
import os
import sys

import pytest
import torch

import chip_smoke
from robust_cvd_tpu_torch.models import midas, raft
from torch_pkg_threads import one_torch_thread  # noqa: F401  (autouse)


def test_path_phase_on_cpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(chip_smoke, "H", 32)
    monkeypatch.setattr(chip_smoke, "W", 64)
    net = midas.seeded_init_(midas.MidasNet(features=32, backbone_layers=(1, 1, 1, 1)), 0)
    base = str(tmp_path)
    launches, depth, net = chip_smoke.path_phase(base, 6, 0, device="cpu", net=net)
    assert launches == 0  # the CPU takes the plain version, never the kernel
    out = capsys.readouterr().out
    assert "stage pose_solve_s" in out and out.count("solve {") == 5

    tuner, adam_launches = chip_smoke.finetune_phase(base, depth, net, 0, 1, device="cpu")
    assert adam_launches == 0 and len(tuner.history) == 1
    out = capsys.readouterr().out
    assert "stage fine_tune_s" in out and out.count("solve {") == 6  # 5 cold, 1 warm
    assert "1 host sync in the train loop" in out

    # the validate, processor, optimizer and colmap phases on the same clip
    # and tuner (the processor's solver ops on the small solver schedule)
    chip_smoke.validate_phase(tuner, device="cpu")
    assert "stage validate_s" in capsys.readouterr().out
    small = dict(num_steps=2, ctf_long=3, ctf_short=2, lm_max_outer=4, lm_cg_iters=8)
    assert chip_smoke.processor_phase(base, tuner.solver_params, 0, device="cpu",
                                      solver_options=small) == 0
    out = capsys.readouterr().out
    for line in ("processor proc_fgf_far", "card vs CPU on 6 frames", "from the median bracket",
                 "processor compute_tracks",
                 "processor reset_normalize_optimize", "each below its start"):
        assert line in out
    assert chip_smoke.optimizer_epochs_phase(tuner, device="cpu") == {
        "adam_radam": 0, "adam_mu_bf16": 0}
    out = capsys.readouterr().out
    assert "optimizer radam: 1 epoch" in out and "torch.bfloat16" in out
    assert chip_smoke.colmap_phase(base, net, 0, device="cpu") == 0
    out = capsys.readouterr().out
    assert "stage colmap_fine_tune_s" in out and "0 solves" in out


def test_flow_phase_on_cpu(monkeypatch, capsys, tmp_path):
    """The flow path at a cut size: 8 frames, color_flow 48x64, RAFT float32
    with 2 iterations, on the CPU; its checks raise on failure. Then the
    exact-flow mask check."""
    monkeypatch.setattr(chip_smoke, "H", 48)
    monkeypatch.setattr(chip_smoke, "W", 64)
    monkeypatch.setattr(chip_smoke, "DOWN_SIZE", (64, 16))
    monkeypatch.setattr(chip_smoke, "FLOW_SIZE", (64, 8))
    launches, stage = chip_smoke.flow_phase(str(tmp_path / "clip"), 8, 0, device="cpu",
                                            iters=2, dtype=torch.float32, min_share=1.0)
    assert launches == 0  # the CPU takes the plain version, never the kernel
    assert len(stage.homographies) == 30
    out = capsys.readouterr().out
    for line in ("stage compute_flow_s", "stage compute_flow_masks_s",
                 "stage flow_pair_stats_s", "registration vs truth: 30 of 30"):
        assert line in out
    chip_smoke.exact_mask_check(str(tmp_path / "exact"), 8, 0, device="cpu")
    assert "30 of 30 masks equal" in capsys.readouterr().out


SMALL_SOLVER = ["--opt.num_steps", "2", "--opt.ctf_long", "3", "--opt.ctf_short", "2",
                "--opt.lm_max_outer", "4", "--opt.lm_cg_iters", "8"]


@pytest.fixture(scope="module")
def pipeline_run(tmp_path_factory):
    """The pipeline phase at a cut size: 8 frames at the card's 224x384, the
    CLI's nets narrowed to the small MiDaS net and RAFT float32 with 2
    iterations (its flow head zeroed by the phase), the small solver
    schedule, one epoch, on the CPU; its checks (the result tree, flows and
    mask ratios against the true shift, static dynamic masks, steps and
    solves) raise on failure. The frame keeps the card's size because a
    mask ratio may miss its in-bounds share by the top and bottom rows and
    a border column (flows a few 1e-5 px off the integer shift), 2/H + 1/W:
    0.0115 at 224x384, 0.0208 at 128x192, against the phase's 0.02.
    Returns the clip, the launches, the processor and the output."""
    import io
    from contextlib import redirect_stdout

    base = str(tmp_path_factory.mktemp("pipeline") / "clip")
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as m, redirect_stdout(out):
        m.setattr(midas, "MidasNet", functools.partial(
            midas.MidasNet, features=32, backbone_layers=(1, 1, 1, 1)))
        m.setattr(raft, "RAFT", functools.partial(raft.RAFT, iters=2, dtype=torch.float32))
        launches, proc = chip_smoke.pipeline_phase(base, 8, 0, 1, device="cpu",
                                                   argv=SMALL_SOLVER)
    return base, launches, proc, out.getvalue()


def test_pipeline_phase_on_cpu(pipeline_run):
    base, launches, proc, out = pipeline_run
    assert launches == {"corner": 0, "adam": 0}  # the CPU takes the plain versions
    for line in ("pipeline stage fine_tune ", "pipeline_s_per_frame ", "post_filter_s ",
                 "pipeline flows vs truth: 30 pairs", "1 warm at or below",
                 "post filter: stream fine_tuned_filtered, 8 finite positive frames"):
        assert line in out
    names = [s["name"] for s in json.load(open(os.path.join(
        base, "R0-7_hierarchical2_midas2", "stage_timings.json")))["spans"]]
    assert set(chip_smoke.PIPELINE_SPANS) <= set(names)
    assert proc.device.type == "cpu" and len(proc.tuner.history) == 1


def test_mesh_phase_on_cpu(pipeline_run, capsys):
    """The mesh phase on the first 4 frames of the pipeline phase's clip: the
    CLI on two gloo ranks (spawned processes with the same cut: small nets,
    small solver, one epoch) on a copy of their inputs; its checks (the
    result tree, the initial depth, flows and masks against the one-process
    files, replicas bitwise equal, launches and steps) raise on failure."""
    base, _, proc, _ = pipeline_run
    mesh = str(os.path.join(os.path.dirname(base), "mesh", "clip"))
    launches = chip_smoke.mesh_phase(base, mesh, 4, 1, proc.tuner.history, device="cpu",
                                     argv=SMALL_SOLVER, small_nets=True)
    assert launches == {"corner": [0, 0], "adam": [0, 0]}  # the CPU's plain versions
    out = capsys.readouterr().out
    for line in ("mesh: 2 ranks on cpu over gloo", "10 flows max|err|", "masks differ in 0 of",
                 "mesh rank 1 epoch 0:", "one process epoch", "mesh replicas: one digest",
                 "mesh rank 1 solves:", "mesh solves: every rank solved its share",
                 "stage mesh_phase_s"):
        assert line in out, line


def test_sharded_solve_check_on_cpu(monkeypatch, capsys):
    """The sharded-solve check with the CPU standing in for the card, on a
    cut schedule (1 step, 4 LM steps; the ranks are spawned, so the cut
    reaches them through the options they are given): the static scene in
    this process and on 2 spawned gloo ranks; it raises on failure."""
    monkeypatch.setattr(chip_smoke, "SHARDED_OPT",
                        dict(chip_smoke.SHARDED_OPT, num_steps=1, lm_max_outer=4))
    chip_smoke.sharded_solve_check(device="cpu")
    out = capsys.readouterr().out
    for line in ("sharded solve rank 1:", "sharded solve: 2 ranks over gloo on cpu",
                 "SolverParams equal on every rank after each of 2 LM solves"):
        assert line in out, line


def test_io_engine_check_on_cpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(chip_smoke, "H", 24)
    monkeypatch.setattr(chip_smoke, "W", 40)
    chip_smoke.io_engine_check(str(tmp_path), n=10)
    out = capsys.readouterr().out
    assert "io engine: a 10-frame 24x40 depth stream" in out
    assert "files equal byte for byte" in out


def test_mask_rcnn_phase_on_cpu(monkeypatch, capsys, tmp_path):
    """The mask_rcnn phase at a cut size: 4 frames of 48x64, test size 64
    (padded to 64x96), heads shaped so that 3 proposals of the first frame
    score person, on the CPU: the stage over the clip, its checks (PNGs,
    dynamic shares, dynamic detections a frame) and mask_rcnn_checks with
    the CPU standing in for the card; they raise on failure."""
    monkeypatch.setattr(chip_smoke, "H", 48)
    monkeypatch.setattr(chip_smoke, "W", 64)
    monkeypatch.setattr(chip_smoke, "DOWN_SIZE", (64, 16))
    base = str(tmp_path / "clip")
    chip_smoke.mask_rcnn_clip(base, 4, 0)
    pkl, net = chip_smoke.mask_rcnn_phase(base, 0, device="cpu", keep=3, test_size=64,
                                          cpu_test_size=64)
    assert os.path.exists(pkl) and net.dtype == torch.float32
    out = capsys.readouterr().out
    for line in ("stage mask_rcnn_checkpoint_s", "mask_rcnn stats first_dispatch_s",
                 "for 4 frames at 64x85 padded to 64x96", "mask_rcnn dynamic share: min",
                 "mask_rcnn card vs CPU detections: 3 on the CPU and 3 on the card",
                 "paste_masks differs in 0 of pixels", "mask_rcnn bf16 vs float32"):
        assert line in out
    assert len(os.listdir(os.path.join(base, "dynamic_mask"))) == 4


def test_quality_phase_checks(monkeypatch, capsys):
    """The quality phase's holds, on stand-in gate results: the JAX package's
    values pass; a gate more than GATE_SLACK below, or a contamination gate
    without exclusion too close to the one with it, fails."""
    from robust_cvd_tpu_torch import quality

    def use(values):
        for name in chip_smoke.QUALITY_GATES:
            keys = {"static_quality_gate": ["quality_gap_closed"],
                    "dynamic_solver_gate": ["quality_gap_closed_dynamic",
                                            "quality_gap_closed_dynamic_vs_floor",
                                            "spatial_warp_recovery"],
                    "contaminated_constraint_gate": [
                        "quality_gap_closed_contaminated",
                        "quality_gap_closed_contaminated_no_exclusion"]}[name]
            monkeypatch.setattr(quality, name, lambda tiny, device, keys=keys: {
                k: values[k] for k in keys})

    use(chip_smoke.JAX_GATES)
    assert chip_smoke.quality_phase(device="cpu") == chip_smoke.JAX_GATES
    assert "stage quality_s" in capsys.readouterr().out
    for key, value in (("spatial_warp_recovery", 0.85),
                       ("quality_gap_closed_contaminated_no_exclusion", 0.7)):
        use(dict(chip_smoke.JAX_GATES, **{key: value}))
        with pytest.raises(AssertionError, match=key):
            chip_smoke.quality_phase(device="cpu")


def test_median_bracket():
    """The weighted median's bracket: a pixel whose cumulative weight ties
    with half the total admits both neighbouring samples, a clear one only
    its median; filters._weighted_median's pick lies inside on random data."""
    from robust_cvd_tpu_torch.ops import filters

    zs = torch.tensor([[4.0, 1.0], [3.0, 2.0], [2.0, 3.0], [1.0, 4.0]])
    wgt = torch.tensor([[1.0, 1.0], [1.0, 1.0], [1.0, 1.0], [1.0, 2.0]])
    lo, hi, ties = chip_smoke.median_bracket(zs, wgt)
    assert lo.tolist() == [2.0, 3.0] and hi.tolist() == [3.0, 3.0] and ties == 1
    assert filters._weighted_median(zs, wgt).tolist() == [2.0, 3.0]
    gen = torch.Generator().manual_seed(0)
    zs, wgt = torch.rand((7, 500), generator=gen), torch.rand((7, 500), generator=gen)
    wgt[3:] *= torch.rand((4, 500), generator=gen) > 0.5  # invalid samples weigh 0
    lo, hi, _ = chip_smoke.median_bracket(zs, wgt)
    pick = filters._weighted_median(zs, wgt)
    assert bool(((lo <= pick) & (pick <= hi)).all())


def test_small_tuner_steps_on_cpu():
    tuner = chip_smoke.small_tuner("cpu", 0)
    p0 = tuner.optimizer.flat.clone()
    for ids in ((2, 0), (1, 3)):
        loss, parts, ok = tuner.train_step(torch.tensor(ids))
        assert bool(ok) and torch.isfinite(loss)
    assert int(tuner.optimizer.count) == 2
    assert not torch.equal(tuner.optimizer.flat, p0)


def test_main_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""
