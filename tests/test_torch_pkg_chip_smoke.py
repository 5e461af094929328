"""chip_smoke.py rehearsed on the CPU.

The card-only phases (kernel builds, kernel comparisons and timing, the
card-vs-CPU checks, the profiles) cannot run here; the pose path, the
fine-tune path and the flow path can, with the CPU device, small nets, a
small frame size and one epoch, and they raise on any failed check (finite depth, constraints, parameters and
losses, cold solves lowering their cost and warm ones not raising it, the
fine-tuned stream and video.dat written, parameters moved). Without CUDA
the script must exit non-zero and print no result.
"""

import sys

import torch

import chip_smoke
from robust_cvd_tpu_torch.models import midas


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
