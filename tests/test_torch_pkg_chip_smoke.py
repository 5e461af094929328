"""chip_smoke.py rehearsed on the CPU.

The card-only phases (kernel builds, kernel comparisons and timing, the
profile) cannot run here; the pose path and the fine-tune path can, with
the CPU device, a small net, a small frame size and one epoch, and they
raise on any failed check (finite depth, constraints, parameters and
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
