"""chip_smoke.py rehearsed on the CPU.

The card-only phases (kernel build and timing) cannot run here; the path
phase can, with the CPU device, a small net and a small frame size, and it
raises on any failed check (finite depth, constraints and parameters, every
LM solve lowering its cost). Without CUDA the script must exit non-zero
and print no result.
"""

import sys

import torch

import chip_smoke
from robust_cvd_tpu_torch.models import midas


def test_path_phase_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "H", 32)
    monkeypatch.setattr(chip_smoke, "W", 64)
    net = midas.seeded_init_(midas.MidasNet(features=32, backbone_layers=(1, 1, 1, 1)), 0)
    launches = chip_smoke.path_phase(6, 0, device="cpu", net=net)
    assert launches == 0  # the CPU takes the plain version, never the kernel
    out = capsys.readouterr().out
    assert "stage pose_solve_s" in out and out.count("solve {") == 5


def test_main_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""
