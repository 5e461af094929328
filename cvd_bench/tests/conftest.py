"""Tests of the benchmark harness, on the CPU at tiny sizes.

    python -m pytest cvd_bench/tests -q -p no:cacheprovider

Tests marked `cuda` need the card and skip here. The harness's modules
import torch and the port only, never JAX."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_config(name: str) -> dict:
    """The configuration's JSON cut to a size the CPU runs in seconds."""
    from cvd_bench import core

    cfg = copy.deepcopy(core.load_json(core.config_path(name)))
    if "raft" in cfg:
        cfg["clip"].update(frames=6, flow_hw=[128, 192], down_hw=[64, 96])
        cfg["flow"]["batch_size"] = 4
        return cfg
    cfg["model"]["features"] = 32
    cfg["model"]["backbone_layers"] = [1, 1, 1, 1]
    cfg["clip"]["frames"] = 8
    cfg["clip"]["down_hw"] = [32, 64]
    return cfg


def tiny_mix(name: str) -> dict:
    """The traffic mix with the few warm-up and traced units the CPU runs
    in seconds."""
    from cvd_bench import core

    mix = core.load_json(core.mix_path(name))
    if "warmup_steps" in mix:
        mix["warmup_steps"] = 3
    mix["trace_units"] = min(mix["trace_units"], 6)
    if "pace_units" in mix:
        mix["pace_units"] = 3
    return mix


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
