"""The port's command-line surface against the JAX package's (config.py).

Exact comparisons: parse_config on the same argv gives the same
dataclasses.asdict in both packages; invalid command lines raise the same
exception in both; non_default_params gives the same lines; the parsers
hold the same flags with the same defaults; `python -m robust_cvd_tpu_torch
--help` lists them.
"""

import dataclasses
import os
import re
import subprocess
import sys

import pytest

from robust_cvd_tpu import config as jconfig
from robust_cvd_tpu_torch import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a verification run's flags: every stage's switches and the small solver schedule
VERIFY = ["--path", "clip", "--size", "64", "--align", "32", "--num_epochs", "1",
          "--batch_size", "2", "--val_epoch_freq", "1", "--save_checkpoints", "true",
          "--save_intermediate_depth_streams_freq", "1", "--post_filter", "true",
          "--vis_flow", "true", "--save_tensorboard", "false", "--min_mask_ratio", "0.1",
          "--opt.num_steps", "2", "--opt.ctf_long", "3", "--opt.ctf_short", "2",
          "--opt.lm_max_outer", "4", "--opt.lm_cg_iters", "8"]

VALID = [
    [],
    ["--path", "/data/clip"],
    VERIFY,
    ["--opt.dynamic_constraints", "Ransac", "--opt.value_xform", "ScaleShift",
     "--opt.intr_opt", "Shared", "--opt.robustness", "0.25", "--opt.focal_long", "0.5"],
    ["--flow_ops", "hierarchical2", "consecutive"],
    ["--flow_ops"],
    ["--save_tensorboard", "no", "--post_filter", "1", "--vis_flow", "T",
     "--opt.coarse_to_fine", "False", "--opt.warm_start", "yes", "--short_side_target", "y"],
    ["--lambda_static_depth_ratio", "10", "--lambda_smooth_reprojection", "0.5",
     "--distance_type_static", "cauchy", "--learning_rate", "1e-4", "--optimizer", "RAdam"],
    ["--recon", "colmap", "--scaling", "extrinsics", "--frame_range", "0-9,20",
     "--exp_tag", "full", "--model_type", "midas2", "--op", "extract_frames"],
    ["--opt.num_threads", "4"],
]

INVALID = [
    ["--recon", "hd_depth"],
    ["--scaling", "disparity"],
    ["--flow_model", "pwc"],
    ["--opt.value_xform", "Affine"],
    ["--opt.static_loss_type", "L2"],
    ["--opt.dynamic_constraints", "Semantic"],
    ["--vis_flow", "maybe"],
    ["--size", "big"],
    ["--no_such_flag", "1"],
]


@pytest.mark.parametrize("argv", VALID, ids=lambda a: " ".join(a)[:60] or "empty")
def test_parse_config_matches_jax(argv, capsys):
    got = tconfig.parse_config(argv)
    tout = capsys.readouterr().out
    want = jconfig.parse_config(argv)
    jout = capsys.readouterr().out
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert isinstance(got.flow_ops, tuple)
    assert tconfig.non_default_params(got) == jconfig.non_default_params(want)
    # the num_threads warning speaks of the GPU in the port
    assert bool(tout) == bool(jout) and "TPU" not in tout


@pytest.mark.parametrize("argv", INVALID, ids=lambda a: " ".join(a))
def test_invalid_argv_exits_in_both(argv, capsys):
    with pytest.raises(SystemExit):
        jconfig.parse_config(argv)
    with pytest.raises(SystemExit):
        tconfig.parse_config(argv)


def test_invalid_flow_ops_raise_in_both():
    for parse in (jconfig.parse_config, tconfig.parse_config):
        with pytest.raises(ValueError):
            parse(["--flow_ops", "sideways"])


def test_echo_non_default_matches_jax(capsys):
    for cfg_mod in (tconfig, jconfig):
        cfg_mod.echo_non_default(cfg_mod.parse_config(VERIFY))
    tout, jout = capsys.readouterr().out.split("Non-default parameters:\n")[1:]
    assert tout == jout and "num_epochs = 1" in tout
    tconfig.echo_non_default(tconfig.parse_config([]))
    assert capsys.readouterr().out == ""


def _flags(parser):
    return [(a.option_strings, a.default, a.nargs) for a in parser._actions]


def test_parsers_hold_the_same_flags():
    t, j = tconfig.build_parser(), jconfig.build_parser()
    assert _flags(t) == _flags(j)
    assert t.prog == "robust_cvd_tpu_torch"


def test_module_help_lists_every_flag():
    out = subprocess.run(
        [sys.executable, "-m", "robust_cvd_tpu_torch", "--help"], cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    listed = set(re.findall(r"--[\w.]+", out.stdout))
    want = {s for opts, _, _ in _flags(jconfig.build_parser()) for s in opts if s != "-h"}
    assert listed == want
