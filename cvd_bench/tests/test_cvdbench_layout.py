"""BENCHMARK.json against its files: every name resolves, a new
configuration, mix, metric and cell are found without an edit, and no
module of the benchmark imports JAX or the JAX package."""

import ast
import json
import os
import re
import sys

import pytest

from conftest import ROOT

from cvd_bench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench():
    return core.load_benchmark(ROOT)


def test_every_name_resolves_to_its_file():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"])), c
        assert c["file"].startswith(b["paths"][0] + "/")
    for w in b["workloads"]:
        cell = core.resolve(b, w["name"])
        assert os.path.isfile(core.mix_path(w["traffic"]))
        assert os.path.isfile(core.limits_path(w["name"]))
        for fn in ("setup", "unit", "min_units", "close_window", "counters",
                   "attempted_failed", "report", "check", "control"):
            assert callable(getattr(cell["stage"], fn)), fn
        assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"], w["name"]
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.isfile(core.metric_path(m["name"])), m["name"]
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_an_added_config_mix_metric_and_cell_need_no_edit(tmp_path):
    """New files and entries only: the harness finds them by name."""
    b = bench()
    tag = f"_probe{os.getpid()}"
    made = [core.config_path(f"cfg{tag}"), core.mix_path(f"mix{tag}"),
            core.metric_path(f"m{tag}.x"), core.limits_path(f"cell{tag}")]
    try:
        with open(made[0], "w") as f:
            json.dump({"clip": {"frames": 3}}, f)
        with open(made[1], "w") as f:
            json.dump({"stage": "train", "trace_units": 1}, f)
        with open(made[2], "w") as f:
            f.write("def read(run):\n    return run['units'] * 2\n")
        with open(made[3], "w") as f:
            json.dump({"loss": 1.0}, f)
        b["configs"].append({"name": f"cfg{tag}", "source": "x", "reduced": [], "why": "x",
                             "file": os.path.relpath(made[0], ROOT)})
        b["workloads"].append({"name": f"cell{tag}", "config": f"cfg{tag}",
                               "traffic": f"mix{tag}", "chips": 1, "why": "x"})
        b["per_layer"].append({"name": f"m{tag}.x", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "x", "moves": "setup_s",
                               "workloads": [f"cell{tag}"]})
        cell = core.resolve(b, f"cell{tag}")
        assert cell["config"] == {"clip": {"frames": 3}}
        assert cell["stage"].__name__.endswith("train")
        assert [m["name"] for m in cell["per_layer"]] == [f"m{tag}.x"]
        assert core.read_metric(f"m{tag}.x", {"units": 4}) == 8.0
    finally:
        for p in made:
            if os.path.exists(p):
                os.remove(p)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _py_files(sub=""):
    base = os.path.join(ROOT, "cvd_bench", sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _py_files():
        for mod in _imports(path):
            assert mod.split(".")[0] not in core.FORBIDDEN_MODULES, (path, mod)


def test_the_reference_imports_nothing_of_the_program():
    for sub in ("reference", "counts"):
        for path in _py_files(sub):
            for mod in _imports(path):
                assert mod.split(".")[0] != "robust_cvd_tpu_torch", (path, mod)


def test_run_end_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "robust_cvd_tpu_torch_probe", sys)
    assert "robust_cvd_tpu_torch_probe" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "robust_cvd_tpu.probe", sys)
    assert "robust_cvd_tpu.probe" in core.forbidden_modules()


@pytest.mark.parametrize("argv", [["--workload", "midas_v2-384.train", "--seed", "1",
                                   "--seconds", "1", "--trace", "0"]])
def test_a_run_without_a_card_fails_and_prints_no_result(argv, capsys, monkeypatch):
    import torch

    from cvd_bench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(ROOT)
    assert run.main(argv) != 0
    assert capsys.readouterr().out.strip() == ""
