"""The harness: finds a cell's files by the names in BENCHMARK.json, runs
its set-up, its measured window and its check, and reduces the result to
the contract's last line.

Everything that belongs to one configuration, traffic mix or metric sits in
files of its own, found by name:

- configuration `<c>`: `cvd_bench/configs/<c>.json` (sizes, source, cuts);
- traffic mix `<t>`: `cvd_bench/traffic/<t>.json`, whose `stage` names the
  stage module `cvd_bench/stages/<stage>.py` that reads it;
- metric `<m>` (end-to-end or per-layer): `cvd_bench/metrics/<m>.py`, a
  reader `read(run) -> float | None` of the run's record;
- cell `<w>`: `cvd_bench/limits/<w>.json`, the limit of each number its
  check compares.

A stage module defines `setup(ctx) -> state`, `unit(state) -> None` (one
unit of the window's work, enqueued), `close_window(state)` (finishes the
window's bookkeeping; the harness then waits for the card),
`counters(state) -> dict`, `attempted_failed(state) -> (int, int)`,
`min_units(state) -> int` (the units a window holds at least: those its
check compares),
`report(state) -> [str]` (lines for standard error) and
`check(state) -> [Check]` (frees the program's state, runs the reference).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
# Top-level module names that no run may hold once its window has closed.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "robust_cvd_tpu")


NOT_FINITE = 1e30  # a compared number that is NaN or infinite reads this


@dataclass
class Check:
    """One number compared against its limit: ok when value <= limit. A
    value that is not finite (a NaN, an answer that never came) is stored
    as NOT_FINITE, so that the result line stays plain JSON and fails."""

    name: str
    value: float
    limit: float

    def __post_init__(self):
        self.value = float(self.value) if math.isfinite(self.value) else NOT_FINITE

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Ctx:
    """What a stage gets: the cell's configuration and mix (parsed JSON),
    the seed, the device, the scratch directory and the trace flag."""

    workload: str
    config: Dict[str, Any]
    mix: Dict[str, Any]
    seed: int
    device: str
    tmpdir: str
    trace: bool
    limits: Dict[str, float] = field(default_factory=dict)

    def say(self, line: str) -> None:
        print(line, file=sys.stderr, flush=True)


def load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str) -> Dict[str, Any]:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def scratch_dir() -> str:
    """Where a run writes its scratch clips: TMPDIR and nowhere else."""
    tmp = os.environ.get("TMPDIR")
    if not tmp:
        raise RuntimeError("TMPDIR is not set: a run writes its scratch clips there")
    return tmp


def load_module(path: str, name: str):
    """A module from a file path (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "configs", f"{name}.json")


def mix_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "traffic", f"{name}.json")


def stage_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "stages", f"{name}.py")


def limits_path(workload: str) -> str:
    return os.path.join(BENCH_DIR, "limits", f"{workload}.json")


def metric_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "metrics", f"{name}.py")


def resolve(bench: Dict[str, Any], workload: str) -> Dict[str, Any]:
    """The cell's entry, configuration, mix, stage module and metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.join(os.path.dirname(BENCH_DIR), cfg_entry["file"]))
    mix = load_json(mix_path(cell["traffic"]))
    stage = load_module(stage_path(mix["stage"]), f"cvd_bench.stages.{mix['stage']}")

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return dict(
        cell=cell, config=config, mix=mix, stage=stage,
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
    )


def read_metric(name: str, run: Dict[str, Any]) -> Optional[float]:
    mod = load_module(metric_path(name), f"cvd_bench.metrics.{name.replace('.', '_')}")
    value = mod.read(run)
    return None if value is None else float(value)


def forbidden_modules() -> List[str]:
    return sorted(k for k in list(sys.modules) if k.split(".")[0] in FORBIDDEN_MODULES)


def device_info(device: str, chips: int) -> Dict[str, Any]:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i) for i in range(chips))),
        "power_limit": power_limit(),
    }


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def run_window(stage, state, device: str, seconds: float, max_units: Optional[int] = None):
    """Whole units until `seconds` have passed (or `max_units` are done),
    and at least the stage's `min_units`; the window ends when the card has
    finished the last. Returns (units, window seconds)."""
    least = stage.min_units(state)
    sync(device)
    t0 = time.perf_counter()
    units = 0
    while True:
        stage.unit(state)
        units += 1
        if units < least:
            continue
        if max_units is not None:
            if units >= max_units:
                break
        elif time.perf_counter() - t0 >= seconds:
            break
    stage.close_window(state)
    sync(device)
    return units, time.perf_counter() - t0


def run_cell(workload: str, seed: int, seconds: float, trace: bool, root: str,
             t_start: float, tmpdir: str, device: str = "cuda", config_override=None,
             mix_override=None) -> Dict[str, Any]:
    """One run of a cell; returns the result object (the last line). The
    chip check is the caller's. `config_override` and `mix_override`
    replace the configuration's and the mix's JSON (the CPU tests' tiny
    sizes)."""
    from . import tracing

    bench = load_benchmark(root)
    cell = resolve(bench, workload)
    config = config_override if config_override is not None else cell["config"]
    mix = mix_override if mix_override is not None else cell["mix"]
    ctx = Ctx(workload=workload, config=config, mix=mix, seed=seed, device=device,
              tmpdir=tmpdir, trace=trace, limits=load_json(limits_path(workload)))
    stage = cell["stage"]
    state = stage.setup(ctx)
    run: Dict[str, Any] = {"config": config, "mix": mix, "trace": None}
    if trace:
        units, window_s, prof_trace, pace = tracing.traced_window(
            stage, state, device, int(mix["trace_units"]), int(mix.get("pace_units", 0)))
        run["trace"] = prof_trace
        run["pace"] = None if pace is None else {"units": pace[0], "seconds": pace[1]}
    else:
        setup_s = time.perf_counter() - t_start
        units, window_s = run_window(stage, state, device, seconds)
        run["setup_s"] = setup_s
    run.update(units=units, window_s=window_s, counters=stage.counters(state))
    attempted, failed = stage.attempted_failed(state)
    dev = device_info(device, int(cell["cell"]["chips"]))
    if trace and run["trace"] is not None:
        dev["busy_s"] = run["trace"]["busy_s"]
        dev["window_s"] = run["trace"]["window_s"]
    for line in stage.report(state):
        ctx.say(line)
    checks = stage.check(state)
    del state

    names = [m["name"] for m in (cell["per_layer"] if trace else cell["end_to_end"])]
    units_of = {m["name"]: m["unit"] for m in bench["per_layer"] + bench["end_to_end"]}
    metrics = {}
    for name in names:
        value = read_metric(name, run)
        if value is None:
            ctx.say(f"metric {name}: nothing to read in this run, left out")
            continue
        metrics[name] = {"value": value, "unit": units_of[name]}
    result: Dict[str, Any] = {
        "correct": all(c.ok for c in checks) and bool(checks),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if trace and run["trace"] is not None:
        result["breakdown"] = run["trace"]["breakdown"]
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result


def emit(result: Dict[str, Any]) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
