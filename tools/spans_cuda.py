"""The port's spans (robust_cvd_tpu_torch/utils/spans.py) on the card: what
a span costs on the card's host, and the benchmark cells' traced windows
with the spans lined up against the device trace.

    PYTHONPATH=. python3 tools/spans_cuda.py [--out DIR] [--seed 7300000011]
        [--cells train flow] [--device cuda|cpu --tiny]

1. cost: nanoseconds a span with no profiler running, under the
   benchmark's CUDA-only torch.profiler and under a CPU and CUDA one.
2. each cell (`train`: midas_v2-384.train, `flow`: raft_things-1024.flow):
   the stage's set-up as a benchmark run makes it, then the mix's
   `trace_units` under the benchmark's profile (cvd_bench/tracing.py).
   Prints whether kineto's host events carry the spans, the idle gaps by
   label as the benchmark reduces them (kineto's host events) and again
   with the ring's spans added as host events (the spans and kineto share
   the Unix-epoch clock), and, for the flow cell, how long before each
   `flow.readback` span ends the device's last operation ends (the
   readback waits for the chunk: a small lag says the clocks agree).
   With --out, writes the ring's spans of the window (`<cell>_ring.json`)
   and the flow cell's Chrome trace (`flow_trace.json.gz`) there.

3. `--ab N`: the train cell's steps with the spans on and with
   `training/fine_tune.py`'s spans replaced by a block that does nothing,
   in N pairs of blocks of `--ab-steps` steps, the order alternating: the
   spans' cost in a step, end to end.

`--tiny` cuts both cells to the CPU tests' sizes (a rehearsal on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CELLS = {"train": "midas_v2-384.train", "flow": "raft_things-1024.flow"}


def span_cost(device: str) -> dict:
    """ns a span (enter and exit of an empty block) with no profiler, under
    a CUDA-only profile (CPU-only on the CPU) and under a CPU+CUDA one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from robust_cvd_tpu_torch.utils.spans import span

    def per_span(n):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("cost.probe"):
                pass
        return (time.perf_counter_ns() - t0) / n

    def empty_loop(n):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            pass
        return (time.perf_counter_ns() - t0) / n

    per_span(10_000)
    out = {"off_ns": min(per_span(200_000) for _ in range(3)),
           "loop_ns": min(empty_loop(200_000) for _ in range(3))}
    dev = [ProfilerActivity.CUDA] if device == "cuda" else [ProfilerActivity.CPU]
    for key, acts in (("on_device_only_ns", dev),
                      ("on_cpu_and_device_ns", list(dict.fromkeys([ProfilerActivity.CPU] + dev)))):
        with profile(activities=acts):
            per_span(1000)
            out[key] = min(per_span(20_000) for _ in range(3))
    return out


def ring_of(t0_ns: int, t1_ns: int):
    """The ring's spans that start and end inside [t0_ns, t1_ns]."""
    from robust_cvd_tpu_torch.utils import spans

    return [r for r in list(spans._ring) if r[3] >= t0_ns and r[4] <= t1_ns]


def readback_lags(ring, dev_events):
    """For each flow.readback span, ms from the end of the device's last
    operation that ends before the span does to the span's end."""
    import bisect

    ends = sorted(e for _, _, e in dev_events)  # us
    lags = []
    for r in ring:
        if r[2] != "flow.readback":
            continue
        t1_us = r[4] / 1e3
        k = bisect.bisect_right(ends, t1_us)
        if k:
            lags.append((t1_us - ends[k - 1]) / 1e3)
    return lags


def cell_setup(name: str, seed: int, device: str, tiny: bool):
    """(stage module, its state after set-up, the mix, set-up seconds, the
    scratch dir) of a cell, as a benchmark run sets it up."""
    import tempfile

    from cvd_bench import core

    bench = core.load_benchmark(ROOT)
    cell = core.resolve(bench, CELLS[name])
    config, mix = cell["config"], dict(cell["mix"])
    if tiny:
        config = json.loads(json.dumps(config))
        if name == "flow":
            config["clip"].update(frames=6, flow_hw=[128, 192], down_hw=[64, 96])
            config["flow"]["batch_size"] = 4
        else:
            config["model"].update(features=32, backbone_layers=[1, 1, 1, 1])
            config["clip"].update(frames=8, down_hw=[32, 64])
            mix["warmup_steps"] = 3
        mix["trace_units"] = min(mix["trace_units"], 6)
    tmp = tempfile.mkdtemp(prefix="spans_cuda_", dir=os.environ.get("TMPDIR"))
    ctx = core.Ctx(workload=CELLS[name], config=config, mix=mix, seed=seed, device=device,
                   tmpdir=tmp, trace=True, limits=core.load_json(core.limits_path(CELLS[name])))
    stage = cell["stage"]
    t0 = time.perf_counter()
    state = stage.setup(ctx)
    return stage, state, mix, time.perf_counter() - t0, tmp


def traced_cell(name: str, seed: int, device: str, tiny: bool, out_dir: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cvd_bench import core, tracing

    stage, state, mix, setup_s, tmp = cell_setup(name, seed, device, tiny)
    acts = [ProfilerActivity.CUDA] if device == "cuda" else [ProfilerActivity.CPU]
    with profile(activities=acts):  # the profiler's start-up, outside
        torch.ones(1, device=device).add_(1)
        core.sync(device)
    units = int(mix["trace_units"])
    w0 = time.time_ns()
    with profile(activities=acts) as prof:
        core.run_window(stage, state, device, 0.0, max_units=units)
    w1 = time.time_ns()
    dev, host = tracing._events(prof)
    ring = ring_of(w0, w1)
    span_names = {r[2] for r in ring}
    kineto_names = {h[0] for h in host}
    res = {"cell": CELLS[name], "setup_s": setup_s, "units": units,
           "device_events": len(dev), "kineto_host_events": len(host),
           "ring_spans": len(ring),
           "spans_in_kineto": sorted(span_names & kineto_names),
           "spans_not_in_kineto": sorted(span_names - kineto_names)}
    if dev:
        as_host = [(r[2], r[3] / 1e3, r[4] / 1e3) for r in ring]
        res["idle_gaps_kineto"] = tracing.reduce_events(dev, host)["breakdown"]["idle_gaps"]
        res["idle_gaps_with_spans"] = tracing.reduce_events(
            dev, host + as_host)["breakdown"]["idle_gaps"]
        if name == "flow":
            lags = sorted(readback_lags(ring, dev))
            res["readback_lag_ms"] = {"n": len(lags), "min": lags[0], "median":
                                      lags[len(lags) // 2], "max": lags[-1]} if lags else None
    top = "train.step" if name == "train" else "flow.iter"
    tops = [r for r in ring if r[2] == top]
    res[f"spans_per_{top}"] = len(ring) / len(tops) if tops else None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{name}_ring.json"), "w") as f:
            json.dump([{"id": r[0], "parent": r[1], "name": r[2], "t0_ns": r[3], "t1_ns": r[4],
                        "attrs": r[5]} for r in ring], f)
        if name == "flow":  # a train window's trace is hundreds of MB
            import gzip
            import shutil

            raw = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(raw)
            with open(raw, "rb") as src, gzip.open(os.path.join(out_dir, "flow_trace.json.gz"),
                                                    "wb") as dst:
                shutil.copyfileobj(src, dst)
    stage.close_window(state)
    del state
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


class _NoSpan:
    """A span that records nothing."""

    def __init__(self, name, **attrs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def ab_train(pairs: int, steps: int, seed: int, device: str, tiny: bool) -> dict:
    """ms a train step with the train step's spans on and off, block by
    block (`pairs` blocks of each, `steps` steps a block, the order
    alternating)."""
    import shutil

    from cvd_bench import core
    from robust_cvd_tpu_torch.training import fine_tune

    stage, state, _, _, tmp = cell_setup("train", seed, device, tiny)
    real = fine_tune.span
    ms = {"on": [], "off": []}
    try:
        for k in range(pairs):
            order = (("on", real), ("off", _NoSpan))
            for mode, impl in order if k % 2 == 0 else order[::-1]:
                fine_tune.span = impl
                core.sync(device)
                t0 = time.perf_counter()
                for _ in range(steps):
                    stage.unit(state)
                core.sync(device)
                ms[mode].append((time.perf_counter() - t0) * 1e3 / steps)
    finally:
        fine_tune.span = real
    shutil.rmtree(tmp, ignore_errors=True)
    return {"ab_train_ms_per_step": ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="a directory for the dumps")
    ap.add_argument("--seed", type=int, default=7300000011)
    ap.add_argument("--cells", nargs="*", default=["train", "flow"], choices=sorted(CELLS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ab", type=int, default=0)
    ap.add_argument("--ab-steps", type=int, default=100)
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("spans_cuda: CUDA is not available", file=sys.stderr)
        return 1
    if args.device == "cuda":
        from cvd_bench.core import power_limit

        print(json.dumps({"device": power_limit()}))
    print(json.dumps({"span_cost": span_cost(args.device)}), flush=True)
    for name in args.cells:
        print(json.dumps(traced_cell(name, args.seed, args.device, args.tiny, args.out)),
              flush=True)
    if args.ab:
        print(json.dumps(ab_train(args.ab, args.ab_steps, args.seed, args.device, args.tiny)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
