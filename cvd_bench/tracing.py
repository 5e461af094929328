"""The traced window: torch.profiler over a fixed number of whole units,
reduced to device busy time, kernel time by name and the longest idle
gaps labelled by what the host was doing.

A traced run measures per-layer metrics only; its window is a fixed count
of units (the mix's `trace_units`), enough that its shares hold from seed
to seed while the reduction stays short. The profiler is started and
stopped once on a trivial operation before the window, so that its own
start-up falls outside. On the card it records the card's activity and the
CUDA runtime calls that go with it, not every host op; an idle gap is
labelled by the runtime call the host was in at its midpoint, or as host
time outside any runtime call. The traced window's length, `window_s`, is
the trace's own: from the first device operation's start to the last's
end."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np

TOP = 10  # entries of each breakdown list


def _intervals_union(spans: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(busy, merged spans) of (start, end) spans."""
    spans = sorted(spans)
    merged: List[Tuple[float, float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged), merged


def reduce_events(device_events, host_events) -> Dict:
    """Device events (name, start_us, end_us) and host events (name,
    start_us, end_us) -> busy_s, window_s (the device events' first start
    to their last end), kernel seconds by name and the breakdown."""
    by_name: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for name, s, e in device_events:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        count[name] = count.get(name, 0) + 1
    busy_us, merged = _intervals_union([(s, e) for _, s, e in device_events])
    gaps = [(merged[k][1], merged[k + 1][0]) for k in range(len(merged) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    gap_by_host: Dict[str, float] = {}
    h_start = np.array([s for _, s, _ in host_events], np.float64)
    h_end = np.array([e for _, _, e in host_events], np.float64)
    h_dur = h_end - h_start
    for s, e in gaps[:200]:
        # the innermost host op running at the gap's midpoint
        mid = (s + e) / 2
        inside = np.flatnonzero((h_start <= mid) & (h_end >= mid))
        if inside.size:
            label = host_events[int(inside[np.argmin(h_dur[inside])])][0]
        else:
            label = "host outside any profiled call"
        gap_by_host[label] = gap_by_host.get(label, 0.0) + (e - s) / 1e6
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (merged[-1][1] - merged[0][0]) / 1e6,
        "kernels": by_name,
        "kernel_counts": count,
        "breakdown": {
            "device_ops": [[n, t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[n, t] for n, t in sorted(gap_by_host.items(), key=lambda kv: -kv[1])[:TOP]],
        },
    }


def _events(prof):
    """(device events, host events) of a finished profile, each (name,
    start_us, end_us); the device-side copies of record_function ranges
    are left out (they span idle time)."""
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type()
        span = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        if kind == cpu:
            host.append(span)
        elif kind == cuda and not getattr(e, "is_user_annotation", bool)():
            dev.append(span)
    host_names = {name for name, _, _ in host}
    return [d for d in dev if d[0] not in host_names], host


def traced_window(stage, state, device: str, units: int, pace_units: int = 0):
    """`pace_units` whole units on the host clock, untraced, where the mix
    asks for them, then `units` under torch.profiler; returns (units,
    host-clock window seconds of the traced units, reduced trace or None
    where the profiler saw no device work, (pace units, their seconds) or
    None). The untraced pace is for a host-bound unit, whose pace the
    profiler's recording of every CUDA runtime call slows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .core import run_window, sync

    pace = run_window(stage, state, device, 0.0, max_units=pace_units) if pace_units else None

    # the card's activity only: recording every host op as well doubled a
    # train step's time and so the idle share
    activities = [ProfilerActivity.CUDA] if device == "cuda" else [ProfilerActivity.CPU]
    with profile(activities=activities):
        torch.ones(1, device=device).add_(1)
        sync(device)
    sync(device)
    with profile(activities=activities) as prof:
        n, window_s = run_window(stage, state, device, 0.0, max_units=units)
    t0 = time.perf_counter()
    dev, host = _events(prof)
    if not dev:
        print("trace: the profiler recorded no device work", flush=True)
        return n, window_s, None, pace
    out = reduce_events(dev, host)
    print(f"trace: {len(dev)} device events, {len(host)} host events, reduced in "
          f"{time.perf_counter() - t0:.3f} s; host-clock window {window_s:.6f} s, "
          f"traced window {out['window_s']:.6f} s", flush=True)
    return n, window_s, out, pace
