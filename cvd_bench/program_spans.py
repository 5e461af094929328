"""What the `program_span` readers read: the program's own spans
(robust_cvd_tpu_torch/utils/spans.py), the last of a name with their
children, from the process's ring. A checkout whose program has no spans
module, or a ring that holds too few spans, gives nothing to read."""

from __future__ import annotations

from typing import List, Optional


def recent(name: str, n: int) -> Optional[List[dict]]:
    """The last `n` spans named `name`, oldest first, or None where the
    ring holds fewer (or the program keeps no spans)."""
    if n <= 0:
        return None
    try:
        from robust_cvd_tpu_torch.utils import spans
    except ImportError:
        return None
    got = spans.recent(name, n)
    return got if len(got) == n else None


def ns_in(tree: dict, name: str) -> int:
    """Nanoseconds of the spans named `name` inside `tree` (its
    descendants, at any depth)."""
    return sum((c["t1_ns"] - c["t0_ns"] if c["name"] == name else 0) + ns_in(c, name)
               for c in tree["children"])


def pace_steps(run) -> Optional[List[dict]]:
    """The `train.step` spans of a traced run's untraced pace block: the
    first `pace.units` of the last `pace.units + units` steps (the pace
    block runs just before the traced steps, and nothing after the window
    takes a step)."""
    pace = run.get("pace")
    if not pace or not pace["units"] or not run.get("units"):
        return None
    steps = recent("train.step", pace["units"] + run["units"])
    return None if steps is None else steps[: pace["units"]]


def phase_ms_per_step(run, name: str) -> Optional[float]:
    """Mean host milliseconds a pace-block step spends in the span `name`."""
    steps = pace_steps(run)
    if steps is None:
        return None
    return sum(ns_in(s, name) for s in steps) / 1e6 / len(steps)


def flow_iters(run) -> Optional[List[dict]]:
    """The `flow.iter` spans of the run's last `units` chunks: the window's
    (nothing after the window computes flow)."""
    return recent("flow.iter", run.get("units") or 0)


def flow_ms(run, name: str, per: str) -> Optional[float]:
    """Host milliseconds in the span `name` over the window's chunks, a
    pair (`per="pair"`) or a chunk (`per="chunk"`)."""
    iters = flow_iters(run)
    if iters is None:
        return None
    total = sum(ns_in(it, name) for it in iters) / 1e6
    if per == "chunk":
        return total / len(iters)
    pairs = sum(it["attrs"].get("pairs", 0) for it in iters)
    return total / pairs if pairs else None
