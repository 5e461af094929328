"""Spans: named, nested host-clock intervals of the port's own work, on
the clock of the device trace.

    from robust_cvd_tpu_torch.utils.spans import span

    with span("flow.iter", pairs=16) as sp:
        ...
    sp.seconds  # once the block has left

A span reads `time.time_ns()` on entry and on exit: Unix-epoch
nanoseconds, the clock torch.profiler's kineto stamps its events with, so
a span lines up with a trace of the same process. On exit it appends
`(id, parent id, name, t0_ns, t1_ns, attrs)` to a bounded ring (the
process's last RING_SIZE spans) and adds to the per-name totals. Its
parent is the innermost span open on the same thread. Only while a
profiler is recording does it also enter a RecordFunction of its name
(`torch._C._profiler._RecordFunctionFast`, which enters no dispatcher op:
a tenth of `torch.profiler.record_function`'s cost), so that the
profiler's host events carry it; otherwise it costs about a microsecond.
A span reads the host clock only: it never synchronizes the device.

Readers: `recent(name, n)`, the last `n` spans of a name with their
children; `totals()`, count and nanoseconds by name.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, Tuple

import torch

RING_SIZE = 1 << 16

# (id, parent id or None, name, t0_ns, t1_ns, attrs), in the order the
# spans ended: a span's children come before it, siblings in start order
_ring: collections.deque = collections.deque(maxlen=RING_SIZE)
_ids = itertools.count(1)
_local = threading.local()  # .thread: the calling thread's _Thread
_threads: List["_Thread"] = []  # every thread's, for totals()
_threads_lock = threading.Lock()
_profiling = torch._C._autograd._profiler_enabled
_record_function = torch._C._profiler._RecordFunctionFast
_now = time.time_ns


class _Thread:
    """A thread's open spans (their ids, innermost last) and its totals
    (name -> [count, ns]); only the thread itself writes them."""

    __slots__ = ("stack", "totals")

    def __init__(self):
        self.stack: List[int] = []
        self.totals: Dict[str, List[int]] = {}
        with _threads_lock:
            _threads.append(self)
        _local.thread = self


class span:
    """`with span(name, **attrs) as sp:` times its block as the span
    `name`; `attrs` are kept with it (e.g. `pairs=16`), and `sp.seconds`
    is its length once it has ended."""

    __slots__ = ("name", "attrs", "id", "parent", "t0_ns", "t1_ns", "_thread", "_rf")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "span":
        try:
            th = self._thread = _local.thread
        except AttributeError:
            th = self._thread = _Thread()
        stack = th.stack
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        if _profiling():
            self._rf = _record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self.t0_ns = _now()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self.t1_ns = _now()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        th = self._thread
        th.stack.pop()
        _ring.append((self.id, self.parent, self.name, self.t0_ns, t1, self.attrs))
        tot = th.totals.get(self.name)
        if tot is None:
            th.totals[self.name] = [1, t1 - self.t0_ns]
        else:
            tot[0] += 1
            tot[1] += t1 - self.t0_ns
        return False

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


def recent(name: str, n: int) -> List[dict]:
    """The last `n` spans named `name` still in the ring, oldest first;
    fewer where the ring holds fewer. Each is a dict of `id`, `parent`,
    `name`, `t0_ns`, `t1_ns`, `attrs` and `children`: the spans it
    enclosed on its thread, in order, each with its own children."""
    if n <= 0:
        return []
    ring = list(_ring)
    picked = [r for r in ring if r[2] == name][-n:]
    kids: Dict[int, list] = {}
    for r in ring:
        if r[1] is not None:
            kids.setdefault(r[1], []).append(r)

    def tree(r):
        return {"id": r[0], "parent": r[1], "name": r[2], "t0_ns": r[3], "t1_ns": r[4],
                "attrs": r[5], "children": [tree(c) for c in kids.get(r[0], ())]}

    return [tree(r) for r in picked]


def totals() -> Dict[str, Tuple[int, int]]:
    """(count, nanoseconds) of every span name the process has ended, over
    all its threads."""
    out: Dict[str, Tuple[int, int]] = {}
    with _threads_lock:
        threads = list(_threads)
    for th in threads:
        for k, (c, ns) in list(th.totals.items()):
            c0, ns0 = out.get(k, (0, 0))
            out[k] = (c0 + c, ns0 + ns)
    return out
