"""A CUDA graph of the fine-tune train step.

On a card without a data mesh, FineTuner.train_step runs through a
StepGraph: the whole step of fine_tune.step_phases, from zero_grad through
commit_batch_stats (the batch gathers, the train-mode forward, joint_loss,
the backward, the non-finite guard and the Adam kernel, the BatchNorm
commit), captured once per batch size into a torch.cuda.CUDAGraph and
replayed on every later step of that size. The host then enqueues one
graph launch a step instead of each of the step's kernels in turn. The
graph runs the eager step's kernels in the eager step's order.

What a replay reads:
- static inputs the StepGraph owns: a `batch_ids` buffer of each batch
  size, into which every call copies the caller's ids, and a copy of the
  PoseState, refreshed by a copy whenever the caller's pose tensors are
  other tensors than those last copied (FineTuner.optimize_poses makes new
  ones after every solve);
- by address: the clip's tensors, the optimizer's flat buffers (the net's
  parameters and gradients are views of them, which `check_aliasing`
  verifies on every call) and the net's BatchNorm statistics. An in-place
  `copy_` or `zero_` of any of them is seen by the next replay.
What a copy cannot refresh is read on the host, without a sync, on every
call: the clip's tensors' addresses, shapes and strides, the pose state's
shapes, the optimizer buffers' addresses, the float32 precision settings
(device.float32_precision), the learning rate, the loss parameters and
whether the temporal losses are on. A change drops every graph with their
pool, and the following calls capture anew.

Capture follows torch.cuda.graphs' rules: the first `warmup` calls of a
batch size run the step eagerly on the StepGraph's side stream (lazy
initialisation, cuDNN and cuBLAS workspaces), then the next call captures
it on that stream into the one memory pool that all the StepGraph's
graphs share, and replays the graph once, since capturing executes
nothing: every call takes exactly one step. Graphs of different batch
sizes may share the pool because they run one at a time on one stream and
each keeps its outputs for good. A call returns fresh tensors, clones of
the graph's outputs made on the card without a sync, so that a caller may
keep every step's values until one readback.

The Adam kernel's launch counters (ops/adam.py) advance on a replay by the
launches that the graph holds, as they would eagerly.

Spans (utils/spans.py): every call is `train.step` > `train.batch` (the
copies into the static inputs); a replayed call then has `train.replay`
(attr `batch`, the batch size); a capturing call has the step's phase
spans inside `train.capture`, then its `train.replay`; a warm-up call has
the phase spans themselves.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict

import torch

from ..ops import adam
from ..utils.spans import span

WARMUP_STEPS = 3  # eager calls of a batch size before its capture


def graphable(device: torch.device, mesh) -> bool:
    """Whether a FineTuner's train step runs through a StepGraph: on a
    card and without a data mesh, whose all-reduces stay eager."""
    return device.type == "cuda" and mesh is None


def _count_adam_launches(launched: Dict[str, int], sign: int) -> None:
    for mode, n in launched.items():
        adam.adam_update.launches += sign * n
        adam.adam_update.launches_by_mode[mode] += sign * n


class StepGraph:
    """Captures and replays `step(loss_opt, batch_ids, clip, ps,
    use_temporal) -> (loss, parts, ok)` (fine_tune.step_phases bound to a
    net and its FlatAdam `optimizer`). `stats` counts the calls run
    eagerly, the captures, the replays and the copies into the static pose
    state."""

    def __init__(self, step: Callable, optimizer, warmup: int = WARMUP_STEPS):
        self.step = step
        self.optimizer = optimizer
        self.warmup = warmup
        self.device = optimizer.flat.device
        self.stats = {"eager": 0, "captures": 0, "replays": 0, "pose_copies": 0}
        self._stream = None
        self._drop()

    def _drop(self) -> None:
        """Forget every graph, its pool and the static inputs."""
        self.graphs: Dict[int, tuple] = {}  # batch size -> (graph, outputs, launches)
        self.warm: Dict[int, int] = {}  # batch size -> eager calls so far
        self.ids: Dict[int, torch.Tensor] = {}  # batch size -> static batch_ids
        self.pose = None
        self._pose_refs = ()
        self._pool = None
        self._inputs = None

    def _observed(self, loss_opt, clip, ps, use_temporal) -> tuple:
        """What a replay cannot follow by a copy, read on the host."""
        opt = self.optimizer
        return (
            tuple(None if t is None else (t.data_ptr(), t.shape, t.stride(), t.dtype)
                  for t in clip),
            tuple((t.shape, t.dtype) for t in ps),
            tuple(t.data_ptr() for t in (opt.flat, opt.grad, opt.mu, opt.nu, opt.count)),
            torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32,
            opt.lr, loss_opt, use_temporal,
        )

    def __call__(self, loss_opt, batch_ids: torch.Tensor, clip, ps, use_temporal: bool):
        self.optimizer.check_aliasing()
        inputs = self._observed(loss_opt, clip, ps, use_temporal)
        if inputs != self._inputs:
            self._drop()
            self._inputs = inputs
        b = int(batch_ids.shape[0])
        with span("train.step"):
            with span("train.batch"):
                ids = self.ids.get(b)
                if ids is None:
                    ids = self.ids[b] = torch.empty(
                        batch_ids.shape, dtype=batch_ids.dtype, device=self.device)
                ids.copy_(batch_ids)
                pose = self._static_pose(ps)
            entry = self.graphs.get(b)
            if entry is None:
                if self.warm.get(b, 0) < self.warmup:
                    self.warm[b] = self.warm.get(b, 0) + 1
                    self.stats["eager"] += 1
                    with self._side():
                        return self.step(loss_opt, ids, clip, pose, use_temporal)
                entry = self.graphs[b] = self._capture_step(
                    lambda: self.step(loss_opt, ids, clip, pose, use_temporal))
            with span("train.replay", batch=b):
                return self._replay(entry)

    def _static_pose(self, ps):
        """The static copy of the pose state, refreshed where `ps` holds
        other tensors than those last copied."""
        if self.pose is None:
            self.pose = type(ps)(*(t.clone() for t in ps))
        elif any(r() is not t for r, t in zip(self._pose_refs, ps)):
            for s, t in zip(self.pose, ps):
                s.copy_(t)
        else:
            return self.pose
        self.stats["pose_copies"] += 1
        self._pose_refs = tuple(weakref.ref(t) for t in ps)
        return self.pose

    def _side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    @contextlib.contextmanager
    def _side(self):
        """The block on the side stream, after the caller's stream's work
        so far and before its next."""
        main, side = torch.cuda.current_stream(self.device), self._side_stream()
        side.wait_stream(main)
        try:
            with torch.cuda.stream(side):
                yield
        finally:
            main.wait_stream(side)

    def _capture(self, fn):
        """(graph, fn's outputs) of `fn` captured on the side stream into
        the shared pool."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._side_stream()):
            out = fn()
        return graph, out

    def _capture_step(self, fn) -> tuple:
        before = dict(adam.adam_update.launches_by_mode)
        with span("train.capture"):
            graph, out = self._capture(fn)
        launched = {m: n - before[m] for m, n in adam.adam_update.launches_by_mode.items()
                    if n != before[m]}
        _count_adam_launches(launched, -1)  # the capture launched nothing
        self.stats["captures"] += 1
        return graph, out, launched

    def _replay(self, entry):
        graph, (loss, parts, ok), launched = entry
        graph.replay()
        _count_adam_launches(launched, 1)
        self.stats["replays"] += 1
        return loss.clone(), {k: v.clone() for k, v in parts.items()}, ok.clone()
