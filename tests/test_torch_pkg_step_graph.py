"""The CUDA graph of the fine-tune train step (training/step_graph.py).

On the CPU:
- the routing: a FineTuner on the CPU or on a data mesh has no step graph
  and its steps are the eager train_step, with no `train.replay` span;
- the StepGraph's own decisions, with the capture primitive stubbed by
  `CPUStepGraph`: its "capture" runs the step once and puts the state back
  (a capture executes nothing), its "replay" runs the step again and
  writes the outputs into the captured ones, as a graph's replay does. So
  a stubbed run must equal the eager run bit for bit; successive calls
  return distinct tensors; a pose-state swap refreshes the static copies
  without a capture; a new clip tensor, learning rate, precision setting or
  batch size captures anew.
On the card (skipped without one): the graphed FineTuner against the eager
train_step, chip_smoke.py's step_graph_check.
"""

import contextlib
import dataclasses
import functools

import pytest
import torch

import chip_smoke
from robust_cvd_tpu_torch.parallel import mesh as tmesh
from robust_cvd_tpu_torch.training import fine_tune, step_graph
from robust_cvd_tpu_torch.utils import spans
from torch_pkg_threads import one_torch_thread  # noqa: F401  (autouse)

SEED = 3


class FakeGraph:
    """torch.cuda.CUDAGraph's part on the CPU: `replay` runs the captured
    function again and copies its outputs into the captured outputs."""

    def __init__(self, fn, out):
        self.fn = fn
        self.out = out

    def replay(self):
        loss, parts, ok = self.fn()
        self.out[0].copy_(loss)
        for k, v in parts.items():
            self.out[1][k].copy_(v)
        self.out[2].copy_(ok)


class CPUStepGraph(step_graph.StepGraph):
    """A StepGraph with the card's primitives stubbed: no side stream, and
    a capture that leaves `state` (every tensor a step writes) as it was."""

    state = ()

    def _side(self):
        return contextlib.nullcontext()

    def _capture(self, fn):
        saved = [t.clone() for t in self.state]
        out = fn()
        for t, s in zip(self.state, saved):
            t.copy_(s)
        return FakeGraph(fn, out), out


def stubbed(tuner, warmup=1):
    """`tuner` with a CPUStepGraph."""
    opt = tuner.optimizer
    g = CPUStepGraph(functools.partial(fine_tune.step_phases, tuner.net, opt), opt,
                     warmup=warmup)
    g.state = [opt.flat, opt.grad, opt.mu, opt.nu, opt.count, *tuner.net.buffers()]
    tuner.step_graph = g
    return tuner


def ids(*pairs):
    return torch.tensor(pairs)


def test_graphable_only_on_a_card_without_a_mesh():
    mesh = tmesh.Mesh(0, 2, torch.device("cuda"))
    assert step_graph.graphable(torch.device("cuda"), None)
    assert not step_graph.graphable(torch.device("cuda"), mesh)
    assert not step_graph.graphable(torch.device("cpu"), None)


def _step_children():
    return [c["name"] for c in spans.recent("train.step", 1)[0]["children"]]


def test_cpu_tuner_steps_eagerly():
    tuner = chip_smoke.small_tuner("cpu", SEED)
    assert tuner.step_graph is None
    for _ in range(3):
        tuner.train_step(ids(0, 1))
    assert _step_children() == ["train.batch", "train.forward", "train.loss",
                                "train.backward", "train.optimizer"]


def test_mesh_tuner_steps_eagerly(tmp_path):
    mesh = tmesh.init_mesh(backend="gloo", device="cpu", init_method=f"file://{tmp_path}/s",
                           rank=0, world_size=1)
    try:
        tuner = chip_smoke.small_tuner("cpu", SEED, mesh=mesh)
        assert tuner.step_graph is None
        for _ in range(2):
            tuner.train_step(ids(0, 1))
        assert "train.replay" not in _step_children()
        assert mesh.stats["collectives"] > 0
    finally:
        tmesh.destroy_mesh()


def test_stubbed_graph_equals_the_eager_steps_bitwise():
    """chip_smoke's step sequence (both batch sizes captured and replayed,
    a pose swap between): every loss and the final state equal the eager
    run's bit for bit on the CPU."""
    eager = chip_smoke.graph_steps(chip_smoke.small_tuner("cpu", SEED), "cpu")
    tuner = stubbed(chip_smoke.small_tuner("cpu", SEED))
    graphed = chip_smoke.graph_steps(tuner, "cpu")
    assert tuner.step_graph.stats == {"eager": 2, "captures": 2, "replays": 4,
                                      "pose_copies": 2}
    for name, want in eager.items():
        assert torch.equal(graphed[name], want), name


def test_successive_calls_return_distinct_tensors():
    eager_tuner = chip_smoke.small_tuner("cpu", SEED)
    tuner = stubbed(chip_smoke.small_tuner("cpu", SEED))
    outs, want = [], []
    for k in range(5):
        step = ids(k % 5, (k + 2) % 5)
        want.append(eager_tuner.train_step(step))
        outs.append(tuner.train_step(step))
    assert tuner.step_graph.stats["replays"] == 4
    kept = [t for loss, parts, ok in outs[1:] for t in (loss, ok, *parts.values())]
    assert len({t.data_ptr() for t in kept}) == len(kept)
    for (loss, parts, ok), (l0, p0, o0) in zip(outs, want):
        assert torch.equal(loss, l0) and torch.equal(ok, o0)
        assert parts.keys() == p0.keys()
        assert all(torch.equal(parts[k], p0[k]) for k in parts)
    assert len({float(loss) for loss, _, _ in outs}) == len(outs)
    assert _step_children() == ["train.batch", "train.replay"]
    assert spans.recent("train.replay", 1)[0]["attrs"] == {"batch": 2}


def test_a_pose_swap_refreshes_the_static_copies():
    tuner = stubbed(chip_smoke.small_tuner("cpu", SEED))
    g = tuner.step_graph
    for _ in range(3):
        tuner.train_step(ids(0, 1))
    assert (g.stats["captures"], g.stats["pose_copies"]) == (1, 1)
    ps = tuner.pose_state
    tuner.pose_state = ps._replace(scales=ps.scales * 2.0, warp=ps.warp + 0.1)
    tuner.train_step(ids(0, 1))
    assert (g.stats["captures"], g.stats["pose_copies"]) == (1, 2)
    for static, new in zip(g.pose, tuner.pose_state):
        assert torch.equal(static, new) and static is not new
    tuner.train_step(ids(0, 1))  # the same pose tensors: no copy
    assert (g.stats["captures"], g.stats["pose_copies"], g.stats["replays"]) == (1, 2, 4)


def _change(tuner, what):
    if what == "clip":
        tuner.clip = tuner.clip._replace(images=tuner.clip.images.clone())
    elif what == "lr":
        tuner.optimizer.lr *= 2
    elif what == "loss":
        loss = tuner.cfg.loss
        loss = dataclasses.replace(
            loss, lambda_static_reprojection=2 * loss.lambda_static_reprojection)
        tuner.cfg = dataclasses.replace(tuner.cfg, loss=loss)
    elif what == "precision":
        tuner.cudnn_tf32 = not tuner.cudnn_tf32


@pytest.mark.parametrize("what", ["clip", "lr", "loss", "precision"])
def test_what_a_copy_cannot_refresh_captures_anew(what):
    tuner = stubbed(chip_smoke.small_tuner("cpu", SEED))
    g = tuner.step_graph
    for _ in range(3):
        tuner.train_step(ids(0, 1))
    assert g.stats == {"eager": 1, "captures": 1, "replays": 2, "pose_copies": 1}
    _change(tuner, what)
    for _ in range(3):
        tuner.train_step(ids(0, 1))
    # the graphs are dropped: a warm-up call, a capture and a replay again
    assert g.stats == {"eager": 2, "captures": 2, "replays": 4, "pose_copies": 2}
    assert list(g.graphs) == [2]


def test_each_batch_size_has_its_graph():
    tuner = stubbed(chip_smoke.small_tuner("cpu", SEED))
    g = tuner.step_graph
    for step in (ids(0, 1), ids(2), ids(3, 4), ids(1), ids(2, 0), ids(4)):
        tuner.train_step(step)
    assert sorted(g.graphs) == [1, 2] and sorted(g.ids) == [1, 2]
    assert g.stats == {"eager": 2, "captures": 2, "replays": 4, "pose_copies": 1}


def test_warm_up_calls_run_the_phases():
    tuner = stubbed(chip_smoke.small_tuner("cpu", SEED), warmup=step_graph.WARMUP_STEPS)
    for k in range(step_graph.WARMUP_STEPS):
        tuner.train_step(ids(0, 1))
        assert _step_children() == ["train.batch", "train.batch", "train.forward",
                                    "train.loss", "train.backward", "train.optimizer"]
    tuner.train_step(ids(0, 1))
    assert _step_children() == ["train.batch", "train.capture", "train.replay"]
    capture = spans.recent("train.capture", 1)[0]
    assert [c["name"] for c in capture["children"]] == [
        "train.batch", "train.forward", "train.loss", "train.backward", "train.optimizer"]


@pytest.mark.cuda
def test_graph_matches_eager_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    report = chip_smoke.step_graph_check(SEED)
    assert all(gap <= (chip_smoke.GRAPH_TOL[k] if spread else 0.0)
               for k, (gap, spread) in report.items())
