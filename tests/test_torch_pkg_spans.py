"""The port's spans (robust_cvd_tpu_torch/utils/spans.py): nesting and
parent ids, the ring's bound, the totals, no record_function without a
profiler, the profiler's host events on the spans' clock, and the spans a
train step and the flow stage leave, and the CPU rehearsal of
tools/spans_cuda.py."""

import importlib.util
import itertools
import json
import os
import threading
from os.path import join as pjoin

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from robust_cvd_tpu_torch import config as tconfig
from robust_cvd_tpu_torch.io.frames import save_frames_txt
from robust_cvd_tpu_torch.io.store import VideoStore, frame_name, save_png_color
from robust_cvd_tpu_torch.models import midas as tm
from robust_cvd_tpu_torch.models import raft as tr
from robust_cvd_tpu_torch.pipeline.flow import FlowStage
from robust_cvd_tpu_torch.pipeline.video import VideoStage
from robust_cvd_tpu_torch.solver.residuals import SolverParams
from robust_cvd_tpu_torch.training import fine_tune as tft
from robust_cvd_tpu_torch.training.optimizer import FlatAdam
from robust_cvd_tpu_torch.utils import spans
from robust_cvd_tpu_torch.utils.spans import recent, span, totals

from torch_pkg_threads import one_torch_thread  # noqa: F401

_names = itertools.count()


def _name(tag):
    """A span name no other test of the process uses."""
    return f"test.{tag}.{os.getpid()}.{next(_names)}"


def test_spans_nest_with_parent_ids():
    outer, a, b, c = (_name(t) for t in "oabc")
    with span(outer, pairs=3) as o:
        with span(a) as sa:
            pass
        with span(b):
            with span(c):
                pass
    [tree] = recent(outer, 1)
    assert tree["id"] == o.id and tree["parent"] is None and tree["attrs"] == {"pairs": 3}
    assert [k["name"] for k in tree["children"]] == [a, b]
    assert [k["parent"] for k in tree["children"]] == [o.id, o.id]
    assert tree["children"][0]["id"] == sa.id
    [inner] = tree["children"][1]["children"]
    assert inner["name"] == c and inner["parent"] == tree["children"][1]["id"]
    assert tree["t0_ns"] <= tree["children"][0]["t0_ns"] <= tree["children"][0]["t1_ns"] \
        <= tree["children"][1]["t0_ns"] <= inner["t0_ns"] <= inner["t1_ns"] <= tree["t1_ns"]
    assert o.seconds == (tree["t1_ns"] - tree["t0_ns"]) / 1e9 and sa.seconds >= 0


def test_a_span_on_another_thread_has_no_parent_there():
    outer, other = _name("o"), _name("t")
    with span(outer) as o:
        t = threading.Thread(target=lambda: span(other).__enter__().__exit__(None, None, None))
        t.start()
        t.join()
    assert recent(other, 1)[0]["parent"] is None
    assert recent(outer, 1)[0]["children"] == [] and o.seconds >= 0


def test_the_ring_keeps_the_last_spans_only():
    assert spans.RING_SIZE >= 65536
    name = _name("ring")
    for k in range(spans.RING_SIZE + 10):
        with span(name, k=k):
            pass
    assert len(spans._ring) == spans.RING_SIZE
    got = recent(name, spans.RING_SIZE + 10)
    assert len(got) == spans.RING_SIZE
    assert got[0]["attrs"]["k"] == 10 and got[-1]["attrs"]["k"] == spans.RING_SIZE + 9
    assert [r["attrs"]["k"] for r in recent(name, 3)] == [spans.RING_SIZE + 7,
                                                           spans.RING_SIZE + 8,
                                                           spans.RING_SIZE + 9]
    assert recent(name, 0) == [] and recent(_name("none"), 5) == []


def test_totals_count_and_sum_every_span():
    name = _name("tot")
    sec = []
    for _ in range(5):
        with span(name) as s:
            pass
        sec.append(s.t1_ns - s.t0_ns)

    def worker():
        with span(name):
            pass

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    count, ns = totals()[name]
    assert count == 8 and ns >= sum(sec)
    assert ns == sum(r["t1_ns"] - r["t0_ns"] for r in recent(name, 8))


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []
    real = spans._record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(spans, "_record_function", counting)
    name = _name("rf")
    assert not torch._C._autograd._profiler_enabled()
    with span(name):
        pass
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with span(name):
            pass
    assert entered == [name]


def test_the_profilers_host_events_carry_the_spans_on_their_clock():
    """kineto stamps its events in Unix-epoch nanoseconds, the spans'
    clock: each span's event starts and ends within 1 ms of the ring's."""
    outer, inner = _name("p"), _name("q")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with span(outer):
                with span(inner):
                    torch.ones(64).sum()
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU and e.name() in (outer, inner):
            events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    for name in (outer, inner):
        ring = [(r["t0_ns"], r["t1_ns"]) for r in recent(name, 3)]
        got = sorted(events[name])
        assert len(got) == 3
        for (s, e), (t0, t1) in zip(got, ring):
            assert abs(s - t0) < 1_000_000 and abs(e - t1) < 1_000_000


N, H, W = 4, 32, 64


def _tiny_step_inputs():
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (N, H, W, 3)).astype(np.float32)
    depth = rng.uniform(1, 3, (N, H, W)).astype(np.float32)
    flow_list, flows, masks = [], {}, {}
    for i in range(N):
        for j in range(N):
            if i != j and abs(i - j) <= 2:
                flow_list.append((i, j, 0.9))
                flows[(i, j)] = rng.normal(0, 1.0, (H, W, 2)).astype(np.float32)
                masks[(i, j)] = (rng.uniform(0, 1, (H, W)) > 0.3).astype(np.float32)
    clip = tft.build_clip_data(images, depth, flow_list, flows, masks, 0.2, device="cpu")
    sp = SolverParams(
        pose=torch.from_numpy(rng.normal(0, 0.02, (N, 6)).astype(np.float32)),
        focal=torch.full((N,), 0.5),
        depth_grid=torch.from_numpy(rng.uniform(0.8, 1.2, (N, 1, 2, 3)).astype(np.float32)),
        spatial_grid=torch.from_numpy(rng.normal(0, 0.01, (N, 1, 1, 2)).astype(np.float32)),
    )
    return clip, tft.pose_state_from_solver(sp, (H, W), W / H, clip.depth_orig)


def test_a_train_step_leaves_its_span_and_five_phases_in_order():
    clip, ps = _tiny_step_inputs()
    net = tm.seeded_init_(tm.MidasNet(features=32, backbone_layers=(1, 1, 1, 1)), 0)
    opt = FlatAdam(list(net.named_parameters()), 1e-4)
    before = totals().get("train.step", (0, 0))[0]
    loss, _, ok = tft.train_step(net, opt, tconfig.LossParams(), torch.tensor([0, 1]), clip, ps,
                                 False)
    assert torch.isfinite(loss) and bool(ok)
    assert totals()["train.step"][0] == before + 1
    [step] = recent("train.step", 1)
    assert [k["name"] for k in step["children"]] == [
        "train.batch", "train.forward", "train.loss", "train.backward", "train.optimizer"]
    assert all(k["parent"] == step["id"] for k in step["children"])
    ends = [step["t0_ns"]] + [t for k in step["children"] for t in (k["t0_ns"], k["t1_ns"])]
    assert ends == sorted(ends) and ends[-1] <= step["t1_ns"]


def _flow_clip(base, n=N):
    rng = np.random.default_rng(4)
    noise = rng.uniform(0, 1, (H + 2, W + 2 * n + 2, 3)).astype(np.float32)
    tex = sum(noise[dy:dy + H, dx:dx + W + 2 * n] for dy in range(3) for dx in range(3)) / 9.0
    os.makedirs(pjoin(base, "color_full"))
    for i in range(n):
        save_png_color(pjoin(base, "color_full", frame_name(i, ".png")), tex[:, 2 * i:2 * i + W])
    save_frames_txt(pjoin(base, "frames.txt"), W, H, [i / 30 for i in range(n)])
    video = VideoStage(base)
    video.downscale_frames("color_down", 32, ".raw", align=8)
    video.downscale_frames("color_flow", 64, ".png", align=8)


def test_compute_flow_leaves_one_flow_iter_a_chunk(tmp_path):
    base = str(tmp_path / "clip")
    _flow_clip(base)
    net = tr.seeded_init_(tr.RAFT(iters=2, dtype=torch.float32), 0)
    stage = FlowStage(VideoStore.open(base), net, batch_size=2, device="cpu")
    pairs = stage.sample_index_pairs(("hierarchical2",), N)
    chunks = (len(pairs) + 1) // 2
    before = totals().get("flow.iter", (0, 0))[0]
    stage.compute_flow(pairs)
    assert totals()["flow.iter"][0] == before + chunks
    iters = recent("flow.iter", chunks)
    assert [it["attrs"] for it in iters] == [{"pairs": len(pairs[s:s + 2])}
                                             for s in range(0, len(pairs), 2)]
    for it in iters:
        load, chunk, write = it["children"]
        assert [load["name"], chunk["name"], write["name"]] == [
            "flow.load", "flow.chunk", "flow.write"]
        assert [k["name"] for k in load["children"]] == ["flow.decode", "flow.upload"]
        assert [k["name"] for k in chunk["children"]] == [
            "flow.register", "flow.raft", "flow.postproc", "flow.readback"]
        raft = chunk["children"][1]
        assert [k["name"] for k in raft["children"]] == ["raft.lookup_corr"] * 2
    assert set(stage.stats) == {"load_s", "chunk_s", "write_s"}

    def total(k):
        return sum(c["t1_ns"] - c["t0_ns"] for it in iters for c in it["children"]
                   if c["name"] == k) / 1e9

    for key, name in (("load_s", "flow.load"), ("chunk_s", "flow.chunk"),
                      ("write_s", "flow.write")):
        assert stage.stats[key] == pytest.approx(total(name), rel=1e-12, abs=1e-12)


def test_the_span_tool_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """tools/spans_cuda.py at the CPU tests' sizes: a span's cost read
    three ways, and the flow cell's traced window with its spans in the
    ring, among the profiler's host events, and written out."""
    path = pjoin(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                 "spans_cuda.py")
    spec = importlib.util.spec_from_file_location("spans_cuda", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cost = tool.span_cost("cpu")
    assert set(cost) == {"off_ns", "loop_ns", "on_device_only_ns", "on_cpu_and_device_ns"}
    assert 0 < cost["loop_ns"] < cost["off_ns"] < cost["on_device_only_ns"]
    out = str(tmp_path / "out")
    res = tool.traced_cell("flow", 7, "cpu", True, out)
    names = {"flow.iter", "flow.load", "flow.decode", "flow.upload", "flow.chunk", "flow.register",
             "flow.raft", "raft.lookup_corr", "flow.postproc", "flow.readback", "flow.write"}
    assert set(res["spans_in_kineto"]) == names and res["spans_not_in_kineto"] == []
    assert res["spans_per_flow.iter"] == 10 + 20  # RAFT's 20 iterations
    ring = json.load(open(pjoin(out, "flow_ring.json")))
    assert len(ring) == res["ring_spans"] == 30 * res["units"]
    assert os.path.getsize(pjoin(out, "flow_trace.json.gz")) > 0
