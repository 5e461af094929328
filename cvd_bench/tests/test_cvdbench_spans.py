"""The `program_span` readers: each reads the program's spans of the
window it names (the train cell's untraced pace block, the flow cell's
traced chunks), gives nothing where the ring holds too few spans or the
program keeps none, and agrees in a tiny traced run on the CPU with the
numbers the stages count themselves."""

import sys
import time

import pytest

from conftest import ROOT, tiny_config, tiny_mix

from cvd_bench import core

TRAIN = ("train.forward_host_ms", "train.loss_host_ms", "train.backward_host_ms",
         "train.optimizer_host_ms")
FLOW = ("flow.decode_ms", "flow.upload_ms", "flow.readback_ms", "flow.write_ms")
PHASES = ("train.batch", "train.forward", "train.loss", "train.backward", "train.optimizer")
MS = 1_000_000


class Ring:
    """Span records as the program's ring holds them: (id, parent, name,
    t0_ns, t1_ns, attrs), children before their parent."""

    def __init__(self):
        self.records = []
        self.ids = 0
        self.t = 0

    def add(self, name, ms, children=(), **attrs):
        """A span of `ms` milliseconds after its `children`, each (name,
        ms, grandchildren)."""
        self.ids += 1
        me, t0 = self.ids, self.t
        for c_name, c_ms, grand in children:
            self._child(me, c_name, c_ms, grand)
        self.t = max(self.t, t0 + int(ms * MS))
        self.records.append((me, None, name, t0, self.t, attrs))

    def _child(self, parent, name, ms, grand):
        self.ids += 1
        me, t0 = self.ids, self.t
        for g_name, g_ms, gg in grand:
            self._child(me, g_name, g_ms, gg)
        self.t = max(self.t, t0 + int(ms * MS))
        self.records.append((me, parent, name, t0, self.t, {}))


@pytest.fixture
def ring(monkeypatch):
    from robust_cvd_tpu_torch.utils import spans

    r = Ring()
    monkeypatch.setattr(spans, "_ring", r.records)
    return r


def _step(ring, phase_ms):
    ring.add("train.step", sum(phase_ms) + 1,
             [(n, ms, ()) for n, ms in zip(PHASES, phase_ms)])


def test_the_train_readers_take_the_pace_block(ring):
    """Warm-up steps, then the pace block, then the traced steps: only the
    pace block's steps count."""
    for _ in range(5):  # warm-up
        _step(ring, (9, 90, 90, 90, 90))
    for k in range(4):  # pace
        _step(ring, (0.5, 10 + k, 4, 12, 2))
    for _ in range(2):  # traced
        _step(ring, (9, 70, 70, 70, 70))
    run = {"pace": {"units": 4, "seconds": 0.2}, "units": 2}
    got = {m: core.read_metric(m, run) for m in TRAIN}
    assert got == pytest.approx({"train.forward_host_ms": 11.5, "train.loss_host_ms": 4.0,
                                 "train.backward_host_ms": 12.0,
                                 "train.optimizer_host_ms": 2.0})


def test_the_train_readers_need_the_whole_window(ring):
    for _ in range(5):
        _step(ring, (1, 1, 1, 1, 1))
    assert core.read_metric(TRAIN[0], {"pace": {"units": 4, "seconds": 1}, "units": 2}) is None
    assert core.read_metric(TRAIN[0], {"pace": None, "units": 2}) is None
    assert core.read_metric(TRAIN[0], {"units": 2}) is None


def _chunk(ring, pairs, decode, upload, device, readback, write):
    ring.add("flow.iter", decode + upload + device + readback + write, [
        ("flow.load", decode + upload, [("flow.decode", decode, ()),
                                        ("flow.upload", upload, ())]),
        ("flow.chunk", device + readback, [("flow.register", device / 3, ()),
                                           ("flow.raft", device / 3,
                                            [("raft.lookup_corr", 0.01, ())] * 20),
                                           ("flow.postproc", device / 3, ()),
                                           ("flow.readback", readback, ())]),
        ("flow.write", write, ())], pairs=pairs)


def test_the_flow_readers_take_the_traced_chunks(ring):
    _chunk(ring, 16, 5000, 500, 50, 500, 500)  # the warm-up chunk
    _chunk(ring, 16, 1600, 80, 10, 240, 32)
    _chunk(ring, 8, 800, 40, 10, 200, 16)
    run = {"units": 2, "trace": {}}
    got = {m: core.read_metric(m, run) for m in FLOW}
    assert got == pytest.approx({"flow.decode_ms": 100.0, "flow.upload_ms": 5.0,
                                 "flow.readback_ms": 220.0, "flow.write_ms": 2.0})


@pytest.mark.parametrize("metric", TRAIN + FLOW)
def test_a_reader_gives_nothing_on_an_empty_ring(metric, ring):
    run = {"pace": {"units": 3, "seconds": 1.0}, "units": 6, "trace": {}}
    assert core.read_metric(metric, run) is None


@pytest.mark.parametrize("metric", TRAIN + FLOW)
def test_a_reader_gives_nothing_where_the_program_keeps_no_spans(metric, monkeypatch):
    """A program from before the spans module: the import fails, the
    reader returns None and does not raise."""
    monkeypatch.setitem(sys.modules, "robust_cvd_tpu_torch.utils.spans", None)
    run = {"pace": {"units": 3, "seconds": 1.0}, "units": 6, "trace": {}}
    assert core.read_metric(metric, run) is None


def test_a_traced_train_run_reports_the_four_phases(tmp_path, monkeypatch):
    """The four phases, each inside the pace block's steps, sum to no more
    than the block's host-clock step."""
    runs = []
    read = core.read_metric
    monkeypatch.setattr(core, "read_metric", lambda name, run: runs.append(run) or read(name, run))
    res = core.run_cell("midas_v2-384.train", 2**33 + 7, 0.5, True, ROOT, time.perf_counter(),
                        str(tmp_path), device="cpu", config_override=tiny_config("midas_v2-384"),
                        mix_override=tiny_mix("train"))
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(TRAIN) <= set(m) and all(m[k] > 0 for k in TRAIN)
    pace = runs[-1]["pace"]
    assert sum(m[k] for k in TRAIN) <= 1e3 * pace["seconds"] / pace["units"]
    assert res["correct"] is True


def test_a_traced_flow_run_splits_the_load(tmp_path):
    res = core.run_cell("raft_things-1024.flow", 2**33 + 11, 0.5, True, ROOT,
                        time.perf_counter(), str(tmp_path), device="cpu",
                        config_override=tiny_config("raft_things-1024"),
                        mix_override=tiny_mix("flow"))
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(FLOW) <= set(m)
    assert m["flow.decode_ms"] + m["flow.upload_ms"] == pytest.approx(m["flow.load_ms"],
                                                                      rel=0.02)
    assert m["flow.readback_ms"] < m["flow.chunk_ms"]
    assert res["correct"] is True
