"""The reader `flow.decodes_per_pair`: the `frames` counts of the traced
chunks' `flow.decode` spans over their pairs, nothing from a program whose
decode spans carry no count, and the count a tiny traced run on the CPU
leaves."""

import time

import pytest

from conftest import ROOT, tiny_config, tiny_mix

from cvd_bench import core

METRIC = "flow.decodes_per_pair"


@pytest.fixture
def ring(monkeypatch):
    from robust_cvd_tpu_torch.utils import spans

    records = []
    monkeypatch.setattr(spans, "_ring", records)
    return records


def _chunk(ring, pairs, **decode_attrs):
    """One `flow.iter` span with its `flow.load` > `flow.decode`,
    `flow.upload` children, children before their parents as the ring
    holds them."""
    base = len(ring)
    t = 1000 * base
    ring.extend([(base + 3, base + 2, "flow.decode", t, t + 5, decode_attrs),
                 (base + 4, base + 2, "flow.upload", t + 5, t + 6, {}),
                 (base + 2, base + 1, "flow.load", t, t + 6, {}),
                 (base + 1, None, "flow.iter", t, t + 9, {"pairs": pairs})])


def test_the_reader_counts_the_traced_chunks_decodes(ring):
    _chunk(ring, 16, frames=32, threads=8)  # before the window
    _chunk(ring, 16, frames=10, threads=8)
    _chunk(ring, 12, frames=8, threads=8)
    assert core.read_metric(METRIC, {"units": 2, "trace": {}}) == pytest.approx(18 / 28)


def test_the_reader_gives_nothing_without_the_count(ring):
    """The parent's decode spans carry no `frames`; too few chunks in the
    ring give nothing either."""
    _chunk(ring, 16)
    _chunk(ring, 16)
    assert core.read_metric(METRIC, {"units": 2, "trace": {}}) is None
    assert core.read_metric(METRIC, {"units": 3, "trace": {}}) is None


def test_a_traced_flow_run_counts_each_distinct_frame_once(tmp_path):
    """The tiny flow cell's pairs (6 frames, chunks of 4) repeat frames
    inside a chunk: fewer decodes than the two frames of every pair."""
    res = core.run_cell("raft_things-1024.flow", 2**33 + 13, 0.5, True, ROOT,
                        time.perf_counter(), str(tmp_path), device="cpu",
                        config_override=tiny_config("raft_things-1024"),
                        mix_override=tiny_mix("flow"))
    got = res["metrics"][METRIC]
    assert got["unit"] == "decodes/pair" and 0 < got["value"] < 2
    assert res["correct"] is True
