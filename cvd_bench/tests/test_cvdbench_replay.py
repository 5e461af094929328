"""The `train.replay_share` reader: the share of the pace block's
`train.step` spans with a `train.replay` child, 0 for eager steps, nothing
where the ring holds too few spans or the program keeps none."""

import sys

import pytest

from cvd_bench import core

METRIC = "train.replay_share"
EAGER = ("train.batch", "train.forward", "train.loss", "train.backward", "train.optimizer")
REPLAYED = ("train.batch", "train.replay")


@pytest.fixture
def ring(monkeypatch):
    """The program's span ring, emptied; `add(children)` appends a
    `train.step` span with children of those names."""
    from robust_cvd_tpu_torch.utils import spans

    records = []
    monkeypatch.setattr(spans, "_ring", records)

    def add(children):
        step = len(records) + len(children) + 1
        t = len(records) * 10
        for k, name in enumerate(children):
            records.append((len(records) + 1, step, name, t + k, t + k + 1, {}))
        records.append((step, None, "train.step", t, t + len(children), {}))

    return add


def test_replayed_steps_of_the_pace_block(ring):
    for _ in range(3):  # warm-up: eager, then the capture
        ring(EAGER)
    ring(("train.batch", "train.capture", "train.replay"))
    for k in range(4):  # pace: three of four replayed
        ring(REPLAYED if k else EAGER)
    for _ in range(2):  # traced
        ring(REPLAYED)
    run = {"pace": {"units": 4, "seconds": 0.2}, "units": 2}
    assert core.read_metric(METRIC, run) == pytest.approx(75.0)


@pytest.mark.parametrize("children, share", [(EAGER, 0.0), (REPLAYED, 100.0)])
def test_all_eager_or_all_replayed(ring, children, share):
    for _ in range(6):
        ring(children)
    assert core.read_metric(METRIC, {"pace": {"units": 4, "seconds": 1.0}, "units": 2}) == share


def test_nothing_to_read_with_too_few_spans(ring):
    for _ in range(3):
        ring(REPLAYED)
    assert core.read_metric(METRIC, {"pace": {"units": 4, "seconds": 1.0}, "units": 2}) is None
    assert core.read_metric(METRIC, {"pace": None, "units": 2}) is None


def test_nothing_to_read_where_the_program_keeps_no_spans(monkeypatch):
    """A program from before the spans module: the import fails, the
    reader returns None and does not raise."""
    import robust_cvd_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "robust_cvd_tpu_torch.utils.spans", None)
    assert core.read_metric(METRIC, {"pace": {"units": 1, "seconds": 1.0}, "units": 1}) is None
