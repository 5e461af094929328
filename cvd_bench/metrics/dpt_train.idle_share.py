"""Share of the traced DPT train-step window in which no kernel ran on the
card: `train.idle_share`'s reader, reported under the DPT cell's own name."""

from cvd_bench.core import read_metric


def read(run):
    return read_metric("train.idle_share", run)
