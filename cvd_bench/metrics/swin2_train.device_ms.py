"""Device time of one Swin V2 train step: `train.device_ms`'s reader (the
union of the card's kernel intervals over the traced steps, over the
steps), reported under the Swin V2 cell's own name."""

from cvd_bench.core import read_metric


def read(run):
    return read_metric("train.device_ms", run)
