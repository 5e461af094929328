"""Share (%) of the untraced pace block's train steps that replayed a CUDA
graph of the step: the `train.step` spans with a `train.replay` among
their children (program spans). A program whose steps run eagerly reads
0."""

from cvd_bench.program_spans import pace_steps


def read(run):
    steps = pace_steps(run)
    if steps is None:
        return None
    replayed = sum(any(c["name"] == "train.replay" for c in s["children"]) for s in steps)
    return 100.0 * replayed / len(steps)
