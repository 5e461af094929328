"""Host milliseconds a train step spends in its span `train.optimizer`
(the guarded Adam step and the BatchNorm commit), over the untraced pace
block's steps (program spans)."""

from cvd_bench.program_spans import phase_ms_per_step


def read(run):
    return phase_ms_per_step(run, "train.optimizer")
