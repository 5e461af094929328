"""Host milliseconds a train step spends in the span `dpt.encoder` (the
enqueue of the ViT encoder's blocks in the forward), over the untraced pace
block's steps (program spans)."""

from cvd_bench.program_spans import phase_ms_per_step


def read(run):
    return phase_ms_per_step(run, "dpt.encoder")
