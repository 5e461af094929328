"""The flow stage's flow-file writes a pair: the span `flow.write` over
the traced chunks and their pairs (program spans)."""

from cvd_bench.program_spans import flow_ms


def read(run):
    return flow_ms(run, "flow.write", "pair")
