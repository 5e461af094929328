"""The flow stage's PNG decodes a pair: the span `flow.decode` over the
traced chunks (`flow.iter` spans) and their pairs (program spans)."""

from cvd_bench.program_spans import flow_ms


def read(run):
    return flow_ms(run, "flow.decode", "pair")
