"""The flow stage's stacking of the decoded frames and their copy to the
card a pair: the span `flow.upload` over the traced chunks and their pairs
(program spans)."""

from cvd_bench.program_spans import flow_ms


def read(run):
    return flow_ms(run, "flow.upload", "pair")
