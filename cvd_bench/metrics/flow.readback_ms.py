"""The host waiting for a flow chunk: the span `flow.readback` (the
flows and homographies copied to the host, which waits for the chunk's
device work) a traced chunk (program spans)."""

from cvd_bench.program_spans import flow_ms


def read(run):
    return flow_ms(run, "flow.readback", "chunk")
