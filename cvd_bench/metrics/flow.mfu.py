"""The whole flow chunk's share of the card's bf16 peak: the operations a
pair of the plain reference needs (counts/raft_flow.py: RAFT's 20
iterations at the flow size and the registration), times the traced
pairs, over the traced window as the trace spans it (the first device
operation's start to the last's end), over 989 TFLOP/s."""

from cvd_bench.counts import peaks, raft_flow


def read(run):
    t = run["trace"]
    pairs = run["counters"].get("pairs")
    if t is None or not pairs:
        return None
    flops = raft_flow.pair_flops(run["config"])
    return 100.0 * flops * pairs / t["window_s"] / peaks.BF16_FLOPS
