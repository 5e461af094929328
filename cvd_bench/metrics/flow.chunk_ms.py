"""One flow chunk on the card, registration, RAFT and un-warp, to its
flows on the host (FlowStage.stats["chunk_s"] over the chunks)."""


def read(run):
    c = run["counters"]
    if not c.get("chunks"):
        return None
    return c["chunk_s"] * 1e3 / c["chunks"]
