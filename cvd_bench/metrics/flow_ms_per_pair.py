"""Wall time per frame pair of the flow stage: the window over the pairs
its compute_flow calls took, from the PNGs on disk to the flow files
written (host clock, the card synchronised at the window's end)."""


def read(run):
    if run.get("setup_s") is None or not run["counters"].get("pairs"):
        return None
    return run["window_s"] * 1e3 / run["counters"]["pairs"]
