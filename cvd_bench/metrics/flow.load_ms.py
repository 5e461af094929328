"""The flow stage's PNG loads and copies to the card a pair
(FlowStage.stats["load_s"] over the pairs)."""


def read(run):
    c = run["counters"]
    if not c.get("pairs"):
        return None
    return c["load_s"] * 1e3 / c["pairs"]
