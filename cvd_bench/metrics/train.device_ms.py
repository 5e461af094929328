"""Device time of one train step: the union of the card's kernel
intervals over the traced steps, over the steps."""


def read(run):
    t = run["trace"]
    if t is None or not run["units"]:
        return None
    return t["busy_s"] * 1e3 / run["units"]
