"""Wall time of one train step: the window over the steps in it (host
clock, the card synchronised at the window's end)."""


def read(run):
    if run.get("setup_s") is None or not run["units"]:
        return None
    return run["window_s"] * 1e3 / run["units"]
