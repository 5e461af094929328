"""Share of the traced flow window in which no kernel ran on the card
(the window as the trace spans it)."""


def read(run):
    t = run["trace"]
    if t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
