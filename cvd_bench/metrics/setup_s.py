"""Set-up time: process start to the window's start (host clock)."""


def read(run):
    return run.get("setup_s")
