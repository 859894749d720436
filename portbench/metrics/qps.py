"""Queries answered in the window over the window's seconds (host clock)."""


def read(run):
    return run.window.answered / run.window.seconds
