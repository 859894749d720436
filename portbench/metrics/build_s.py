"""The window's seconds over the builds it completed (host clock)."""


def read(run):
    return run.window.seconds / run.window.answered if run.window.answered else None
