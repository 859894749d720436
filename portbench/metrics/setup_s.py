"""Seconds from the process's start to the window's: imports, kernel
libraries, rows drawn, index trained, warm-up and graph capture."""


def read(run):
    return run.setup_s
