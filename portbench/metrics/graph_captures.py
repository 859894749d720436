"""CUDA graphs the program captured (``graph.capture`` spans, kept whether
tracing is on or off) from the window's start to the traced sub-window's
end: 0 once set-up has warmed every shape."""

from portbench import spans


def read(run):
    return spans.captures(run)
