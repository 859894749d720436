"""Share (%) of the traced sub-window of MSTG batch calls in which the
device ran no kernel, copy or memset."""

from portbench.trace import idle_pct


def read(run):
    return idle_pct(run.trace)
