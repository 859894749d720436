"""Share (%) of the traced sub-window of the dense ``packed`` scan's batch
calls in which the device ran no kernel, copy or memset."""

from portbench.trace import idle_pct


def read(run):
    return idle_pct(run.trace)
