"""Share (%) of the traced sub-window of MSTG batch calls in which the
device idled with no program span open (the harness between calls, or host
work the program does not name)."""

from portbench import spans


def read(run):
    return spans.idle_pct(run, spans.OUTSIDE)
