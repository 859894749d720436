"""Share (%) of the traced sub-window of batch calls in which the device
idled while the program encoded queries (``serve.encode`` the innermost
program span over the gap)."""

from portbench import spans


def read(run):
    return spans.idle_pct(run, "serve.encode")
