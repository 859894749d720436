"""Share (%) of the plane's row tiles that the bin scan walks: the mean over
the traced sub-window's scan dispatches of the counts ``tiles`` over
``plane_tiles`` of the program's ``search.dispatch`` spans (100: the dense
walk; below, the compacted walk's tile budget). None where the spans carry
no such counts."""

import numpy as np

from portbench import spans


def read(run):
    found = spans.traced(run)
    if found is None:
        return None
    shares = [s.counts["tiles"] / s.counts["plane_tiles"] for s in found
              if s.name == "search.dispatch" and s.counts.get("plane_tiles")]
    return 100.0 * float(np.mean(shares)) if shares else None
