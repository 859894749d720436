"""Share (%) of the traced sub-window's scan dispatches whose bin scan took
the query as int8 codes (K1 on the int8 tensor cores): the mean over the
program's ``search.dispatch`` spans of their count ``k1_int8`` (1 or 0).
100 where the query reaching K1 is an integer grid (an un-rotated int8
upload), 0 where a rotation makes it f32. None where the spans carry no
such count."""

import numpy as np

from portbench import spans


def read(run):
    found = spans.traced(run)
    if found is None:
        return None
    marks = [s.counts["k1_int8"] for s in found
             if s.name == "search.dispatch" and "k1_int8" in s.counts]
    return 100.0 * float(np.mean(marks)) if marks else None
