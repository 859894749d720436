"""Median over the traced calls of the host microseconds of the program's
scan dispatch (self time of ``search.dispatch``: argument set-up, graph key
and lookup, input copies, output clones; the graph launch, ``graph.replay``,
left out)."""

from collections import defaultdict

import numpy as np

from portbench import spans


def read(run):
    found = spans.traced(run)
    if found is None:
        return None
    per_call = defaultdict(float)
    for s, t in spans.self_us(found):
        if s.name == "search.dispatch":
            per_call[s.call] += t
    return float(np.median(list(per_call.values()))) if per_call else None
