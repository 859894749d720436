"""Median of the window's call latencies (host clock), in milliseconds."""

import numpy as np


def read(run):
    lat = run.window.latencies_s
    return float(np.median(lat)) * 1e3 if lat else None
