"""99th percentile of the window's call latencies (host clock around each
call to its returned results), in milliseconds."""

import numpy as np


def read(run):
    lat = run.window.latencies_s
    return float(np.percentile(lat, 99)) * 1e3 if lat else None
