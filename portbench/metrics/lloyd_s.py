"""Lloyd iterations' seconds of a build (``build_report["kmeans"]["lloyd_s"]``,
the program's span ``kmeans.lloyd``, synchronised), mean over the window's
builds."""

import numpy as np


def read(run):
    reports = run.counters.get("build_reports") or []
    vals = [r["kmeans"]["lloyd_s"] for r in reports if "lloyd_s" in r.get("kmeans", {})]
    return float(np.mean(vals)) if vals else None
