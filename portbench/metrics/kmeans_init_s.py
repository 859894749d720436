"""The k-means++ init's seconds (``build_report["kmeans"]["init_s"]``, the
program's own clock, synchronised), mean over the window's builds."""

import numpy as np


def read(run):
    reports = run.counters.get("build_reports") or []
    vals = [r["kmeans"]["init_s"] for r in reports if "init_s" in r.get("kmeans", {})]
    return float(np.mean(vals)) if vals else None
