"""Rotation, quantization and layout seconds of a build
(``build_report["quantize_s"]``, the program's own clock), mean over the
window's builds."""

import numpy as np


def read(run):
    vals = [r["quantize_s"] for r in run.counters.get("build_reports") or [] if "quantize_s" in r]
    return float(np.mean(vals)) if vals else None
