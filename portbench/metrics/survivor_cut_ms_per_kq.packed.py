"""Device milliseconds a thousand queries of the survivor cut in the dense
``packed`` scan: the long-row selection (``csrc/select.cu``
``top_k_cluster_kernel``, whose spill runs in the same launch) that keeps
each query's 400 best lower bounds of the ``[B, Np]`` plane. The centroid
ranking and the final top-k take the shorter rows' kernels and are not
counted."""

import re

CUT = re.compile(r"\btop_k_cluster_kernel\b")


def read(run):
    t = run.trace
    if t is None or not t.device or not t.requests:
        return None
    cut_s = sum(e - s for s, e, name in t.device if CUT.search(name)) / 1e6
    return cut_s * 1e3 / (t.requests / 1000) if cut_s > 0 else None
