"""Device milliseconds a thousand queries of every kernel and copy in the
traced sub-window of the dense ``packed`` scan's cell except K4
(``k4_roofline_pct.packed``'s kernel) and the survivor cut
(``survivor_cut_ms_per_kq.packed``'s): centroid ranking, the query's decode
and rotation, stage 2's gather-dot, the final top-k, sorts, copies."""

import re

K4_AND_CUT = re.compile(r"\b(packed_lb_kernel|top_k_cluster_kernel)\b")


def read(run):
    t = run.trace
    if t is None or not t.device or not t.requests:
        return None
    rest_s = sum(e - s for s, e, name in t.device if not K4_AND_CUT.search(name)) / 1e6
    return rest_s * 1e3 / (t.requests / 1000)
