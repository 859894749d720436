"""Device milliseconds a thousand queries of every kernel and copy in the
traced sub-window except the bin-scan kernels (K1, K3)."""

import re

BIN_SCAN = re.compile(r"\b(packed_)?bin_scan_kernel\b")  # csrc/fused_bin_scan.cu, csrc/packed_bin_scan.cu


def read(run):
    t = run.trace
    if t is None or not t.device or not t.requests:
        return None
    rest_s = sum(e - s for s, e, name in t.device if not BIN_SCAN.search(name)) / 1e6
    return rest_s * 1e3 / (t.requests / 1000)
