"""K4's share of its roofline (%) in the dense ``packed`` scan: the traced
blocks' least time over the device time of the lower-bound plane kernel
(``csrc/packed_lb_scan.cu``), stage 1 of the dense scan.

Per block, counted from the problem: the probed clusters' 1-bit plane, 16
bytes a row of factors (add, rescale, error, cluster id), the f32 query and
the top-k out; 2 * D operations a probed (query, row) pair at the bf16
tensor peak. The kernel's dense plane over every row is the
implementation's, not the problem's, and is not counted.
"""

import re

from portbench import roofline

KERNEL = re.compile(r"\bpacked_lb_kernel\b")
CODE_BITS = 1
FACTOR_BYTES = 16
QUERY_BYTES_PER_DIM = 4
PEAK = "bf16_tensor"


def read(run):
    return roofline.share_pct(run, KERNEL, CODE_BITS, FACTOR_BYTES, QUERY_BYTES_PER_DIM, PEAK)
