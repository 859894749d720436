"""K3's share of its roofline (%): the traced blocks' least time over the
device time of the packed bin scan (``csrc/packed_bin_scan.cu``), stage 1
of the two-stage scan.

Per block: the probed clusters' 1-bit plane, two f32 factors a row (the
1-bit estimate's add and rescale), the int8 query and the top-k out; 2 * D
operations a probed (query, row) pair at the int8 tensor peak.
"""

import re

from portbench import roofline

KERNEL = re.compile(r"\bpacked_bin_scan_kernel\b")
CODE_BITS = 1
FACTOR_BYTES = 8
QUERY_BYTES_PER_DIM = 1
PEAK = "int8_tensor"


def read(run):
    return roofline.share_pct(run, KERNEL, CODE_BITS, FACTOR_BYTES, QUERY_BYTES_PER_DIM, PEAK)
