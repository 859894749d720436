"""K1's share of its roofline (%): the traced blocks' least time over the
device time of the fused EXACT bin scan (``csrc/fused_bin_scan.cu``).

Per block: the probed clusters' codes at total_bits a dimension, two f32
factors a row (the EXACT estimate's add and rescale), the rotated query in
f32 and the top-k out; 2 * D operations a probed (query, row) pair at the
int8 tensor peak, the fastest unit a 7-bit code could be multiplied on.
"""

import re

from portbench import roofline

KERNEL = re.compile(r"(?<!packed_)\bbin_scan_kernel\b")
FACTOR_BYTES = 8
QUERY_BYTES_PER_DIM = 4
PEAK = "int8_tensor"


def read(run):
    return roofline.share_pct(run, KERNEL, run.config["index"]["total_bits"], FACTOR_BYTES,
                              QUERY_BYTES_PER_DIM, PEAK)
