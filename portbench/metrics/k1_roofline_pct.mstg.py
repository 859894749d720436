"""K1's share of its roofline (%) in the MSTG cell: the same count as
``k1_roofline_pct`` (the traced blocks' least time over the device time of
the fused EXACT bin scan), with the posting lists each query probes (its
top-``ef`` lists, ``nprobe`` in the configuration) as the probed clusters."""

from portbench import spec


def read(run):
    return spec.metric_reader("k1_roofline_pct")(run)
