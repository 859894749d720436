"""Device milliseconds a thousand queries of every kernel and copy in the
traced sub-window of the MSTG cell except the bin-scan kernels: the same
count as ``scan_rest_ms_per_kq`` (centroid ranking, the query's encode and
split, selection, re-rank, result sort, copies)."""

from portbench import spec


def read(run):
    return spec.metric_reader("scan_rest_ms_per_kq")(run)
