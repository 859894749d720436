"""``k1_int8_pct`` rehearsed on the CPU: in the MSTG cell (no rotator, int8
uploads) every scan dispatch hands the bin scan int8 codes and it reads 100;
in the 7-bit IVF cell the rotation makes the query f32 and it reads 0. No
cell lists the metric yet: each is run with it added."""

import copy
import time

import pytest
import torch

from portbench import harness, spec

ENTRY = {"name": "k1_int8_pct", "unit": "%", "better": "higher", "source": "program_counter",
         "layer": "kernels", "moves": "qps"}


@pytest.mark.parametrize("cell_name, want", [("gist1m-mstg7.batch", 100.0),
                                             ("gist1m-ivf7.batch", 0.0)])
def test_k1_int8_share_in_a_traced_rehearsal(cell_name, want):
    cell = copy.copy(spec.load_cell(cell_name))
    cell.per_layer = cell.per_layer + [ENTRY]
    result = harness.run_cell(cell, 3200000021, 0.5, True, torch.device("cpu"),
                              time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["metrics"]["k1_int8_pct"]["value"] == want


def test_no_dispatch_count_reads_nothing():
    """A program whose dispatches carry no ``k1_int8`` (the parent's) gives
    no reading, and does not raise."""
    from rabitq_tpu_torch.utils import profiling

    reader = spec.metric_reader("k1_int8_pct")
    run = type("Run", (), {})()
    run.traced_window = type("W", (), {"calls": [(0.0, 1e9)]})()
    profiling.clear()
    with profiling.recording():
        with profiling.span("search.dispatch", tiles=1):
            pass
    try:
        assert reader(run) is None
    finally:
        profiling.clear()
