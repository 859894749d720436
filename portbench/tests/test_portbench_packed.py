"""The dense ``packed`` scan's cell (``gist1m-ivf8.packed``, configuration
``ivf-gist1m-8b-packed``, ``programs/ivf.py``) rehearsed on the CPU: through
``run.py`` traced and untraced, its int4 control and a planted altered id,
which must each read ``correct`` false; its program counter read from a
run that takes the roofline counts; and its device-trace readers on a
hand-made trace."""

import json
import time
import types

import numpy as np
import pytest
import torch

from portbench import harness, spec
from portbench import spans as pb_spans
from portbench import trace as trace_mod
from portbench.limits import control_config

from test_portbench_control import run
from test_portbench_rehearsal import cli

CELL = "gist1m-ivf8.packed"
PACKED_METRICS = {"k4_roofline_pct.packed", "survivor_cut_ms_per_kq.packed",
                  "rest_ms_per_kq.packed", "device_idle_pct.packed", "lb_probed_pct.packed"}


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_of_the_packed_cell(trace):
    p = cli("--workload", CELL, "--seed", "3230000023", "--seconds", "0.5", "--trace", str(trace),
            "--rehearse")
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert result["device"]["platform"] == "cpu" and "breakdown" not in result
    c = spec.load_cell(CELL)
    assert c.chips == 1 and c.config["index"]["scan_dtype"] == "packed"
    assert c.config["serving"]["nprobe"] == 256
    assert {m["name"] for m in c.end_to_end} == {"qps", "recall_at_10", "setup_s"}
    assert {m["name"] for m in c.per_layer} == PACKED_METRICS
    if trace:
        # the CPU has no device trace, and the harness takes the roofline
        # counts that the program counter is read against on the card only
        assert result["metrics"] == {}
    else:
        assert set(result["metrics"]) == {"qps", "recall_at_10", "setup_s"}


class _OnCard(harness.Run):
    """A run that takes the harness's roofline counts on the CPU, as it
    takes them on the card; each is kept in ``made``."""

    made: list = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.on_card = True
        _OnCard.made.append(self)


def test_the_probed_share_of_the_scored_pairs(monkeypatch):
    """Traced, with the roofline counts taken: of the five, only the
    program counter reads, in (0, 100], and it is the probed pairs over
    the padded queries times the plane's rows of every dispatch."""
    monkeypatch.setattr(harness, "Run", _OnCard)
    cell = spec.load_cell(CELL)
    result = harness.run_cell(cell, 3230000029, 0.5, True, torch.device("cpu"),
                              time.perf_counter())
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"lb_probed_pct.packed"}
    share = result["metrics"]["lb_probed_pct.packed"]["value"]
    assert 0 < share <= 100
    r = _OnCard.made[-1]
    dispatches = [s for s in pb_spans.traced(r) if s.name == "search.dispatch"]
    assert dispatches and all(s.counts == dispatches[0].counts for s in dispatches)
    b = dispatches[0].counts["survivors"] // 400  # the padded queries of a block
    rows_pad = dispatches[0].counts["lb_pairs"] // b  # the plane's rows
    assert b * 400 == dispatches[0].counts["survivors"] and b * rows_pad == \
        dispatches[0].counts["lb_pairs"]
    n_rows = harness.rehearsal_config(cell.config)["dataset"]["rows"]
    assert b >= 64 and rows_pad >= n_rows and rows_pad % 128 == 0
    probed = sum(int(r.roofline["sizes"][r.roofline["probes"][blk]].sum())
                 for blk in r.trace.blocks)
    assert share == pytest.approx(100.0 * probed / (len(dispatches) * b * rows_pad))
    # nprobe 2 of 32 lists: about a sixteenth of the rows a query
    assert 3 < share < 13


def test_the_int4_control_is_not_correct():
    config = control_config(spec.load_cell(CELL).config)
    assert config["serving"]["upload_dtype"] == "int4"
    result = run(CELL, seed=23, config=config)
    assert not result["correct"]
    assert not result["checks"]["dist_gap_mean"]["ok"]


def test_a_planted_altered_id_is_not_correct(monkeypatch):
    real = spec.program_kind("ivf")
    ns = types.SimpleNamespace(**{k: getattr(real, k) for k in dir(real) if not k.startswith("__")})

    def batch(index, config, queries):
        ids, dists = real.batch(index, config, queries)
        ids = ids.copy()
        ids[1, 0] = (ids[1, 0] + len(index) // 2) % len(index)
        return ids, dists

    ns.batch = batch
    assert run(CELL, seed=23)["correct"]
    result = run(CELL, seed=23, program=ns, monkeypatch=monkeypatch)
    assert not result["correct"], result["checks"]


# device names as the profiler gave them on an H100 (CUPTI's demangled
# kernels, arguments cut short)
K4 = ("void (anonymous namespace)::packed_lb_kernel<1>(unsigned char const*, unsigned char "
      "const*, float const*, float const*, float const*, unsigned int const*, float const*)")
CUT = ("void (anonymous namespace)::top_k_cluster_kernel<16>(void const*, void*, int*, "
       "unsigned long long*, unsigned int*, unsigned int*, int*, long, long, int, int, int)")
OTHERS = [
    # the centroid ranking and the final top-k
    "void (anonymous namespace)::top_k_shared_kernel<32>(void const*, void*, int*, int, int, int)",
    "void (anonymous namespace)::top_k_warp_kernel<32, 16>(void const*, void*, int*, long, int)",
    "void (anonymous namespace)::top_k_grid_kernel<32>(void const*, void*, int*, long, int)",
    "void (anonymous namespace)::gather_dot_kernel<2>((anonymous namespace)::Args)",
    "void (anonymous namespace)::packed_bin_scan_kernel<0>(unsigned char const*, float const*)",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x64x8_stage3_warpsize2x2x1_ffma_cublas",
    "Memcpy HtoD (Pinned -> Device)",
]


def _hand_made_run(names_ms, requests=1000):
    """A run whose trace holds one device interval of the given ms per
    name, back to back, in a 20 ms window."""
    device, t = [], 0.0
    for name, ms in names_ms:
        device.append((t, t + 1e3 * ms, name))
        t += 1e3 * ms
    tr = trace_mod.Trace(window_s=0.020, span=(0.0, 20e3), device=device, host=[],
                         requests=requests)
    return types.SimpleNamespace(trace=tr, roofline=None, traced_window=None)


def test_the_device_readers_on_a_hand_made_trace():
    k4 = spec.metric_reader("k4_roofline_pct.packed")
    cut = spec.metric_reader("survivor_cut_ms_per_kq.packed")
    rest = spec.metric_reader("rest_ms_per_kq.packed")
    idle = spec.metric_reader("device_idle_pct.packed")
    # each kernel counted once, where its reader's pattern puts it: K4 and
    # the cut only in their own readers, every other name only in the rest
    others_ms = [0.25 * (i + 1) for i in range(len(OTHERS))]
    r = _hand_made_run([(K4, 7.0), (CUT, 2.5)] + list(zip(OTHERS, others_ms)), requests=2000)
    assert cut(r) == pytest.approx(2.5 / 2)
    assert rest(r) == pytest.approx(sum(others_ms) / 2)
    busy_ms = 7.0 + 2.5 + sum(others_ms)
    assert idle(r) == pytest.approx(100.0 * (1 - busy_ms / 20.0))
    assert k4(r) is None  # no roofline counts

    # the roofline share: one block of two queries, probing clusters 0, 1 and 1, 2
    r.roofline = {"probes": np.array([[0, 1], [1, 2]]), "sizes": np.array([100, 200, 300]),
                  "dim": 128, "k": 10}
    r.trace.blocks = [np.array([0, 1])]
    rows, pairs = 600, 100 + 200 + 200 + 300
    n_bytes = rows * (128 / 8 + 16) + 2 * (4 * 128 + 10 * 8)
    least = max(n_bytes / 3.35e12, 2 * 128 * pairs / 989e12)
    assert k4(r) == pytest.approx(100.0 * least / 7e-3)

    # no K4 or cut in the trace: the kernels' readers read nothing
    r = _hand_made_run(list(zip(OTHERS, others_ms)))
    assert cut(r) is None and k4(r) is None
    assert rest(r) == pytest.approx(sum(others_ms))


def test_no_dispatch_count_reads_nothing():
    """A program whose dispatches carry no ``lb_pairs`` (the fused scans,
    or a program before the counts) gives no reading, and does not raise."""
    from rabitq_tpu_torch.utils import profiling

    reader = spec.metric_reader("lb_probed_pct.packed")
    r = _hand_made_run([(K4, 1.0)])
    r.traced_window = types.SimpleNamespace(calls=[(0.0, 1e9)])
    r.roofline = {"probes": np.array([[0]]), "sizes": np.array([10]), "dim": 128, "k": 10}
    r.trace.blocks = [np.array([0])]
    profiling.clear()
    with profiling.recording():
        with profiling.span("search.dispatch", k1_int8=0):
            pass
    try:
        assert reader(r) is None
        r.roofline = None
        assert reader(r) is None
    finally:
        profiling.clear()
