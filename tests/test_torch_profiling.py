"""The port's spans (``rabitq_tpu_torch/utils/profiling.py``): the recorder,
the spans of the serving and build paths, the build report read from them,
the operator's Chrome trace, and the benchmark's reading of them
(``portbench/spans.py``) on a real CPU profiler run. All on the CPU; the
graph capture and replay are exercised with a stand-in graph."""

from __future__ import annotations

import json
import logging
import sys
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import rabitq_tpu_torch as tr
from portbench import generator
from portbench import spans as pb_spans
from portbench import trace as pb_trace
from rabitq_tpu_torch.index import scan as tscan
from rabitq_tpu_torch.utils import profiling
from rabitq_tpu_torch.utils.profiling import OFF, Span, recording, span

N, DIM, NLIST = 1500, 32, 8
PARAMS = tr.SearchParams(top_k=5, nprobe=3)


@pytest.fixture(autouse=True)
def empty_ring():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((NLIST, DIM)).astype(np.float32) * 3
    data = (centers[rng.integers(0, NLIST, N)] + rng.standard_normal((N, DIM))).astype(np.float32)
    ix = tr.IvfRabitqIndex.train(data, nlist=NLIST, total_bits=7, seed=3, scan_dtype="fused8",
                                 use_faster_config=True, device="cpu")
    ix.upload_dtype = "int8"
    return ix, data


def _names(found):
    return [s.name for s in found]


def test_spans_nest_with_parent_and_call_id():
    with recording():
        with span("outer", rows=3) as outer:
            with span("inner") as inner:
                pass
            with span("inner2"):
                with span("leaf"):
                    pass
        with span("second"):
            pass
    got = {s.name: s for s in profiling.spans()}
    assert _names(profiling.spans()) == ["inner", "leaf", "inner2", "outer", "second"]
    assert got["outer"].parent == 0 and got["outer"].call == outer.id
    assert got["inner"].parent == outer.id and got["leaf"].parent == got["inner2"].id
    assert {got[n].call for n in ("inner", "inner2", "leaf")} == {outer.id}
    assert got["second"].call == got["second"].id != outer.id
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert outer.counts == {"rows": 3} and outer.seconds >= inner.seconds >= 0


def test_nothing_is_kept_while_off():
    assert not profiling._recording and not torch.autograd.profiler._is_profiler_enabled
    with span("off", rows=1) as sp:
        sp.add(bytes=2)
    assert span("off") is OFF and sp is OFF
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_an_off_span_allocates_nothing():
    def loop():
        for _ in range(5000):
            with span("off", rows=1) as sp:
                sp.add(bytes=2)

    loop()
    before = sys.getallocatedblocks()
    loop()
    assert sys.getallocatedblocks() - before < 50  # no block a span: 5,000 spans ran
    assert profiling.spans() == []


def test_a_profiler_switches_spans_on():
    with profile(activities=[ProfilerActivity.CPU]):
        with span("traced"):
            torch.ones(4).sum()
    with span("after"):
        pass
    assert _names(profiling.spans()) == ["traced"]


def test_recording_switches_spans_on_and_nests():
    with recording():
        with recording():
            with span("a"):
                pass
        with span("b"):
            pass
    with span("c"):
        pass
    assert _names(profiling.spans()) == ["a", "b"] and not profiling._recording


def test_the_ring_is_bounded_and_counts_what_it_drops(monkeypatch):
    assert profiling._ring.maxlen == profiling.RING == 1 << 18
    monkeypatch.setattr(profiling, "_ring", deque(maxlen=4))
    with recording():
        for i in range(10):
            with span(f"s{i}"):
                pass
    assert _names(profiling.spans()) == ["s6", "s7", "s8", "s9"] and profiling.dropped() == 6
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_graph_capture_is_kept_while_off(monkeypatch):
    fused = tscan.FusedSearch(None)
    monkeypatch.setattr(fused, "_capture_body", lambda q, qscale, scan: "graph")
    assert fused._capture(None, None, {}) == "graph"
    (cap,) = profiling.spans()
    assert cap.name == "graph.capture" and fused.stats["capture_s"] == [cap.seconds]
    with Span("measured") as sp:  # timed always, kept only while tracing
        pass
    assert sp.seconds >= 0 and _names(profiling.spans()) == ["graph.capture"]


def test_a_replay_adds_only_the_counters_its_capture_moved():
    slots = tscan._launch_counters()
    launches = [0] * len(slots)
    launches[0] = 2  # the FHT kernel's counter
    graph = SimpleNamespace(replays=0)
    graph.replay = lambda: setattr(graph, "replays", graph.replays + 1)
    inputs = {"q": torch.zeros(2, 3), "qscale": None, "row_allowed": torch.zeros(4, dtype=bool)}
    g = tscan._Graph(graph, inputs, (torch.arange(3),), launches)
    assert [(d is slots[0][0], k, n) for d, k, n in g._moved] == [(True, "launches", 2)]
    before = tscan._read_launches()
    with recording():
        out = g.run(torch.ones(2, 3), None, torch.ones(4, dtype=bool))
    assert [a - b for a, b in zip(tscan._read_launches(), before)] == launches
    tscan._add_launches(launches, -1)
    assert graph.replays == 1 and g.launches == launches
    assert torch.equal(inputs["q"], torch.ones(2, 3)) and bool(inputs["row_allowed"].all())
    assert torch.equal(out[0], torch.arange(3)) and out[0] is not g.outputs[0]
    assert _names(profiling.spans()) == ["graph.replay"]


def test_a_span_logs_its_duration(caplog):
    with caplog.at_level(logging.INFO, logger="rabitq_tpu_torch"):
        with Span("download", rows=12):
            pass
    (rec,) = [r for r in caplog.records if r.name == "rabitq_tpu_torch.span"]
    assert rec.levelno == logging.INFO and rec.getMessage().startswith("download rows=12: ")
    assert rec.getMessage().endswith("s")


def test_build_report_from_spans(index, caplog):
    ix, data = index
    with caplog.at_level(logging.INFO, logger="rabitq_tpu_torch"):
        with recording():
            again = tr.IvfRabitqIndex.train(data, nlist=NLIST, total_bits=7, seed=3,
                                            use_faster_config=True, device="cpu")
    r = again.build_report
    assert set(r) == {"upload", "upload_s", "kmeans_s", "kmeans", "quantize_s", "total_s"}
    assert set(r["kmeans"]) == {"init_s", "lloyd_s", "assign_s", "assign_dtype", "iters"}
    got = {s.name: s for s in profiling.spans()}
    for key, name in (("upload_s", "build.upload"), ("kmeans_s", "kmeans"),
                      ("quantize_s", "build.quantize"), ("total_s", "ivf.train")):
        assert r[key] == got[name].seconds and r[key] > 0
    for key in ("init_s", "lloyd_s", "assign_s"):
        assert r["kmeans"][key] == got[f"kmeans.{key[:-2]}"].seconds
    assert r["total_s"] >= r["upload_s"] + r["kmeans_s"] + r["quantize_s"]
    assert any(round(v, 2) != v for v in (r["total_s"], r["kmeans_s"], r["quantize_s"]))
    root = got["ivf.train"]
    assert got["kmeans.init"].parent == got["kmeans"].id and got["kmeans"].parent == root.id
    assert got["build.codes"].parent == got["build.quantize"].id
    assert all(s.call == root.id for s in profiling.spans())
    logged = [rec.getMessage() for rec in caplog.records if rec.name == "rabitq_tpu_torch.span"]
    assert any(m.startswith(f"kmeans n={N} k={NLIST}: ") for m in logged)


def test_build_report_is_kept_without_tracing(index):
    ix, _ = index
    assert profiling.spans() == [] and "lloyd_first_s" not in ix.build_report["kmeans"]
    assert ix.build_report["kmeans"]["init_s"] > 0 and ix.build_report["quantize_s"] > 0


def test_the_serving_spans_of_one_search(index):
    ix, data = index
    with recording():
        hits = ix.search(data[0], PARAMS)
    assert hits[0].id == 0
    found = profiling.spans()
    root = found[-1]
    assert root.name == "ivf.search" and root.counts == {"queries": 1} and root.parent == 0
    assert _names(found[:-1]) == ["serve.encode", "serve.copy_in", "search.dispatch",
                                  "serve.fetch", "serve.results"]
    assert all(s.parent == root.id and s.call == root.id for s in found[:-1])
    assert found[0].counts == {"rows": 1, "bytes": 32 + 4}  # int8 row and its f32 scale


def test_the_serving_spans_of_a_pipelined_batch(index):
    ix, data = index
    with recording():
        ids, _ = ix.batch_search_arrays_pipelined(data[:70], PARAMS, batch_size=16,
                                                  upload_block=32)
        ix.batch_search(data[:3], PARAMS)
    assert ids.shape == (70, 5)
    found = profiling.spans()
    roots = [s for s in found if s.parent == 0]
    assert [(s.name, s.counts) for s in roots] == [("ivf.batch", {"queries": 70}),
                                                   ("ivf.batch", {"queries": 3})]
    first = [s.name for s in found if s.call == roots[0].id and s is not roots[0]]
    assert first.count("serve.encode") == first.count("serve.copy_in") == 3  # 32-row uploads
    assert first.count("search.dispatch") == 5 and first[-1] == "serve.fetch"  # 16-row scans
    second = [s.name for s in found if s.call == roots[1].id]
    assert second[-2:] == ["serve.results", "ivf.batch"]


@pytest.mark.parametrize("scan_dtype", ["packed", "bf16", "fused8"])
def test_the_dispatch_counts_a_dense_scans_pairs_and_survivors(index, scan_dtype):
    """A dense scan's ``search.dispatch`` counts ``lb_pairs``, the block's
    padded queries times the plane's rows that stage 1 scores, and
    ``survivors``, the padded queries times ``rerank``; the fused scans
    count neither."""
    _, data = index
    ix = tr.IvfRabitqIndex.train(data, nlist=NLIST, total_bits=8, seed=3, scan_dtype=scan_dtype,
                                 use_faster_config=True, device="cpu")
    ix.upload_dtype = "int8"
    with recording():
        ix.batch_search_arrays_pipelined(data[:70], PARAMS, batch_size=16, upload_block=32)
        ix.batch_search(data[:3], PARAMS)
    found = [s for s in profiling.spans() if s.name == "search.dispatch"]
    assert [s.counts["k1_int8"] for s in found] == [0] * 6
    if scan_dtype == "fused8":
        assert not any("lb_pairs" in s.counts or "survivors" in s.counts for s in found)
        return
    n_pad = int(ix.layout.ids.shape[0])
    rerank = PARAMS.resolved_rerank()
    assert n_pad >= N and rerank == 400
    blocks = [16] * 5 + [4]  # five 16-row windows, then 3 queries padded to 4
    assert [s.counts["lb_pairs"] for s in found] == [b * n_pad for b in blocks]
    assert [s.counts["survivors"] for s in found] == [b * rerank for b in blocks]


def test_device_trace_adds_the_spans_as_a_track(tmp_path):
    x = torch.ones(256, 256)
    with profiling.device_trace(str(tmp_path)):
        with span("probe", rows=256):
            torch.mm(x, x)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    (probe,) = [e for e in events if e.get("pid") == profiling.SPAN_PID and e.get("ph") == "X"]
    assert probe["name"] == "probe" and probe["args"]["rows"] == 256
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert probe["ts"] - 50 <= mm["ts"] and mm["ts"] + mm["dur"] <= probe["ts"] + probe["dur"] + 50
    assert any(e.get("ph") == "M" and e.get("pid") == profiling.SPAN_PID for e in events)


class _Calls:
    """The harness's kind of call, around ``fn(i)``."""

    requests = 1

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, i):
        self.fn(i)

    def blocks(self, i):
        return []


def _traced_run(fn, n=12):
    """A traced sub-window of ``n`` calls of ``fn`` on the CPU, taken as the
    harness takes it."""
    trace, window = generator.traced(_Calls(fn), n, 0, torch.device("cpu"))
    return SimpleNamespace(trace=trace, traced_window=window, window=window)


def test_portbench_places_a_span_over_its_profiler_operator():
    """After the mapping, a span around a torch operator holds that
    operator's profiler interval, to within 50 us."""
    x = torch.randn(128, 128)

    def call(i):
        with span("call"):
            torch.relu(x)
            with span("probe"):
                torch.mm(x, x)
            torch.sigmoid(x)

    run = _traced_run(call)
    found = pb_spans.traced(run)
    assert _names(found).count("probe") == 12
    d = pb_spans.clock_offset_us(run, found)
    probes = sorted((s.start_ns / 1e3 + d, s.end_ns / 1e3 + d) for s in found if s.name == "probe")
    mms = sorted((s, e) for s, e, name in run.trace.host if name == "aten::mm")
    assert len(mms) == 12
    for (a, b), (s, e) in zip(probes, mms):
        assert a - 50 <= s and e <= b + 50


def _fake_run(spans_, device, window_calls, span_us=(0.0, 100.0)):
    """A run whose trace is given: host clock == trace clock (anchor 0)."""
    trace = pb_trace.Trace(window_s=(span_us[1] - span_us[0]) / 1e6, span=span_us,
                           device=device, host=[])
    window = generator.Window(start=window_calls[0][0], end=window_calls[-1][1],
                              calls=list(window_calls))
    return SimpleNamespace(trace=trace, traced_window=window, window=window)


def _fake_span(name, a_us, b_us, sid, parent=0, call=None):
    return SimpleNamespace(name=name, start_ns=int(a_us * 1e3), end_ns=int(b_us * 1e3), id=sid,
                           parent=parent, call=call or (parent or sid), counts={})


def test_idle_gaps_go_to_the_innermost_span_or_outside(monkeypatch):
    spans_ = [_fake_span("ivf.batch", 10, 90, 1), _fake_span("serve.encode", 10, 40, 2, 1),
              _fake_span("serve.fetch", 70, 90, 3, 1)]
    monkeypatch.setattr(pb_spans, "program_spans", lambda: spans_)
    device = [(40.0, 60.0, "k1"), (65.0, 66.0, "k2"), (85.0, 88.0, "copy")]
    run = _fake_run(spans_, device, [(0.0, 100e-6, 1, True)])
    idle = pb_spans.idle_by_span(run)
    assert idle == pytest.approx({"serve.encode": 40e-6, "ivf.batch": 5e-6, "serve.fetch": 19e-6,
                                  "outside": 12e-6})
    assert pb_spans.idle_pct(run, "serve.encode") == pytest.approx(40.0)
    assert pb_spans.idle_pct(run, pb_spans.OUTSIDE) == pytest.approx(12.0)
    assert dict((s.name, t) for s, t in pb_spans.self_us(spans_))["ivf.batch"] == pytest.approx(30)


def test_portbench_readers_without_a_recorder(monkeypatch):
    """A program without the recorder (the parent of this change): every
    reader of spans returns None and none raises."""
    monkeypatch.setattr(pb_spans, "program_spans", lambda: None)
    run = _fake_run([], [(40.0, 60.0, "k1")], [(0.0, 100e-6, 1, True)])
    assert pb_spans.idle_by_span(run) is None and pb_spans.captures(run) is None
    assert pb_spans.traced(run) is None and pb_spans.idle_pct(run, "serve.encode") is None
