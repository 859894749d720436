"""The port's MSTG index served as the benchmark's MSTG cell serves it, on the
CPU through the kernels' plain versions.

The index is built by ``portbench/programs/mstg.py`` from the configuration
``mstg-gist1m-7b`` at its rehearsal sizes (rows from ``portbench.data.blobs``)
and its answers are held against the benchmark's reference
(``portbench/reference/exact_knn.py``: exact top-k and the exact distance of
every returned id) under the configuration's own limits; the int4 control
must fail them. Then the spans the serving and build paths keep
(``utils/profiling.py``), and the device dedup on an index with a repeated id.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import rabitq_tpu_torch as tr
from portbench import data, harness, judge, spec
from portbench.limits import control_config
from portbench.reference import exact_knn
from rabitq_tpu_torch.utils import profiling

CPU = torch.device("cpu")
CONFIG = json.loads((spec.BENCH_DIR / "configs" / "mstg-gist1m-7b.json").read_text())
SEED = 2190000007


@pytest.fixture(scope="module")
def served():
    """(config, rows, queries, index, build spans) at the rehearsal sizes."""
    config = harness.rehearsal_config(CONFIG)
    ds = config["dataset"]
    rows, queries = data.blobs(ds, 2 * ds["queries"], data.generator(SEED, CPU), CPU)
    program = spec.program_kind("mstg")
    profiling.clear()
    with profiling.recording():
        index = program.build(config, rows, CPU)
    build_spans = profiling.spans()
    profiling.clear()
    return config, rows, queries, index, build_spans


def _params(config, top_k=None):
    s = config["serving"]
    return tr.MstgSearchParams(top_k=top_k or s["top_k"], ef_search=s["nprobe"],
                               pruning_epsilon=s["pruning_epsilon"])


def _serve(index, config, queries):
    s = config["serving"]
    return index.batch_search_arrays_pipelined(
        queries.numpy(), _params(config), batch_size=s["batch_size"],
        upload_block=s["upload_block"])


@pytest.mark.parametrize("upload, passes", [("int8", True), ("int4", False)],
                         ids=["configured", "int4-control"])
def test_served_at_the_configuration_against_the_reference(served, upload, passes):
    config, rows, queries, index, _ = served
    if not passes:
        config = control_config(config)
        assert config["serving"]["upload_dtype"] == "int4"
    assert index.posting_list_count() > 2 * config["serving"]["nprobe"]
    assert index.scan_dtype == "fused8" and index.quant_dim == rows.shape[1]
    saved = index.upload_dtype
    index.upload_dtype = config["serving"]["upload_dtype"]
    try:
        ids, dists = _serve(index, config, queries)
    finally:
        index.upload_dtype = saved
    k = config["serving"]["top_k"]
    assert ids.shape == (queries.shape[0], k) and (ids >= 0).all()
    gt_ids, gt_d = exact_knn.top_k(rows, queries, k)
    exact = exact_knn.pair_distances(rows, queries, torch.as_tensor(ids, dtype=torch.int64))
    hits = (ids[:, :, None] == gt_ids.numpy()[:, None, :]).any(axis=2).mean()
    gap = np.abs(dists - exact.numpy().astype(np.float64)) / gt_d[:, k - 1].numpy()[:, None]
    numbers = judge.measure(rows, queries, [judge.Group(np.arange(len(ids)), ids, dists)], k, 0)
    assert numbers["recall_at_10"] == pytest.approx(hits)
    assert numbers["dist_gap_mean"] == pytest.approx(gap.mean())
    checks = judge.checks(numbers, config["limits"])
    if passes:
        assert all(c["ok"] for c in checks.values()), checks
    else:
        assert not checks["dist_gap_mean"]["ok"], checks


def test_search_and_the_pipelined_batch_agree(served):
    config, _, queries, index, _ = served
    ids, dists = _serve(index, config, queries)
    for i in range(0, queries.shape[0], 7):
        hits = index.search(queries[i].numpy(), _params(config))
        np.testing.assert_array_equal([h.id for h in hits], ids[i])
        np.testing.assert_allclose([h.score for h in hits], dists[i], rtol=1e-6)


def _calls(index, config, queries):
    s = config["serving"]
    q = queries[:40].numpy()  # not a power of two
    params = _params(config)
    return {
        "batch_search": lambda: index.batch_search(q, params),
        "batch_search_pipelined": lambda: index.batch_search_pipelined(q, params, 16, 32),
        "batch_search_arrays_pipelined": lambda: index.batch_search_arrays_pipelined(
            q, params, s["batch_size"], s["upload_block"]),
        "batch_search_resident": lambda: index.batch_search_resident(
            index.upload_queries(q), params, 16),
        "search": lambda: index.search(q[0], params),
    }


# scan blocks of each call of _calls: 40 queries in blocks of 16 where the
# call names 16, else in one block padded to 64
DISPATCHES = {"batch_search": 1, "batch_search_pipelined": 3, "batch_search_arrays_pipelined": 1,
              "batch_search_resident": 3, "search": 1}


def _root_of(s, by_id):
    while s.parent:
        s = by_id[s.parent]
    return s


@pytest.mark.parametrize("call", list(DISPATCHES))
def test_a_call_keeps_one_root_with_the_dispatches_inside(served, call):
    config, _, queries, index, _ = served
    run = _calls(index, config, queries)[call]
    run()  # shapes warmed
    profiling.clear()
    with profiling.recording():
        run()
    found = profiling.spans()
    profiling.clear()
    by_id = {s.id: s for s in found}
    names = [s.name for s in found]
    roots = [s for s in found if s.parent == 0 and s.name.startswith("mstg.")]
    root_name = "mstg.search" if call == "search" else "mstg.batch"
    assert [r.name for r in roots] == [root_name], names
    root = roots[0]
    n = 1 if call == "search" else 40
    assert root.counts["queries"] == n
    if call != "search":
        assert root.counts["ef"] == config["serving"]["nprobe"]
        assert root.counts["lists"] == index.posting_list_count()
    # the resident call's queries were encoded before it, by upload_queries
    outside = {s.name for s in found if _root_of(s, by_id) is not root}
    assert outside <= ({"serve.encode", "serve.copy_in"} if call == "batch_search_resident"
                       else set()), outside
    dispatches = [s for s in found if s.name == "search.dispatch"]
    assert len(dispatches) == DISPATCHES[call]
    for d in dispatches:
        assert {"tiles", "plane_tiles", "dense", "rerank", "dedup"} <= set(d.counts)
        assert 0 < d.counts["tiles"] <= d.counts["plane_tiles"]
        assert d.counts["dense"] in (0, 1)
        assert d.counts["tiles"] == d.counts["plane_tiles"] or not d.counts["dense"]
        assert d.counts["dedup"] == 0 and d.counts["rerank"] >= config["serving"]["top_k"]
    assert "serve.fetch" in names and "mstg.dedup" not in names
    assert ("serve.results" in names) == (call != "batch_search_arrays_pipelined")


def test_the_build_keeps_one_root_and_reports_its_spans(served):
    _, rows, _, index, found = served
    by_id = {s.id: s for s in found}
    roots = [s for s in found if s.name == "mstg.build"]
    assert len(roots) == 1 and roots[0].parent == 0
    root = roots[0]
    assert root.counts["rows"] == rows.shape[0]
    assert root.counts["lists"] == index.posting_list_count()
    assert root.counts["replication"] == pytest.approx(index.replication_factor())
    children = {s.name: s for s in found if s.parent == root.id}
    assert {"build.upload", "mstg.clustering", "mstg.closure", "mstg.quantize"} <= set(children)
    assert all(_root_of(s, by_id) is root for s in found)
    r = index.build_report
    assert r["total_s"] == root.seconds
    for key, name in (("upload_s", "build.upload"), ("clustering_s", "mstg.clustering"),
                      ("closure_s", "mstg.closure"), ("quantize_s", "mstg.quantize")):
        assert r[key] == children[name].seconds, key  # unrounded: the span's own seconds
    assert children["mstg.quantize"].counts["rows"] == index.total_rows


def _k1_int8_marks(index, queries, upload):
    """``k1_int8`` of each ``search.dispatch`` span of one pipelined call
    served with ``upload`` queries, and the direct bin scans it made, as
    (query dtype, given a scale) pairs."""
    from rabitq_tpu_torch.ops import fused_scan

    real, seen = fused_scan.fused_bin_scan, []

    def spy(plane, q, *a, f_error=None, q_scale=None, **kw):
        if f_error is None:
            seen.append((q.dtype, q_scale is not None))
        return real(plane, q, *a, f_error=f_error, q_scale=q_scale, **kw)

    saved = index.upload_dtype
    index.upload_dtype = upload
    fused_scan.fused_bin_scan = spy
    profiling.clear()
    try:
        with profiling.recording():
            index.batch_search_arrays_pipelined(queries, _params_of(index), 16, 32)
    finally:
        fused_scan.fused_bin_scan = real
        index.upload_dtype = saved
    found = profiling.spans()
    profiling.clear()
    return [s.counts["k1_int8"] for s in found if s.name == "search.dispatch"], seen


def _params_of(index):
    if isinstance(index, tr.MstgIndex):
        return tr.MstgSearchParams(top_k=10, ef_search=8)
    return tr.SearchParams(top_k=10, nprobe=4)


# the rotated indexes' rows: a slice of the served rows, so that they build fast
SMALL_ROWS, SMALL_DIM = 2048, 256


@pytest.fixture(scope="module")
def rotated(served):
    """The served index's configuration, with its FhtKac rotator, built on
    a slice of its rows."""
    config, rows, _, _, _ = served
    config = json.loads(json.dumps(config))
    config["index"]["use_rotator"] = True
    return spec.program_kind("mstg").build(config, rows[:SMALL_ROWS, :SMALL_DIM], CPU)


@pytest.mark.parametrize("kind, upload, want", [
    ("mstg", "int8", 1), ("mstg", "int4", 1), ("mstg", "f32", 0), ("mstg", "bf16", 0),
    ("mstg_rotated", "int8", 0), ("ivf", "int8", 0)])
def test_k1_takes_int8_codes_only_from_an_unrotated_integer_upload(served, request, kind, upload,
                                                                    want):
    """The bin scan takes the query as int8 codes exactly where it is an
    integer grid: an int8 or int4 upload that no rotation turns to f32. The
    dispatch spans count it (``k1_int8``)."""
    _, rows, queries, index, _ = served
    queries = queries[:40]
    if kind == "mstg_rotated":
        index = request.getfixturevalue("rotated")
    elif kind == "ivf":
        index = tr.IvfRabitqIndex.train(rows[:SMALL_ROWS, :SMALL_DIM], nlist=16, total_bits=7,
                                        seed=3, scan_dtype="fused8", device="cpu")
    if kind != "mstg":
        queries = queries[:, :SMALL_DIM]
    marks, seen = _k1_int8_marks(index, queries.numpy(), upload)
    assert len(marks) == 3 and all(m == want for m in marks)
    assert len(seen) == 3  # every dispatch ran the direct bin scan (K1's EXACT path)
    assert all(s == ((torch.int8, True) if want else (torch.float32, False)) for s in seen)


def test_int8_codes_answer_as_their_f32_values(served):
    """One query set served as int8 uploads (K1 on the codes) and as the f32
    values those codes decode to (K1's three-plane path): the same ids, and
    distances equal to f32 rounding."""
    from rabitq_tpu_torch.index.scan import decode_queries, encode_queries

    config, _, queries, index, _ = served
    q = queries.numpy()
    codes, scale = encode_queries(q, q.shape[0], q.shape[1], "int8")
    q32 = decode_queries(codes, scale, q.shape[1]).numpy()
    saved = index.upload_dtype
    try:
        index.upload_dtype = "int8"
        ids8, d8 = _serve(index, config, queries)
        index.upload_dtype = "f32"
        ids32, d32 = _serve(index, config, torch.from_numpy(q32))
    finally:
        index.upload_dtype = saved
    np.testing.assert_array_equal(ids8, ids32)
    np.testing.assert_allclose(d8, d32, rtol=1e-5, atol=1e-3)


def _replicated(index):
    """An index over ``index``'s codes in which the first row of the second
    posting list carries the id of the first row of the first."""
    h = index.host
    ids = h.ids.copy()
    ids[h.list_offsets[1]] = ids[0]
    fields = ("binary_bits", "ex_codes", "f_add", "f_rescale", "f_add_ex", "f_rescale_ex",
              "delta", "vl", "list_offsets", "centroids", "f_error", "residual_norm")
    out = tr.MstgIndex.from_host_arrays(
        config=index.config, dim=index.dim, ids=ids, scan_dtype=index.scan_dtype, device="cpu",
        **{f: getattr(h, f) for f in fields})
    out.upload_dtype = index.upload_dtype
    return out, int(ids[0])


def test_replicas_run_the_device_dedup_and_no_id_repeats(served):
    config, rows, queries, index, _ = served
    rep, twice = _replicated(index)
    assert rep._has_replicas()
    q = torch.cat([rows[twice][None, :], queries[:31]])
    profiling.clear()
    with profiling.recording():
        ids, dists = _serve(rep, config, q)
    found = profiling.spans()
    profiling.clear()
    dispatches = [s for s in found if s.name == "search.dispatch"]
    assert dispatches and all(d.counts["dedup"] == 1 for d in dispatches)
    by_id = {s.id: s for s in found}
    dedups = [s for s in found if s.name == "mstg.dedup"]
    assert len(dedups) == len(dispatches)
    assert all(by_id[s.parent].name == "search.dispatch" for s in dedups)
    for row in ids:
        row = row[row >= 0]
        assert len(set(row.tolist())) == len(row), row
    assert ids[0, 0] == twice and (ids[0] == twice).sum() == 1
    assert np.isfinite(dists).all() and (np.diff(dists, axis=1) >= 0).all()
