"""The port's streamed tier on the CPU, against the JAX package's.

A JAX index is carried into the port with ``from_host_arrays``; both wrap
it in their ``StreamedIvfIndex`` and serve the same queries chunk by chunk.

Tolerances. ``assemble_host_chunks``: every array bitwise equal. The
streamed search: ids equal per query for every ``scan_dtype`` (the indexes
select survivors exactly, ``approx_topk=False``, where the JAX package
would otherwise use an approximate selection the port has no twin of);
distances rtol 1e-5 for the f32 oracle configuration and 1e-4 elsewhere
(f32 sums of bf16 or int8 products in another order), atol 1e-3.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import rabitq_tpu as jr
import rabitq_tpu_torch as tr
from rabitq_tpu.index import layout as jlayout
from rabitq_tpu.index.streaming import StreamedIvfIndex as JaxStreamed
from rabitq_tpu_torch.index import layout as tlayout
from rabitq_tpu_torch.index.streaming import StreamedIvfIndex

N, DIM, NLIST = 2000, 64, 16
TOP_K, NPROBE = 10, 6
SCAN_DTYPES = ("f32", "bf16", "packed", "fused", "fused8")


def _data(n=N, dim=DIM, seed=42):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((NLIST, dim)).astype(np.float32)
    rows = centers[rng.integers(0, NLIST, n)] + 0.5 * rng.standard_normal((n, dim))
    return rows.astype(np.float32)


def _carry(jidx, scan_dtype) -> tr.IvfRabitqIndex:
    h = jidx.host
    return tr.IvfRabitqIndex.from_host_arrays(
        dim=jidx.dim, padded_dim=jidx.padded_dim,
        metric=tr.Metric.from_str(jidx.metric.value), ex_bits=jidx.ex_bits,
        rotator_type=tr.RotatorType(int(jidx.rotator.rotator_type)),
        rotator_bytes=jidx.rotator.serialize(),
        binary_bits=h.binary_bits, ex_codes=h.ex_codes, f_add=h.f_add,
        f_rescale=h.f_rescale, f_error=h.f_error, f_add_ex=h.f_add_ex,
        f_rescale_ex=h.f_rescale_ex, delta=h.delta, vl=h.vl, ids=h.ids,
        cluster_offsets=h.cluster_offsets, centroids=h.centroids,
        scan_dtype=scan_dtype, approx_topk=jidx.approx_topk, device="cpu",
    )


@pytest.fixture(scope="module")
def jax_index():
    """One trained JAX index per (total_bits, metric), on first use."""
    data = _data()
    cache = {}

    def get(total_bits, metric):
        key = (total_bits, metric)
        if key not in cache:
            cache[key] = jr.IvfRabitqIndex.train(
                data, nlist=NLIST, total_bits=total_bits, seed=3, scan_dtype="f32",
                metric=jr.Metric.from_str(metric),
            )
        return cache[key]

    return data, get


def _pair(jidx, scan_dtype):
    """The JAX index on ``scan_dtype`` with exact survivor selection, and
    its carried copy in the port."""
    jidx.scan_dtype = scan_dtype
    jidx.approx_topk = False
    return jidx, _carry(jidx, scan_dtype)


@pytest.mark.parametrize("total_bits", [1, 7, 8])
@pytest.mark.parametrize("fused", [False, True])
def test_assemble_host_chunks_matches_jax(jax_index, fused, total_bits):
    _, get = jax_index
    h = get(total_bits, "l2").host
    kw = dict(
        n=N, ex_bits=total_bits - 1, binary=h.binary_bits, ex=h.ex_codes, f_add=h.f_add,
        f_rescale=h.f_rescale, f_error=h.f_error, f_add_ex=h.f_add_ex,
        f_rescale_ex=h.f_rescale_ex, cluster_sizes=np.diff(h.cluster_offsets), ids=h.ids,
        chunk_rows=768, fused=fused,
    )
    want = jlayout.assemble_host_chunks(**kw)
    got = tlayout.assemble_host_chunks(**kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert ("binary" in g) == (not fused or total_bits == 1 or total_bits == 8)
        for key in w:
            assert g[key].dtype == np.asarray(w[key]).dtype, key
            np.testing.assert_array_equal(g[key], np.asarray(w[key]), err_msg=key)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("zero_f_error,row_pad", [(True, 128), (False, 256), (True, 64)])
def test_assemble_host_chunks_keywords_match_jax(jax_index, zero_f_error, row_pad, fused):
    """The JAX package's ``zero_f_error`` and ``row_pad`` keywords: the same
    slabs (``fused=True`` pads to the bin kernels' row tiles whatever
    ``row_pad`` says, as in the JAX package)."""
    _, get = jax_index
    h = get(7, "l2").host
    kw = dict(
        n=N, ex_bits=6, binary=h.binary_bits, ex=h.ex_codes, f_add=h.f_add,
        f_rescale=h.f_rescale, f_error=h.f_error, f_add_ex=h.f_add_ex,
        f_rescale_ex=h.f_rescale_ex, cluster_sizes=np.diff(h.cluster_offsets), ids=h.ids,
        chunk_rows=900, zero_f_error=zero_f_error, row_pad=row_pad, fused=fused,
    )
    want = jlayout.assemble_host_chunks(**kw)
    got = tlayout.assemble_host_chunks(**kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["valid"].shape[0] % (tlayout.TN if fused else row_pad) == 0
        assert (g["f_error"] == 0).all() == zero_f_error
        for key in w:
            assert g[key].dtype == np.asarray(w[key]).dtype, key
            np.testing.assert_array_equal(g[key], np.asarray(w[key]), err_msg=key)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("scan_dtype", SCAN_DTYPES)
def test_streamed_search_matches_jax(jax_index, scan_dtype, metric):
    data, get = jax_index
    jidx, tidx = _pair(get(7, metric), scan_dtype)
    js = JaxStreamed(jidx, chunk_rows=700)
    ts = StreamedIvfIndex(tidx, chunk_rows=700)
    assert ts.n_chunks == js.n_chunks and ts.chunk_rows == js.chunk_rows
    assert ts._scan_dtype == js._scan_dtype
    assert sorted(ts._chunks[0]) == sorted(js._chunks[0])
    t_bytes = sum(t.numel() * t.element_size() for c in ts._chunks for t in c.values())
    assert t_bytes == sum(np.asarray(v).nbytes for c in js._chunks for v in c.values())
    queries = data[:20] + 0.05
    params = (TOP_K, NPROBE)
    j_ids, j_d = js.batch_search_arrays(queries, jr.SearchParams(*params))
    t_ids, t_d = ts.batch_search_arrays(queries, tr.SearchParams(*params))
    assert t_ids.shape == (20, TOP_K) and t_ids.dtype == np.int32 and t_d.dtype == np.float32
    assert np.all(np.diff(t_d, axis=1) >= 0)
    np.testing.assert_array_equal(t_ids, j_ids)
    rtol = 1e-5 if scan_dtype == "f32" else 1e-4
    np.testing.assert_allclose(t_d, j_d, rtol=rtol, atol=1e-3)


@pytest.mark.parametrize(
    "scan_dtype,chunk_rows,n_chunks,rows",
    [("f32", 512, 4, 512), ("f32", 100, 8, 256), ("f32", 1000, 3, 896),
     ("fused", 1024, 2, 1024), ("fused", 700, 2, 1024), ("fused", 2000, 2, 1536), ("fused", 2048, 1, 2048)],
)
def test_chunk_rounding(jax_index, scan_dtype, chunk_rows, n_chunks, rows):
    """``chunk_rows`` rounds down to the padding unit (128 rows, or the bin
    kernels' 512-row tiles for the fused scans), with at least two units a
    chunk, as the JAX tier rounds it (``tests/test_ivf.py``)."""
    _, get = jax_index
    jidx, tidx = _pair(get(7, "l2"), scan_dtype)
    ts = StreamedIvfIndex(tidx, chunk_rows=chunk_rows)
    js = JaxStreamed(jidx, chunk_rows=chunk_rows)
    assert (ts.n_chunks, ts.chunk_rows) == (n_chunks, rows) == (js.n_chunks, js.chunk_rows)
    for c in ts._chunks:
        assert c["valid"].shape[0] % (512 if scan_dtype == "fused" else 128) == 0
    # the fused tier's TOTAL plane leaves the dense binary plane behind
    assert ("binary" in ts._chunks[0]) == (scan_dtype == "f32")


def test_packed_streams_as_bf16(jax_index):
    _, get = jax_index
    _, tidx = _pair(get(7, "l2"), "packed")
    ts = StreamedIvfIndex(tidx, chunk_rows=512)
    assert ts._scan_dtype == "bf16" and tidx.scan_dtype == "packed"
    assert "packed" not in ts._chunks[0]


@pytest.mark.parametrize("scan_dtype", ["f32", "fused8"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_filter_and_search_results(jax_index, scan_dtype, metric):
    """``filter_ids`` as an id array and as a bool mask (the JAX tier's
    host-side mask, here each chunk's ``valid & allowed[ids]``), and
    ``batch_search``'s results with the score's sign per metric."""
    data, get = jax_index
    jidx, tidx = _pair(get(7, metric), scan_dtype)
    js = JaxStreamed(jidx, chunk_rows=512)
    ts = StreamedIvfIndex(tidx, chunk_rows=512)
    queries = data[:8]
    params = (TOP_K, NLIST)
    allowed = np.arange(1, N, 3)
    mask = np.zeros(N + 40, bool)
    mask[allowed] = True
    for filt in (allowed, mask, np.array([-1, 5, 7, N + 100])):
        j_ids, _ = js.batch_search_arrays(queries, jr.SearchParams(*params), filt)
        t_ids, _ = ts.batch_search_arrays(queries, tr.SearchParams(*params), filt)
        np.testing.assert_array_equal(t_ids, j_ids)
    t_ids, _ = ts.batch_search_arrays(queries, tr.SearchParams(*params), allowed)
    assert (t_ids >= 0).all() and (t_ids % 3 == 1).all()
    t_ids, t_d = ts.batch_search_arrays(queries, tr.SearchParams(*params), np.array([-1, 5, 7]))
    assert set(t_ids[t_ids >= 0].tolist()) <= {5, 7} and (t_ids[:, 2:] == -1).all()
    assert np.isinf(t_d[:, 2:]).all()
    hits = ts.batch_search(queries, tr.SearchParams(*params))
    j_hits = js.batch_search(queries, jr.SearchParams(*params))
    t_ids, t_d = ts.batch_search_arrays(queries, tr.SearchParams(*params))
    sign = 1.0 if metric == "l2" else -1.0
    for row, j_row, ids, d in zip(hits, j_hits, t_ids, t_d):
        assert all(isinstance(h, tr.SearchResult) for h in row)
        assert [h.id for h in row] == [h.id for h in j_row] == ids.tolist()
        np.testing.assert_allclose([h.score for h in row], sign * d, rtol=1e-6)
        np.testing.assert_allclose([h.score for h in row], [h.score for h in j_row],
                                   rtol=1e-4, atol=1e-3)
    assert hits[0][0].id == 0


def test_batch_sizes_pad_like_in_memory(jax_index):
    """Batches of 1, 8 and 40 queries (under, at and over one 32-query
    block of the bin kernel) serve the ids of the same queries in one
    batch of 64; distances to atol 1e-4 (the re-rank's f32 product sums in
    an order that may depend on the batch's shape)."""
    data, get = jax_index
    _, tidx = _pair(get(7, "l2"), "fused8")
    ts = StreamedIvfIndex(tidx, chunk_rows=1024)
    queries = data[100:164]
    full, full_d = ts.batch_search_arrays(queries, tr.SearchParams(TOP_K, NPROBE))
    for b in (1, 8, 40):
        ids, d = ts.batch_search_arrays(queries[:b], tr.SearchParams(TOP_K, NPROBE))
        np.testing.assert_array_equal(ids, full[:b])
        np.testing.assert_allclose(d, full_d[:b], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("scan_dtype", ["f32", "fused8"])
def test_wrapped_index_serves_again(jax_index, scan_dtype):
    """Wrapping releases the index's device layout in both packages; each
    index then lays itself out again from its host copy and serves the ids
    it gave before (the port's ``layout`` rebuilt from ``_host``)."""
    data, get = jax_index
    jidx, tidx = _pair(get(7, "l2"), scan_dtype)
    queries = data[:12]
    params = (TOP_K, NPROBE)
    j_before, _ = jidx.batch_search_arrays(queries, jr.SearchParams(*params))
    t_before, t_d_before = tidx.batch_search_arrays(queries, tr.SearchParams(*params))
    JaxStreamed(jidx, chunk_rows=512)
    StreamedIvfIndex(tidx, chunk_rows=512)
    assert jidx._device is None and tidx._layout is None and tidx._plan.packed is None
    j_after, _ = jidx.batch_search_arrays(queries, jr.SearchParams(*params))
    t_after, t_d_after = tidx.batch_search_arrays(queries, tr.SearchParams(*params))
    assert tidx._layout is not None
    np.testing.assert_array_equal(j_after, j_before)
    np.testing.assert_array_equal(t_after, t_before)
    np.testing.assert_array_equal(t_d_after, t_d_before)
    np.testing.assert_array_equal(t_after, j_after)
    # a truly empty index still refuses
    empty = tr.IvfRabitqIndex(DIM, DIM, tr.Metric.L2, tidx.rotator, 6, device="cpu")
    with pytest.raises(tr.EmptyIndex):
        empty.layout  # noqa: B018


def test_one_chunk_equals_in_memory_two_stage(jax_index, monkeypatch):
    """One chunk holding every row serves what the in-memory index serves
    through its two-stage fused scan: the same rows, bins and re-rank."""
    data, get = jax_index
    _, tidx = _pair(get(7, "l2"), "fused8")
    monkeypatch.setenv("RABITQ_FUSED_EXACT", "0")
    queries = data[:40] + 0.1
    want = {np_: tidx.batch_search_arrays(queries, tr.SearchParams(TOP_K, np_))
            for np_ in (NPROBE, NLIST)}
    ts = StreamedIvfIndex(tidx, chunk_rows=N + 512)
    assert ts.n_chunks == 1
    for np_, (w_ids, w_d) in want.items():
        ids, d = ts.batch_search_arrays(queries, tr.SearchParams(TOP_K, np_))
        np.testing.assert_array_equal(ids, w_ids)
        np.testing.assert_allclose(d, w_d, rtol=1e-6)

