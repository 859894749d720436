"""The port's IVF index end to end on the CPU, against the JAX package.

A JAX index (3000 x 128, nlist 48, 7 bits, fused8) is carried into the
port with ``from_host_arrays``; both then search the same codes.
Tolerances: per query the top-10 overlap is >= 9/10 and the mean >= 0.98;
distances of common ids agree to rtol 1e-3 (the f32 dot sums in another
order). Then an index built by the port alone must clear the recall bar
``tests/test_fused_exact.py`` sets against its naive-scan oracle. An index
made in the JAX package's shape, ``IvfRabitqIndex(..., ex_bits, host)``,
serves as the JAX index made the same way (ids equal on the f32 oracle
configuration).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import rabitq_tpu as jr
import rabitq_tpu_torch as tr
from rabitq_tpu_torch.index.ivf import HostCodes
from rabitq_tpu_torch.index.scan import ex_plane_is_total
from rabitq_tpu_torch.ops.rotation import deserialize_rotator

N, DIM, NLIST = 3000, 128, 48
PARAMS = (10, 6)  # top_k, nprobe


def _data():
    return np.random.default_rng(42).standard_normal((N, DIM)).astype(np.float32)


def _carry(jidx) -> tr.IvfRabitqIndex:
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
        scan_dtype="fused8", device="cpu",
    )


@pytest.fixture(scope="module", params=["l2", "ip"])
def pair(request):
    data = _data()
    jidx = jr.IvfRabitqIndex.train(
        data, nlist=NLIST, total_bits=7, metric=jr.Metric.from_str(request.param),
        seed=3, scan_dtype="fused8",
    )
    return data, jidx, _carry(jidx)


def _agree(j_ids, j_d, t_ids, t_d):
    overlaps = []
    for i in range(len(j_ids)):
        common = set(j_ids[i].tolist()) & set(t_ids[i].tolist())
        overlaps.append(len(common) / j_ids.shape[1])
        jm = dict(zip(j_ids[i].tolist(), j_d[i].tolist()))
        for rid, dist in zip(t_ids[i].tolist(), t_d[i].tolist()):
            if rid in jm and np.isfinite(dist):
                assert dist == pytest.approx(jm[rid], rel=1e-3, abs=1e-3), (i, rid)
    assert min(overlaps) >= 0.9 and np.mean(overlaps) >= 0.98, overlaps


def test_carried_index_state(pair):
    _, jidx, tidx = pair
    assert len(tidx) == len(jidx) and tidx.cluster_count() == jidx.cluster_count()
    assert jidx._fused_exact_ok()  # the JAX index serves the EXACT scan too
    jidx._scan_inputs(None)  # builds the JAX index's c_blk windows
    tidx._scan_inputs(None)
    jdev, tdev = jidx.device, tidx.layout
    np.testing.assert_array_equal(tdev.ex.numpy(), np.asarray(jdev.ex))
    np.testing.assert_array_equal(tdev.ids.numpy(), np.asarray(jdev.ids))
    np.testing.assert_array_equal(tidx._plan.c_blk.numpy(), np.asarray(jidx._fused_cblk))
    for nprobe in (1, 4, 6, 48):
        # the port sizes its lists per 32-query block, whatever the batch:
        # the JAX rule at that block
        assert tidx._plan.max_tiles(tidx.scan_dtype, nprobe) == _jax_max_tiles(jidx, nprobe, 32)


def _jax_max_tiles(jidx, nprobe, bt):
    from rabitq_tpu.index.layout import pad_rows
    from rabitq_tpu.ops.pallas_fused_scan import TN, expected_tile_cost, probed_tile_bound

    sizes = np.diff(jidx._offsets)
    n_tiles = pad_rows(len(jidx), TN) // TN
    if expected_tile_cost(sizes, nprobe, batch_tile=bt) >= 0.6 * n_tiles:
        return None
    bound = probed_tile_bound(sizes, nprobe, batch_tile=bt)
    return min(1 << (bound - 1).bit_length(), n_tiles)


def test_batch_search_arrays_matches_jax(pair):
    data, jidx, tidx = pair
    params = jr.SearchParams(*PARAMS)
    j_ids, j_d = jidx.batch_search_arrays(data[:24], params)
    t_ids, t_d = tidx.batch_search_arrays(data[:24], tr.SearchParams(*PARAMS))
    assert t_ids.dtype == np.int32 and t_d.dtype == np.float32
    _agree(j_ids, j_d, t_ids, t_d)
    # results come sorted; under L2 each query finds itself first
    assert np.all(np.diff(t_d, axis=1) >= 0)
    if jidx.metric is jr.Metric.L2:
        assert np.mean(t_ids[:, 0] == np.arange(24)) == 1.0


@pytest.mark.parametrize("upload", ["f32", "int8", "int4"])
def test_pipelined_uploads_match_jax(pair, upload):
    data, jidx, tidx = pair
    queries = data[100:124]
    jidx.upload_dtype = tidx.upload_dtype = upload
    try:
        j_ids, j_d = jidx.batch_search_arrays_pipelined(
            queries, jr.SearchParams(*PARAMS), batch_size=8, upload_block=16
        )
        t_ids, t_d = tidx.batch_search_arrays_pipelined(
            queries, tr.SearchParams(*PARAMS), batch_size=8, upload_block=16
        )
        t_one, t_one_d = tidx.batch_search_arrays(queries, tr.SearchParams(*PARAMS))
    finally:
        jidx.upload_dtype = tidx.upload_dtype = "f32"
    _agree(j_ids, j_d, t_ids, t_d)
    np.testing.assert_array_equal(t_ids, t_one)
    np.testing.assert_allclose(t_d, t_one_d, rtol=1e-6)


def test_search_filtered_matches_jax(pair):
    data, jidx, tidx = pair
    allowed = np.arange(0, N, 2)
    params = (10, NLIST)
    j = jidx.search_filtered(data[0], jr.SearchParams(*params), allowed)
    t = tidx.search_filtered(data[0], tr.SearchParams(*params), allowed)
    assert t and all(h.id % 2 == 0 for h in t)
    assert len({h.id for h in j} & {h.id for h in t}) >= 9
    hits = tidx.search(data[1], tr.SearchParams(*PARAMS))
    assert len(hits) == 10
    if jidx.metric is jr.Metric.L2:
        assert t[0].id == 0 and hits[0].id == 1


def _port_naive(index, data, query, top_k, nprobe):
    """Naive scan (reference ivf.rs:2143-2240) over the port's own codes:
    every row of the nprobe nearest clusters, extended estimator."""
    lay = index.layout
    q_rot = index.rotator.rotate(torch.from_numpy(query[None, :]))[0].numpy()
    cents = lay.centroids.numpy()
    sq = np.sum((cents - q_rot) ** 2, axis=1)
    probed = np.lexsort((np.arange(len(sq)), sq))[:nprobe]
    cb = -((1 << index.ex_bits) - 0.5)
    plane = lay.ex.numpy()[:, : index.padded_dim].astype(np.float32)
    out = []
    for c in probed:
        s, e = int(index._offsets[c]), int(index._offsets[c + 1])
        dist = lay.f_add_ex.numpy()[s:e] + sq[c] + lay.f_rescale_ex.numpy()[s:e] * (
            plane[s:e] @ q_rot + cb * q_rot.sum()
        )
        out += list(zip(lay.ids.numpy()[s:e].tolist(), dist.tolist()))
    out.sort(key=lambda t: t[1])
    return out[:top_k]


def _jax_shaped(jidx, scan_dtype) -> tr.IvfRabitqIndex:
    """The port's index made as the JAX package makes one over codes it
    already holds (``io/persistence.py``, ``parallel/sharding.py``):
    ``IvfRabitqIndex(dim, padded_dim, metric, rotator, ex_bits, host,
    scan_dtype)``, the JAX index's ``HostCodes`` carried across as numpy."""
    h = jidx.host
    host = HostCodes(**{f.name: np.array(getattr(h, f.name)) for f in dataclasses.fields(h)})
    rotator = deserialize_rotator(
        jidx.dim, jidx.padded_dim, tr.RotatorType(int(jidx.rotator.rotator_type)),
        jidx.rotator.serialize())
    return tr.IvfRabitqIndex(
        jidx.dim, jidx.padded_dim, tr.Metric.from_str(jidx.metric.value), rotator,
        jidx.ex_bits, host, scan_dtype, device="cpu")


def test_jax_shaped_constructor_serves_the_host_codes(pair):
    """The carried-state configuration (7 bits, fused8): an index made over
    the JAX index's host codes lays itself out at its first search and
    serves as the JAX index made the same way does (the tolerance above),
    with ids and distances equal to the carried index's."""
    data, jidx, tidx = pair
    made = _jax_shaped(jidx, "fused8")
    assert made._layout is None and len(made) == len(jidx)
    assert made.cluster_count() == jidx.cluster_count()
    jmade = jr.IvfRabitqIndex(jidx.dim, jidx.padded_dim, jidx.metric, jidx.rotator,
                              jidx.ex_bits, jidx.host, "fused8")
    params = (jr.SearchParams(*PARAMS), tr.SearchParams(*PARAMS))
    j_ids, j_d = jmade.batch_search_arrays(data[:24], params[0])
    t_ids, t_d = made.batch_search_arrays(data[:24], params[1])
    assert made.layout is not None and made.host is made._host
    _agree(j_ids, j_d, t_ids, t_d)
    c_ids, c_d = tidx.batch_search_arrays(data[:24], params[1])
    np.testing.assert_array_equal(t_ids, c_ids)
    np.testing.assert_array_equal(t_d, c_d)


def test_jax_shaped_constructor_f32_oracle():
    """The f32 oracle configuration (exact selection): ids equal to the JAX
    index's, distances to rtol 1e-5 (f32 sums in another order)."""
    data = _data()[:800, :64]
    jidx = jr.IvfRabitqIndex.train(data, nlist=8, total_bits=7, seed=3, scan_dtype="f32")
    made = _jax_shaped(jidx, "f32")
    assert not made.approx_topk
    params = (jr.SearchParams(10, 4), tr.SearchParams(10, 4))
    j_ids, j_d = jidx.batch_search_arrays(data[:32] + 0.05, params[0])
    t_ids, t_d = made.batch_search_arrays(data[:32] + 0.05, params[1])
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_d, j_d, rtol=1e-5, atol=1e-4)


def test_port_alone_matches_naive_oracle():
    data = _data()
    index = tr.IvfRabitqIndex.train(
        data, nlist=NLIST, total_bits=7, seed=3, scan_dtype="fused8", device="cpu"
    )
    assert ex_plane_is_total(index.ex_bits)
    params = tr.SearchParams(top_k=10, nprobe=6)
    for qi in range(8):
        fast = {h.id: h.score for h in index.search(data[qi], params)}
        naive = _port_naive(index, data, data[qi], 10, 6)
        assert len(set(fast) & {i for i, _ in naive}) >= 9
        for nid, nd in naive:
            if nid in fast:
                denom = max(abs(nd), abs(fast[nid]), 2.0 * DIM * 0.35)
                assert abs(fast[nid] - nd) / denom < 0.03


def test_unported_paths_raise():
    """An unknown scan_dtype builds, as in the reference, and raises
    ValueError at the first scan; what the port refused before the dense and
    two-stage scans were ported, it now serves."""
    data = _data()[:600]
    params = tr.SearchParams(top_k=5, nprobe=8)
    unknown = tr.IvfRabitqIndex.train(data, nlist=8, total_bits=7, scan_dtype="fp4", device="cpu")
    with pytest.raises(ValueError, match="fp4"):
        unknown.search(data[0], params)
    dense = tr.IvfRabitqIndex.train(data, nlist=8, total_bits=7, scan_dtype="bf16", device="cpu")
    assert dense.search(data[0], params)[0].id == 0
    wide_bits = tr.IvfRabitqIndex.train(
        data, nlist=8, total_bits=8, scan_dtype="fused8", device="cpu"
    )
    assert not wide_bits._plan.fused_exact(wide_bits.scan_dtype)  # raw ex plane: two-stage
    assert wide_bits.search(data[0], params)[0].id == 0
    # 300 clusters over 600 rows: a 512-row tile spans > 128 clusters
    tiny = tr.IvfRabitqIndex.train_with_clusters(
        data, data[:300].copy(), np.arange(600) % 300, 7, scan_dtype="fused8", device="cpu"
    )
    assert tiny.scan_dtype == "bf16"
    assert tiny.search(data[0], tr.SearchParams(top_k=5, nprobe=300))[0].id == 0
    wide = np.random.default_rng(1).standard_normal((600, 2700)).astype(np.float32)
    idx = tr.IvfRabitqIndex.train_with_clusters(
        wide, wide[:2].copy(), np.arange(600) % 2, 7, scan_dtype="fused8", device="cpu"
    )
    assert idx.scan_dtype == "fused8" and not idx._plan.fused_exact("fused8")  # 2752 > 2560
    assert idx.search(wide[0], tr.SearchParams(top_k=5, nprobe=2))[0].id == 0


def test_input_errors(pair):
    data, _, tidx = pair
    with pytest.raises(tr.DimensionMismatch):
        tidx.batch_search_arrays(data[:2, :64], tr.SearchParams(*PARAMS))
    ids, d = tidx.batch_search_arrays(data[:3], tr.SearchParams(0, 4))
    assert ids.shape == (3, 0) and d.shape == (3, 0)
    with pytest.raises(tr.InvalidConfig):
        tr.IvfRabitqIndex.train(data, nlist=N + 1, total_bits=7, device="cpu")


def test_clamp_l2_clamps_after_ranking(pair):
    from rabitq_tpu_torch.index.scan import scan_kernel

    data, _, tidx = pair
    tidx._scan_inputs(None)
    lay = tidx.layout
    q_rot = tidx.rotator.rotate(torch.from_numpy(data[:8]))
    args = (q_rot, lay.centroids, lay.binary, lay.ex, lay.f_add, lay.f_rescale, lay.f_error,
            lay.f_add_ex, lay.f_rescale_ex, lay.cluster_of, lay.valid, lay.ids)
    kw = dict(nprobe=6, fused_cblk=tidx._plan.c_blk, top_k=10, rerank=400, metric=tidx.metric,
              ex_bits=tidx.ex_bits, scan_dtype="fused8", fused_exact=True)
    ids, d = scan_kernel(*args, **kw)
    c_ids, c_d = scan_kernel(*args, clamp_l2=True, **kw)
    assert torch.equal(ids, c_ids)
    want = torch.clamp_min(d, 0.0) if tidx.metric.value == "l2" else d
    assert torch.equal(c_d, want)


@pytest.mark.parametrize("upload", ["f32", "bf16", "int8", "int4"])
def test_resident_queries(pair, upload):
    """upload_queries + batch_search_resident equal batch_search_arrays on
    the same upload_dtype (ids equal, distances to rtol 1e-6), and with f32
    uploads agree with the JAX package's resident path."""
    data, jidx, tidx = pair
    queries = data[200:237]
    tidx.upload_dtype = upload
    try:
        handle = tidx.upload_queries(queries)
        r_ids, r_d = tidx.batch_search_resident(handle, tr.SearchParams(*PARAMS), batch_size=16)
        a_ids, a_d = tidx.batch_search_arrays(queries, tr.SearchParams(*PARAMS))
        empty = tidx.batch_search_resident(handle, tr.SearchParams(0, 4))
    finally:
        tidx.upload_dtype = "f32"
    assert r_ids.shape == (37, 10) and empty[0].shape == (37, 0)
    np.testing.assert_array_equal(r_ids, a_ids)
    np.testing.assert_allclose(r_d, a_d, rtol=1e-6)
    if upload == "f32":
        j_ids, j_d = jidx.batch_search_resident(
            jidx.upload_queries(queries), jr.SearchParams(*PARAMS), batch_size=16
        )
        _agree(j_ids, j_d, r_ids, r_d)
