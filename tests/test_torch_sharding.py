"""The port's sharded tier on the CPU, against the JAX package's.

The JAX side runs ``rabitq_tpu.parallel.sharding`` on its 8-device virtual
CPU mesh (``tests/conftest.py``), with the Pallas kernels in interpret mode
as its own tests run them; the port's side runs on a mesh of eight CPU
devices (``make_mesh(devices=["cpu"] * 8)``). JAX indexes are carried into
the port with ``from_host_arrays``, so both shard and search the same codes.

Tolerances. Mesh placement and the k-means step: assignments and counts
equal, segment sums rtol 1e-4 (atol 1e-3: f32 sums in another order). Whole
k-means runs: objective within 3% (both draw the k-means++ init from
``PRNGKey(seed * 1_000_003)``, but the f32 products and cumulative sums
round otherwise, so runs part once a draw lands within rounding of a
boundary); on integer-valued rows, where those sums are exact, the init
picks the JAX package's rows and one step gives its centroids bitwise. Built codes: equal except <= 0.1%
of entries off by one level (a rotated coordinate on a level boundary moves
with the f32 summation order); factors rtol 1e-5 on rows whose codes are
equal, atol 1e-4 (inner-product factors are 1 minus dot products of ~10,
summed in another order).
Sharded IVF search: ids equal per query for every ``scan_dtype``, the
indexes selecting survivors exactly (``approx_topk=False`` on both sides,
where the JAX wrapper would otherwise take ``approx_max_k``, which the port
has no twin of); distances rtol 1e-5 for ``f32`` and 1e-4 elsewhere, atol
1e-3. Sharded MSTG with replicas: ids equal per query and scores rtol 1e-4
for the dense scans; through the EXACT scan (``fused8``: bins selected on
values with bf16 g terms, f32 sums in another order) top-10 overlap >= 0.9
per query and >= 0.98 on average, scores of common ids rtol 1e-3, as
``tests/test_torch_mstg.py`` holds the in-memory index.
A sharded train against the JAX package's: objective within 3%, recall@10
within 0.02. One shard against the in-memory index: ids and distances
equal.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

import rabitq_tpu as jr
import rabitq_tpu_torch as tr
from rabitq_tpu.ops.rotation import make_rotator as jmake_rotator
from rabitq_tpu.parallel import sharding as jsh
from rabitq_tpu_torch.index.build import exact_t_rows
from rabitq_tpu_torch.ops.rotation import deserialize_rotator
from rabitq_tpu_torch.parallel import sharding as tsh

N, DIM, NLIST = 3000, 64, 16
TOP_K, NPROBE = 10, 6
SCAN_DTYPES = ("f32", "bf16", "int8", "packed", "fused", "fused8")
MSTG_FIELDS = ("binary_bits", "ex_codes", "f_add", "f_rescale", "f_add_ex", "f_rescale_ex",
               "delta", "vl", "ids", "list_offsets", "centroids", "f_error", "residual_norm")


def _data(n=N, dim=DIM, seed=42, centers=NLIST):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, dim)).astype(np.float32)
    return (c[rng.integers(0, centers, n)] + 0.5 * rng.standard_normal((n, dim))).astype(np.float32)


def _blobs(n, dim=DIM, seed=2, k=6, spread=8.0):
    """Six separated blobs: under 24 centroids every blob is seeded, so a
    k-means objective hardly depends on the seeds drawn."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim)).astype(np.float32) * spread
    return (centers[rng.integers(0, k, n)] + rng.standard_normal((n, dim))).astype(np.float32)


def _mesh(n=8):
    return tsh.make_mesh(devices=["cpu"] * n)


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


@pytest.fixture
def exact_jax_selection(monkeypatch):
    """The JAX wrappers' scans with exact survivor selection: the JAX
    ``ShardedIvfIndex`` leaves ``approx_topk`` at its default."""
    monkeypatch.setattr(jsh, "sharded_scan", functools.partial(jsh.sharded_scan, approx_topk=False))


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
    """The JAX index on ``scan_dtype`` with exact survivor selection, and its
    carried copy in the port."""
    jidx.scan_dtype = scan_dtype
    jidx.approx_topk = False
    return jidx, _carry(jidx, scan_dtype)


def test_mesh_and_shard_rows_match_jax():
    mesh = _mesh()
    assert mesh.shape[tsh.SHARD_AXIS] == 8 == jsh.make_mesh(8).shape[jsh.SHARD_AXIS]
    assert tsh.make_mesh(3, devices=["cpu"] * 8).shape[tsh.SHARD_AXIS] == 3
    assert tsh.make_mesh(20, devices=["cpu"] * 8).devices == mesh.devices  # what there is
    x = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    (got,) = tsh.shard_rows(mesh, x)
    (want,) = jsh.shard_rows(jsh.make_mesh(8), x)
    shards = sorted(want.addressable_shards, key=lambda s: s.index[0].start)
    assert len(got) == len(shards) == 8
    for g, w in zip(got, shards):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w.data))
    t = torch.from_numpy(x)
    (views,) = tsh.shard_rows(mesh, t)
    assert all(v.data_ptr() == t[8 * i].data_ptr() for i, v in enumerate(views))  # no copy
    with pytest.raises(ValueError):
        tsh.shard_rows(mesh, x[:60])
    (rep,) = tsh.replicate(mesh, x)
    assert len(rep) == 8 and all(r is rep[0] for r in rep)  # one copy a distinct device
    with pytest.raises(ValueError):
        tsh.Mesh(())


def test_merge_keeps_lax_top_k_tie_order():
    rng = np.random.default_rng(0)
    dists = rng.integers(0, 4, (6, 4 * 5)).astype(np.float32)  # many ties
    dists[0, :3] = np.inf
    ids = rng.integers(0, 1000, dists.shape).astype(np.int32)
    g_ids, g_d = tsh._merge_topk(
        list(torch.from_numpy(ids).split(5, dim=1)), list(torch.from_numpy(dists).split(5, dim=1)),
        7, torch.device("cpu"),
    )
    neg, pos = jax.lax.top_k(-dists, 7)
    np.testing.assert_array_equal(g_ids.numpy(), np.take_along_axis(ids, np.asarray(pos), 1))
    np.testing.assert_array_equal(g_d.numpy(), -np.asarray(neg))


@pytest.mark.parametrize("padded", [False, True])
def test_kmeans_step_matches_numpy_and_jax(padded):
    data = np.random.default_rng(0).standard_normal((1024, 64)).astype(np.float32)
    k = 8
    cents = data[:k].copy()
    n = 1000 if padded else 1024  # padding rows go to the scratch segment
    valid = np.arange(1024) < n
    mesh, jmesh = _mesh(), jsh.make_mesh(8)
    (x_sh, v_sh), (c_rep,) = tsh.shard_rows(mesh, data, valid), tsh.replicate(mesh, cents)
    sums, counts, assign = tsh.sharded_kmeans_step(x_sh, c_rep, v_sh, mesh=mesh, k=k, block=64)
    jx, jv = jsh.shard_rows(jmesh, data, valid)
    (jc,) = jsh.replicate(jmesh, cents)
    j_sums, j_counts, j_assign = jsh.sharded_kmeans_step(jx, jc, jv, mesh=jmesh, k=k, block=64)
    assign = torch.cat(assign).numpy()
    ref = ((data[:, None, :] - cents[None]) ** 2).sum(-1).argmin(1)
    np.testing.assert_array_equal(assign, ref)
    np.testing.assert_array_equal(assign, np.asarray(j_assign))
    ref_counts = np.bincount(ref[:n], minlength=k).astype(np.float32)
    np.testing.assert_array_equal(counts.numpy(), ref_counts)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    for c in range(k):
        np.testing.assert_allclose(sums[c].numpy(), data[:n][ref[:n] == c].sum(0),
                                   rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(sums.numpy(), np.asarray(j_sums), rtol=1e-4, atol=1e-3)


def test_kmeans_init_picks_the_jax_rows(monkeypatch):
    """On integer-valued rows the sharded init draws what the JAX one draws
    (``PRNGKey(seed * 1_000_003)`` on the same subsample), so it picks the
    same rows, and one step (integer sums, one division) gives the same
    centroids bitwise."""
    from rabitq_tpu.ops import kmeans as jk

    data = np.random.default_rng(4).integers(-4, 5, (4096, 32)).astype(np.float32)
    picks = {"jax": [], "port": []}

    def spy(fn, side):
        def call(*a, **kw):
            out = fn(*a, **kw)
            picks[side].append(np.asarray(out))
            return out
        return call

    monkeypatch.setattr(jk, "_kmeanspp_init", spy(jk._kmeanspp_init, "jax"))
    monkeypatch.setattr(tsh, "_kmeanspp_init", spy(tsh._kmeanspp_init, "port"))
    for seed in (5, 6):
        km = tsh.sharded_kmeans(data, 24, mesh=_mesh(), niter=1, seed=seed)
        j_km = jsh.sharded_kmeans(data, 24, mesh=jsh.make_mesh(8), niter=1, seed=seed)
        np.testing.assert_array_equal(picks["port"][-1], picks["jax"][-1])
        np.testing.assert_array_equal(km.centroids.numpy(), j_km.centroids)
        np.testing.assert_array_equal(km.assignments, j_km.assignments)
    assert not np.array_equal(picks["port"][0], picks["port"][1])


def test_kmeans_objective_close_to_jax():
    data = _blobs(3000)
    km = tsh.sharded_kmeans(data, 24, mesh=_mesh(), niter=8, seed=5)
    j_km = jsh.sharded_kmeans(data, 24, mesh=jsh.make_mesh(8), niter=8, seed=5)
    assert km.assignments.shape == (3000,) and km.assignments.dtype == np.int32
    assert tuple(km.centroids.shape) == (24, DIM) and km.iters == 8
    c = km.centroids.numpy()
    want = float(np.sum((data - c[km.assignments]) ** 2, dtype=np.float64))
    assert km.objective == pytest.approx(want, rel=1e-5)
    assert abs(km.objective - j_km.objective) <= 0.03 * j_km.objective


@pytest.mark.parametrize("metric,faster", [("l2", True), ("ip", False)])
def test_build_codes_match_jax(metric, faster):
    data = _data(n=1000)
    ex_bits, seed = 6, 3
    jrot = jmake_rotator(DIM, jr.RotatorType.FhtKacRotator, seed)
    trot = deserialize_rotator(DIM, jrot.padded_dim, tr.RotatorType.FhtKacRotator,
                               jrot.serialize())
    raw_cents = data[:NLIST]
    assign = ((data[:, None, :] - raw_cents[None]) ** 2).sum(-1).argmin(1)
    order = np.argsort(assign, kind="stable")
    assign_sorted = assign[order]
    rotated = jrot.rotate_np(raw_cents)
    t_const, t_rows = 0.0, None
    if faster:
        t_const = 0.8
    else:
        t_rows = exact_t_rows(data, raw_cents, assign_sorted, order, trot, ex_bits)
    kw = dict(ex_bits=ex_bits, use_t_const=faster, t_const=t_const, t_rows=t_rows)
    want = jsh.sharded_build_codes(
        data[order], rotated, assign_sorted, mesh=jsh.make_mesh(8), rotator=jrot,
        metric=jr.Metric.from_str(metric), **kw)
    got = tsh.sharded_build_codes(
        data[order], rotated, assign_sorted, mesh=_mesh(), rotator=trot,
        metric=tr.Metric.from_str(metric), **kw)
    assert sorted(got) == sorted(want)
    same_rows = np.ones(len(data), bool)
    for name in ("binary", "ex"):
        assert got[name].dtype == want[name].dtype
        diff = np.abs(got[name].astype(np.int32) - want[name].astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
        same_rows &= (diff == 0).all(axis=1)
    assert same_rows.mean() > 0.9
    for name, w in want.items():
        if name in ("binary", "ex"):
            continue
        assert got[name].dtype == np.float32
        np.testing.assert_allclose(got[name][same_rows], w[same_rows], rtol=1e-5, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize(
    "total_bits,metric,scan_dtype",
    [(7, m, s) for s in SCAN_DTYPES for m in ("l2", "ip")] + [(8, "l2", "fused8")],
)
def test_sharded_ivf_matches_jax(jax_index, exact_jax_selection, total_bits, metric, scan_dtype):
    data, get = jax_index
    jidx, tidx = _pair(get(total_bits, metric), scan_dtype)
    js = jsh.ShardedIvfIndex(jidx, jsh.make_mesh(8))
    ts = tsh.ShardedIvfIndex(tidx, _mesh())
    assert ts._slab_rows == js._slab_rows and tidx.scan_dtype == scan_dtype
    assert ts._fused == js._fused and ts._packed_mode == js._packed_mode
    for a, b in zip(ts._rows, js._rows):  # the same rows in every shard
        assert tuple(torch.cat(a).shape) == b.shape
    np.testing.assert_array_equal(torch.cat(ts._rows[9]).numpy(), np.asarray(js._rows[9]))
    queries = data[:20] + 0.05
    j_ids, j_d = js.batch_search_arrays(queries, jr.SearchParams(TOP_K, NPROBE))
    t_ids, t_d = ts.batch_search_arrays(queries, tr.SearchParams(TOP_K, NPROBE))
    assert t_ids.shape == (20, TOP_K) and t_ids.dtype == np.int32 and t_d.dtype == np.float32
    assert np.all(np.diff(t_d, axis=1) >= 0)
    np.testing.assert_array_equal(t_ids, j_ids)
    rtol = 1e-5 if scan_dtype == "f32" else 1e-4
    np.testing.assert_allclose(t_d, j_d, rtol=rtol, atol=1e-3)


@pytest.mark.parametrize("scan_dtype", ["f32", "fused8"])
def test_filtered_search_matches_jax(jax_index, exact_jax_selection, scan_dtype):
    data, get = jax_index
    jidx, tidx = _pair(get(7, "l2"), scan_dtype)
    js = jsh.ShardedIvfIndex(jidx, jsh.make_mesh(8))
    ts = tsh.ShardedIvfIndex(tidx, _mesh())
    queries = data[:20] + 0.05
    allowed = np.arange(1, N, 3)
    mask = np.zeros(N + 40, bool)
    mask[allowed] = True
    for filt in (allowed, mask, np.array([-1, 5, 7, N + 100])):
        j_ids, _ = js.batch_search_arrays(queries, jr.SearchParams(TOP_K, NPROBE), filt)
        t_ids, _ = ts.batch_search_arrays(queries, tr.SearchParams(TOP_K, NPROBE), filt)
        np.testing.assert_array_equal(t_ids, j_ids)
    t_ids, _ = ts.batch_search_arrays(queries, tr.SearchParams(TOP_K, NPROBE), allowed)
    assert (t_ids[t_ids >= 0] % 3 == 1).all() and (t_ids >= 0).mean() > 0.9
    want, _ = tidx.batch_search_arrays(queries, tr.SearchParams(TOP_K, NPROBE), allowed)
    np.testing.assert_array_equal(t_ids, want)


@pytest.mark.parametrize("scan_dtype", ["f32", "int8", "packed", "fused", "fused8"])
def test_one_shard_equals_in_memory(jax_index, scan_dtype):
    data, get = jax_index
    _, tidx = _pair(get(7, "ip"), scan_dtype)
    ts = tsh.ShardedIvfIndex(tidx, _mesh(1))
    queries = data[100:140] - 0.05
    for nprobe in (2, NLIST):
        params = tr.SearchParams(TOP_K, nprobe)
        ids, d = ts.batch_search_arrays(queries, params)
        want_ids, want_d = tidx.batch_search_arrays(queries, params)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(d, want_d)


def test_non_pow2_batch(jax_index):
    """300 queries (not a power of two, not a multiple of the kernel's
    32-query block) on 8 shards through the EXACT scan serve what the same
    queries do in batches of 256 and 44, and find themselves. Against the
    in-memory index: top-5 overlap >= 0.99 (each shard keeps its own best
    bins, selected on values with bf16 g terms, so the sharded search may
    keep a row the in-memory cut dropped)."""
    data, get = jax_index
    _, tidx = _pair(get(7, "l2"), "fused8")
    ts = tsh.ShardedIvfIndex(tidx, _mesh())
    params = tr.SearchParams(5, NLIST)
    ids, d = ts.batch_search_arrays(data[:300], params)
    assert ids.shape == (300, 5) and (ids[:, 0] == np.arange(300)).all()
    parts = [ts.batch_search_arrays(data[s:e], params) for s, e in ((0, 256), (256, 300))]
    np.testing.assert_array_equal(ids, np.concatenate([p[0] for p in parts]))
    np.testing.assert_array_equal(d, np.concatenate([p[1] for p in parts]))
    want_ids, _ = tidx.batch_search_arrays(data[:300], params)
    assert np.mean([len(set(a) & set(b)) / 5 for a, b in zip(ids, want_ids)]) >= 0.99
    empty, empty_d = ts.batch_search_arrays(data[:3], tr.SearchParams(0, 4))
    assert empty.shape == empty_d.shape == (3, 0)
    with pytest.raises(tr.DimensionMismatch):
        ts.batch_search_arrays(data[:3, :10], params)


@pytest.mark.parametrize("scan_dtype", ["fused8", "fused"])
def test_compacted_walk_equals_dense_walk(monkeypatch, scan_dtype):
    """Two shards of 36 row tiles each, 512 clusters: at nprobe 1 the
    per-shard budget turns compaction on; with ``RABITQ_FUSED_COMPACT=0``
    every shard walks every tile, to the same results."""
    data = _data(n=36 * 1024, centers=512, seed=9)
    tidx = tr.IvfRabitqIndex.train(data, nlist=512, total_bits=7, seed=1, kmeans_iters=4,
                                   use_faster_config=True, scan_dtype=scan_dtype, device="cpu")
    ts = tsh.ShardedIvfIndex(tidx, _mesh(2))
    queries = data[:8] + 0.05
    assert ts._plan.max_tiles(scan_dtype, 1) is not None
    compact = ts.batch_search_arrays(queries, tr.SearchParams(TOP_K, 1))
    monkeypatch.setenv("RABITQ_FUSED_COMPACT", "0")
    assert ts._plan.max_tiles(scan_dtype, 1) is None  # re-read at each call
    dense = ts.batch_search_arrays(queries, tr.SearchParams(TOP_K, 1))
    np.testing.assert_array_equal(compact[0], dense[0])
    np.testing.assert_array_equal(compact[1], dense[1])
    assert (compact[0][:, 0] == np.arange(8)).all()


def _bridged(seed=7, dim=DIM, per=300, n_centers=8, n_bridge=300):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, dim)).astype(np.float32) * 2
    blobs = np.concatenate([c + 0.3 * rng.standard_normal((per, dim)) for c in centers])
    pa = rng.integers(0, n_centers, n_bridge)
    pb = (pa + 1 + rng.integers(0, n_centers - 1, n_bridge)) % n_centers
    mid = 0.5 * (centers[pa] + centers[pb]) + 0.3 * rng.standard_normal((n_bridge, dim))
    data = np.concatenate([blobs, mid]).astype(np.float32)
    queries = np.concatenate([data[rng.integers(0, len(blobs), 8)], mid[:8]]).astype(np.float32)
    return data, queries


@pytest.fixture(scope="module")
def replicated_mstg():
    data, queries = _bridged()
    cfg = jr.MstgConfig(max_posting_size=150, faster_config=True, closure_epsilon=0.9,
                        max_replicas=4, use_rotator=True)
    return data, queries, jr.MstgIndex.build(data, cfg, seed=3, scan_dtype="f32")


@pytest.mark.parametrize("scan_dtype", ["fused8", "packed", "bf16"])
def test_sharded_mstg_matches_jax(replicated_mstg, scan_dtype):
    import dataclasses

    data, queries, jbuilt = replicated_mstg
    jcfg = jbuilt.config
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["metric"] = tr.Metric.from_str(jcfg.metric.value)
    kw["centroid_precision"] = tr.ScalarPrecision(jcfg.centroid_precision.value)
    jidx = jr.MstgIndex(dataclasses.replace(jcfg), jbuilt.dim, jbuilt.host, scan_dtype,
                        approx_topk=False, rotator=jbuilt.rotator)
    tidx = tr.MstgIndex.from_host_arrays(
        config=tr.MstgConfig(**kw), dim=jbuilt.dim,
        **{f: getattr(jbuilt.host, f) for f in MSTG_FIELDS},
        rotator_bytes=jbuilt.rotator.serialize(), scan_dtype=scan_dtype, approx_topk=False,
        device="cpu",
    )
    assert tidx.replication_factor() == jidx.replication_factor() > 1.0
    js = jsh.ShardedMstgIndex(jidx, jsh.make_mesh(8))
    ts = tsh.ShardedMstgIndex(tidx, _mesh())
    assert ts._slab_rows == js._slab_rows
    params = dict(top_k=TOP_K, ef_search=12, pruning_epsilon=0.8)
    want = js.batch_search(queries, jr.MstgSearchParams(**params))
    got = ts.batch_search(queries, tr.MstgSearchParams(**params))
    for g_row, w_row in zip(got, want):
        assert len({h.id for h in g_row}) == len(g_row) == len(w_row)  # deduplicated
    if scan_dtype != "fused8":
        assert [[h.id for h in row] for row in got] == [[h.id for h in row] for row in want]
        for g_row, w_row in zip(got, want):
            np.testing.assert_allclose([h.score for h in g_row], [h.score for h in w_row],
                                       rtol=1e-4, atol=1e-3)
    else:
        overlaps = []
        for g_row, w_row in zip(got, want):
            w_score = {h.id: h.score for h in w_row}
            overlaps.append(len(w_score.keys() & {h.id for h in g_row}) / len(w_row))
            for h in g_row:
                if h.id in w_score:
                    assert h.score == pytest.approx(w_score[h.id], rel=1e-3, abs=1e-3)
        assert min(overlaps) >= 0.9 and np.mean(overlaps) >= 0.98, overlaps
    one = tsh.ShardedMstgIndex(tidx, _mesh(1)).batch_search(queries, tr.MstgSearchParams(**params))
    in_memory = tidx.batch_search(queries, tr.MstgSearchParams(**params))
    assert [[h.id for h in r] for r in one] == [[h.id for h in r] for r in in_memory]


def _recall(ids, data, queries, k=10):
    d = ((queries[:, None, :] - data[None]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :k]
    return np.mean([len(set(a[:k].tolist()) & set(g.tolist())) / k for a, g in zip(ids, gt)])


def test_sharded_train_close_to_jax():
    data = _blobs(2000, seed=5)
    queries = data[:32] + 0.1
    kw = dict(nlist=24, total_bits=7, seed=3, use_faster_config=True, kmeans_iters=6,
              scan_dtype="f32")
    ts = tsh.ShardedIvfIndex.train(data, mesh=_mesh(), **kw)
    js = jsh.ShardedIvfIndex.train(data, mesh=jsh.make_mesh(8), **kw)
    j_obj = jsh.sharded_kmeans(data, 24, mesh=jsh.make_mesh(8), niter=6, seed=3).objective
    report = ts.index.build_report
    assert set(report) >= {"kmeans_s", "codes_s", "layout_s", "total_s", "kmeans"}
    assert abs(report["kmeans"]["objective"] - j_obj) <= 0.03 * j_obj
    assert len(ts.index) == 2000 and ts.index.device == torch.device("cpu")
    params = (TOP_K, 4)
    t_ids, _ = ts.batch_search_arrays(queries, tr.SearchParams(*params))
    j_ids, _ = js.batch_search_arrays(queries, jr.SearchParams(*params))
    t_rec, j_rec = _recall(t_ids, data, queries), _recall(np.asarray(j_ids), data, queries)
    assert abs(t_rec - j_rec) <= 0.02 and t_rec > 0.5
    # the index's host copy is the codes the shards built
    h = ts.index.host
    assert h.binary_bits.dtype == np.uint8 and h.ex_codes.dtype == np.uint16
    np.testing.assert_array_equal(np.sort(h.ids), np.arange(2000))


@pytest.mark.parametrize("case", [
    "empty", "nlist_zero", "bits_zero", "bits_17", "nlist_over_n",
])
def test_train_refuses_bad_arguments_like_jax(case):
    data = _data(n=64)
    args = {
        "empty": (data[:0], 4, 7), "nlist_zero": (data, 0, 7), "bits_zero": (data, 4, 0),
        "bits_17": (data, 4, 17), "nlist_over_n": (data, 65, 7),
    }[case]
    with pytest.raises(jr.InvalidConfig) as want:
        jr.IvfRabitqIndex.train(*args)
    with pytest.raises(tr.InvalidConfig, match=str(want.value)):
        tr.IvfRabitqIndex.train(*args, device="cpu")
    with pytest.raises(tr.InvalidConfig, match=str(want.value)):
        tr.IvfRabitqIndex.train(torch.from_numpy(args[0]), *args[1:], device="cpu")
    with pytest.raises(jr.InvalidConfig, match=str(want.value)):
        jsh.ShardedIvfIndex.train(*args, mesh=jsh.make_mesh(8))
    with pytest.raises(tr.InvalidConfig, match=str(want.value)):
        tsh.ShardedIvfIndex.train(*args, mesh=_mesh())


def test_dryrun_multichip_steps():
    """The steps of ``__graft_entry__.dryrun_multichip(8)`` on the port's
    8-device CPU mesh: the sharded train (k-means, rotation and
    quantization), sharded serving, the fused scan sharded, and sharded MSTG
    serving."""
    rng = np.random.default_rng(0)
    data = rng.standard_normal((64 * 8, 128)).astype(np.float32)
    queries = rng.standard_normal((8, 128)).astype(np.float32)
    mesh = _mesh()
    sharded = tsh.ShardedIvfIndex.train(data, nlist=16, total_bits=7, metric=tr.Metric.L2,
                                        mesh=mesh, seed=0, use_faster_config=True, kmeans_iters=4)
    ids, dists = sharded.batch_search_arrays(queries, tr.SearchParams(top_k=5, nprobe=16))
    assert ids.shape == (8, 5) and np.isfinite(dists).all()
    sids, _ = sharded.batch_search_arrays(data[:8], tr.SearchParams(top_k=5, nprobe=16))
    assert all(i in sids[i] for i in range(8))
    sharded.index.scan_dtype = "fused"
    fused = tsh.ShardedIvfIndex(sharded.index, mesh)
    assert fused._fused and fused._slab_rows % 512 == 0
    fids, _ = fused.batch_search_arrays(data[:4], tr.SearchParams(top_k=5, nprobe=16))
    assert all(i in fids[i] for i in range(4))
    mstg = tr.MstgIndex.build(data, tr.MstgConfig(max_posting_size=64, faster_config=True),
                              seed=0, device="cpu")
    hits = tsh.ShardedMstgIndex(mstg, mesh).batch_search(
        data[:4], tr.MstgSearchParams(top_k=3, ef_search=8, pruning_epsilon=0.8))
    assert all(row and row[0].id == i for i, row in enumerate(hits))
