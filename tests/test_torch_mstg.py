"""The port's MSTG index on the CPU, against the JAX package.

A JAX ``MstgIndex`` (3000 x 96 blobs, ``max_posting_size`` 150, 7 bits,
faster config; with and without the rotator; L2 and inner product) is
carried into the port with ``from_host_arrays`` and both search the same
codes through every ``scan_dtype``, with refinement on and off.

Tolerances (as ``tests/test_torch_scan_paths.py``): ``f32`` with exact
selection is the oracle configuration, ids equal per query and distances
rtol 1e-5 (with an absolute floor of 1e-5 of the largest distance, for
distances near 0); every other path rounds the query to bf16 or int8 somewhere and
selects survivors from bf16 values, where ties fall differently in the two
packages: top-10 overlap >= 0.9 per query and >= 0.98 on average, distances
of common ids rtol 1e-3.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np
import pytest
import torch

import rabitq_tpu as jr
import rabitq_tpu_torch as tr
from rabitq_tpu_torch.index.mstg.index import MstgHost as THost

N, DIM, MAX_POSTING = 3000, 96, 150
TOP_K = 10
SCAN_DTYPES = ("f32", "bf16", "packed", "fused", "fused8")
HOST_FIELDS = ("binary_bits", "ex_codes", "f_add", "f_rescale", "f_add_ex", "f_rescale_ex",
               "delta", "vl", "ids", "list_offsets", "centroids", "f_error", "residual_norm")


def _data(n=N, dim=DIM, seed=42, centers=24):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, dim)).astype(np.float32) * 1.5
    return (c[rng.integers(0, centers, n)] + 0.5 * rng.standard_normal((n, dim))).astype(
        np.float32
    )


def _bridged(seed=7, dim=DIM, per=300, n_centers=8, n_bridge=300):
    """Isotropic blobs plus rows at midpoints of pairs of blob centres, and
    queries at the same midpoints (the bench's replicated recipe)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, dim)).astype(np.float32) * 2
    blobs = np.concatenate([c + 0.3 * rng.standard_normal((per, dim)) for c in centers])
    pa = rng.integers(0, n_centers, n_bridge)
    pb = (pa + 1 + rng.integers(0, n_centers - 1, n_bridge)) % n_centers
    mid = 0.5 * (centers[pa] + centers[pb]) + 0.3 * rng.standard_normal((n_bridge, dim))
    data = np.concatenate([blobs, mid]).astype(np.float32)
    queries = np.concatenate([
        data[rng.integers(0, len(blobs), 16)],
        0.5 * (centers[pa[:16]] + centers[pb[:16]]) + 0.3 * rng.standard_normal((16, dim)),
    ]).astype(np.float32)
    return data, queries


def _tcfg(jcfg) -> tr.MstgConfig:
    """The port's config with the JAX config's values."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["metric"] = tr.Metric.from_str(jcfg.metric.value)
    kw["centroid_precision"] = tr.ScalarPrecision(jcfg.centroid_precision.value)
    return tr.MstgConfig(**kw)


def _carry(jidx, scan_dtype, refine=None, **kw) -> tr.MstgIndex:
    h = jidx.host
    cfg = _tcfg(jidx.config)
    if refine is not None:
        cfg.refine_ex = refine
    return tr.MstgIndex.from_host_arrays(
        config=cfg, dim=jidx.dim, **{f: getattr(h, f) for f in HOST_FIELDS},
        rotator_bytes=jidx.rotator.serialize() if jidx.rotator is not None else b"",
        scan_dtype=scan_dtype, device="cpu", **kw,
    )


def _view(jidx, scan_dtype, refine=None) -> jr.MstgIndex:
    """The JAX index's codes as a fresh JAX index (own layout) on ``scan_dtype``."""
    cfg = dataclasses.replace(jidx.config)
    if refine is not None:
        cfg.refine_ex = refine
    return jr.MstgIndex(cfg, jidx.dim, jidx.host, scan_dtype, rotator=jidx.rotator)


def _agree(j_ids, j_d, t_ids, t_d, exact):
    if exact:
        np.testing.assert_array_equal(t_ids, j_ids)
        # a distance near 0 is what is left of terms as large as the row's
        # largest distance, summed in another order: an absolute floor of
        # 1e-5 of that
        scale = np.abs(j_d[np.isfinite(j_d)]).max()
        np.testing.assert_allclose(t_d, j_d, rtol=1e-5, atol=1e-5 * scale)
        return
    overlaps = []
    for i in range(len(j_ids)):
        overlaps.append(len(set(j_ids[i].tolist()) & set(t_ids[i].tolist())) / j_ids.shape[1])
        jm = dict(zip(j_ids[i].tolist(), j_d[i].tolist()))
        for rid, dist in zip(t_ids[i].tolist(), t_d[i].tolist()):
            if rid in jm and np.isfinite(dist):
                assert dist == pytest.approx(jm[rid], rel=1e-3, abs=1e-3), (i, rid)
    assert min(overlaps) >= 0.9 and np.mean(overlaps) >= 0.98, overlaps


def _no_dup(ids):
    for row in ids:
        row = row[row >= 0]
        assert len(set(row.tolist())) == len(row), row


def _ids(results, k=TOP_K):
    out = np.full((len(results), k), -1, np.int64)
    for i, row in enumerate(results):
        out[i, : len(row)] = [h.id for h in row]
    return out


@pytest.fixture(scope="module")
def built():
    """JAX builds, one per (metric, rotator), made on first use."""
    data = _data()
    cache = {}

    def get(metric, rotator):
        key = (metric, rotator)
        if key not in cache:
            cfg = jr.MstgConfig(max_posting_size=MAX_POSTING, faster_config=True,
                                use_rotator=rotator, metric=jr.Metric.from_str(metric))
            cache[key] = jr.MstgIndex.build(data, cfg, seed=3, scan_dtype="f32")
        return cache[key]

    return data, get


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("scan_dtype", SCAN_DTYPES)
@pytest.mark.parametrize("rotator", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_carried_index_matches_jax(built, metric, rotator, scan_dtype, refine):
    data, get = built
    jbuilt = get(metric, rotator)
    jidx, tidx = _view(jbuilt, scan_dtype, refine), _carry(jbuilt, scan_dtype, refine)
    assert tidx.quant_dim == jidx.quant_dim and tidx.approx_topk == jidx.approx_topk
    queries = data[:32] + 0.05
    params = dict(top_k=TOP_K, ef_search=8, pruning_epsilon=0.6)
    j_ids, j_d = jidx.batch_search_arrays_pipelined(
        queries, jr.MstgSearchParams(**params), batch_size=16)
    t_ids, t_d = tidx.batch_search_arrays_pipelined(
        queries, tr.MstgSearchParams(**params), batch_size=16)
    assert tidx.scan_dtype == jidx.scan_dtype == scan_dtype  # no downgrade
    assert tidx._plan.fused_exact(tidx.scan_dtype) == jidx._fused_exact_ok()
    assert t_ids.shape == (32, TOP_K) and t_ids.dtype == np.int32 and t_d.dtype == np.float32
    assert np.all(np.diff(t_d, axis=1) >= 0)
    _agree(np.asarray(j_ids), np.asarray(j_d), t_ids, t_d, exact=scan_dtype == "f32")
    np.testing.assert_array_equal(tidx.layout.ids.numpy(), np.asarray(jidx.device.ids))


@pytest.mark.parametrize("scan_dtype", ["f32", "bf16", "fused8", "fused"])
def test_replicated_index_dedup_matches_jax(scan_dtype):
    data, queries = _bridged()
    cfg = jr.MstgConfig(max_posting_size=MAX_POSTING, faster_config=True, closure_epsilon=0.9,
                        max_replicas=4)
    jbuilt = jr.MstgIndex.build(data, cfg, seed=3, scan_dtype="f32")
    jidx, tidx = _view(jbuilt, scan_dtype), _carry(jbuilt, scan_dtype)
    assert tidx._has_replicas() and jidx._has_replicas()
    assert tidx.replication_factor() == jidx.replication_factor() > 1.03
    assert len(tidx) == len(jidx) == len(data) and tidx.total_rows > len(data)
    params = dict(top_k=TOP_K, ef_search=12, pruning_epsilon=0.8)
    j_ids, j_d = jidx.batch_search_arrays_pipelined(queries, jr.MstgSearchParams(**params))
    t_ids, t_d = tidx.batch_search_arrays_pipelined(queries, tr.MstgSearchParams(**params))
    _no_dup(t_ids)
    assert (t_ids >= 0).all()
    _agree(np.asarray(j_ids), np.asarray(j_d), t_ids, t_d, exact=scan_dtype == "f32")
    lists = tidx.batch_search(queries, tr.MstgSearchParams(**params))
    np.testing.assert_array_equal(_ids(lists), t_ids)


def test_dedup_topk_device_matches_jax():
    rng = np.random.default_rng(5)
    for b, r, top_k in ((7, 25, 6), (3, 40, 40), (2, 3, 8)):
        ids = rng.integers(0, 12, (b, r)).astype(np.int32)
        dists = np.sort(rng.random((b, r)).astype(np.float32), axis=1)
        ids[rng.random((b, r)) < 0.2] = -1
        dists[rng.random((b, r)) < 0.1] = np.inf
        ids[b // 2] = -1  # one row fully invalid
        j_ids, j_d = jr.MstgIndex._dedup_topk_device(ids, dists, top_k=top_k)
        t_ids, t_d = tr.MstgIndex._dedup_topk_device(
            torch.from_numpy(ids), torch.from_numpy(dists), top_k=top_k)
        assert t_ids.shape == (b, top_k)  # padded past the candidate axis
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
        np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))
        _no_dup(t_ids.numpy())


@pytest.mark.parametrize("upload", ["f32", "bf16", "int8", "int4"])
def test_pipelined_and_resident_equal_batch_search(built, upload):
    data, get = built
    tidx = _carry(get("l2", True), "fused8")
    tidx._has_repl = True  # the dedup path too
    tidx.upload_dtype = upload
    queries = data[100:170]  # not a power of two: block padding
    params = tr.MstgSearchParams(top_k=TOP_K, ef_search=8, pruning_epsilon=0.6)
    ref = _ids(tidx.batch_search(queries, params))
    assert (ref[:, 0] == np.arange(100, 170)).mean() >= 0.95
    np.testing.assert_array_equal(_ids(tidx.batch_search_pipelined(queries, params, 32)), ref)
    np.testing.assert_array_equal(
        _ids(tidx.batch_search_pipelined(queries, params, 16, upload_block=64)), ref)
    a_ids, a_d = tidx.batch_search_arrays_pipelined(queries, params, 32, upload_block=64)
    np.testing.assert_array_equal(a_ids, ref)
    assert np.isfinite(a_d).all()
    handle = tidx.upload_queries(queries)
    np.testing.assert_array_equal(_ids(tidx.batch_search_resident(handle, params, 32)), ref)
    empty = tr.MstgSearchParams(top_k=0, ef_search=8)
    assert tidx.batch_search(queries[:3], empty) == [[], [], []]
    assert tidx.batch_search_arrays_pipelined(queries[:3], empty)[0].shape == (3, 0)


@pytest.mark.parametrize("scan_dtype", ["f32", "fused", "packed"])
def test_search_with_diagnostics_matches_jax(built, scan_dtype):
    data, get = built
    jbuilt = get("l2", False)
    jidx, tidx = _view(jbuilt, scan_dtype), _carry(jbuilt, scan_dtype)
    for eps in (10.0, 0.02):
        params = dict(top_k=5, ef_search=8, pruning_epsilon=eps)
        j_res, j_d = jidx.search_with_diagnostics(data[0], jr.MstgSearchParams(**params))
        t_res, t_d = tidx.search_with_diagnostics(data[0], tr.MstgSearchParams(**params))
        assert (t_d.estimated, t_d.skipped_by_lower_bound, t_d.extended_evaluations) == (
            j_d.estimated, j_d.skipped_by_lower_bound, j_d.extended_evaluations)
        assert t_res[0].id == 0 and len({h.id for h in t_res} & {h.id for h in j_res}) >= 4


def _jax_build(prec, metric="l2", rotator=False, seed=5):
    data = _data(800, 48, seed=seed)
    cfg = jr.MstgConfig(max_posting_size=128, faster_config=True, use_rotator=rotator,
                        centroid_precision=jr.ScalarPrecision(prec),
                        metric=jr.Metric.from_str(metric))
    return data, jr.MstgIndex.build(data, cfg, seed=seed, scan_dtype="f32")


@pytest.mark.parametrize("prec,metric,rotator", [
    ("fp32", "l2", False), ("bf16", "ip", True), ("fp16", "l2", True), ("int8", "l2", False),
])
def test_native_files_byte_identical_and_cross_read(tmp_path, prec, metric, rotator):
    data, jidx = _jax_build(prec, metric, rotator)
    tidx = _carry(jidx, "f32")
    jp, tp = tmp_path / "jax.mstg", tmp_path / "port.mstg"
    jidx.save_to_path(jp)
    tidx.save_to_path(tp)
    assert tp.read_bytes() == jp.read_bytes()
    j_from_t = jr.MstgIndex.load_from_path(tp, scan_dtype="f32")
    t_from_j = tr.MstgIndex.load_from_path(jp, scan_dtype="f32", device="cpu")
    for f in HOST_FIELDS:
        np.testing.assert_array_equal(getattr(t_from_j.host, f), getattr(jidx.host, f), f)
        np.testing.assert_array_equal(getattr(j_from_t.host, f), getattr(jidx.host, f), f)
    assert t_from_j.config == _tcfg(j_from_t.config)
    assert (t_from_j.rotator is None) == (not rotator) and t_from_j.quant_dim == jidx.quant_dim
    params = dict(top_k=TOP_K, ef_search=16, pruning_epsilon=0.8)
    want = _ids(jidx.batch_search(data[:8], jr.MstgSearchParams(**params)))
    np.testing.assert_array_equal(_ids(t_from_j.batch_search(data[:8], tr.MstgSearchParams(**params))), want)
    again = tmp_path / "again.mstg"
    t_from_j.save_to_path(again)
    assert again.read_bytes() == jp.read_bytes()
    blob = bytearray(tp.read_bytes())
    blob[len(blob) // 3] ^= 0x10
    tp.write_bytes(bytes(blob))
    with pytest.raises(tr.InvalidPersistence, match="checksum"):
        tr.MstgIndex.load_from_path(tp, device="cpu")
    with pytest.raises(tr.InvalidConfig):
        tidx.save_to_path(tmp_path / "x", format="hdf5")


def test_older_native_versions_read_alike(tmp_path):
    """v1002 (f32 centroids, no f_error / residual_norm) and v1001 (no
    rotator fields either), made from a v1003 file, read alike by both."""
    _, jidx = _jax_build("fp32")
    p = tmp_path / "v1003.mstg"
    jidx.save_to_path(p)
    raw = p.read_bytes()
    r = jidx.total_rows
    body = raw[8 : -4 - 8 * r]  # drop the two v1003 [R] f32 fields
    head = struct.calcsize("<IBBBBffIIfIB")
    for version, payload in ((1002, body), (1001, body[:head] + body[head + 12 :])):
        f = tmp_path / f"v{version}.mstg"
        f.write_bytes(b"MSTG" + struct.pack("<I", version) + payload
                      + struct.pack("<I", zlib.crc32(payload)))
        j = jr.MstgIndex.load_from_path(f, scan_dtype="f32")
        t = tr.MstgIndex.load_from_path(f, scan_dtype="f32", device="cpu")
        assert t.host.f_error is None and j.host.f_error is None
        for name in HOST_FIELDS[:11]:
            np.testing.assert_array_equal(getattr(t.host, name), getattr(j.host, name))
    bad = tmp_path / "v7.mstg"
    bad.write_bytes(b"MSTG" + struct.pack("<I", 7) + raw[8:])
    with pytest.raises(tr.InvalidPersistence, match="version 7"):
        tr.MstgIndex.load_from_path(bad, device="cpu")


@pytest.mark.parametrize("scan_dtype", ["fused8", "bf16"])
def test_lazy_host_equals_jax_host(built, scan_dtype):
    """A built JAX index's lazily downloaded host, and the port's download of
    the same codes from its own device layout (an index holding only device
    planes, as a build leaves it): equal arrays; the metadata never forces
    the download."""
    data, get = built
    jbuilt = jr.MstgIndex.build(
        data[:1500], jr.MstgConfig(max_posting_size=MAX_POSTING, faster_config=True,
                                   use_rotator=True), seed=3, scan_dtype=scan_dtype)
    jbuilt.batch_search(data[:4], jr.MstgSearchParams(top_k=5, ef_search=8))
    jh = jbuilt.host  # downloaded from the JAX layout
    small = {k: getattr(jh, k) for k in ("f_add", "f_rescale", "f_error", "f_add_ex",
                                         "f_rescale_ex", "delta", "vl", "residual_norm")}
    codes = {"binary": torch.from_numpy(jh.binary_bits.copy()),
             "ex": torch.from_numpy(jh.ex_codes.astype(np.uint8)),
             **{k: torch.from_numpy(v.copy()) for k, v in small.items()}}
    tidx = tr.MstgIndex(
        _tcfg(jbuilt.config), jbuilt.dim, None, scan_dtype,
        rotator=_carry(jbuilt, "f32").rotator, device="cpu",
        _meta={"ids": jh.ids, "list_offsets": jh.list_offsets, "centroids": jh.centroids,
               "small": small},
        _codes_dev=codes,
    )
    assert tidx.memory_usage() == jbuilt.memory_usage()
    assert (len(tidx), tidx.total_rows, tidx.posting_list_count()) == (
        len(jbuilt), jbuilt.total_rows, jbuilt.posting_list_count())
    t_res = tidx.batch_search(data[:4], tr.MstgSearchParams(top_k=5, ef_search=8))
    assert tidx._host is None and tidx._codes_dev is None  # served from the layout
    th = tidx.host
    for f in HOST_FIELDS:
        np.testing.assert_array_equal(getattr(th, f), getattr(jh, f), f)
    assert [h.id for h in t_res[0]][0] == 0


def test_scan_dtype_switch_relays_from_the_layout(built):
    data, get = built
    jbuilt = get("l2", True)
    tidx = _carry(jbuilt, "fused8")
    params = tr.MstgSearchParams(top_k=TOP_K, ef_search=8)
    queries = data[:16]
    tidx.batch_search(queries, params)
    tidx._host = None  # the relayout must come from the device layout alone
    for scan_dtype in ("bf16", "packed", "fused"):
        tidx.scan_dtype = scan_dtype
        tidx.approx_topk = True
        got = _ids(tidx.batch_search(queries, params))
        fresh = _carry(jbuilt, scan_dtype, approx_topk=True)
        np.testing.assert_array_equal(got, _ids(fresh.batch_search(queries, params)))


def _recall(ids, gt):
    return float(np.mean([len(set(ids[i].tolist()) & set(gt[i].tolist())) / gt.shape[1]
                          for i in range(len(gt))]))


@pytest.mark.parametrize("rotator,faster", [(False, True), (True, False)])
def test_port_build_recall_close_to_jax(rotator, faster):
    data = _data(4000, 64, seed=8, centers=32)
    rng = np.random.default_rng(8)  # queries near the data's own rows
    queries = data[rng.integers(0, 4000, 200)] + 0.5 * rng.standard_normal((200, 64)).astype(
        np.float32)
    d2 = ((queries[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1)[:, :TOP_K]
    kw = dict(max_posting_size=150, faster_config=faster, use_rotator=rotator)
    j = jr.MstgIndex.build(data, jr.MstgConfig(**kw), seed=4, scan_dtype="f32")
    t = tr.MstgIndex.build(data, tr.MstgConfig(**kw), seed=4, scan_dtype="f32", device="cpu")
    assert {"upload", "clustering_s", "closure_s", "quantize_s", "total_s"} <= set(t.build_report)
    assert len(t) == 4000 and t.replication_factor() >= 1.0
    params = dict(top_k=TOP_K, ef_search=12, pruning_epsilon=0.8)
    j_rec = _recall(_ids(j.batch_search(queries, jr.MstgSearchParams(**params))), gt)
    t_rec = _recall(_ids(t.batch_search(queries, tr.MstgSearchParams(**params))), gt)
    assert t_rec >= j_rec - 0.02 and t_rec >= 0.8, (t_rec, j_rec)


# ---------------------------------------------------------------------------
# faults of earlier slices, repaired: each package given the same input
# ---------------------------------------------------------------------------


def test_unknown_upload_dtype_serves_as_f32(built):
    data, get = built
    jbuilt = get("l2", False)
    jidx, tidx = _view(jbuilt, "f32"), _carry(jbuilt, "f32")
    params = dict(top_k=TOP_K, ef_search=8)
    queries = data[:12]
    want = _ids(tidx.batch_search(queries, tr.MstgSearchParams(**params)))
    jidx.upload_dtype = tidx.upload_dtype = "fp8"
    got = _ids(tidx.batch_search(queries, tr.MstgSearchParams(**params)))
    j_got = _ids(jidx.batch_search(queries, jr.MstgSearchParams(**params)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, j_got)
    ivf_data = _data(1000, 64)
    jivf = jr.IvfRabitqIndex.train(ivf_data, nlist=8, total_bits=7, seed=3, scan_dtype="f32")
    tivf = tr.IvfRabitqIndex.train(ivf_data, nlist=8, total_bits=7, seed=3, scan_dtype="f32",
                                   device="cpu")
    ivf_params = (TOP_K, 4)
    want = tivf.batch_search_arrays(ivf_data[:8], tr.SearchParams(*ivf_params))[0]
    jivf.upload_dtype = tivf.upload_dtype = "fp8"
    got = tivf.batch_search_arrays_pipelined(ivf_data[:8], tr.SearchParams(*ivf_params))[0]
    j_got = jivf.batch_search_arrays(ivf_data[:8], jr.SearchParams(*ivf_params))[0]
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == np.arange(8)).all() and (np.asarray(j_got)[:, 0] == np.arange(8)).all()


def test_unknown_scan_dtype_raises_at_the_first_scan(built):
    data, get = built
    jbuilt = get("l2", False)
    for idx, params in ((_view(jbuilt, "fp4"), jr.MstgSearchParams(top_k=5, ef_search=4)),
                        (_carry(jbuilt, "fp4"), tr.MstgSearchParams(top_k=5, ef_search=4))):
        assert idx.scan_dtype == "fp4"
        with pytest.raises(ValueError, match="fp4"):
            idx.batch_search(data[:2], params)
    ivf_data = _data(600, 32)
    jivf = jr.IvfRabitqIndex.train(ivf_data, nlist=4, total_bits=7, scan_dtype="fp4")
    tivf = tr.IvfRabitqIndex.train(ivf_data, nlist=4, total_bits=7, scan_dtype="fp4",
                                   device="cpu")
    tivf2 = tr.IvfRabitqIndex.train_with_clusters(
        ivf_data, ivf_data[:4].copy(), np.arange(600) % 4, 7, scan_dtype="fp4", device="cpu")
    for idx, params in ((jivf, jr.SearchParams(5, 4)), (tivf, tr.SearchParams(5, 4)),
                        (tivf2, tr.SearchParams(5, 4))):
        assert len(idx) == 600
        with pytest.raises(ValueError, match="fp4"):
            idx.batch_search_arrays(ivf_data[:2], params)


def test_upload_queries_on_an_empty_index_checks_the_width_only():
    from rabitq_tpu.ops.rotation import make_rotator as j_make
    from rabitq_tpu_torch.ops.rotation import make_rotator as t_make

    dim = 32
    j_rot = j_make(dim, jr.RotatorType.FhtKacRotator, 1)
    t_rot = t_make(dim, tr.RotatorType.FhtKacRotator, 1)
    jivf = jr.IvfRabitqIndex(dim, j_rot.padded_dim, jr.Metric.L2, j_rot, 6, None)
    tivf = tr.IvfRabitqIndex(dim, t_rot.padded_dim, tr.Metric.L2, t_rot, 6, device="cpu")
    queries = np.ones((3, dim), np.float32)
    cfg = tr.MstgConfig()
    empty = THost(*(np.zeros((0, dim), np.uint8),) * 2, *(np.zeros(0, np.float32),) * 6,
                  ids=np.zeros(0, np.int64), list_offsets=np.zeros(1, np.int64),
                  centroids=np.zeros((0, dim), np.float32))
    tmstg = tr.MstgIndex(cfg, dim, empty, device="cpu")
    assert len(tmstg) == 0 and tmstg.total_rows == 0
    j_handle = jivf.upload_queries(queries)
    assert j_handle[1] == 3
    with pytest.raises(jr.DimensionMismatch):
        jivf.upload_queries(queries[:, :8])
    for idx, params in ((tivf, tr.SearchParams(5, 2)), (tmstg, tr.MstgSearchParams(top_k=5))):
        handle = idx.upload_queries(queries)
        assert handle[2] == 3 and handle[0].shape == j_handle[0][0].shape
        with pytest.raises(tr.DimensionMismatch):
            idx.upload_queries(queries[:, :8])
        with pytest.raises(tr.EmptyIndex):
            idx.batch_search_resident(handle, params)


def test_fine_lists_downgrade_fused_with_a_warning(caplog):
    """Lists of ~2 rows cannot fit a 128-list tile window: both packages warn
    and serve the index through the dense bf16 scan."""
    import logging

    data = _data(1024, 32, seed=13)
    cfg = jr.MstgConfig(max_posting_size=3, faster_config=True, refine_iters=0)
    jbuilt = jr.MstgIndex.build(data, cfg, seed=3, scan_dtype="fused8")
    params = dict(top_k=3, ef_search=64, pruning_epsilon=3.0)
    with caplog.at_level(logging.WARNING):
        j_res = jbuilt.batch_search(data[:4], jr.MstgSearchParams(**params))
        j_warned = [r for r in caplog.records if r.name.startswith("rabitq_tpu.")]
        tidx = _carry(jbuilt, "fused8")
        t_res = tidx.batch_search(data[:4], tr.MstgSearchParams(**params))
        t_warned = [r for r in caplog.records if r.name.startswith("rabitq_tpu_torch.")]
    assert jbuilt.scan_dtype == tidx.scan_dtype == "bf16"
    assert j_warned and "falling back to bf16" in j_warned[0].getMessage()
    assert t_warned and "falling back to bf16" in t_warned[0].getMessage()
    assert tidx.layout.packed is None  # the permuted layout of the dense scans
    assert [r[0].id for r in t_res] == [r[0].id for r in j_res] == [0, 1, 2, 3]
