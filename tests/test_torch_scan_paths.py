"""Every scan path of the port's IVF index on the CPU, against the JAX
package: a JAX index is carried across with ``from_host_arrays`` and both
search the same codes with ``scan_dtype`` in f32, bf16, int8, packed,
fused and fused8, ``total_bits`` 1, 7 and 8, L2 and inner product.

Tolerances. ``f32`` with exact selection is the oracle configuration: ids
equal per query, distances rtol 1e-5 (the f32 sums run in another order).
Every selection of both packages is ``lax.top_k``'s (the port's
``ops/select.top_k``: ties to the lower index), so with exact selection
(``approx_topk=False``) the ``int8``, ``bf16`` and ``packed`` scans also
give equal ids per query, even at a ``rerank`` so tight that many lower
bounds tie at the cut, and the ``f32`` oracle does on rows that each appear
three times. Where the JAX package takes ``approx_max_k`` (the default
outside ``f32``) its survivors are approximate and the port's exact; those
paths, and the fused scans, whose bins hold values the two packages sum in
another order, hold top-10 overlap >= 0.9 per query and >= 0.98 on
average, distances of common ids rtol 1e-3 (as ``tests/test_torch_ivf.py``)."""

from __future__ import annotations

import logging

import numpy as np
import pytest

import rabitq_tpu as jr
import rabitq_tpu_torch as tr
from rabitq_tpu.ops import pallas_fused_scan as jfs
from rabitq_tpu_torch.ops import fused_scan as tfs

N, DIM, NLIST = 2000, 64, 16
TOP_K, NPROBE = 10, 6
SCAN_DTYPES = ("f32", "bf16", "int8", "packed", "fused", "fused8")


def _data(n=N, dim=DIM, seed=42):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((NLIST, dim)).astype(np.float32)
    rows = centers[rng.integers(0, NLIST, n)] + 0.5 * rng.standard_normal((n, dim))
    return rows.astype(np.float32)


def _carry(jidx, scan_dtype, **kw) -> tr.IvfRabitqIndex:
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
        scan_dtype=scan_dtype, device="cpu", **kw,
    )


@pytest.fixture(scope="module")
def jax_indexes():
    """One JAX index per (total_bits, metric), trained on first use."""
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


def _use(jidx, scan_dtype):
    """Put the JAX index on ``scan_dtype`` with that path's default selection."""
    jidx.scan_dtype = scan_dtype
    jidx.approx_topk = scan_dtype != "f32"


def _agree(j_ids, j_d, t_ids, t_d, exact, abs_tol=1e-3):
    if exact:
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_allclose(t_d, j_d, rtol=1e-5, atol=1e-4)
        return
    overlaps = []
    for i in range(len(j_ids)):
        overlaps.append(len(set(j_ids[i].tolist()) & set(t_ids[i].tolist())) / j_ids.shape[1])
        jm = dict(zip(j_ids[i].tolist(), j_d[i].tolist()))
        for rid, dist in zip(t_ids[i].tolist(), t_d[i].tolist()):
            if rid in jm and np.isfinite(dist):
                assert dist == pytest.approx(jm[rid], rel=1e-3, abs=abs_tol), (i, rid)
    assert min(overlaps) >= 0.9 and np.mean(overlaps) >= 0.98, overlaps


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("total_bits", [1, 7, 8])
@pytest.mark.parametrize("scan_dtype", SCAN_DTYPES)
def test_scan_path_matches_jax(jax_indexes, scan_dtype, total_bits, metric):
    data, get = jax_indexes
    jidx = get(total_bits, metric)
    _use(jidx, scan_dtype)
    tidx = _carry(jidx, scan_dtype)
    assert tidx.approx_topk == jidx.approx_topk
    queries = data[:16]
    j_ids, j_d = jidx.batch_search_arrays(queries, jr.SearchParams(TOP_K, NPROBE))
    t_ids, t_d = tidx.batch_search_arrays(queries, tr.SearchParams(TOP_K, NPROBE))
    assert tidx.scan_dtype == jidx.scan_dtype == scan_dtype
    assert tidx._plan.fused_exact(tidx.scan_dtype) == jidx._fused_exact_ok()
    assert t_ids.shape == (16, TOP_K) and t_ids.dtype == np.int32 and t_d.dtype == np.float32
    assert np.all(np.diff(t_d, axis=1) >= 0)
    _agree(j_ids, j_d, t_ids, t_d, exact=scan_dtype == "f32")
    # the permuted layouts share the permutation, so row order matches
    np.testing.assert_array_equal(tidx.layout.perm, jidx._device_perm)
    np.testing.assert_array_equal(tidx.layout.ids.numpy(), np.asarray(jidx.device.ids))


@pytest.mark.parametrize("total_bits", [7, 8])
@pytest.mark.parametrize("scan_dtype", ["int8", "bf16", "packed"])
def test_exact_selection_ids_equal_jax(jax_indexes, scan_dtype, total_bits):
    """Exact survivors at ``rerank=12``: both packages cut the same lower
    bounds with ``lax.top_k``, ties to the lower row, so the ids are equal
    per query (the ``packed`` scan's bf16 plane ties often at the cut)."""
    data, get = jax_indexes
    jidx = get(total_bits, "l2")
    jidx.scan_dtype = scan_dtype
    jidx.approx_topk = False
    tidx = _carry(jidx, scan_dtype, approx_topk=False)
    queries = data[:16]
    j_ids, j_d = jidx.batch_search_arrays(queries, jr.SearchParams(TOP_K, NPROBE, rerank=12))
    t_ids, t_d = tidx.batch_search_arrays(queries, tr.SearchParams(TOP_K, NPROBE, rerank=12))
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_d, j_d, rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def triplicated():
    """Every row three times, as real datasets carry exact duplicates, and
    a JAX index over them."""
    data = np.tile(_data(n=N // 3), (3, 1))
    return data, jr.IvfRabitqIndex.train(data, nlist=NLIST, total_bits=7, seed=3, scan_dtype="f32")


@pytest.mark.parametrize("scan_dtype", ["f32", "int8", "bf16", "packed"])
def test_exact_selection_ids_equal_jax_on_triplicated_rows(triplicated, scan_dtype):
    """The copies' lower bounds and distances tie exactly; both packages
    list them in the same order, at the default ``rerank``."""
    data, jidx = triplicated
    jidx.scan_dtype = scan_dtype
    jidx.approx_topk = False
    tidx = _carry(jidx, scan_dtype, approx_topk=False)
    queries = data[:16]
    j_ids, j_d = jidx.batch_search_arrays(queries, jr.SearchParams(TOP_K, NPROBE))
    t_ids, t_d = tidx.batch_search_arrays(queries, tr.SearchParams(TOP_K, NPROBE))
    np.testing.assert_array_equal(t_ids, j_ids)
    if scan_dtype == "f32":
        _agree(j_ids, j_d, t_ids, t_d, exact=True)
    else:
        np.testing.assert_allclose(t_d, j_d, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("scan_dtype,total_bits", [("f32", 7), ("fused", 7), ("fused", 8), ("packed", 8)])
def test_search_with_diagnostics_matches_jax(jax_indexes, scan_dtype, total_bits):
    data, get = jax_indexes
    jidx = get(total_bits, "l2")
    _use(jidx, scan_dtype)
    tidx = _carry(jidx, scan_dtype)
    for qi in (0, 5):
        j_res, j_diag = jidx.search_with_diagnostics(data[qi], jr.SearchParams(TOP_K, 3))
        t_res, t_diag = tidx.search_with_diagnostics(data[qi], tr.SearchParams(TOP_K, 3))
        assert (t_diag.estimated, t_diag.skipped_by_lower_bound, t_diag.extended_evaluations) == (
            j_diag.estimated, j_diag.skipped_by_lower_bound, j_diag.extended_evaluations
        )
        assert t_diag.estimated > 0
        assert len({h.id for h in j_res} & {h.id for h in t_res}) >= 9
        assert t_res[0].id == qi


@pytest.mark.parametrize("scan_dtype", ["bf16", "fused"])
@pytest.mark.parametrize("total_bits", [7, 8])
def test_filtered_search_matches_jax(jax_indexes, scan_dtype, total_bits):
    data, get = jax_indexes
    jidx = get(total_bits, "l2")
    _use(jidx, scan_dtype)
    tidx = _carry(jidx, scan_dtype)
    allowed = np.arange(0, N, 3)
    j_ids, _ = jidx.batch_search_arrays(data[:6], jr.SearchParams(TOP_K, NLIST), allowed)
    t_ids, _ = tidx.batch_search_arrays(data[:6], tr.SearchParams(TOP_K, NLIST), allowed)
    assert (t_ids >= 0).all() and (t_ids % 3 == 0).all()
    for i in range(6):
        assert len(set(j_ids[i].tolist()) & set(t_ids[i].tolist())) >= 9
    hits = tidx.search_filtered(data[3], tr.SearchParams(TOP_K, NLIST), allowed)
    assert hits[0].id == 3 and all(h.id % 3 == 0 for h in hits)


_OPTION_CASES = {
    # MSTG's way in: L2 centroid ranking under inner product, epsilon pruning
    "prune_epsilon_f32": ("f32", "ip", dict(
        use_prune_epsilon=True, prune_epsilon=0.05, centroid_select_l2=True, clamp_l2=True)),
    "no_refine_bf16": ("bf16", "l2", dict(refine_ex=False)),
    "locality2_two_stage": ("fused8", "l2", dict(locality_depth=2, max_tiles=4)),
    "exact_unsorted": ("fused", "l2", dict(
        fused_exact=True, fused_exact_sort=False, max_tiles=4, clamp_l2=True)),
}


@pytest.mark.parametrize("case", sorted(_OPTION_CASES))
def test_scan_kernel_options_match_jax(jax_indexes, case):
    """``scan_kernel`` options no index entry point sets, on the same
    layouts in both packages."""
    import jax.numpy as jnp
    import torch

    from rabitq_tpu.index.scan import scan_kernel as j_scan
    from rabitq_tpu_torch.index.scan import scan_kernel as t_scan

    scan_dtype, metric, opts = _OPTION_CASES[case]
    data, get = jax_indexes
    jidx = get(7, metric)
    _use(jidx, scan_dtype)
    tidx = _carry(jidx, scan_dtype)
    jdev, j_packed, j_allowed = jidx._scan_inputs(None)
    t_allowed = tidx._scan_inputs(None)
    lay = tidx.layout
    q_rot = tidx.rotator.rotate(torch.from_numpy(data[:12]))
    common = dict(top_k=TOP_K, rerank=64, ex_bits=jidx.ex_bits, scan_dtype=scan_dtype,
                  approx_topk=False, **{k: v for k, v in opts.items() if k != "prune_epsilon"})
    eps = opts.get("prune_epsilon", 0.0)
    j_out = j_scan(
        jnp.asarray(q_rot.numpy()), jdev.centroids, *jdev.scan_args()[:8], j_allowed, jdev.ids,
        NPROBE, eps, j_packed, jidx._fused_cblk, metric=jidx.metric, **common,
    )
    t_out = t_scan(
        q_rot, lay.centroids, lay.binary, lay.ex, lay.f_add, lay.f_rescale, lay.f_error,
        lay.f_add_ex, lay.f_rescale_ex, lay.cluster_of, t_allowed, lay.ids,
        NPROBE, eps, tidx._plan.packed, tidx._plan.c_blk, metric=tidx.metric, **common,
    )
    j_ids, j_d = (np.asarray(a) for a in j_out)
    t_ids, t_d = (a.numpy() for a in t_out)
    if scan_dtype == "f32":
        assert (t_d < 0).any()  # clamp_l2 leaves inner-product distances alone
        _agree(j_ids, j_d, t_ids, t_d, exact=True)
    elif case == "exact_unsorted":
        # the kernel's bin order, not sorted by the corrected distances
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_allclose(t_d, j_d, rtol=1e-5, atol=1e-4)
        assert (t_d[np.isfinite(t_d)] >= 0).all()
    else:
        _agree(j_ids, j_d, t_ids, t_d, exact=False)


def test_routing_thresholds_match_jax():
    """The widths at which the fused modes stop are the reference's."""
    for w in range(128, 8193, 128):
        assert (w <= tfs.EXACT_MAX_WIDTH) == jfs.fused_fits_vmem(w, direct=True), w
        assert (w <= tfs.TWO_STAGE_MAX_WIDTH) == jfs.fused_fits_vmem(w, direct=False), w
        assert (w <= tfs.TWO_STAGE_MAX_WIDTH_INT8) == jfs.fused_fits_vmem(
            w, direct=False, int8_q=True
        ), w


def test_wide_plane_routes_to_two_stage_fused():
    """A 3072-wide index is past the EXACT budget: both packages serve it
    with the two-stage fused scan (TOTAL plane, single-gather re-rank), and
    "fused" past 3072 would drop to bf16 in both."""
    data = np.random.default_rng(11).standard_normal((600, 3072)).astype(np.float32)
    jidx = jr.IvfRabitqIndex.train(data, nlist=12, total_bits=7, seed=5, scan_dtype="fused8")
    tidx = _carry(jidx, "fused8")
    params = (TOP_K, 4)
    j_ids, j_d = jidx.batch_search_arrays(data[:6], jr.SearchParams(*params))
    t_ids, t_d = tidx.batch_search_arrays(data[:6], tr.SearchParams(*params))
    assert not jidx._fused_exact_ok() and not tidx._plan.fused_exact(tidx.scan_dtype)
    for idx in (jidx, tidx):
        assert idx.padded_dim == 3072 and idx.scan_dtype == "fused8"
    # a self-distance near 0 is what is left of f32 terms ~2 * 3072 that
    # cancel, summed in another order: an absolute floor of 1e-5 of them
    _agree(j_ids, j_d, t_ids, t_d, exact=False, abs_tol=1e-5 * 2 * 3072)
    assert np.all(t_ids[:, 0] == np.arange(6))


def test_degenerate_geometry_downgrades_with_a_warning(caplog):
    """~2-row clusters cannot fit a 128-cluster tile window: both packages
    warn and serve the index through the dense bf16 scan."""
    data = np.random.default_rng(11).standard_normal((1024, 32)).astype(np.float32)
    params = (3, 512)
    with caplog.at_level(logging.WARNING):
        jidx = jr.IvfRabitqIndex.train(data, nlist=512, total_bits=3, seed=3, scan_dtype="fused")
        j_ids, _ = jidx.batch_search_arrays(data[:4], jr.SearchParams(*params))
        j_warned = [r for r in caplog.records if r.name.startswith("rabitq_tpu.")]
        tidx = _carry(jidx, "fused")
        t_ids, _ = tidx.batch_search_arrays(data[:4], tr.SearchParams(*params))
        t_warned = [r for r in caplog.records if r.name.startswith("rabitq_tpu_torch.")]
    assert jidx.scan_dtype == tidx.scan_dtype == "bf16"
    assert j_warned and "falling back to bf16" in j_warned[0].getMessage()
    assert t_warned and "falling back to bf16" in t_warned[0].getMessage()
    assert tidx.layout.packed is None  # the permuted layout of the dense scans
    np.testing.assert_array_equal(t_ids[:, 0], np.arange(4))
    np.testing.assert_array_equal(t_ids[:, 0], j_ids[:, 0])


@pytest.mark.parametrize("total_bits", [7, 8])
def test_assigning_scan_dtype_relays_the_index(jax_indexes, total_bits):
    """Assigning ``scan_dtype`` after construction rebuilds the layout on the
    device from the current one; planes and results equal a fresh index's."""
    data, get = jax_indexes
    jidx = get(total_bits, "l2")
    tidx = _carry(jidx, "fused8")
    params = tr.SearchParams(TOP_K, NPROBE)
    tidx.batch_search_arrays(data[:8], params)
    for scan_dtype in ("bf16", "fused", "packed"):
        tidx.scan_dtype = scan_dtype
        ids, d = tidx.batch_search_arrays(data[:8], params)
        fresh = _carry(jidx, scan_dtype, approx_topk=True)
        f_ids, f_d = fresh.batch_search_arrays(data[:8], params)
        np.testing.assert_array_equal(ids, f_ids)
        np.testing.assert_array_equal(d, f_d)
        a, b = tidx.layout, fresh.layout
        np.testing.assert_array_equal(a.perm, b.perm)
        for name in ("binary", "ex", "packed", "f_add", "f_error", "f_rescale_ex",
                     "cluster_of", "valid", "ids", "delta"):
            av, bv = getattr(a, name), getattr(b, name)
            assert (av is None) == (bv is None), (scan_dtype, name)
            if av is not None:
                np.testing.assert_array_equal(av.numpy(), bv.numpy(), err_msg=name)


def test_default_scan_dtype_is_the_dense_bf16_path():
    data = _data(1200)
    jidx = jr.IvfRabitqIndex.train(data, nlist=8, total_bits=7, seed=3)
    tidx = tr.IvfRabitqIndex.train(data, nlist=8, total_bits=7, seed=3, device="cpu")
    assert jidx.scan_dtype == tidx.scan_dtype == "bf16"
    assert jidx._layout_mode() == tidx._layout_mode() == "perm"
    assert jidx.approx_topk and tidx.approx_topk
    params = (TOP_K, 8)
    tidx.batch_search_arrays(data[:8], tr.SearchParams(*params))
    assert tidx.layout.packed is None and tidx._plan.c_blk is None  # nothing fused was built
    carried = _carry(jidx, jidx.scan_dtype)
    j_ids, j_d = jidx.batch_search_arrays(data[:8], jr.SearchParams(*params))
    t_ids, t_d = carried.batch_search_arrays(data[:8], tr.SearchParams(*params))
    _agree(j_ids, j_d, t_ids, t_d, exact=False)
    assert tr.IvfRabitqIndex.from_host_arrays.__kwdefaults__["scan_dtype"] == "bf16"
