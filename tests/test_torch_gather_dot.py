"""The survivors' gather-dot (``rabitq_tpu_torch/ops/gather_dot.py``) on the CPU.

The plain version against an exact int64 / float64 numpy reference, within
the stated f32 summation tolerance (``sum_tolerance``: two f32 sums of one
dot in two orders lie within ``2 * D * 2**-24 * sum_d |code_d * q_d|``; one
f32 sum and the exact value within half of that). Stage 2's re-rank and the
gather scan, which now call it, against the inline chain they ran before
(kept below as the witness): bitwise equal on the CPU. The kernel itself is
held to the plain version on the card (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rabitq_tpu_torch.index import scan
from rabitq_tpu_torch.ops import estimator as est_ops
from rabitq_tpu_torch.ops import gather_dot as gd
from rabitq_tpu_torch.ops.select import top_k as select_top_k
from rabitq_tpu_torch.types import Metric

PLANES = {  # name -> (dtype, low, high) of the codes drawn
    "binary": (np.int8, 0, 2),
    "int8": (np.int8, -128, 128),
    "raw7": (np.int8, 0, 128),
    "int32": (np.int32, 0, 1 << 9),
}


def _plane(kind, n, width, seed):
    dtype, lo, hi = PLANES[kind]
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, (n, width)).astype(dtype)


def _reference(plane, rows, q):
    """Exact dots: int64 codes times f64 query, summed in f64 (each product
    of an int and an f32 is exact in f64; the sums are within 1e-16)."""
    codes = plane[rows][:, :, : q.shape[1]].astype(np.int64).astype(np.float64)
    return np.einsum("brd,bd->br", codes, q.astype(np.float64))


@pytest.mark.parametrize("kind", sorted(PLANES))
@pytest.mark.parametrize("dim,width", [(1024, 1024), (960, 1024), (100, 100)])
@pytest.mark.parametrize("r", [1, 17, 400])
def test_plain_matches_the_exact_reference(kind, dim, width, r):
    _against_the_reference(kind, dim, width, r, max_bytes=None)


@pytest.mark.parametrize("max_bytes", [1, 40_000])
def test_plain_sub_blocks_match_the_exact_reference(max_bytes):
    """A budget that holds one query's f32 codes, or a few, splits the block."""
    _against_the_reference("raw7", 960, 1024, 17, max_bytes=max_bytes, b=9)


def _against_the_reference(kind, dim, width, r, max_bytes, b=3):
    n = 300
    plane = _plane(kind, n, width, seed=r + width)
    rng = np.random.default_rng(dim + r)
    q = rng.standard_normal((b, dim)).astype(np.float32)
    rows = rng.integers(0, n, (b, r)).astype(np.int64)
    rows[0, 0], rows[-1, -1] = 0, n - 1  # the first and the last row of the plane
    rows_t, plane_t, q_t = map(torch.from_numpy, (rows, plane, q))
    (got,) = gd.gather_dot(rows_t, (plane_t, q_t), max_bytes=max_bytes)
    assert got.dtype == torch.float32 and got.shape == (b, r)
    want = _reference(plane, rows, q)
    tol = gd.sum_tolerance(rows_t, plane_t, q_t).double().numpy() / 2
    assert np.all(np.abs(got.double().numpy() - want) <= tol)


@pytest.mark.parametrize("ex_kind,width", [("raw7", 1024), ("int32", 1024), ("raw7", 1152)])
def test_two_planes_equal_two_one_plane_calls(ex_kind, width):
    n, b, r, dim = 250, 4, 17, 1024
    rng = np.random.default_rng(width)
    binary = torch.from_numpy(_plane("binary", n, dim, seed=5))
    ex = torch.from_numpy(_plane(ex_kind, n, width, seed=6))
    rows = torch.from_numpy(rng.integers(0, n, (b, r)))
    q_rot = torch.from_numpy(rng.standard_normal((b, dim)).astype(np.float32))
    q_op = q_rot.to(torch.bfloat16).to(torch.float32)
    bdot, edot = gd.gather_dot(rows, (binary, q_op), (ex, q_rot))
    assert torch.equal(bdot, gd.gather_dot(rows, (binary, q_op))[0])
    assert torch.equal(edot, gd.gather_dot(rows, (ex, q_rot))[0])


def _bad_inputs(case):
    plane = torch.zeros((10, 64), dtype=torch.int8)
    rows = torch.zeros((3, 5), dtype=torch.int64)
    q = torch.zeros((3, 64))
    if case == "float plane":
        return rows, ((plane.float(), q),)
    if case == "query wider than the plane":
        return rows, ((plane, torch.zeros((3, 65))),)
    if case == "mismatched B":
        return rows, ((plane, torch.zeros((4, 64))),)
    if case == "int32 rows":
        return rows.int(), ((plane, q),)
    if case == "bf16 query":
        return rows, ((plane, q.bfloat16()),)
    return rows, ((plane, q),) * 3  # three pairs


@pytest.mark.parametrize("case", ["float plane", "query wider than the plane", "mismatched B",
                                  "int32 rows", "bf16 query", "three pairs"])
def test_the_wrapper_refuses_what_it_does_not_take(case):
    rows, pairs = _bad_inputs(case)
    with pytest.raises(ValueError):
        gd.gather_dot(rows, *pairs)


# ----------------------------------------------------------------------
# the callers against the inline chain they ran before (the witness)
# ----------------------------------------------------------------------


def _old_stage2_rerank(
    q_rot, qc, g_add, binary, ex, f_add, f_rescale, f_add_ex, f_rescale_ex,
    cluster_of, ids, cand_idx, cand_ok,
    *, top_k, rerank, metric, ex_bits, scan_dtype, refine_ex, clamp_l2,
):
    rows = torch.clamp_min(cand_idx, 0).to(torch.int64)  # [B, R]
    q_op = q_rot if scan_dtype == "f32" else q_rot.to(torch.bfloat16).to(torch.float32)

    def _dot(plane, q):
        codes = plane[rows].to(torch.float32)  # [B, R, D]
        if codes.shape[-1] != q.shape[-1]:  # width-padded refine plane
            q = torch.nn.functional.pad(q, (0, codes.shape[-1] - q.shape[-1]))
        return torch.bmm(codes, q[:, :, None])[:, :, 0]

    g_add_c = torch.gather(g_add, 1, cluster_of[rows].to(torch.int64))
    if ex_bits > 0 and refine_ex and scan.ex_plane_is_total(ex_bits):
        total_term = _dot(ex, q_op) + qc.kbx_sum_q[:, None]
        dist = f_add_ex[rows] + g_add_c + f_rescale_ex[rows] * total_term
    elif ex_bits > 0 and refine_ex:
        dist = est_ops.est_extended(
            f_add_ex[rows], g_add_c, f_rescale_ex[rows], _dot(binary, q_op),
            _dot(ex, q_rot), qc.binary_scale, qc.kbx_sum_q[:, None],
        )
    else:
        dist = est_ops.est_1bit(
            f_add[rows], g_add_c, f_rescale[rows], _dot(binary, q_op), qc.k1x_sum_q[:, None]
        )
    dist = torch.where(cand_ok & torch.isfinite(dist), dist, float("inf"))
    k = min(top_k, rerank)
    neg_d, pos = select_top_k(-dist, k, site="final")
    result_dist = scan._clamp_l2(-neg_d, metric, clamp_l2)
    result_rows = torch.gather(rows, 1, pos.to(torch.int64))
    result_ids = torch.where(torch.isfinite(result_dist), ids[result_rows], -1)
    return scan._pad_results(result_ids, result_dist, top_k)


def _old_gather_scan(
    q_rot, qc, g_add, ranked, within, cl_starts, cl_sizes, ex_total, f_add_ex, f_rescale_ex,
    row_allowed, ids, *, top_k, metric, scan_dtype, clamp_l2, gather_rows, gather_bytes,
):
    b = q_rot.shape[0]
    r_idx = torch.arange(gather_rows, device=q_rot.device)
    seg_len = torch.where(within, cl_sizes[ranked], 0)
    cum = torch.cumsum(seg_len, dim=1)
    seg = torch.searchsorted(cum, r_idx.expand(b, -1).contiguous(), right=True)
    seg = torch.clamp_max(seg, cum.shape[1] - 1)
    cluster = torch.gather(ranked, 1, seg)
    prev = torch.where(seg > 0, torch.gather(cum, 1, torch.clamp_min(seg - 1, 0)), 0)
    valid = r_idx[None, :] < cum[:, -1:]
    row = torch.where(valid, cl_starts[cluster] + (r_idx[None, :] - prev), 0)

    q_op = q_rot if scan_dtype == "f32" else q_rot.to(torch.bfloat16).to(torch.float32)
    if ex_total.shape[1] != q_op.shape[1]:
        q_op = torch.nn.functional.pad(q_op, (0, ex_total.shape[1] - q_op.shape[1]))
    tdot = torch.empty((b, gather_rows), dtype=torch.float32, device=q_rot.device)
    step = max(1, gather_bytes // (gather_rows * ex_total.shape[1] * 4))
    for s in range(0, b, step):
        codes = ex_total[row[s : s + step]].to(torch.float32)
        tdot[s : s + step] = torch.bmm(codes, q_op[s : s + step, :, None])[:, :, 0]
    dist = f_add_ex[row] + torch.gather(g_add, 1, cluster) + f_rescale_ex[row] * (
        tdot + qc.kbx_sum_q[:, None]
    )
    ok = valid & row_allowed[row]
    dist = torch.where(ok & torch.isfinite(dist), dist, float("inf"))
    k = min(top_k, gather_rows)
    neg_d, pos = select_top_k(-dist, k, site="final")
    result_dist = scan._clamp_l2(-neg_d, metric, clamp_l2)
    result_rows = torch.gather(row, 1, pos.to(torch.int64))
    result_ids = torch.where(torch.isfinite(result_dist), ids[result_rows], -1)
    return scan._pad_results(result_ids, result_dist, top_k)


def _index_tensors(n, dim, width, ex_bits, n_clusters, seed):
    """Random planes and factors of an index of ``n`` rows: the binary plane,
    the refine plane (TOTAL codes, raw ex codes or int32 raw codes), the
    per-row factors, ids and clusters."""
    rng = np.random.default_rng(seed)
    binary = rng.integers(0, 2, (n, dim)).astype(np.int8)
    ex = rng.integers(0, 1 << ex_bits, (n, dim)) if ex_bits else np.zeros((n, dim), np.int64)
    plane = scan.make_refine_plane(binary, ex, ex_bits) if ex_bits else ex
    plane = np.asarray(plane).astype(np.int8 if ex_bits <= 7 else np.int32)
    plane = np.pad(plane, ((0, 0), (0, width - dim)))
    f = {k: torch.from_numpy(rng.standard_normal(n).astype(np.float32))
         for k in ("f_add", "f_rescale", "f_add_ex", "f_rescale_ex")}
    return dict(
        binary=torch.from_numpy(binary), ex=torch.from_numpy(plane), **f,
        cluster_of=torch.from_numpy(np.sort(rng.integers(0, n_clusters, n)).astype(np.int32)),
        ids=torch.from_numpy(rng.permutation(n).astype(np.int32)),
    )


@pytest.mark.parametrize("ex_bits,refine_ex", [(3, True), (7, True), (8, True), (7, False),
                                               (0, True)])
@pytest.mark.parametrize("scan_dtype,width", [("fused8", 128), ("f32", 128), ("bf16", 96)])
def test_stage2_rerank_equals_the_old_chain(ex_bits, refine_ex, scan_dtype, width):
    """The TOTAL plane (ex_bits 3), the two-plane 8-bit branch (raw ex codes
    as int8 at 7 bits and int32 at 8) and the 1-bit re-score (refine off, or
    no ex bits), with and without a width-padded refine plane."""
    n, dim, b, r, c = 400, 96, 5, 40, 7
    t = _index_tensors(n, dim, width, ex_bits, c, seed=ex_bits + width)
    rng = np.random.default_rng(11)
    q_rot = torch.from_numpy(rng.standard_normal((b, dim)).astype(np.float32))
    qc = est_ops.query_constants(q_rot, ex_bits)
    g_add = torch.from_numpy(rng.standard_normal((b, c)).astype(np.float32))
    cand_idx = torch.from_numpy(rng.integers(-1, n, (b, r)).astype(np.int32))
    cand_ok = cand_idx >= 0
    args = (q_rot, qc, g_add, t["binary"], t["ex"], t["f_add"], t["f_rescale"], t["f_add_ex"],
            t["f_rescale_ex"], t["cluster_of"], t["ids"], cand_idx, cand_ok)
    kw = dict(top_k=10, rerank=r, metric=Metric.L2, ex_bits=ex_bits, scan_dtype=scan_dtype,
              refine_ex=refine_ex, clamp_l2=False)
    got = scan._stage2_rerank(*args, **kw)
    want = _old_stage2_rerank(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("scan_dtype,width,gather_bytes", [
    ("fused8", 128, 1 << 30), ("f32", 96, 1 << 30), ("fused8", 128, 60_000)])
def test_gather_scan_equals_the_old_chain(scan_dtype, width, gather_bytes, monkeypatch):
    """The gather scan over every probed row, with one sub-block of queries
    and with several (a small ``GATHER_BYTES``)."""
    n, dim, b, c, k_sel, r = 600, 96, 6, 12, 5, 256
    t = _index_tensors(n, dim, width, 4, c, seed=width)
    sizes = np.bincount(t["cluster_of"].numpy(), minlength=c)
    rng = np.random.default_rng(12)
    q_rot = torch.from_numpy(rng.standard_normal((b, dim)).astype(np.float32))
    qc = est_ops.query_constants(q_rot, 4)
    g_add = torch.from_numpy(rng.standard_normal((b, c)).astype(np.float32))
    ranked = torch.from_numpy(np.stack([rng.permutation(c)[:k_sel] for _ in range(b)]))
    within = torch.from_numpy(rng.random((b, k_sel)) < 0.7)
    cl_starts = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)[:-1]]))
    cl_sizes = torch.from_numpy(sizes)
    row_allowed = torch.from_numpy(rng.random(n) < 0.9)
    args = (q_rot, qc, g_add, ranked, within, cl_starts, cl_sizes, t["ex"], t["f_add_ex"],
            t["f_rescale_ex"], row_allowed, t["ids"])
    kw = dict(top_k=10, metric=Metric.L2, scan_dtype=scan_dtype, clamp_l2=True,
              gather_rows=r)
    monkeypatch.setattr(scan, "_GATHER_BYTES", gather_bytes)
    got = scan._gather_scan(*args, **kw, with_diagnostics=False)
    want = _old_gather_scan(*args, **kw, gather_bytes=gather_bytes)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
