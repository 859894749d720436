"""The batched RaBitQ scan (port of ``rabitq_tpu/index/scan.py``).

Per query block, :func:`scan_kernel` ranks the centroids, marks the first
``nprobe`` as probed and takes one of three scans:

* fused EXACT (``fused_exact``): the int8 TOTAL plane streams through the
  direct bin kernel with the extended factors; the bin minima are the final
  distances (``est_extended``, reference ``ivf.rs:2086-2099``);
* fused two-stage (``scan_dtype`` "fused"/"fused8" otherwise): the packed
  bin kernel reduces 1-bit lower bounds into bins, the best ``rerank`` bins
  are the survivors, and :func:`_stage2_rerank` re-scores them exactly;
* dense (``scan_dtype`` "f32"/"bf16"/"int8"/"packed"): a ``[B, Np]`` plane
  of 1-bit lower bounds (a matrix product and torch ops, or for "packed" the
  packed lower-bound kernel with the g terms and masks in its epilogue), a
  top-``rerank`` survivor selection over it, then the same stage 2;
* gather (``gather_rows``, opt-in on cluster-sorted layouts): the probed
  clusters' rows of each query gathered and scored exactly, no bins and no
  survivor cut (:func:`_gather_scan`).

Stage 2 and the gather scan dot the gathered code rows with the query
through ``ops/gather_dot`` (one kernel on the card). The other products,
gathers and selections outside the kernels are torch ops, as they are XLA
ops in the reference. :func:`make_fused_search` is what the
indexes call: query decode, rotation and :func:`scan_kernel` as one search,
one CUDA graph replay a dispatch on the card (the reference's one jitted
program).
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from ..ops import estimator as est_ops
from ..ops.encode import encode_rows
from ..ops.fht import fht_kernel
from ..ops.fused_scan import (
    BIG,
    fused_bin_scan_cuda,
    fused_bin_scan_packed_cuda,
    fused_select,
)
from ..ops.gather_dot import gather_dot, gather_dot_kernel
from ..ops.packed_scan import (
    packed_lb_plane,
    packed_lb_plane_cuda,
    packed_lb_scan_cuda,
    permute_query,
)
from ..ops.select import top_k as select_top_k, top_k_cuda
from ..types import Metric
from ..utils.profiling import Span, span

SCAN_DTYPES = ("f32", "bf16", "int8", "packed", "fused", "fused8")


def probe_k_bucket(nprobe, n_clusters: int, scan_dtype: str = "fused") -> int | None:
    """Truncated centroid-ranking size: a power of two >= nprobe, or None
    (full ranking) when nprobe is close to the cluster count."""
    if not is_fused(scan_dtype):
        return None
    if not isinstance(nprobe, (int, np.integer)):
        return None
    k = max(int(nprobe), 1)
    if 2 * k >= n_clusters:
        return None
    return min(1 << (k - 1).bit_length(), n_clusters)


def is_fused(scan_dtype: str) -> bool:
    return scan_dtype in ("fused", "fused8")


def ex_plane_is_total(ex_bits: int) -> bool:
    """Whether the refine plane stores TOTAL codes (ex + binary << ex_bits
    <= 127 fits int8): ex_bits in 1..6."""
    return 1 <= ex_bits <= 6


def make_refine_plane(binary, ex, ex_bits: int):
    """The refine plane from binary/ex code planes (numpy arrays or
    tensors): TOTAL codes when they fit int8, else the raw ex codes."""
    if ex_plane_is_total(ex_bits):
        if isinstance(ex, torch.Tensor):
            return ex.to(torch.uint8) + (binary.to(torch.uint8) << ex_bits)
        return ex.astype("uint8") + (binary.astype("uint8") << ex_bits)
    return ex


def device_row_permutation(n: int, n_pad: int, seed: int = 0x5EED) -> np.ndarray:
    """Fixed pseudorandom permutation of the first ``n`` device rows;
    padding rows stay at the tail."""
    rng = np.random.default_rng(seed + n)
    perm = np.arange(n_pad, dtype=np.int64)
    perm[:n] = rng.permutation(n)
    return perm


def sort_result_rows(ids: torch.Tensor, dists: torch.Tensor):
    """Sort each ``[B, k]`` result row ascending by distance (invalid
    entries carry +inf and land last); stable, as ``jnp.argsort``."""
    dists, order = torch.sort(dists, dim=1, stable=True)
    return torch.gather(ids, 1, order), dists


def pack_int4_queries(q: np.ndarray):
    """Host-side int4 query encoding: symmetric per-query scale to [-7, 7],
    two dims per byte (lo nibble = even dim, hi = odd). Returns
    (packed uint8 [B, ceil(dim/2)], scale f32 [B])."""
    b, dim = q.shape
    scale = np.maximum(np.abs(q).max(axis=1), 1e-30) / 7.0
    qi = np.clip(np.rint(q / scale[:, None]), -7, 7).astype(np.int8)
    if dim % 2:
        qi = np.concatenate([qi, np.zeros((b, 1), np.int8)], axis=1)
    lo = qi[:, 0::2] & 0x0F
    hi = (qi[:, 1::2] & 0x0F) << 4
    return (lo | hi).astype(np.uint8), scale.astype(np.float32)


def _pad_pow2(n: int, floor: int = 1) -> int:
    """``n`` rounded up to a power of two, at least ``floor``."""
    p = floor
    while p < n:
        p *= 2
    return p


def encode_queries(queries: np.ndarray, b_pad: int, dim: int, upload_dtype: str):
    """Host (q, qscale | None) tensors of ``queries`` zero-padded to ``b_pad``
    rows in the upload encoding, encoded by numpy: "bf16", "int8" (symmetric
    per-query scale, a quarter of the bytes), "int4" (nibble pairs, an
    eighth), and f32 for "f32" or any other value, as the reference serves it.
    An index on the CPU encodes so (:class:`QueryStage`). On the card the raw
    f32 rows cross the link and one kernel gives the same codes and scales,
    bit for bit: there ``upload_dtype`` names the encoding the scan decodes,
    not what crosses the link."""
    with span("serve.encode", rows=queries.shape[0]) as sp:
        out = _encode(queries, b_pad, dim, upload_dtype)
        sp.add(bytes=sum(0 if t is None else t.nbytes for t in out))
    return out


def _encode(queries: np.ndarray, b_pad: int, dim: int, upload_dtype: str):
    q = np.zeros((b_pad, dim), np.float32)
    q[: queries.shape[0]] = queries
    if upload_dtype == "bf16":
        return torch.from_numpy(q).to(torch.bfloat16), None
    if upload_dtype == "int8":
        scale = np.maximum(np.abs(q).max(axis=1), 1e-30) / 127.0
        q_i8 = np.clip(np.rint(q / scale[:, None]), -127, 127).astype(np.int8)
        return torch.from_numpy(q_i8), torch.from_numpy(scale.astype(np.float32))
    if upload_dtype == "int4":
        packed, scale = pack_int4_queries(q)
        return torch.from_numpy(packed), torch.from_numpy(scale)
    return torch.from_numpy(q), None


def decode_queries(q: torch.Tensor, qscale: torch.Tensor | None, dim: int) -> torch.Tensor:
    """Upload encoding -> f32 raw queries: f32, bf16, symmetric int8 with a
    per-query scale, or int4 nibble pairs (uint8, lo = even dim) with a
    per-query scale, sign-extended here."""
    q = _query_codes(q, dim).to(torch.float32)
    if qscale is not None:
        q = q * qscale[:, None]
    return q


def _query_codes(q: torch.Tensor, dim: int) -> torch.Tensor:
    """An upload block as it is, int4 nibble pairs unpacked to int8 codes of
    ``dim`` columns."""
    if q.dtype != torch.uint8:
        return q
    b8 = q.view(torch.int8)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(b8, 4), 4)
    hi = torch.bitwise_right_shift(b8, 4)
    return torch.stack([lo, hi], dim=-1).reshape(q.shape[0], -1)[:, :dim]


# on the card, what a block of raw query rows takes to the link: a block of at
# most SMALL_BYTES (one query: 3.8 KB at 960 dims) is copied from the
# caller's pageable memory, which CUDA stages at once; one of at most
# SLOT_BYTES (an upload block) goes through a pinned slot the stage keeps,
# so that the copy runs on the DMA engine while the host goes on; a larger
# one (a whole unpipelined call) is copied from pageable memory, so that no
# slot grows beyond SLOT_BYTES
SMALL_BYTES = 1 << 16
SLOT_BYTES = 1 << 24


class QueryStage:
    """Where an index puts a block of its queries on its device, encoded
    (:meth:`__call__`).

    On the CPU numpy encodes the block (:func:`encode_queries`, the span
    ``serve.encode``), then ``serve.copy_in``. On the card the raw f32 rows
    cross the link with one non-blocking copy and are encoded there by one
    launch of the encode kernel (``ops/encode.encode_rows``; a pad and, for
    "bf16", a cast where the upload has no codes), queued behind the copy;
    the block's scans queue behind the kernel. A block of SMALL_BYTES to
    SLOT_BYTES is first written into one of two pinned slots the stage
    keeps, used in turn, each grown to the largest such block it has held; a
    slot is written only once its last copy has finished (an event a slot),
    so the host fills one block while the card copies and scans the one
    before. The codes and scales are the host's, bit for bit. On the card the
    span ``serve.encode`` covers the host's part (the staging write, the
    copy's launch as ``serve.copy_in``, the kernel's launch) and counts
    ``rows``, ``on_card`` (rows encoded on the card) and ``bytes`` (what
    crossed the link)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._slots: list = [None, None]  # pinned f32 [rows, dim] blocks
        self._copied: list = [None, None]  # event after each slot's last copy
        self._turn = 0

    def __call__(self, queries: np.ndarray, b_pad: int, dim: int, upload_dtype: str):
        """(q, qscale | None) of ``queries`` [n, dim] f32 zero-padded to
        ``b_pad`` rows in the ``upload_dtype`` encoding, on the device."""
        if self.device.type != "cuda":
            q, qscale = encode_queries(queries, b_pad, dim, upload_dtype)
            with span("serve.copy_in"):
                return q.to(self.device), None if qscale is None else qscale.to(self.device)
        n = queries.shape[0]
        with span("serve.encode", rows=n) as sp:
            rows = self._rows_on_card(queries)
            out = encode_rows(rows, b_pad, upload_dtype)
            sp.add(on_card=n, bytes=rows.nbytes)
        return out

    def _rows_on_card(self, queries: np.ndarray) -> torch.Tensor:
        if any(st < 0 for st in queries.strides):
            queries = np.ascontiguousarray(queries)  # torch takes no negative strides
        src = torch.from_numpy(queries)
        if not SMALL_BYTES < queries.nbytes <= SLOT_BYTES:
            with span("serve.copy_in"):
                return src.to(self.device, non_blocking=True)
        i = self._turn
        self._turn ^= 1
        if self._copied[i] is None:
            self._copied[i] = torch.cuda.Event()
        else:
            self._copied[i].synchronize()
        n, dim = queries.shape
        slot = self._slots[i]
        if slot is None or slot.shape[0] < n or slot.shape[1] != dim:
            # the block it replaces is freed once its copy is done (torch's
            # pinned allocator holds it until then)
            slot = self._slots[i] = torch.empty((n, dim), dtype=torch.float32, pin_memory=True)
        host = slot[:n]
        host.copy_(src)  # torch's threads: ~5x numpy's one at 3.8 MB
        with span("serve.copy_in"):
            rows = host.to(self.device, non_blocking=True)
            self._copied[i].record(torch.cuda.current_stream(self.device))
        return rows


def serve_pipelined(queries, batch_size, upload_block, upload, dispatch):
    """Queue ``dispatch(q, qscale, offset, sub_block)`` over fixed-size
    blocks of ``queries`` and fetch the results once: each upload block
    (``upload_block`` rows, >= ``batch_size``; None: one per scan block) is
    put on the device by ``upload(rows, b_pad)`` (the index's
    :class:`QueryStage`: on the card the raw rows cross the link without
    blocking and are encoded there), and its ``batch_size`` scan blocks are
    queued behind it, each the ``sub_block``-row window at ``offset`` of the
    upload block. Returns host (ids, dists) trimmed to the queries."""
    b_total = queries.shape[0]
    bs = _pad_pow2(min(batch_size, _pad_pow2(b_total)))
    ub = bs if upload_block is None else _pad_pow2(min(max(upload_block, bs), _pad_pow2(b_total)))
    pending = []
    for s in range(0, b_total, ub):
        q, qscale = upload(queries[s : s + ub], ub)
        for off in range(0, min(ub, b_total - s), bs):
            pending.append(dispatch(q, qscale, off, bs))
    return _fetch(pending, b_total)


def _fetch(pending, b_total: int) -> tuple[np.ndarray, np.ndarray]:
    """Host (ids, dists) of queued per-block results, trimmed to the
    queries asked for: the wait for the card, the copy and the conversion."""
    with span("serve.fetch"):
        ids = torch.cat([p[0] for p in pending]).cpu().numpy()[:b_total]
        dists = torch.cat([p[1] for p in pending]).cpu().numpy()[:b_total]
    return ids, dists


def gather_rows_bound(cluster_sizes, nprobe: int) -> int:
    """Safe per-query bound on probed rows: the sum of the ``nprobe``
    largest cluster sizes (a query probes ``nprobe`` clusters; pruning and
    filters only shrink the set)."""
    sizes = np.sort(np.asarray(cluster_sizes, np.int64))[::-1]
    return int(sizes[: max(int(nprobe), 1)].sum())


def gather_budget_bucket(cluster_sizes, nprobe) -> int | None:
    """:func:`gather_rows_bound` rounded up to a power of two, or None when
    the gather scan does not apply (no integer nprobe, no rows)."""
    if not isinstance(nprobe, (int, np.integer)):
        return None
    bound = gather_rows_bound(cluster_sizes, int(nprobe))
    if bound <= 0:
        return None
    return 1 << (bound - 1).bit_length()


_DOT_ROWS = 1 << 17  # code rows converted per product of _stage1_dots
_GATHER_BYTES = 1 << 30  # f32 code rows one query sub-block of the gather scan holds on the CPU


def _stage1_dots(q_rot: torch.Tensor, codes: torch.Tensor, scan_dtype: str) -> torch.Tensor:
    """<code_row, q> for all rows: q_rot [B, D] f32, codes [N, D] int8 ->
    [B, N] f32. ``scan_dtype`` picks the operand precision: "f32" exact,
    "bf16" the query rounded to bf16 (the codes are exact in bf16; f32
    accumulation), "int8" a per-query symmetric int8 quantization of the
    query with an exact integer dot, scaled back."""
    scale = None
    if scan_dtype == "f32":
        q = q_rot
    elif scan_dtype == "bf16":
        q = q_rot.to(torch.bfloat16)
    elif scan_dtype == "int8":
        scale = torch.clamp_min(q_rot.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-30)
        q = torch.clamp(torch.round(q_rot / scale), -127, 127)
    else:
        raise ValueError(f"unknown scan_dtype: {scan_dtype}")
    out = torch.empty((q.shape[0], codes.shape[0]), dtype=torch.float32, device=q.device)
    for s in range(0, codes.shape[0], _DOT_ROWS):
        blk = codes[s : s + _DOT_ROWS]
        if scan_dtype == "bf16" and q.is_cuda:
            # bf16 operands on the tensor cores, f32 accumulation and output
            out[:, s : s + _DOT_ROWS] = torch.mm(
                q, blk.to(torch.bfloat16).T, out_dtype=torch.float32
            )
        else:
            # f32 product of the rounded operands: the same products, summed
            # in f32 (int8: every partial sum is an integer below 2^24)
            torch.mm(q.to(torch.float32), blk.to(torch.float32).T, out=out[:, s : s + _DOT_ROWS])
    return out if scale is None else out * scale


def scan_kernel(
    q_rot: torch.Tensor,  # [B, Dpad] f32 rotated queries
    centroids: torch.Tensor,  # [C, Dpad] f32 rotated centroids
    binary: torch.Tensor | None,  # [Np, Dpad] int8 {0,1} (None: fused + TOTAL plane)
    ex: torch.Tensor,  # refine plane: TOTAL codes when ex_plane_is_total, else raw ex
    f_add: torch.Tensor,  # [Np] f32
    f_rescale: torch.Tensor,
    f_error: torch.Tensor,
    f_add_ex: torch.Tensor,
    f_rescale_ex: torch.Tensor,
    cluster_of: torch.Tensor,  # [Np] int32
    row_allowed: torch.Tensor,  # [Np] bool (valid & user filter)
    ids: torch.Tensor,  # [Np] int32 original ids
    nprobe: int = 1,
    prune_epsilon: float = 0.0,
    packed: torch.Tensor | None = None,  # [Np, Db] uint8 bit planes ("packed"/fused)
    fused_cblk: torch.Tensor | None = None,  # [N_tiles] int32 (fused windows)
    cl_starts: torch.Tensor | None = None,  # [C] first row of each cluster (gather)
    cl_sizes: torch.Tensor | None = None,  # [C] rows of each cluster (gather)
    *,
    top_k: int,
    rerank: int,
    metric: Metric,
    ex_bits: int,
    scan_dtype: str,
    use_prune_epsilon: bool = False,
    refine_ex: bool = True,
    clamp_l2: bool = False,
    centroid_select_l2: bool = False,
    approx_topk: bool = True,
    with_diagnostics: bool = False,
    max_tiles: int | None = None,
    probe_k: int | None = None,
    gather_rows: int | None = None,
    fused_exact: bool = False,
    fused_exact_sort: bool = True,
    locality_depth: int = 1,
    q_int8: tuple[torch.Tensor, torch.Tensor] | None = None,  # (codes [B, D] int8, scale [B])
):
    """Returns (result_ids [B, top_k] int32, -1 padded; result_dist
    [B, top_k] f32 internal distances, +inf padded). For InnerProduct the
    score is -dist (``ivf.rs:2106-2109``).

    With ``with_diagnostics`` a third output ``diag [B, 3] int32``, measured
    from the scan's own masks: ``[:, 0]`` candidates fully scored and
    offered to the final top-k, ``[:, 1]`` probed rows cut by the
    lower-bound survivor selection, ``[:, 2]`` extended-code evaluations.

    ``approx_topk`` selects survivors from the bf16 plane as the reference
    does; the selection itself is exact (the reference's approximate op has
    no counterpart, and an exact selection is one of its legal outcomes).
    Every selection here (centroid ranking, survivors, final top-k) is
    ``ops/select.top_k``, ``lax.top_k``'s contract: ties to the lower index.

    With ``gather_rows`` (a static per-query row budget, cluster-sorted rows
    and the TOTAL refine plane) the gather scan serves the block instead.

    ``q_int8``, where given, is ``q_rot`` as an integer grid: ``q_rot ==
    codes * scale[:, None]`` (an un-rotated int8 or int4 upload,
    :func:`_fused_body`). The fused EXACT scan's bin kernel then takes it in
    place of the f32 query (K1 on the int8 tensor cores); everything else
    reads ``q_rot``."""
    b = q_rot.shape[0]
    n_rows = ids.shape[0]
    n_clusters = centroids.shape[0]
    rerank = min(max(rerank, top_k), n_rows)

    qc = est_ops.query_constants(q_rot, ex_bits)
    g_add, g_error, sq_dist, cent_dot = est_ops.g_terms(q_rot, centroids, metric)

    # --- cluster selection (ivf.rs:1782-1835): descending, ties to the lower
    # cluster id; MSTG navigates centroids by L2 whatever the scan metric
    sel = -sq_dist if (centroid_select_l2 or metric is Metric.L2) else cent_dot
    k_sel = n_clusters if probe_k is None else min(probe_k, n_clusters)
    nprobe = min(max(int(nprobe), 1), n_clusters, k_sel)
    ranked_sel, ranked = select_top_k(sel, k_sel, site="centroids")
    ranked = ranked.to(torch.int64)
    within = (torch.arange(k_sel, device=q_rot.device) < nprobe)[None, :].expand(b, k_sel)
    if use_prune_epsilon:
        # MSTG dynamic pruning (mstg/index.rs:349-362) on squared distances
        ranked_sq = -ranked_sel
        within = within & (ranked_sq <= ranked_sq[:, :1] * (1.0 + prune_epsilon) ** 2)

    if gather_rows is not None:
        if cl_starts is None or cl_sizes is None:
            raise ValueError("the gather scan needs the cluster row ranges")
        if not (ex_bits > 0 and refine_ex and ex_plane_is_total(ex_bits)):
            raise ValueError("the gather scan needs the TOTAL refine plane (ex_bits 1..6)")
        return _gather_scan(
            q_rot, qc, g_add, ranked, within, cl_starts, cl_sizes, ex, f_add_ex,
            f_rescale_ex, row_allowed, ids, top_k=top_k, metric=metric, scan_dtype=scan_dtype,
            clamp_l2=clamp_l2, gather_rows=gather_rows, with_diagnostics=with_diagnostics,
        )
    probe_mask = torch.zeros((b, n_clusters), dtype=torch.bool, device=q_rot.device)
    probe_mask.scatter_(1, ranked, within)

    if is_fused(scan_dtype):
        if fused_cblk is None:
            raise ValueError("the fused scans need the c_blk windows")
        if fused_exact and ex.shape[1] % 128:
            fused_exact = False  # a plane not width-padded to 128 columns: two-stage scan
        if fused_exact:
            if not (ex_plane_is_total(ex_bits) and refine_ex):
                raise ValueError("fused_exact needs the TOTAL refine plane")
            plane = ex
            fa_eff = torch.where(row_allowed, f_add_ex, BIG)
            fr_in, k1x_full = f_rescale_ex, qc.kbx_sum_q
        else:
            if packed is None:
                raise ValueError("the two-stage fused scan needs the packed plane")
            plane = packed
            fa_eff = torch.where(row_allowed, f_add, BIG)
            fr_in, k1x_full = f_rescale, qc.k1x_sum_q
        q_in, k1x_in, g_add_in, g_err_in, probe_in = q_rot, k1x_full, g_add, g_error, probe_mask
        grid = q_int8 if fused_exact else None
        inv = None
        if max_tiles is not None:
            # locality sort: queries sharing a best centroid (and, at depth 2,
            # a second one) share a kernel block
            if locality_depth >= 2 and ranked.shape[1] >= 2:
                key = ranked[:, 0] * n_clusters + ranked[:, 1]
            else:
                key = ranked[:, 0]
            order = torch.argsort(key, stable=True)
            inv = torch.argsort(order, stable=True)
            q_in, k1x_in = q_rot[order], k1x_full[order]
            g_add_in, g_err_in, probe_in = g_add[order], g_error[order], probe_mask[order]
            if grid is not None:
                grid = (grid[0][order], grid[1][order])
        if fused_exact and plane.shape[1] != q_in.shape[1]:
            q_in = torch.nn.functional.pad(q_in, (0, plane.shape[1] - q_in.shape[1]))
            if grid is not None:
                grid = (torch.nn.functional.pad(grid[0], (0, plane.shape[1] - grid[0].shape[1])),
                        grid[1])
        packed_kw = {} if fused_exact else dict(
            f_error=f_error, g_err=g_err_in, int8_stage1=scan_dtype == "fused8"
        )
        cand_idx, cand_ok, cand_val, probed = fused_select(
            q_in, plane, fa_eff, fr_in, cluster_of, k1x_in, g_add_in, probe_in,
            fused_cblk, top_k if fused_exact else rerank, max_tiles=max_tiles,
            direct_plane=fused_exact, q_int8=grid, **packed_kw,
        )
        if inv is not None:
            cand_idx, cand_ok, cand_val, probed = (
                cand_idx[inv], cand_ok[inv], cand_val[inv], probed[inv]
            )
        if fused_exact:
            result = _exact_result(
                cand_idx, cand_ok, cand_val, g_add, cluster_of, ids, top_k=top_k,
                metric=metric, clamp_l2=clamp_l2, sort=fused_exact_sort,
            )
        else:
            result = _stage2_rerank(
                q_rot, qc, g_add, binary, ex, f_add, f_rescale, f_add_ex, f_rescale_ex,
                cluster_of, ids, cand_idx, cand_ok, top_k=top_k, rerank=cand_idx.shape[1],
                metric=metric, ex_bits=ex_bits, scan_dtype=scan_dtype, refine_ex=refine_ex,
                clamp_l2=clamp_l2,
            )
        if not with_diagnostics:
            return result
        # `probed` is the kernel's own offered-row count. In exact mode
        # every offered row is scored at full precision: none is skipped
        if fused_exact:
            return (*result, torch.stack([probed, torch.zeros_like(probed), probed], dim=1))
        return (*result, _diagnostics(probed, cand_ok, ex_bits, refine_ex))

    # --- stage 1: dense 1-bit estimate for every row, as the [B, Np] plane of
    # -lb the survivor selection takes: -inf where a row is not allowed, +inf
    # where lb is not finite (non-finite lower bounds never prune,
    # ivf.rs:2031-2042)
    if scan_dtype == "packed":
        if packed is None:
            raise ValueError("scan_dtype='packed' needs the packed plane")
        # one kernel from the g terms and masks to the bf16 plane
        neg_lb = packed_lb_plane(
            packed, permute_query(q_rot, q_rot.shape[1]).contiguous(), f_add, f_rescale,
            qc.k1x_sum_q.contiguous(), g_add, g_error, f_error, cluster_of, probe_mask,
            row_allowed,
        )
        if not approx_topk:
            neg_lb = neg_lb.to(torch.float32)
    else:
        if binary is None:
            raise ValueError("the dense scan needs the binary plane")
        # the [B, Np] g planes are bf16 except on the f32 oracle path
        g_dtype = torch.float32 if scan_dtype == "f32" else torch.bfloat16
        g_add_rows = g_add.to(g_dtype).index_select(1, cluster_of)
        g_err_rows = g_error.to(g_dtype).index_select(1, cluster_of)
        allowed = probe_mask.index_select(1, cluster_of) & row_allowed[None, :]
        bdot = _stage1_dots(q_rot, binary, scan_dtype)
        est = est_ops.est_1bit(
            f_add[None, :], g_add_rows, f_rescale[None, :], bdot, qc.k1x_sum_q[:, None]
        )
        lb = est_ops.lower_bound(est, f_error[None, :], g_err_rows)
        lb = torch.where(torch.isfinite(lb), lb, -float("inf"))
        neg_lb = torch.where(allowed, -lb, -float("inf"))
        if approx_topk:
            neg_lb = neg_lb.to(torch.bfloat16)

    # --- survivor selection: a fixed-size replacement of the heap prune
    top_neg, cand_idx = select_top_k(neg_lb, rerank, site="survivors")
    cand_ok = top_neg.to(torch.float32) > -float("inf")

    result = _stage2_rerank(
        q_rot, qc, g_add, binary, ex, f_add, f_rescale, f_add_ex, f_rescale_ex,
        cluster_of, ids, cand_idx, cand_ok, top_k=top_k, rerank=rerank, metric=metric,
        ex_bits=ex_bits, scan_dtype=scan_dtype, refine_ex=refine_ex, clamp_l2=clamp_l2,
    )
    if not with_diagnostics:
        return result
    if scan_dtype == "packed":
        # allowed rows per cluster, summed over each query's probed clusters
        per_cluster = torch.zeros(n_clusters, dtype=torch.int64, device=q_rot.device)
        per_cluster.index_add_(0, cluster_of.to(torch.int64), row_allowed.to(torch.int64))
        probed = (probe_mask.to(torch.int64) * per_cluster[None, :]).sum(dim=1).to(torch.int32)
    else:
        probed = allowed.sum(dim=1, dtype=torch.int32)
    return (*result, _diagnostics(probed, cand_ok, ex_bits, refine_ex))


def _gather_scan(
    q_rot, qc, g_add, ranked, within, cl_starts, cl_sizes, ex_total, f_add_ex, f_rescale_ex,
    row_allowed, ids, *, top_k, metric, scan_dtype, clamp_l2, gather_rows, with_diagnostics,
):
    """Exact scoring of every probed row by a per-query row gather
    (reference ``rabitq_tpu/index/scan.py:_gather_scan``).

    Each query's probed clusters (``ranked`` best-first, ``within`` the
    probed mask) are flattened into a ``[B, R]`` matrix of rows (R =
    ``gather_rows``; slots past a query's probed rows are masked), their
    TOTAL codes dotted with the query (``ops/gather_dot``; on the CPU over
    sub-blocks of queries whose f32 codes stay within ``_GATHER_BYTES``),
    scored with the extended estimator (``ivf.rs:2086-2099``), and the best
    ``top_k`` kept. Outside the f32 oracle configuration the query is
    rounded to bf16 (the codes are exact in bf16, the sums f32)."""
    b = q_rot.shape[0]
    r_idx = torch.arange(gather_rows, device=q_rot.device)
    seg_len = torch.where(within, cl_sizes[ranked], 0)  # [B, k_sel]
    cum = torch.cumsum(seg_len, dim=1)
    # segment of each slot: the first cumulative size strictly above it
    seg = torch.searchsorted(cum, r_idx.expand(b, -1).contiguous(), right=True)
    seg = torch.clamp_max(seg, cum.shape[1] - 1)
    cluster = torch.gather(ranked, 1, seg)  # [B, R]
    prev = torch.where(seg > 0, torch.gather(cum, 1, torch.clamp_min(seg - 1, 0)), 0)
    valid = r_idx[None, :] < cum[:, -1:]
    row = torch.where(valid, cl_starts[cluster] + (r_idx[None, :] - prev), 0)

    q_op = q_rot if scan_dtype == "f32" else q_rot.to(torch.bfloat16).to(torch.float32)
    (tdot,) = gather_dot(row, (ex_total, q_op), max_bytes=_GATHER_BYTES)
    dist = f_add_ex[row] + torch.gather(g_add, 1, cluster) + f_rescale_ex[row] * (
        tdot + qc.kbx_sum_q[:, None]
    )
    ok = valid & row_allowed[row]
    dist = torch.where(ok & torch.isfinite(dist), dist, float("inf"))

    # final top-k: ties to the earlier slot
    k = min(top_k, gather_rows)
    neg_d, pos = select_top_k(-dist, k, site="final")
    result_dist = _clamp_l2(-neg_d, metric, clamp_l2)
    result_rows = torch.gather(row, 1, pos.to(torch.int64))
    result_ids = torch.where(torch.isfinite(result_dist), ids[result_rows], -1)
    result = _pad_results(result_ids, result_dist, top_k)
    if not with_diagnostics:
        return result
    # every offered row is scored exactly: none is cut by a lower bound
    estimated = ok.sum(dim=1, dtype=torch.int32)
    return (*result, torch.stack([estimated, torch.zeros_like(estimated), estimated], dim=1))


def _diagnostics(probed, cand_ok, ex_bits: int, refine_ex: bool) -> torch.Tensor:
    """[B, 3] int32: survivors, probed rows cut by the lower bound, extended
    evaluations (the survivors when stage 2 refines, else 0)."""
    survivors = cand_ok.sum(dim=1, dtype=torch.int32)
    extended = survivors if (ex_bits > 0 and refine_ex) else torch.zeros_like(survivors)
    return torch.stack([survivors, probed - survivors, extended], dim=1)


def _pad_results(result_ids, result_dist, top_k: int):
    k = result_ids.shape[1]
    if k < top_k:
        result_ids = torch.nn.functional.pad(result_ids, (0, top_k - k), value=-1)
        result_dist = torch.nn.functional.pad(result_dist, (0, top_k - k), value=float("inf"))
    return result_ids, result_dist


def _clamp_l2(result_dist, metric: Metric, clamp_l2: bool):
    """MSTG clamps small negative L2 estimates to 0 (mstg/index.rs:322-327),
    after ranking: clamping first would turn them into ties."""
    if clamp_l2 and metric is Metric.L2:
        return torch.where(
            torch.isfinite(result_dist), torch.clamp_min(result_dist, 0.0), result_dist
        )
    return result_dist


def _exact_result(
    cand_idx, cand_ok, cand_val, g_add, cluster_of, ids, *, top_k, metric, clamp_l2, sort
):
    """Results of the fused EXACT scan from its best bins. g_add entered the
    kernel as bf16: the f32 value is restored on the returned distances,
    while the selected set stays the kernel's order; ``sort`` then orders
    each row by the corrected values."""
    g_corr = g_add - g_add.to(torch.bfloat16).to(torch.float32)
    rows = torch.clamp_min(cand_idx, 0).to(torch.int64)
    corr = torch.gather(g_corr, 1, cluster_of[rows].to(torch.int64))
    cand_val = cand_val + torch.where(cand_ok, corr, 0.0)
    result_dist = torch.where(cand_ok & torch.isfinite(cand_val), cand_val, float("inf"))
    result_dist = _clamp_l2(result_dist, metric, clamp_l2)
    result_ids = torch.where(torch.isfinite(result_dist), ids[rows], -1)
    result_ids, result_dist = _pad_results(result_ids, result_dist, top_k)
    result_ids, result_dist = result_ids[:, :top_k], result_dist[:, :top_k]
    if sort:
        return sort_result_rows(result_ids, result_dist)
    return result_ids, result_dist


def _stage2_rerank(
    q_rot, qc, g_add, binary, ex, f_add, f_rescale, f_add_ex, f_rescale_ex,
    cluster_of, ids, cand_idx, cand_ok,
    *, top_k, rerank, metric, ex_bits, scan_dtype, refine_ex, clamp_l2,
):
    """High-precision re-rank of the survivors and the final top-k
    (``ivf.rs:2060-2099``), shared by the dense and the fused two-stage
    scans. Codes <= 127 are exact in bf16, so outside the f32 oracle
    configuration only the query is rounded to bf16; the sums are f32."""
    rows = torch.clamp_min(cand_idx, 0).to(torch.int64)  # [B, R]
    q_op = q_rot if scan_dtype == "f32" else q_rot.to(torch.bfloat16).to(torch.float32)

    g_add_c = torch.gather(g_add, 1, cluster_of[rows].to(torch.int64))
    if ex_bits > 0 and refine_ex and ex_plane_is_total(ex_bits):
        # single gather: <total, q> == binary_scale * bdot + edot exactly
        (tdot,) = gather_dot(rows, (ex, q_op))
        dist = f_add_ex[rows] + g_add_c + f_rescale_ex[rows] * (tdot + qc.kbx_sum_q[:, None])
    elif ex_bits > 0 and refine_ex:
        if binary is None:
            raise ValueError("the two-gather refine needs the binary plane")
        # both rows of a survivor in one pass; raw ex codes may exceed 127: f32 query
        bdot, edot = gather_dot(rows, (binary, q_op), (ex, q_rot))
        dist = est_ops.est_extended(
            f_add_ex[rows], g_add_c, f_rescale_ex[rows], bdot, edot,
            qc.binary_scale, qc.kbx_sum_q[:, None],
        )
    else:
        if binary is None:
            raise ValueError("the 1-bit re-score needs the binary plane")
        (bdot,) = gather_dot(rows, (binary, q_op))
        dist = est_ops.est_1bit(
            f_add[rows], g_add_c, f_rescale[rows], bdot, qc.k1x_sum_q[:, None]
        )
    dist = torch.where(cand_ok & torch.isfinite(dist), dist, float("inf"))

    # final top-k: ties to the earlier survivor
    k = min(top_k, rerank)
    neg_d, pos = select_top_k(-dist, k, site="final")
    result_dist = _clamp_l2(-neg_d, metric, clamp_l2)
    result_rows = torch.gather(rows, 1, pos.to(torch.int64))
    result_ids = torch.where(torch.isfinite(result_dist), ids[result_rows], -1)
    return _pad_results(result_ids, result_dist, top_k)


# ----------------------------------------------------------------------
# the one-dispatch search (``make_fused_search``)
# ----------------------------------------------------------------------

_SCAN_PARAMS = inspect.signature(scan_kernel).parameters
_SCAN_NAMES = tuple(_SCAN_PARAMS)[1:]  # the arguments after q_rot
_SCAN_DEFAULTS = {
    name: p.default for name, p in _SCAN_PARAMS.items()
    if p.default is not inspect.Parameter.empty
}
# tensors a graph reads from its own buffers, copied in at every call; every
# other tensor is read at the address it had when the graph was captured
_COPIED_IN = ("q", "qscale", "row_allowed")


def _fused_body(rotate_fn, dim, q, *args, qscale=None, offset=None, sub_block=None, **kwargs):
    """Decode, scale, rotate and scan one encoded query block, op by op, as
    the program of the JAX package's ``make_fused_search`` does: the
    ``sub_block`` rows at ``offset`` where given, int4 nibble pairs decoded
    to ``dim`` columns, f32 with the per-query scale applied, ``rotate_fn``
    (None: the queries are already in the index's space), then
    :func:`scan_kernel` with the remaining arguments. An int8 or int4 upload
    that is not rotated reaches the scan as an integer grid too (``q_int8``:
    the codes and their scales). What a CPU tensor runs, what a CUDA graph
    records, and the eager witness the graphs are held against on the
    card."""
    if sub_block is not None:
        q = q[offset : offset + sub_block]
        if qscale is not None:
            qscale = qscale[offset : offset + sub_block]
    if q.dtype == torch.uint8 and dim is None:
        raise ValueError("int4 uploads need make_fused_search(dim=)")
    codes = _query_codes(q, dim)
    q = decode_queries(codes, qscale, dim)
    if rotate_fn is not None:
        return scan_kernel(rotate_fn(q), *args, **kwargs)
    if integer_grid(codes, qscale):
        kwargs = {**kwargs, "q_int8": (codes, qscale)}
    return scan_kernel(q, *args, **kwargs)


def integer_grid(q: torch.Tensor, qscale: torch.Tensor | None) -> bool:
    """Whether an upload block ``q`` is an integer grid: int8 codes, or
    int4 nibble pairs, with per-query scales. Where no rotation turns it to
    f32, the fused EXACT scan's bin kernel (K1) takes the codes and scales
    in place of the f32 query (:func:`_fused_body`); MSTG's
    ``search.dispatch`` span counts that as ``k1_int8``."""
    return qscale is not None and q.dtype in (torch.int8, torch.uint8)


def _launch_counters():
    """(dict, key) of every kernel wrapper's launch counter."""
    slots = [(vars(f), "launches") for f in (fht_kernel, packed_lb_scan_cuda, packed_lb_plane_cuda)]
    return slots + [(d, k) for d in (fused_bin_scan_cuda.launches,
                                     fused_bin_scan_packed_cuda.launches, top_k_cuda.launches,
                                     gather_dot_kernel.launches)
                    for k in d]


def _read_launches() -> list[int]:
    return [d[k] for d, k in _launch_counters()]


def _add_launches(deltas, sign: int = 1) -> None:
    for (d, k), n in zip(_launch_counters(), deltas):
        d[k] += sign * n


def _graph_key(q, qscale, scan: dict) -> tuple:
    """Everything a captured graph freezes: each Python argument's value,
    and each tensor's shape, strides, type and device, with its address
    where the graph reads it in place (the index's resident tensors)."""

    def part(name, v):
        if isinstance(v, torch.Tensor):
            ptr = None if name in _COPIED_IN else v.data_ptr()
            return (name, tuple(v.shape), v.stride(), v.dtype, v.device, ptr)
        return (name, v)

    return (part("q", q), part("qscale", qscale)) + tuple(
        part(name, scan[name]) for name in _SCAN_NAMES)


class _Graph:
    """One captured search: its input buffers, its outputs and the kernel
    launches one replay makes (a count a slot of ``_launch_counters``)."""

    def __init__(self, graph, inputs: dict, outputs, launches: list[int]):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        # a replay adds to the few counters that moved, not to every slot
        self._moved = [(d, k, n) for (d, k), n in zip(_launch_counters(), launches) if n]

    def run(self, q, qscale, row_allowed):
        self.inputs["q"].copy_(q)
        if qscale is not None:
            self.inputs["qscale"].copy_(qscale)
        self.inputs["row_allowed"].copy_(row_allowed)
        with span("graph.replay"):
            self.graph.replay()
        for d, k, n in self._moved:
            d[k] += n
        # the next replay writes the same buffers: each call gets its own copy
        return tuple(o.clone() for o in self.outputs)


class FusedSearch:
    """The search :func:`make_fused_search` returns (one per index).

    A CPU tensor runs :func:`_fused_body`. On the card every key is one CUDA
    graph that replays decode, rotation (the FHT kernel) and the whole scan
    (the bin scans, the packed lower-bound kernel and the torch ops around
    them) as one launch. The key (:func:`_graph_key`) holds the static
    options, the Python scalars the body reads on the host (``nprobe``,
    ``prune_epsilon``, ``rerank``, ``probe_k``, the tile and gather budgets),
    the shape and type of every tensor, the address of every tensor the
    graph reads in place, and which optional tensors are given. The first
    call of a key runs the body once on the capture stream (it builds the
    kernels' libraries and fills the caches they read at first use) and
    captures it; each call copies the query window, its scale and the row
    mask into the graph's buffers, replays it and clones its outputs. The
    graphs of one index share one memory pool: replays run in one stream
    order, so the pool holds the largest capture's memory, not the sum.

    A graph reads the index's tensors at their captured addresses, so the
    index calls :meth:`clear` whenever it replaces one (a new layout, the
    packed plane, the tile windows, the cluster ranges); the addresses in the
    key keep a replaced tensor from ever meeting an old graph. The kernel
    wrappers count their launches in Python, which a replay does not run:
    each graph adds the counts its capture made at every replay instead.
    A capture is the span ``graph.capture``, kept whether tracing is on or
    off; a replay is ``graph.replay``.
    On the card a failed capture or replay raises; nothing falls back to the
    eager body."""

    def __init__(self, rotate_fn, dim: int | None = None):
        self.rotate_fn = rotate_fn
        self.dim = dim
        self._graphs: dict = {}
        self._pool = None
        self._stream = None
        # seconds of each capture (warm-up included), replays, and the bytes
        # the graphs' pool holds now and at most
        self.stats = {"capture_s": [], "replays": 0, "pool_bytes": 0, "pool_peak": 0}

    def clear(self) -> None:
        """Drop every graph: the index replaced a tensor they read."""
        self._graphs.clear()
        self.stats["pool_bytes"] = 0

    def eager(self, q, *args, **kwargs):
        """:func:`_fused_body` with this search's rotation: the eager witness."""
        return _fused_body(self.rotate_fn, self.dim, q, *args, **kwargs)

    def __call__(self, q, *args, qscale=None, offset=None, sub_block=None, **kwargs):
        if not q.is_cuda:
            return self.eager(q, *args, qscale=qscale, offset=offset, sub_block=sub_block,
                              **kwargs)
        if sub_block is not None:
            q = q[offset : offset + sub_block]
            if qscale is not None:
                qscale = qscale[offset : offset + sub_block]
        scan = {**_SCAN_DEFAULTS, **dict(zip(_SCAN_NAMES, args)), **kwargs}
        key = _graph_key(q, qscale, scan)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = self._capture(q, qscale, scan)
        self.stats["replays"] += 1
        return graph.run(q, qscale, scan["row_allowed"])

    def _capture(self, q, qscale, scan: dict) -> _Graph:
        with Span("graph.capture", always=True) as sp:
            graph = self._capture_body(q, qscale, scan)
        self.stats["capture_s"].append(sp.seconds)
        return graph

    def _capture_body(self, q, qscale, scan: dict) -> _Graph:
        dev = q.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(dev)
        inputs = {
            "q": q.clone(memory_format=torch.contiguous_format),
            "qscale": None if qscale is None else qscale.clone(),
            "row_allowed": scan["row_allowed"].clone(),
        }
        kw = {**scan, "row_allowed": inputs["row_allowed"]}

        def body():
            return self.eager(inputs["q"], qscale=inputs["qscale"], **kw)

        self._stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self._stream):
            body()  # the warm-up: first-use work must not happen inside the capture
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = _read_launches()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            outputs = body()
        # the capture counted launches it only recorded: they count at replays
        launches = [a - b for a, b in zip(_read_launches(), before)]
        _add_launches(launches, -1)
        st = self.stats
        st["pool_bytes"] += torch.cuda.memory_reserved(dev) - reserved
        st["pool_peak"] = max(st["pool_peak"], st["pool_bytes"])
        return _Graph(graph, inputs, tuple(outputs), launches)


def make_fused_search(rotate_fn, dim: int | None = None) -> FusedSearch:
    """One search per index with the rotation fused into the scan (the JAX
    package's ``make_fused_search``): ``fused(q, *args, qscale=None,
    offset=None, sub_block=None, **kwargs)`` decodes an encoded query block
    (f32, bf16, symmetric int8 or int4 nibble pairs, with ``qscale`` for the
    last two), rotates it with ``rotate_fn`` (None for indexes that quantize
    in the original space, MSTG's default) and runs :func:`scan_kernel` with
    ``args`` / ``kwargs``; with ``sub_block`` it scans the ``sub_block``-row
    window at ``offset`` of ``q`` (an upload superblock). ``dim``, the raw
    query width, is needed to decode int4 uploads. On the card each call is
    one CUDA graph replay (:class:`FusedSearch`)."""
    return FusedSearch(rotate_fn, dim)
