"""Batched search over the fused EXACT scan (port of the EXACT branch of
``rabitq_tpu/index/scan.py``).

Per query block: rank the centroids, mark the first ``nprobe`` as probed,
sort the queries by their best centroid (so each kernel block's probed set,
and so its compacted tile list, stays small), stream the int8 TOTAL plane
through the bin kernel with the extended factors -- the bin minima are the
final distances (``est_extended``, reference ``ivf.rs:2086-2099``) -- then
restore the f32 g_add on the returned values and sort each result row.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import estimator as est_ops
from ..ops.fused_scan import BIG, fused_select
from ..types import Metric


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


def decode_queries(q: torch.Tensor, qscale: torch.Tensor | None, dim: int) -> torch.Tensor:
    """Upload encoding -> f32 raw queries: f32, bf16, symmetric int8 with a
    per-query scale, or int4 nibble pairs (uint8, lo = even dim) with a
    per-query scale, sign-extended here."""
    if q.dtype == torch.uint8:
        b8 = q.view(torch.int8)
        lo = torch.bitwise_right_shift(torch.bitwise_left_shift(b8, 4), 4)
        hi = torch.bitwise_right_shift(b8, 4)
        q = torch.stack([lo, hi], dim=-1).reshape(q.shape[0], -1)[:, :dim]
    q = q.to(torch.float32)
    if qscale is not None:
        q = q * qscale[:, None]
    return q


def fused_exact_scan(
    q_rot: torch.Tensor,  # [B, Dpad] f32 rotated queries
    centroids: torch.Tensor,  # [C, Dpad] f32 rotated centroids
    plane: torch.Tensor,  # [Np, Dplane] int8 TOTAL codes, Dplane % 128 == 0
    f_add_ex: torch.Tensor,  # [Np] f32
    f_rescale_ex: torch.Tensor,  # [Np] f32
    cluster_of: torch.Tensor,  # [Np] int32
    row_allowed: torch.Tensor,  # [Np] bool (valid & user filter)
    ids: torch.Tensor,  # [Np] int32 original ids
    c_blk: torch.Tensor,  # [N_tiles] int32
    *,
    nprobe: int,
    top_k: int,
    metric: Metric,
    ex_bits: int,
    max_tiles: int | None = None,
    probe_k: int | None = None,
    clamp_l2: bool = False,
):
    """Returns (result_ids [B, top_k] int32, -1 padded; result_dist
    [B, top_k] f32 internal distances, +inf padded). For InnerProduct the
    score is -dist."""
    b = q_rot.shape[0]
    n_clusters = centroids.shape[0]
    qc = est_ops.query_constants(q_rot, ex_bits)
    g_add, _, sq_dist, cent_dot = est_ops.g_terms(q_rot, centroids, metric)

    # cluster selection (ivf.rs:1782-1835): stable descending order, ties to
    # the lower cluster id as lax.top_k breaks them
    sel = -sq_dist if metric is Metric.L2 else cent_dot
    k_sel = n_clusters if probe_k is None else min(probe_k, n_clusters)
    nprobe = min(max(int(nprobe), 1), n_clusters, k_sel)
    ranked = torch.sort(sel, dim=1, descending=True, stable=True).indices[:, :k_sel]
    probe_mask = torch.zeros((b, n_clusters), dtype=torch.bool, device=q_rot.device)
    probe_mask.scatter_(1, ranked[:, :nprobe], True)

    fa_eff = torch.where(row_allowed, f_add_ex, BIG)
    q_in, k1x_in, g_add_in, probe_in = q_rot, qc.kbx_sum_q, g_add, probe_mask
    inv = None
    if max_tiles is not None:
        # locality sort: queries sharing a best centroid share a kernel block
        order = torch.argsort(ranked[:, 0], stable=True)
        inv = torch.argsort(order, stable=True)
        q_in, k1x_in = q_rot[order], k1x_in[order]
        g_add_in, probe_in = g_add[order], probe_mask[order]
    if plane.shape[1] != q_in.shape[1]:
        q_in = torch.nn.functional.pad(q_in, (0, plane.shape[1] - q_in.shape[1]))
    cand_idx, cand_ok, cand_val, _ = fused_select(
        q_in, plane, fa_eff, f_rescale_ex, cluster_of, k1x_in, g_add_in, probe_in,
        c_blk, top_k, max_tiles=max_tiles,
    )
    if inv is not None:
        cand_idx, cand_ok, cand_val = cand_idx[inv], cand_ok[inv], cand_val[inv]

    # g_add entered the kernel as bf16: restore the f32 value on the
    # returned distances; the selected set stays the kernel's order
    g_corr = g_add - g_add.to(torch.bfloat16).to(torch.float32)
    rows = torch.clamp_min(cand_idx, 0).to(torch.int64)
    corr = torch.gather(g_corr, 1, cluster_of[rows].to(torch.int64))
    cand_val = cand_val + torch.where(cand_ok, corr, 0.0)
    result_dist = torch.where(cand_ok & torch.isfinite(cand_val), cand_val, float("inf"))
    if clamp_l2 and metric is Metric.L2:
        result_dist = torch.where(
            torch.isfinite(result_dist), torch.clamp_min(result_dist, 0.0), result_dist
        )
    result_ids = torch.where(torch.isfinite(result_dist), ids[rows], -1)
    k = result_ids.shape[1]
    if k < top_k:
        result_ids = torch.nn.functional.pad(result_ids, (0, top_k - k), value=-1)
        result_dist = torch.nn.functional.pad(result_dist, (0, top_k - k), value=float("inf"))
    return sort_result_rows(result_ids[:, :top_k], result_dist[:, :top_k])
