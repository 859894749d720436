"""Distance estimator formulas (port of ``rabitq_tpu/ops/estimator.py``).

  est_1bit   = f_add + g_add + f_rescale * (<binary_code, q_rot> + c1 * sum(q)),  c1 = -.5
  lower      = est_1bit - f_error * g_error
  total_term = 2^ex_bits * <binary_code, q_rot> + <ex_code, q_rot>
               + cb * sum(q),                        cb = -(2^ex_bits - .5)
  dist_ex    = f_add_ex + g_add + f_rescale_ex * total_term

where g_add = ||q - c||^2 (L2) or -<q, c> (IP) and g_error = ||q - c||
(reference ``ivf.rs:1850-1857, 2086-2099``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..types import Metric


class QueryConstants(NamedTuple):
    """Per-query precomputed constants (``QueryPrecomputed``)."""

    sum_q: torch.Tensor  # [...]: sum of rotated query entries
    k1x_sum_q: torch.Tensor  # c1 * sum_q
    kbx_sum_q: torch.Tensor  # cb * sum_q
    binary_scale: float  # 2^ex_bits


def query_constants(q_rot: torch.Tensor, ex_bits: int) -> QueryConstants:
    sum_q = torch.sum(q_rot, dim=-1)
    c1 = -0.5
    cb = -((1 << ex_bits) - 0.5)
    return QueryConstants(
        sum_q=sum_q,
        k1x_sum_q=c1 * sum_q,
        kbx_sum_q=cb * sum_q,
        binary_scale=float(1 << ex_bits),
    )


def g_terms(q_rot: torch.Tensor, centroids: torch.Tensor, metric: Metric):
    """Per-(query, centroid) terms: q_rot [B, D], centroids [C, D] ->
    (g_add [B, C], g_error [B, C], cent_sq_dist [B, C], cent_dot [B, C])."""
    q = q_rot.to(torch.float32)
    c = centroids.to(torch.float32)
    dot = q @ c.T
    q_sq = torch.sum(q * q, dim=-1, keepdim=True)
    c_sq = torch.sum(c * c, dim=-1)[None, :]
    sq_dist = torch.clamp_min(q_sq + c_sq - 2.0 * dot, 0.0)
    g_add = sq_dist if metric is Metric.L2 else -dot
    g_error = torch.sqrt(sq_dist)
    return g_add, g_error, sq_dist, dot


def est_1bit(
    f_add: torch.Tensor,
    g_add: torch.Tensor,
    f_rescale: torch.Tensor,
    binary_dot: torch.Tensor,
    k1x_sum_q: torch.Tensor,
) -> torch.Tensor:
    """1-bit distance estimate (``simd.rs:2058``)."""
    return f_add + g_add + f_rescale * (binary_dot + k1x_sum_q)


def lower_bound(est: torch.Tensor, f_error: torch.Tensor, g_error: torch.Tensor) -> torch.Tensor:
    """Pruning lower bound (``simd.rs:2059``)."""
    return est - f_error * g_error


def est_extended(
    f_add_ex: torch.Tensor,
    g_add: torch.Tensor,
    f_rescale_ex: torch.Tensor,
    binary_dot: torch.Tensor,
    ex_dot: torch.Tensor,
    binary_scale: float,
    kbx_sum_q: torch.Tensor,
) -> torch.Tensor:
    """Extended-code refined distance (``ivf.rs:2093-2099``)."""
    total_term = binary_scale * binary_dot + ex_dot + kbx_sum_q
    return f_add_ex + g_add + f_rescale_ex * total_term


def scores_from_distances(dist: torch.Tensor, metric: Metric) -> torch.Tensor:
    """The reference reports the distance for L2 and -distance for inner
    product (``ivf.rs:2106-2109``; results ordered best-first either way)."""
    return dist if metric is Metric.L2 else -dist
