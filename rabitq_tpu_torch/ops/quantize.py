"""RaBitQ residual quantization (port of ``rabitq_tpu/ops/quantize.py``).

Batched tensor ops over ``[N, D]`` residual blocks, same arithmetic and order
as the JAX package (reference ``src/quantizer.rs``). Produced per row:
binary sign bits, ex_bits magnitude codes, delta/vl, the 1-bit factors
(f_add, f_rescale, f_error) and the extended factors (f_add_ex,
f_rescale_ex). The rescale factor ``t`` is a constant (``faster_config``),
a per-row value from the exact host sweep, or a 128-point grid search.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..types import Metric
from ..utils.device import resolve_device

# Constants from quantizer.rs:8-11.
K_TIGHT_START = (0.0, 0.15, 0.20, 0.52, 0.59, 0.71, 0.75, 0.77, 0.81)
K_EPS = 1e-5
K_NENUM = 10.0
K_CONST_EPSILON = 1.9

F32_EPS = float(np.finfo(np.float32).eps)


class QuantizedBatch(NamedTuple):
    binary: torch.Tensor  # [N, D] int8 in {0, 1}
    ex: torch.Tensor  # [N, D] int32 in [0, 2^ex_bits - 1]
    delta: torch.Tensor  # [N] f32
    vl: torch.Tensor
    f_add: torch.Tensor
    f_rescale: torch.Tensor
    f_error: torch.Tensor
    f_add_ex: torch.Tensor
    f_rescale_ex: torch.Tensor
    residual_norm: torch.Tensor


def grid_best_t(o_abs: torch.Tensor, ex_bits: int, grid: int = 128) -> torch.Tensor:
    """Per-row rescale factor by dense grid search over
    ``[t_start, t_end)`` (``quantizer.rs:337-358``). o_abs [N, D] -> [N]."""
    max_val = (1 << ex_bits) - 1
    d = o_abs.shape[-1]
    max_o = torch.amax(o_abs, dim=-1)
    safe_max_o = torch.clamp_min(max_o, F32_EPS)
    t_end = (max_val + K_NENUM) / safe_max_o
    t_start = t_end * K_TIGHT_START[min(ex_bits, len(K_TIGHT_START) - 1)]
    frac = torch.arange(grid, dtype=torch.float32, device=o_abs.device) / grid
    ts = t_start[:, None] + (t_end - t_start)[:, None] * frac[None, :]  # [N, G]
    c = torch.floor(ts[:, :, None] * o_abs[:, None, :] + K_EPS)  # [N, G, D]
    c = torch.clamp(c, 0.0, float(max_val))
    numerator = torch.sum((c + 0.5) * o_abs[:, None, :], dim=-1)
    sqr_denom = 0.25 * d + torch.sum(c * c + c, dim=-1)
    objective = numerator / torch.sqrt(sqr_denom)
    best = torch.gather(ts, 1, torch.argmax(objective, dim=-1)[:, None])[:, 0]
    return torch.where(max_o <= F32_EPS, torch.ones_like(best), best)


def best_rescale_factor_exact(
    o_abs: np.ndarray, ex_bits: int, row_chunk: int = 2048
) -> np.ndarray:
    """Exact per-row rescale factor by the reference's event sweep
    (``best_rescale_factor``, ``quantizer.rs:337-427``), vectorized across
    rows on the host: the events of a row chunk are sorted in the heap's pop
    order and the incremental numerator/denominator become segmented
    cumulative sums. ``o_abs`` [N, D] unit-norm |residual| rows; returns [N]
    float32 t values."""
    o_all = np.ascontiguousarray(o_abs, np.float64)
    nrows, dim = o_all.shape
    max_val = (1 << ex_bits) - 1
    tight = K_TIGHT_START[min(ex_bits, len(K_TIGHT_START) - 1)]
    out = np.ones(nrows, np.float64)
    f64_eps = np.finfo(np.float64).eps

    for s in range(0, nrows, row_chunk):
        o = o_all[s : s + row_chunk]
        m = o.shape[0]
        max_o = o.max(axis=1)
        ok = max_o > f64_eps  # degenerate rows keep t = 1.0
        t_end = np.where(ok, (max_val + K_NENUM) / np.maximum(max_o, f64_eps), 0.0)
        t_start = t_end * tight

        c0 = np.floor(t_start[:, None] * o + K_EPS).astype(np.int64)
        den0 = dim * 0.25 + np.sum(c0 * (c0 + 1), axis=1).astype(np.float64)
        num0 = np.sum((c0 + 0.5) * o, axis=1)

        lo = c0 + 1
        cap = np.maximum(max_val, lo)  # first event may exceed max_val
        lim = np.floor(t_end[:, None] * np.maximum(o, 0.0)).astype(np.int64) + 1
        lens = np.where(
            (o > 0.0) & ok[:, None], np.maximum(np.minimum(cap, lim) - lo + 1, 0), 0
        ).ravel()
        total = int(lens.sum())
        best = t_start.copy()
        if total:
            run_start = np.cumsum(lens) - lens
            flat_pos = np.arange(total, dtype=np.int64)
            coord = np.repeat(np.arange(m * dim, dtype=np.int64), lens)
            row = coord // dim
            idx = coord % dim
            c = np.repeat(lo.ravel(), lens) + (flat_pos - np.repeat(run_start, lens))
            o_ev = o[row, idx]
            t = c / o_ev
            keep = t < t_end[row]
            row, idx, c, o_ev, t = row[keep], idx[keep], c[keep], o_ev[keep], t[keep]
            order = np.lexsort((idx, t, row))  # heap pop order
            row, t, c, o_ev = row[order], t[order], c[order], o_ev[order]
            num_c = np.cumsum(o_ev)
            den_c = np.cumsum(2.0 * c)
            counts = np.bincount(row, minlength=m)
            seg_start = np.cumsum(counts) - counts
            prev_num = np.concatenate(([0.0], num_c))[seg_start]
            prev_den = np.concatenate(([0.0], den_c))[seg_start]
            num = num0[row] + num_c - np.repeat(prev_num, counts)
            den = den0[row] + den_c - np.repeat(prev_den, counts)
            ip = num / np.sqrt(den)
            seg_max = np.full(m, -np.inf)
            has = counts > 0
            if has.any():
                seg_max[has] = np.maximum.reduceat(ip, seg_start[has])
            first = np.full(m, -1, np.int64)
            at_max = np.flatnonzero(ip == seg_max[row])
            first[row[at_max][::-1]] = at_max[::-1]  # reversed: first wins
            hit = (seg_max > 0.0) & (first >= 0)
            best = np.where(hit, t[np.maximum(first, 0)], t_start)
        best = np.where(best <= 0.0, np.maximum(t_start, f64_eps), best)
        out[s : s + row_chunk] = np.where(ok, best, 1.0)
    return out.astype(np.float32)


def compute_const_scaling_factor(
    dim: int, ex_bits: int, seed: int, grid: int = 1024,
    device: torch.device | str | None = None,
) -> float:
    """Average optimal t over 100 random Gaussian directions
    (``quantizer.rs:563-592``) on ``device`` (``None``: the card); the
    directions come from numpy with the JAX package's seed."""
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((100, dim)).astype(np.float32)
    norms = np.linalg.norm(vecs, axis=-1, keepdims=True)
    o_abs = np.abs(vecs / np.maximum(norms, F32_EPS))
    ts = grid_best_t(torch.from_numpy(o_abs).to(resolve_device(device)), ex_bits, grid=grid)
    return float(torch.mean(ts))


def _ex_code_with_inv(residual: torch.Tensor, ex_bits: int, t: torch.Tensor):
    """Magnitude codes + ipnorm_inv (``quantize_ex_with_inv``,
    ``quantizer.rs:429-473``)."""
    max_val = (1 << ex_bits) - 1
    o_abs = torch.abs(residual)
    norm = torch.sqrt(torch.sum(o_abs * o_abs, dim=-1, keepdim=True))
    degenerate = norm[:, 0] <= F32_EPS
    o = o_abs / torch.clamp_min(norm, F32_EPS)
    cur = torch.floor(t[:, None] * o + K_EPS)
    cur = torch.clamp(cur, 0.0, float(max_val))
    ipnorm = torch.sum((cur + 0.5) * o, dim=-1)
    ones = torch.ones_like(ipnorm)
    ipnorm_inv = torch.where(torch.isfinite(ipnorm) & (ipnorm > 0.0), 1.0 / ipnorm, ones)
    code = torch.where(residual < 0.0, max_val - cur, cur)
    code = torch.where(degenerate[:, None], torch.zeros_like(code), code)
    ipnorm_inv = torch.where(degenerate, ones, ipnorm_inv)
    return code.to(torch.int32), ipnorm_inv


def quantize_block(
    rotated_data: torch.Tensor,  # [N, D] rows in rotated space
    centroids: torch.Tensor,  # [N, D] per-row centroid in rotated space
    ex_bits: int,
    metric: Metric,
    t_const: "torch.Tensor | float" = 1.0,
    use_t_const: bool = False,
    grid: int = 128,
) -> QuantizedBatch:
    """Quantize a block of rows against their centroids
    (``quantize_with_centroid``, ``quantizer.rs:140-262``)."""
    data = rotated_data.to(torch.float32)
    cent = centroids.to(torch.float32)
    n, d = data.shape
    dev = data.device
    residual = data - cent
    binary_f = (residual >= 0.0).to(torch.float32)

    if ex_bits > 0:
        if use_t_const:
            t = torch.as_tensor(t_const, dtype=torch.float32, device=dev).expand(n)
        else:
            o_abs = torch.abs(residual)
            rnorm = torch.sqrt(torch.sum(o_abs * o_abs, dim=-1, keepdim=True))
            t = grid_best_t(o_abs / torch.clamp_min(rnorm, F32_EPS), ex_bits, grid=grid)
        ex_code, ipnorm_inv = _ex_code_with_inv(residual, ex_bits, t)
    else:
        ex_code = torch.zeros((n, d), dtype=torch.int32, device=dev)
        ipnorm_inv = torch.ones((n,), dtype=torch.float32, device=dev)

    ex_f = ex_code.to(torch.float32)
    total_code = ex_f + binary_f * float(1 << ex_bits)
    cb = -((1 << ex_bits) - 0.5)
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
    inf = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)

    # delta / vl (quantizer.rs:170-187)
    xu_total = total_code + cb
    norm_quan_sqr = torch.sum(xu_total * xu_total, dim=-1)
    dot_resid_quant = torch.sum(residual * xu_total, dim=-1)
    norm_resid_sqr = torch.sum(residual * residual, dim=-1)
    norm_resid = torch.sqrt(norm_resid_sqr)
    norm_quant = torch.sqrt(norm_quan_sqr)
    denom_dq = torch.clamp_min(norm_resid * norm_quant, F32_EPS)
    cos_sim = torch.clamp(dot_resid_quant / denom_dq, -1.0, 1.0)
    delta = torch.where(
        norm_quant <= F32_EPS,
        zeros,
        (norm_resid / torch.clamp_min(norm_quant, F32_EPS)) * cos_sim,
    )
    vl = delta * cb

    # one-bit factors (quantizer.rs:264-308)
    xu1 = binary_f - 0.5
    xu1_norm_sqr = torch.sum(xu1 * xu1, dim=-1)
    ip_resi_xu1 = torch.sum(residual * xu1, dim=-1)
    ip_cent_xu1 = torch.sum(cent * xu1, dim=-1)
    dot_resid_cent = torch.sum(residual * cent, dim=-1)
    denom1 = torch.where(torch.abs(ip_resi_xu1) <= F32_EPS, inf, ip_resi_xu1)
    tmp_error1 = torch.zeros_like(norm_resid)
    if d > 1:
        ratio1 = (norm_resid_sqr * xu1_norm_sqr) / (denom1 * denom1) - 1.0
        tmp_error1 = torch.where(
            torch.isfinite(ratio1) & (ratio1 > 0.0),
            norm_resid * K_CONST_EPSILON * torch.sqrt(torch.clamp_min(ratio1 / (d - 1), 0.0)),
            zeros,
        )
    if metric is Metric.L2:
        f_add = norm_resid_sqr + 2.0 * norm_resid_sqr * ip_cent_xu1 / denom1
        f_rescale = -2.0 * norm_resid_sqr / denom1
        f_error = 2.0 * tmp_error1
    else:
        f_add = 1.0 - dot_resid_cent + norm_resid_sqr * ip_cent_xu1 / denom1
        f_rescale = -norm_resid_sqr / denom1
        f_error = tmp_error1

    # extended factors (quantizer.rs:475-535)
    if ex_bits > 0:
        ip_cent_xu = torch.sum(cent * xu_total, dim=-1)
        safe_denom = torch.where(torch.abs(dot_resid_quant) <= F32_EPS, inf, dot_resid_quant)
        if metric is Metric.L2:
            f_add_ex = norm_resid_sqr + 2.0 * norm_resid_sqr * ip_cent_xu / safe_denom
            f_rescale_ex = -2.0 * norm_resid * ipnorm_inv
        else:
            f_add_ex = 1.0 - dot_resid_cent + norm_resid_sqr * ip_cent_xu / safe_denom
            f_rescale_ex = -norm_resid * ipnorm_inv
    else:
        f_add_ex = torch.zeros_like(f_add)
        f_rescale_ex = torch.zeros_like(f_rescale)

    return QuantizedBatch(
        binary=binary_f.to(torch.int8),
        ex=ex_code,
        delta=delta,
        vl=vl,
        f_add=f_add,
        f_rescale=f_rescale,
        f_error=f_error,
        f_add_ex=f_add_ex,
        f_rescale_ex=f_rescale_ex,
        residual_norm=norm_resid,
    )


def reconstruct(
    centroid: torch.Tensor, total_code: torch.Tensor, delta: torch.Tensor, vl: torch.Tensor
) -> torch.Tensor:
    """Rows rebuilt in rotated space (``reconstruct_into``,
    ``quantizer.rs:542-548``): centroid + delta * code + vl."""
    return centroid + delta[..., None] * total_code.to(torch.float32) + vl[..., None]
