"""Code-building pipeline (port of ``rabitq_tpu/index/build.py``).

Rows stream through the device in fixed-size chunks: gather the chunk's
source rows (storage order), rotate them (the FHT kernel on the card),
gather each row's centroid, quantize. Outputs stay on the device
(:func:`build_codes_device`); :func:`build_codes` returns host arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.quantize import best_rescale_factor_exact, quantize_block
from ..ops.rotation import Rotator
from ..types import Metric
from ..utils.device import resolve_device

_FIELDS = (
    "binary",
    "ex",
    "delta",
    "vl",
    "f_add",
    "f_rescale",
    "f_error",
    "f_add_ex",
    "f_rescale_ex",
    "residual_norm",
)


def exact_t_rows(
    data: np.ndarray,  # [N, dim] raw host rows
    centroids: np.ndarray | None,  # [C, dim] RAW (unrotated) centroids; None = zero
    assign: np.ndarray,  # [M] cluster of each output row
    order: np.ndarray | None,  # [M] source row per output row (None = identity)
    rotator: Rotator | None,
    ex_bits: int,
    chunk: int = 32768,
    centroids_rotated: np.ndarray | None = None,  # [C, Dq] ROTATED-space base
) -> np.ndarray:
    """Per-output-row exact rescale t on the host: rotation is linear, so the
    rotated residual is ``rotate_np(row - raw_centroid)``, swept by
    :func:`best_rescale_factor_exact` (the reference's default,
    ``quantizer.rs:332``). ``centroids_rotated`` subtracts the base after the
    rotation instead, for centroids rounded in rotated space (MSTG's
    ``centroid_precision`` with ``use_rotator``): rounding does not commute
    with rotation."""
    if centroids is not None and centroids_rotated is not None:
        raise ValueError("pass centroids or centroids_rotated, not both")
    m = assign.shape[0]
    out = np.empty(m, np.float32)
    for s in range(0, m, chunk):
        e = min(s + chunk, m)
        rows = order[s:e] if order is not None else np.arange(s, e)
        resid = np.ascontiguousarray(data[rows], np.float32)
        if centroids is not None:
            resid = resid - centroids[assign[s:e]]
        if rotator is not None:
            resid = rotator.rotate_np(resid)
        if centroids_rotated is not None:
            resid = resid - centroids_rotated[assign[s:e]]
        o = np.abs(resid)
        norm = np.linalg.norm(o, axis=-1, keepdims=True)
        o = o / np.maximum(norm, np.finfo(np.float32).eps)
        out[s:e] = best_rescale_factor_exact(o, ex_bits)
    return out


def build_codes_device(
    data: torch.Tensor,  # [N, dim] rows on the build device
    centroids: torch.Tensor,  # [C, Dq] in quantization space, same device
    assign: np.ndarray,  # [M] cluster of each output row
    *,
    rotator: Rotator | None,
    ex_bits: int,
    metric: Metric,
    use_t_const: bool,
    t_const: float = 0.0,
    t_rows: np.ndarray | None = None,  # [M] per-row exact t (overrides t_const)
    order: np.ndarray | None = None,  # [M] source row per output row
    chunk: int | None = None,
) -> dict[str, torch.Tensor]:
    """Quantize rows on ``data``'s device; returns {field: tensor [M, ...]}
    with ``binary`` and ``ex`` as uint8 planes and f32 vectors otherwise.

    ``order`` selects and re-orders source rows (cluster-sorted storage
    order); ``t_rows`` supplies exact per-row rescale factors; without it
    ``use_t_const`` picks the constant-t mode, else the grid search runs.
    """
    dev = data.device
    m = assign.shape[0]
    use_t = bool((use_t_const or t_rows is not None) and ex_bits > 0)
    if chunk is None:
        chunk = 8192 if (use_t or ex_bits == 0) else 256
    dq = centroids.shape[1]
    assign_t = torch.from_numpy(np.asarray(assign, np.int64)).to(dev)
    order_t = None if order is None else torch.from_numpy(np.asarray(order, np.int64)).to(dev)
    t_all = None
    if t_rows is not None:
        t_all = torch.from_numpy(np.asarray(t_rows, np.float32)).to(dev)
    out = {
        "binary": torch.empty((m, dq), dtype=torch.uint8, device=dev),
        "ex": torch.empty((m, dq), dtype=torch.uint8 if ex_bits <= 8 else torch.int32, device=dev),
    }
    for name in _FIELDS[2:]:
        out[name] = torch.empty((m,), dtype=torch.float32, device=dev)
    for s in range(0, m, chunk):
        e = min(s + chunk, m)
        blk = data[s:e] if order_t is None else data.index_select(0, order_t[s:e])
        if rotator is not None:
            blk = rotator.rotate(blk)
        cents = centroids.index_select(0, assign_t[s:e])
        t_c = t_all[s:e] if t_all is not None else t_const
        qb = quantize_block(
            blk, cents, ex_bits=ex_bits, metric=metric, t_const=t_c, use_t_const=use_t
        )
        out["binary"][s:e] = qb.binary.to(torch.uint8)
        out["ex"][s:e] = qb.ex.to(out["ex"].dtype)
        for name in _FIELDS[2:]:
            out[name][s:e] = getattr(qb, name)
    return out


def build_codes(
    data,  # [N, dim] host rows or a tensor
    centroids,  # [C, Dq] in quantization space, host array or tensor
    assign: np.ndarray,  # [M] cluster of each output row
    *,
    rotator: Rotator | None,
    ex_bits: int,
    metric: Metric,
    use_t_const: bool,
    t_const: float = 0.0,
    t_rows: np.ndarray | None = None,
    order: np.ndarray | None = None,
    chunk: int | None = None,
    device: "str | torch.device | None" = None,
) -> dict[str, np.ndarray]:
    """Host-output wrapper over :func:`build_codes_device`: the rows and
    centroids go to ``device`` (None: the card), the codes come back as host
    arrays with the JAX package's types (``ex`` uint16, ``binary`` uint8,
    f32 factors)."""
    dev = resolve_device(device)

    def on_device(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev, torch.float32)
        return torch.tensor(np.asarray(x, np.float32), device=dev)  # a copy: x may be read-only

    codes = build_codes_device(
        on_device(data), on_device(centroids), assign, rotator=rotator, ex_bits=ex_bits,
        metric=metric, use_t_const=use_t_const, t_const=t_const, t_rows=t_rows, order=order,
        chunk=chunk,
    )
    out = {name: x.cpu().numpy() for name, x in codes.items()}
    out["ex"] = out["ex"].astype(np.uint16)
    return out
