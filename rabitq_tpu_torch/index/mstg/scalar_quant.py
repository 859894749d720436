"""Scalar quantization of MSTG centroids (``mstg/scalar_quant.rs``); a copy of
``rabitq_tpu/index/mstg/scalar_quant.py``, byte for byte the same encodings.

The reference materializes BF16 copies of the centroids with
round-to-nearest-even fp32->bf16 bit twiddling (``scalar_quant.rs:69-86``)
and tests <1% conversion error (``scalar_quant.rs:88-140``); FP16/INT8 are
declared in the config enum but panic (``mstg/hnsw.rs:40-52``). Here all
four precisions are real:

* centroids are quantized ONCE at build time and the de-quantized values
  are used everywhere downstream — as the residual base for posting-list
  RaBitQ quantization, as the centroid-scoring operands, and as the
  persisted bytes — so the estimator stays self-consistent (the residual
  anchor and the g-terms reference the same point);
* persistence stores the native encoding (u16 bf16 bits, fp16 halves,
  int8 + per-row scale), halving/quartering the centroid block.

Vectorized numpy, not a translation of the per-element trait objects.
"""

from __future__ import annotations

import numpy as np

from .config import ScalarPrecision


def fp32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even fp32 -> bf16 bit pattern (u16), mirroring
    ``scalar_quant.rs:69-79``."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bias = np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))
    return ((bits + bias) >> np.uint32(16)).astype(np.uint16)


def bf16_bits_to_fp32(u: np.ndarray) -> np.ndarray:
    """Inverse expansion (``scalar_quant.rs:82-86``)."""
    return (np.ascontiguousarray(u, np.uint16).astype(np.uint32) << np.uint32(16)).view(
        np.float32
    )


def quantize_centroids(
    cents: np.ndarray, precision: ScalarPrecision
) -> tuple[dict, np.ndarray]:
    """Quantize [C, D] f32 centroids to ``precision``.

    Returns ``(stored, dequantized)``: ``stored`` holds the persistable
    encoding (``data`` plus ``scale`` for INT8), ``dequantized`` the f32
    values every downstream consumer uses. De-quantized values are exactly
    representable in the target precision, so quantize(dequantize(x)) is
    idempotent (save/load round-trips byte-exactly).
    """
    cents = np.ascontiguousarray(cents, np.float32)
    if precision is ScalarPrecision.FP32:
        return {"data": cents}, cents
    if precision is ScalarPrecision.BF16:
        bits = fp32_to_bf16_bits(cents)
        return {"data": bits}, bf16_bits_to_fp32(bits)
    if precision is ScalarPrecision.FP16:
        halves = cents.astype(np.float16)  # IEEE RNE
        return {"data": halves}, halves.astype(np.float32)
    if precision is ScalarPrecision.INT8:
        # symmetric per-centroid scale (one f32 per row)
        scale = np.maximum(np.abs(cents).max(axis=1), 1e-30) / 127.0
        q = np.clip(np.rint(cents / scale[:, None]), -127, 127).astype(np.int8)
        return {"data": q, "scale": scale.astype(np.float32)}, (
            q.astype(np.float32) * scale[:, None].astype(np.float32)
        )
    raise ValueError(f"unknown precision {precision}")


def dequantize_centroids(stored: dict, precision: ScalarPrecision) -> np.ndarray:
    data = stored["data"]
    if precision is ScalarPrecision.FP32:
        return np.ascontiguousarray(data, np.float32)
    if precision is ScalarPrecision.BF16:
        return bf16_bits_to_fp32(data)
    if precision is ScalarPrecision.FP16:
        return np.ascontiguousarray(data, np.float16).astype(np.float32)
    if precision is ScalarPrecision.INT8:
        scale = np.ascontiguousarray(stored["scale"], np.float32)
        return data.astype(np.float32) * scale[:, None]
    raise ValueError(f"unknown precision {precision}")


def apply_centroid_precision(
    cents: np.ndarray, precision: ScalarPrecision
) -> np.ndarray:
    """Round centroids through ``precision`` (build-time entry point)."""
    return quantize_centroids(cents, precision)[1]
