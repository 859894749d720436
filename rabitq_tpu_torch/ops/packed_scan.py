"""Packed bit-plane helpers (counterpart of ``rabitq_tpu/ops/pallas_scan.py``).

Byte j, bit k (LSB-first) of a packed row holds dimension ``j*8 + k``;
queries for a packed scan are permuted so position ``k*Db + j`` holds that
dimension (``permute_query``). The fused layout builds the packed plane.
The packed lower-bound kernel itself (``packed_lb_scan``) is not ported yet
(``ROADMAP.md`` queue B).
"""

from __future__ import annotations

import numpy as np
import torch


def packed_bytes(padded_dim: int) -> int:
    """Packed bytes per row, padded to a multiple of 128."""
    db = (padded_dim + 7) // 8
    return ((db + 127) // 128) * 128


def pack_bitplanes(binary: torch.Tensor, padded_dim: int) -> torch.Tensor:
    """[N, Dpad] {0,1} -> [N, Db] uint8 with byte j bit k = dim j*8+k."""
    n = binary.shape[0]
    db = packed_bytes(padded_dim)
    b = binary.to(torch.int32)
    pad = db * 8 - b.shape[1]
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    weights = (1 << torch.arange(8, dtype=torch.int32, device=b.device))[None, None, :]
    return torch.sum(b.reshape(n, db, 8) * weights, dim=-1).to(torch.uint8)


def pack_bitplanes_np(binary: np.ndarray, padded_dim: int) -> np.ndarray:
    """Host-side :func:`pack_bitplanes` (same layout)."""
    n = binary.shape[0]
    db = packed_bytes(padded_dim)
    pad = db * 8 - padded_dim
    b = np.asarray(binary, np.uint16)
    if pad:
        b = np.pad(b, ((0, 0), (0, pad)))
    weights = (1 << np.arange(8, dtype=np.uint16))[None, None, :]
    return (b.reshape(n, db, 8) * weights).sum(axis=-1).astype(np.uint8)


def permute_query(q_rot: torch.Tensor, padded_dim: int) -> torch.Tensor:
    """[B, Dpad] -> [B, 8*Db] bf16 in bit-plane order (p = k*Db + j)."""
    b = q_rot.shape[0]
    db = packed_bytes(padded_dim)
    pad = db * 8 - q_rot.shape[1]
    q = torch.nn.functional.pad(q_rot, (0, pad)) if pad else q_rot
    q = q.reshape(b, db, 8).transpose(1, 2).reshape(b, 8 * db)
    return q.to(torch.bfloat16)
