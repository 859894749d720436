"""Packed bit planes and the packed lower-bound scan (counterpart of
``rabitq_tpu/ops/pallas_scan.py``).

Byte j, bit k (LSB-first) of a packed row holds dimension ``j*8 + k``;
queries for a packed scan are permuted so position ``k*Db + j`` holds that
dimension (``permute_query``).

:func:`packed_lb_scan` computes, for every query b and stored row n,

    lb[b, n] = bf16(f_add[n] + f_rescale[n] * (<bits[n], q[b]> + k1x[b]) + g_comb[b, n])

reading the codes at one bit per dimension. A CUDA tensor goes to the
hand-written kernel (``csrc/packed_lb_scan.cu``), a CPU tensor to
:func:`packed_lb_scan_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda

_KERNEL_QB = 32  # queries per kernel block (csrc/bitplane_dot.cuh QB)
_KERNEL_RU = 128  # rows per kernel block (RU)


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


def unpack_bitplanes(packed: torch.Tensor) -> torch.Tensor:
    """[N, Db] uint8 -> [N, 8*Db] uint8 {0,1} in bit-plane order (position
    ``k*Db + j`` is bit k of byte j), the order of :func:`permute_query`."""
    return torch.cat([(packed >> k) & 1 for k in range(8)], dim=-1)


def packed_lb_scan(
    packed: torch.Tensor,  # [Np, Db] uint8, Np % 128 == 0, Db % 128 == 0
    q_perm: torch.Tensor,  # [Bq, 8*Db] bf16 (permute_query)
    f_add: torch.Tensor,  # [Np] f32
    f_rescale: torch.Tensor,  # [Np] f32
    k1x: torch.Tensor,  # [Bq] f32 (c1 * sum(q))
    g_comb: torch.Tensor,  # [Bq, Np] bf16: g_add - f_error * g_error, UNMASKED
) -> torch.Tensor:
    """Stage-1 lower bounds ``[Bq, Np]`` bf16. Callers mask the returned
    plane (probe and filter). The batch is padded to whole kernel blocks and
    trimmed. The kernel on the card, the plain version on the CPU."""
    n, db = packed.shape
    bq, d8 = q_perm.shape
    if n % _KERNEL_RU or db % 128 or d8 != 8 * db:
        raise ValueError(f"packed {tuple(packed.shape)} / q_perm {tuple(q_perm.shape)} mismatch")
    if f_add.shape != (n,) or f_rescale.shape != (n,):
        raise ValueError("per-row vectors must be [Np]")
    if k1x.shape != (bq,) or g_comb.shape != (bq, n):
        raise ValueError("k1x must be [Bq] and g_comb [Bq, Np]")
    b_pad = -(-bq // _KERNEL_QB) * _KERNEL_QB
    if b_pad != bq:
        q_perm = torch.nn.functional.pad(q_perm, (0, 0, 0, b_pad - bq))
        k1x = torch.nn.functional.pad(k1x, (0, b_pad - bq))
        g_comb = torch.nn.functional.pad(g_comb, (0, 0, 0, b_pad - bq))
    if packed.is_cuda:
        out = packed_lb_scan_cuda(packed, q_perm, f_add, f_rescale, k1x, g_comb)
    elif packed.device.type == "cpu":
        out = packed_lb_scan_plain(packed, q_perm, f_add, f_rescale, k1x, g_comb)
    else:
        raise ValueError(f"no packed scan for device {packed.device}")
    return out[:bq]


def packed_lb_scan_plain(
    packed, q_perm, f_add, f_rescale, k1x, g_comb, row_chunk: int = 1 << 16
) -> torch.Tensor:
    """Plain PyTorch version of the packed scan, on any device: bits
    unpacked in bit-plane order, an f32 dot of exact products, the kernel's
    f32 epilogue order and one rounding to bf16. Rows go in chunks of
    ``row_chunk`` so the unpacked plane stays small."""
    n = packed.shape[0]
    qf = q_perm.to(torch.float32)
    out = torch.empty(g_comb.shape, dtype=torch.bfloat16, device=packed.device)
    for s in range(0, n, row_chunk):
        e = min(s + row_chunk, n)
        bits = unpack_bitplanes(packed[s:e]).to(torch.float32)
        acc = qf @ bits.T
        lb = f_add[None, s:e] + f_rescale[None, s:e] * (acc + k1x[:, None])
        out[:, s:e] = (lb + g_comb[:, s:e].to(torch.float32)).to(torch.bfloat16)
    return out


def packed_lb_scan_cuda(packed, q_perm, f_add, f_rescale, k1x, g_comb) -> torch.Tensor:
    """The CUDA kernel; counts its launches in
    ``packed_lb_scan_cuda.launches``."""
    n, db = packed.shape
    bq = q_perm.shape[0]
    want = (
        (packed, torch.uint8), (q_perm, torch.bfloat16), (f_add, torch.float32),
        (f_rescale, torch.float32), (k1x, torch.float32), (g_comb, torch.bfloat16),
    )
    for t, dtype in want:
        if not t.is_cuda or t.device != packed.device:
            raise ValueError("packed scan inputs must all lie on one CUDA device")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"packed scan needs contiguous {dtype}, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError("packed scan needs 16-byte aligned inputs")
    if n % _KERNEL_RU or db % 128 or bq % _KERNEL_QB or n >= 1 << 31:
        raise ValueError(
            f"packed scan needs rows % {_KERNEL_RU} == 0, Db % 128 == 0 and a "
            f"batch that is a multiple of {_KERNEL_QB}"
        )
    out = torch.empty((bq, n), dtype=torch.bfloat16, device=packed.device)
    fn = _cuda.entry("packed_lb_scan")
    err = fn(
        packed.data_ptr(), q_perm.data_ptr(), f_add.data_ptr(), f_rescale.data_ptr(),
        k1x.data_ptr(), g_comb.data_ptr(), out.data_ptr(), n, db, bq,
        torch.cuda.current_stream(packed.device).cuda_stream,
    )
    _cuda.check_launch(err, "packed_lb_scan")
    packed_lb_scan_cuda.launches += 1
    return out


packed_lb_scan_cuda.launches = 0
