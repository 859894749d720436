"""Packed bit planes and the packed lower-bound scan (counterpart of
``rabitq_tpu/ops/pallas_scan.py``).

Byte j, bit k (LSB-first) of a packed row holds dimension ``j*8 + k``;
queries for a packed scan are permuted so position ``k*Db + j`` holds that
dimension (``permute_query``).

:func:`packed_lb_scan` computes, for every query b and stored row n,

    lb[b, n] = bf16(f_add[n] + f_rescale[n] * (<bits[n], q[b]> + k1x[b]) + g_comb[b, n])

reading the codes at one bit per dimension (the TPU kernel's contract).
:func:`packed_lb_plane` is stage 1 of the dense "packed" scan as one
function: the same lower bound with ``g_comb`` formed from per-cluster g
terms, masked by the probe mask and the row filter, as the ``-lb`` plane
the survivor selection takes. Both run one hand-written kernel
(``csrc/packed_lb_scan.cu``, two epilogues) for a CUDA tensor, and their
plain versions for a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda

_KERNEL_QB = 32  # queries per kernel block (csrc/mma_tile.cuh QB)
_KERNEL_RU = 128  # rows per kernel tile (RU)


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


def _check_cuda_shapes(packed, q_perm) -> None:
    n, db = packed.shape
    if n % _KERNEL_RU or db % 128 or q_perm.shape[0] % _KERNEL_QB:
        raise ValueError(
            f"packed scan needs rows % {_KERNEL_RU} == 0, Db % 128 == 0 and a "
            f"batch that is a multiple of {_KERNEL_QB}"
        )
    if packed.data_ptr() % 16:
        raise ValueError("packed scan needs a 16-byte aligned plane")


def _query_image(q_perm: torch.Tensor, db: int) -> torch.Tensor:
    from .fused_scan import query_image  # fused_scan imports this module

    return query_image(q_perm, "bits_bf16", db)


def packed_lb_scan_cuda(packed, q_perm, f_add, f_rescale, k1x, g_comb) -> torch.Tensor:
    """The CUDA kernel, TPU contract (epilogue G_PLANE); counts its launches
    in ``packed_lb_scan_cuda.launches``."""
    n, db = packed.shape
    bq = q_perm.shape[0]
    _cuda.check_inputs(
        (
            (packed, torch.uint8), (q_perm, torch.bfloat16), (f_add, torch.float32),
            (f_rescale, torch.float32), (k1x, torch.float32), (g_comb, torch.bfloat16),
        ),
        packed.device, "packed scan",
    )
    _check_cuda_shapes(packed, q_perm)
    out = torch.empty((bq, n), dtype=torch.bfloat16, device=packed.device)
    fn = _cuda.entry("packed_lb_scan")
    err = fn(
        packed.data_ptr(), _query_image(q_perm, db).data_ptr(), f_add.data_ptr(),
        f_rescale.data_ptr(), k1x.data_ptr(), g_comb.data_ptr(), out.data_ptr(), n, db, bq,
        torch.cuda.current_stream(packed.device).cuda_stream,
    )
    _cuda.check_launch(err, "packed_lb_scan")
    packed_lb_scan_cuda.launches += 1
    return out


packed_lb_scan_cuda.launches = 0


# ----------------------------------------------------------------------
# stage 1 of the dense "packed" scan
# ----------------------------------------------------------------------


def packed_lb_plane(
    packed: torch.Tensor,  # [Np, Db] uint8, Np % 128 == 0, Db % 128 == 0
    q_perm: torch.Tensor,  # [Bq, 8*Db] bf16 (permute_query)
    f_add: torch.Tensor,  # [Np] f32
    f_rescale: torch.Tensor,  # [Np] f32
    k1x: torch.Tensor,  # [Bq] f32 (c1 * sum(q))
    g_add: torch.Tensor,  # [Bq, C] g_add (rounded to bf16 here)
    g_error: torch.Tensor,  # [Bq, C] g_error (rounded to bf16 here)
    f_error: torch.Tensor,  # [Np] f32
    cluster_of: torch.Tensor,  # [Np] int32
    probe_mask: torch.Tensor,  # [Bq, C] bool
    row_allowed: torch.Tensor,  # [Np] bool
) -> torch.Tensor:
    """``[Bq, Np]`` bf16 plane the dense survivor selection takes: with
    ``cl = cluster_of[n]``, ``g_comb = bf16(bf16(g_add)[b, cl] - f_error[n] *
    bf16(g_error)[b, cl])`` and ``lb`` as :func:`packed_lb_scan` gives it,
    ``-lb`` where row n is allowed for query b (``probe_mask[b, cl] &
    row_allowed[n]``) and ``lb`` is finite, ``+inf`` where it is allowed and
    ``lb`` is not finite (never pruned, ``ivf.rs:2031-2042``), ``-inf`` where it
    is not allowed. The batch is padded to whole kernel blocks and trimmed.
    The kernel on the card, the plain version on the CPU."""
    n, db = packed.shape
    bq, d8 = q_perm.shape
    c = g_add.shape[1]
    if n % _KERNEL_RU or db % 128 or d8 != 8 * db:
        raise ValueError(f"packed {tuple(packed.shape)} / q_perm {tuple(q_perm.shape)} mismatch")
    if f_add.shape != (n,) or f_rescale.shape != (n,) or f_error.shape != (n,):
        raise ValueError("per-row vectors must be [Np]")
    if cluster_of.shape != (n,) or row_allowed.shape != (n,):
        raise ValueError("cluster_of and row_allowed must be [Np]")
    if k1x.shape != (bq,) or g_error.shape != (bq, c) or probe_mask.shape != (bq, c):
        raise ValueError("k1x must be [Bq], g_add, g_error and probe_mask [Bq, C]")
    b_pad = -(-bq // _KERNEL_QB) * _KERNEL_QB
    if b_pad != bq:
        pad = (0, 0, 0, b_pad - bq)
        q_perm = torch.nn.functional.pad(q_perm, pad)
        k1x = torch.nn.functional.pad(k1x, (0, b_pad - bq))
        g_add = torch.nn.functional.pad(g_add, pad)
        g_error = torch.nn.functional.pad(g_error, pad)
        probe_mask = torch.nn.functional.pad(probe_mask, pad)
    args = (packed, q_perm, f_add, f_rescale, k1x, g_add, g_error, f_error, cluster_of,
            probe_mask, row_allowed)
    if packed.is_cuda:
        out = packed_lb_plane_cuda(*args)
    elif packed.device.type == "cpu":
        out = packed_lb_plane_plain(*args)
    else:
        raise ValueError(f"no packed scan for device {packed.device}")
    return out[:bq]


def packed_lb_plane_plain(
    packed, q_perm, f_add, f_rescale, k1x, g_add, g_error, f_error, cluster_of, probe_mask,
    row_allowed, row_chunk: int = 1 << 16,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`packed_lb_plane`, on any device: the
    g terms gathered per row as bf16 planes, ``g_comb`` in f32 rounded to
    bf16, :func:`packed_lb_scan_plain`, then the finite test and the mask,
    op by op as the JAX caller (``rabitq_tpu/index/scan.py``) runs them, in
    chunks of ``row_chunk`` rows."""
    n = packed.shape[0]
    ga, ge = g_add.to(torch.bfloat16), g_error.to(torch.bfloat16)
    out = torch.empty((q_perm.shape[0], n), dtype=torch.bfloat16, device=packed.device)
    for s in range(0, n, row_chunk):
        e = min(s + row_chunk, n)
        cl = cluster_of[s:e]
        g_comb = (ga.index_select(1, cl) - f_error[None, s:e] * ge.index_select(1, cl)).to(
            torch.bfloat16
        )
        lb = packed_lb_scan_plain(
            packed[s:e], q_perm, f_add[s:e], f_rescale[s:e], k1x, g_comb, row_chunk
        ).to(torch.float32)
        lb = torch.where(torch.isfinite(lb), lb, -float("inf"))
        allowed = probe_mask.index_select(1, cl) & row_allowed[None, s:e]
        out[:, s:e] = torch.where(allowed, -lb, -float("inf")).to(torch.bfloat16)
    return out


def g_table(g_add: torch.Tensor, g_error: torch.Tensor) -> torch.Tensor:
    """``[B, C]`` int32 words of the kernel's g table: bf16 ``g_add`` in the
    low half, bf16 ``g_error`` in the high half."""
    pair = torch.stack([g_add.to(torch.bfloat16), g_error.to(torch.bfloat16)], dim=-1)
    return pair.view(torch.int32)[..., 0]


def probe_words(probe_mask: torch.Tensor) -> torch.Tensor:
    """``[B // 32, C]`` int32 words of the kernel's probe mask: bit i of word
    ``[k, c]`` is ``probe_mask[32 * k + i, c]``."""
    b, c = probe_mask.shape
    shifts = torch.arange(8, dtype=torch.int32, device=probe_mask.device)[:, None]
    bits = probe_mask.reshape(b // 32, 4, 8, c).to(torch.int32) << shifts
    octets = bits.sum(dim=2).to(torch.uint8)  # [B // 32, 4, C]: byte k of each word
    # a fresh tensor has the canonical strides the int32 view needs, also
    # where a dimension is 1 (one block of 32 queries, or one cluster)
    words = torch.empty((b // 32, c, 4), dtype=torch.uint8, device=probe_mask.device)
    words.copy_(octets.permute(0, 2, 1))
    return words.view(torch.int32)[..., 0]


def packed_lb_plane_cuda(
    packed, q_perm, f_add, f_rescale, k1x, g_add, g_error, f_error, cluster_of, probe_mask,
    row_allowed,
) -> torch.Tensor:
    """The CUDA kernel, epilogue G_TABLE; counts its launches in
    ``packed_lb_plane_cuda.launches``."""
    n, db = packed.shape
    bq = q_perm.shape[0]
    c = g_add.shape[1]
    _cuda.check_inputs(
        (
            (packed, torch.uint8), (q_perm, torch.bfloat16), (f_add, torch.float32),
            (f_rescale, torch.float32), (k1x, torch.float32), (f_error, torch.float32),
            (cluster_of, torch.int32), (row_allowed, torch.bool), (probe_mask, torch.bool),
        ),
        packed.device, "packed scan",
    )
    if g_add.device != packed.device or g_error.device != packed.device:
        raise ValueError("packed scan inputs must all lie on one CUDA device")
    _check_cuda_shapes(packed, q_perm)
    table = g_table(g_add, g_error)
    words = probe_words(probe_mask)
    out = torch.empty((bq, n), dtype=torch.bfloat16, device=packed.device)
    fn = _cuda.entry("packed_lb_plane")
    err = fn(
        packed.data_ptr(), _query_image(q_perm, db).data_ptr(), f_add.data_ptr(),
        f_rescale.data_ptr(), k1x.data_ptr(), f_error.data_ptr(), cluster_of.data_ptr(),
        row_allowed.data_ptr(), table.data_ptr(), words.data_ptr(), out.data_ptr(), n, db, bq,
        c, torch.cuda.current_stream(packed.device).cuda_stream,
    )
    _cuda.check_launch(err, "packed_lb_plane")
    packed_lb_plane_cuda.launches += 1
    return out


packed_lb_plane_cuda.launches = 0
