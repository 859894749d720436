"""Fused bin scan: kernels, plain version and the selection around them.

Counterpart of ``rabitq_tpu/ops/pallas_fused_scan.py``. For every query b
and stored row n the scan forms

    lb[b, n] = fa_eff[n] + fr[n] * (<plane[n], q[b]> + k1x[b]) + g[b, n]

and keeps, per query, the minimum over rows n == l (mod L) in bin l
(L = GROUPS * TN = 8192) with its arg-row; unprobed clusters carry
``g1 = BIG`` and masked rows ``fa_eff = BIG``, so they never enter a bin.
Rows are cluster-sorted in TN-row tiles; each tile's clusters lie in a
W-wide window starting at ``128 * c_blk[t]`` (``tile_cluster_blocks``), and
the g term applies only inside it, as the TPU kernel's one-hot window does.

Two modes, told apart by the shapes as in the reference:

* direct (EXACT): ``plane`` is the dense int8 TOTAL plane, ``q`` f32 of the
  same width, or int8 with a per-query ``q_scale`` (a query that is an
  integer grid: the exact integer dot, rounded to f32 once, times the
  scale), ``g = g1[b, cluster_of[n]]``, and ``lb`` is the final distance;
* packed (stage 1 of the two-stage scan): ``plane`` holds 1-bit planes
  ``[Np, Db]`` uint8, ``q`` is ``8 * Db`` wide in bit-plane order
  (``packed_scan.permute_query``), bf16 or int8 with a per-query
  ``q_scale``, and ``g = g1[b, cl] - bf16(f_error[n]) * g2[b, cl]`` with
  ``g2`` the bf16 g_error: ``lb`` is the 1-bit lower bound.

:func:`fused_bin_scan` is the entry: a CUDA tensor goes to a hand-written
kernel (``csrc/fused_bin_scan.cu`` direct, ``csrc/packed_bin_scan.cu``
packed), a CPU tensor to
:func:`fused_bin_scan_plain`. With ``tiles``/``tcount`` each query block of
``Bp // tiles.shape[0]`` queries walks only its listed tiles (probed-tile
compaction); unlisted tiles hold only BIG rows for that block, so the bins
are unchanged.

Geometry of the port: ``TB`` (queries per compaction list) is 32, not the
TPU's 128 -- on the card the per-block union of probed clusters, not VMEM,
sets the list length, and a 32-query block is also the kernel's block.

The kernels run their dot on the tensor cores (``csrc/mma_tile.cuh``) and
take the query as an image laid out for them: :func:`split_bf16x3` makes an
f32 query three bf16 planes whose products with int8 codes are exact, and
:func:`query_image` writes the planes (or an int8 query's bytes) as the
swizzled tiles the kernels copy straight into shared memory.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _cuda
from .packed_scan import permute_query, unpack_bitplanes
from .select import top_k

TN = 512  # rows per tile (device layouts for this path pad rows to TN)
GROUPS = 16  # bin groups: L = GROUPS * TN bins
TB = 32  # queries per compaction list (and per kernel block)
W = 256  # cluster window width
BIG = 1.0e30  # masked-value sentinel
# Widest plane (columns, 128-aligned) each fused mode serves. They mirror the
# reference's routing, so one configuration takes the same scan in both
# packages; they are not limits of the card.
EXACT_MAX_WIDTH = 2560  # EXACT (direct) mode
TWO_STAGE_MAX_WIDTH = 3072  # packed mode, bf16 query
TWO_STAGE_MAX_WIDTH_INT8 = 7168  # packed mode, int8 query


def n_bins() -> int:
    return GROUPS * TN


def tile_cluster_blocks(cluster_of: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Per-row-tile 128-aligned cluster-window index ``c_blk``: every valid
    row n of tile i has ``0 <= cluster_of[n] - 128 * c_blk[i] < W``. Raises
    ``ValueError`` if a tile spans more than 128 clusters."""
    n_pad = len(cluster_of)
    if n_pad % TN:
        raise ValueError(f"row count {n_pad} is not a multiple of {TN}")
    cl = np.asarray(cluster_of, np.int64).reshape(-1, TN)
    ok = np.asarray(valid, bool).reshape(-1, TN)
    any_valid = ok.any(axis=1)
    lo = np.where(any_valid, np.min(np.where(ok, cl, np.iinfo(np.int64).max), axis=1), 0)
    hi = np.where(any_valid, np.max(np.where(ok, cl, -1), axis=1), 0)
    span = hi - lo
    if span.max(initial=0) > 128:
        raise ValueError(
            f"row tile spans {int(span.max())} clusters (> 128); "
            "fused scan needs cluster-sorted rows with clusters >= "
            f"{TN // 128} rows on average"
        )
    c_pad = _pad_clusters(int(cl.max(initial=0)) + 1)
    c_blk = np.minimum(lo // 128, c_pad // 128 - W // 128)
    return np.maximum(c_blk, 0).astype(np.int32)


def _pad_clusters(c: int) -> int:
    """g-plane cluster padding: at least one full window, 128-aligned."""
    return max(W, ((c + 127) // 128) * 128)


def fused_geometry_ok(cluster_sizes, row_pad: int = TN) -> bool:
    """Whether cluster-sorted rows with these sizes fit the <=128-cluster
    tile windows (:func:`tile_cluster_blocks` would not raise)."""
    sizes = np.asarray(cluster_sizes, np.int64)
    n = int(sizes.sum())
    n_pad = max(row_pad, ((n + row_pad - 1) // row_pad) * row_pad)
    cl = np.zeros(n_pad, np.int32)
    cl[:n] = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    try:
        tile_cluster_blocks(cl, np.arange(n_pad) < n)
        return True
    except ValueError:
        return False


def _cluster_spans(sizes: np.ndarray) -> np.ndarray:
    """Row tiles each cluster's rows touch (0 for empty clusters)."""
    off = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum(sizes, out=off[1:])
    spans = np.zeros(len(sizes), np.int64)
    nonempty = sizes > 0
    spans[nonempty] = (off[1:][nonempty] - 1) // TN - off[:-1][nonempty] // TN + 1
    return spans


def probed_tile_bound(cluster_sizes, nprobe: int, batch_tile: int | None = None) -> int:
    """Safe upper bound on the row tiles one block of ``batch_tile``
    queries can touch: the sum of the largest ``batch_tile * nprobe``
    cluster tile spans, capped at the tile count."""
    if batch_tile is None:
        batch_tile = TB
    sizes = np.asarray(cluster_sizes, np.int64)
    n = int(sizes.sum())
    n_tiles = max(TN, ((n + TN - 1) // TN) * TN) // TN
    spans = np.sort(_cluster_spans(sizes))[::-1]
    u = min(len(sizes), batch_tile * max(int(nprobe), 1))
    return int(min(n_tiles, spans[:u].sum()))


def expected_tile_cost(cluster_sizes, nprobe: int, batch_tile: int | None = None) -> float:
    """Expected per-block probed-tile count, ``u * mean_span``: gates
    compaction (sizing always uses the safe bound)."""
    if batch_tile is None:
        batch_tile = TB
    sizes = np.asarray(cluster_sizes, np.int64)
    n = int(sizes.sum())
    if n == 0 or not len(sizes):
        return 0.0
    n_tiles = max(TN, ((n + TN - 1) // TN) * TN) // TN
    spans = _cluster_spans(sizes)
    u = min(len(sizes), batch_tile * max(int(nprobe), 1))
    return float(min(n_tiles, u * spans[sizes > 0].astype(np.float64).mean()))


def sliced_max_tiles(
    cluster_sizes, nprobe: int, slices, batch_tile: int | None = None
) -> int | None:
    """Compaction budget valid for every TN-aligned row slice
    ``(start, stop)`` in ``slices``: the max over slices of the local safe
    bound, with the expected-cost gate applied per slice; one
    pow2-bucketed budget, or None for the dense walk."""
    if batch_tile is None:
        batch_tile = TB
    sizes = np.asarray(cluster_sizes, np.int64)
    off = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum(sizes, out=off[1:])
    c_nonempty = max(int((sizes > 0).sum()), 1)
    u = min(c_nonempty, batch_tile * max(int(nprobe), 1))
    best = 0
    max_slab_tiles = 0
    for s, e in slices:
        local = np.maximum(np.minimum(off[1:], e) - np.maximum(off[:-1], s), 0)
        nonempty = local > 0
        m = int(nonempty.sum())
        if m == 0:
            continue
        slab_tiles = (int(e) - int(s) + TN - 1) // TN
        max_slab_tiles = max(max_slab_tiles, slab_tiles)
        spans = _cluster_spans(local)
        exp = u * (m / c_nonempty) * float(spans[nonempty].mean())
        if exp >= 0.6 * slab_tiles:
            return None
        top = np.sort(spans[nonempty])[::-1][: min(m, u)]
        best = max(best, int(min(slab_tiles, top.sum())))
    if best <= 0:
        return None
    return int(min(1 << (best - 1).bit_length(), max_slab_tiles))


# ----------------------------------------------------------------------
# the bin scan
# ----------------------------------------------------------------------


def _check_bin_scan_args(
    plane, q, fa_eff, f_rescale, cluster_of, k1x, g1, c_blk, tiles, tcount, f_error, g2, q_scale
) -> bool:
    """Shape checks; returns whether the call is in packed mode."""
    n, d = plane.shape
    bq = q.shape[0]
    packed = q.shape[1] == 8 * d
    if n % TN or (q.shape[1] != d and not packed):
        raise ValueError(f"plane {tuple(plane.shape)} / q {tuple(q.shape)} mismatch")
    if fa_eff.shape != (n,) or f_rescale.shape != (n,) or cluster_of.shape != (n,):
        raise ValueError("per-row vectors must be [Np]")
    if k1x.shape != (bq,) or g1.shape[0] != bq or c_blk.shape != (n // TN,):
        raise ValueError("per-query inputs or c_blk have the wrong shape")
    if g1.shape[1] % 128 or g1.shape[1] < W:
        raise ValueError(f"g1 width {g1.shape[1]} must be a multiple of 128 and >= {W}")
    if (tiles is None) != (tcount is None):
        raise ValueError("tiles and tcount go together")
    if tiles is not None and (bq % tiles.shape[0] or tcount.shape != (tiles.shape[0],)):
        raise ValueError("tiles must hold one list per equal query block")
    if (q.dtype == torch.int8) != (q_scale is not None):
        raise ValueError("q_scale goes with an int8 query, and only with one")
    if q_scale is not None and q_scale.shape != (bq,):
        raise ValueError("q_scale must be [Bp]")
    if packed:
        if d % 128 or f_error is None or g2 is None:
            raise ValueError("packed mode needs Db % 128 == 0, f_error and g2")
        if f_error.shape != (n,) or g2.shape != g1.shape:
            raise ValueError("f_error must be [Np] and g2 shaped as g1")
    elif f_error is not None or g2 is not None:
        raise ValueError("f_error and g2 belong to packed mode")
    return packed


def fused_bin_scan(
    plane: torch.Tensor,  # [Np, D] int8 TOTAL plane, or [Np, Db] uint8 bit planes
    q: torch.Tensor,  # [Bp, D] f32 / int8, or [Bp, 8*Db] bf16 / int8 in bit-plane order
    fa_eff: torch.Tensor,  # [Np] f32 f_add (f_add_ex in direct mode), BIG on masked rows
    f_rescale: torch.Tensor,  # [Np] f32
    cluster_of: torch.Tensor,  # [Np] int32
    k1x: torch.Tensor,  # [Bp] f32
    g1: torch.Tensor,  # [Bp, C_pad] bf16: g_add, BIG where unprobed
    c_blk: torch.Tensor,  # [N_tiles] int32
    tiles: torch.Tensor | None = None,  # [Bp // tb, T] int32 tile lists
    tcount: torch.Tensor | None = None,  # [Bp // tb] int32 valid entries
    *,
    f_error: torch.Tensor | None = None,  # [Np] f32 (packed mode)
    g2: torch.Tensor | None = None,  # [Bp, C_pad] bf16 g_error (packed mode)
    q_scale: torch.Tensor | None = None,  # [Bp] f32 dequant scale (int8 q)
):
    """Returns (bins_val [Bp, L] f32, bins_idx [Bp, L] int32,
    offered [Bp, 128] int32). Packed mode is inferred from the shapes
    (``q`` is 8 x the plane's width). The kernel on the card, the plain
    version on the CPU."""
    packed = _check_bin_scan_args(
        plane, q, fa_eff, f_rescale, cluster_of, k1x, g1, c_blk, tiles, tcount,
        f_error, g2, q_scale,
    )
    args = (plane, q, fa_eff, f_rescale, cluster_of, k1x, g1, c_blk, tiles, tcount)
    if plane.is_cuda:
        if packed:
            return fused_bin_scan_packed_cuda(*args, f_error=f_error, g2=g2, q_scale=q_scale)
        return fused_bin_scan_cuda(*args, q_scale=q_scale)
    if plane.device.type != "cpu":
        raise ValueError(f"no bin scan for device {plane.device}")
    return fused_bin_scan_plain(*args, f_error=f_error, g2=g2, q_scale=q_scale)


def fused_bin_scan_plain(
    plane, q, fa_eff, f_rescale, cluster_of, k1x, g1, c_blk, tiles=None, tcount=None,
    *, f_error=None, g2=None, q_scale=None,
):
    """Plain PyTorch version of the bin scan in both modes, on any device:
    the same walk as the kernels (ascending tiles; list order per query
    block), the same f32 epilogue order, and strict-< updates, so the first
    row wins a tie. In packed mode (``q`` 8 x the plane's width) the bits
    are unpacked in bit-plane order, an int8 dot is exact and scaled by
    ``q_scale``, and ``f_error`` is rounded to bf16 before its product. In
    direct mode an int8 query's dot is the exact integer dot (in float64,
    exact below 2**53: at most 128 * 127 * 2560 here), rounded to f32 and
    times ``q_scale``, as the kernel computes it."""
    n, d = plane.shape
    bq = q.shape[0]
    dev = q.device
    packed = q.shape[1] == 8 * d
    n_tiles = n // TN
    c_pad = g1.shape[1]
    if tiles is None:
        nb = 1
        steps = [
            torch.arange(c0, min(c0 + GROUPS, n_tiles), device=dev)[None, :]
            for c0 in range(0, n_tiles, GROUPS)
        ]
        actives = [torch.ones_like(t, dtype=torch.bool) for t in steps]
    else:
        nb = tiles.shape[0]
        t_all = tiles.to(torch.int64)
        cnt = torch.clamp(tcount.to(torch.int64), max=tiles.shape[1])
        steps = [t_all[:, s : s + 1] for s in range(tiles.shape[1])]
        actives = [
            (s < cnt)[:, None] & (t >= 0) & (t < n_tiles) for s, t in enumerate(steps)
        ]
    tb = bq // nb
    val = torch.full((nb, tb, GROUPS, TN), BIG, dtype=torch.float32, device=dev)
    idx = torch.full((nb, tb, GROUPS, TN), -1, dtype=torch.int32, device=dev)
    offered = torch.zeros((nb, tb, 128), dtype=torch.int32, device=dev)
    int_direct = not packed and q_scale is not None
    dot_dtype = torch.float64 if int_direct else torch.float32
    qv = q.to(dot_dtype).reshape(nb, tb, q.shape[1])
    kx = k1x.reshape(nb, tb, 1, 1)
    g1f = g1.to(torch.float32).reshape(nb, tb, c_pad)
    qs = None if q_scale is None else q_scale.reshape(nb, tb, 1, 1)
    if packed:
        g2f = g2.to(torch.float32).reshape(nb, tb, c_pad)
        neg_fe = (-f_error).to(torch.bfloat16).to(torch.float32)
    lane = torch.arange(TN, device=dev)
    for t, act in zip(steps, actives):
        m = t.shape[1]
        t = torch.clamp(t, 0, n_tiles - 1)
        rows = t[:, :, None] * TN + lane  # [nb, m, TN]
        codes = plane[rows.reshape(-1)]
        if packed:
            codes = unpack_bitplanes(codes)
        codes = codes.reshape(nb, m * TN, -1).to(dot_dtype)
        acc = torch.bmm(qv, codes.transpose(1, 2)).reshape(nb, tb, m, TN)
        if qs is not None:
            # the int8 dot is exact (packed: in f32; direct: in float64, then
            # rounded to f32 once)
            acc = acc.to(torch.float32) * qs
        fa = fa_eff[rows][:, None]  # [nb, 1, m, TN]
        fr = f_rescale[rows][:, None]
        cl = cluster_of[rows].to(torch.int64)
        loc = cl - (c_blk[t].to(torch.int64) * 128)[:, :, None]
        inwin = (loc >= 0) & (loc < W) & (cl < c_pad)
        cl_idx = torch.clamp(cl, 0, c_pad - 1).reshape(nb, 1, m * TN).expand(nb, tb, m * TN)
        g = torch.gather(g1f, 2, cl_idx).reshape(nb, tb, m, TN)
        if packed:
            g = g + neg_fe[rows][:, None] * torch.gather(g2f, 2, cl_idx).reshape(nb, tb, m, TN)
        g = torch.where(inwin[:, None], g, 0.0)
        lb = fa + fr * (acc + kx) + g
        a = act[:, None, :, None]
        offered += ((lb < BIG / 2) & a).to(torch.int32).reshape(nb, tb, m * TN // 128, 128).sum(2, dtype=torch.int32)
        grp = (t % GROUPS)[:, None, :, None].expand(nb, tb, m, TN)
        cur = torch.gather(val, 2, grp)
        cur_i = torch.gather(idx, 2, grp)
        better = (lb < cur) & a
        val.scatter_(2, grp, torch.where(better, lb, cur))
        idx.scatter_(2, grp, torch.where(better, rows[:, None].to(torch.int32), cur_i))
    return val.reshape(bq, n_bins()), idx.reshape(bq, n_bins()), offered.reshape(bq, 128)


_KERNEL_QB = 32  # queries per kernel block (QB in csrc/mma_tile.cuh)


def split_bf16x3(q: torch.Tensor) -> torch.Tensor:
    """``[3, Bp, D]`` bf16 planes ``hi, mid, lo`` of an f32 ``[Bp, D]`` tensor
    with ``hi + mid + lo == q`` exactly in f32: 3 x 8 significant bits hold
    an f32's 24, and bf16 has f32's exponent range. (Exact for zero and for
    magnitudes from 2**-100, below which the lo part may leave the normal
    range, up to the largest bf16, 3.39e38.) Each plane's product with an
    integer code of up to 8 bits is exact in f32, so a tensor-core dot of
    the planes keeps f32 accuracy."""
    q = q.to(torch.float32)
    hi = q.to(torch.bfloat16)
    rest = q - hi  # f32: the bf16 operand is promoted inside the op
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])


# Stage geometry of csrc/mma_tile.cuh by mode: (code bytes of a row per
# stage, B tiles per stage, query planes, bytes per query element). A B tile
# is [32 queries][128 bytes] with the 128-byte swizzle and holds 4 k-steps.
_IMAGE_MODES = {"direct": (64, 3, 3, 2), "bits_bf16": (32, 4, 1, 2), "bits_s8": (32, 2, 1, 1),
                "dense_s8": (128, 1, 1, 1)}


@functools.lru_cache(maxsize=32)
def query_image_index(mode: str, width: int) -> np.ndarray:
    """For one block of 32 queries, the flat source element (in the block's
    ``[planes, 32, K]`` slab, K = ``width`` columns in direct mode, ``8 *
    width`` bit-plane positions in the packed modes) of every element of the
    kernel's query image ``[stages, tiles, 32, 128 // elem_bytes]``.

    Inside a k-step the fragment slots take the code bytes in the order the
    kernel's conversions produce them, and the query follows: slot kap of a
    16-wide bf16 k-step reads byte ``4 * ((kap % 8) // 2) + (kap % 2) + 2 *
    (kap // 8)`` of the step's 16 code bytes in direct mode (a thread's word
    gives slots 2t, 2t+1 from bytes 0, 1 and 2t+8, 2t+9 from bytes 2, 3) and
    byte ``4 * ((kap % 8) // 2) + 2 * (kap % 2) + kap // 8`` in bits_bf16
    (bytes 0, 2 and 1, 3); a 32-wide s8 k-step is bit 2kp of 16 bytes in
    order, then bit 2kp + 1 of the same bytes. In dense_s8 (an int8 query
    against the int8 plane, both operands read by descriptor) the columns
    stay in order: stage c's tile holds columns ``128 * c ..``."""
    code_bytes, tiles, planes, elem = _IMAGE_MODES[mode]
    if width % code_bytes:
        raise ValueError(f"{mode}: width {width} is not a multiple of {code_bytes}")
    stages = width // code_bytes
    per_unit = 16 // elem  # elements in a 16-byte swizzle unit
    step = 32 // elem  # elements in a k-step
    c, tl, n, e = np.indices((stages, tiles, 32, 128 // elem))
    kk = per_unit * ((e // per_unit) ^ (n % 8)) + e % per_unit  # logical position in the row
    s, kap = kk // step, kk % step
    if mode == "direct":
        col = code_bytes * c + 16 * s + 4 * ((kap % 8) // 2) + kap % 2 + 2 * (kap // 8)
        return ((tl * 32 + n) * width + col).reshape(-1)
    if mode == "dense_s8":
        return (n * width + code_bytes * c + kk).reshape(-1)
    i = 4 * tl + s  # k-step of the stage
    if mode == "bits_bf16":
        jg, k = i // 8, i % 8
        byte = 4 * ((kap % 8) // 2) + 2 * (kap % 2) + kap // 8
    else:
        jg, k = i // 4, 2 * (i % 4) + kap // 16
        byte = kap % 16
    pos = k * width + code_bytes * c + 16 * jg + byte
    return (n * 8 * width + pos).reshape(-1)


_image_index_on: dict = {}  # (mode, width, device) -> index tensor


def query_image(q: torch.Tensor, mode: str, width: int) -> torch.Tensor:
    """The kernels' query image of ``q``: ``[Bp // 32, stages * tiles * 4096]``
    bytes' worth of ``q.dtype``. ``q`` is ``[3, Bp, D]`` bf16 planes in
    direct mode, ``[Bp, D]`` int8 in dense_s8, else ``[Bp, 8 * Db]`` bf16 or
    int8 in bit-plane order."""
    planes = _IMAGE_MODES[mode][2]
    k = q.shape[-1]
    q = q.reshape(planes, -1, 32, k)
    key = (mode, width, q.device)
    idx = _image_index_on.get(key)
    if idx is None:
        idx = torch.from_numpy(query_image_index(mode, width)).to(q.device)
        _image_index_on[key] = idx
    slab = q.permute(1, 0, 2, 3).reshape(q.shape[1], planes * 32 * k)
    return torch.index_select(slab, 1, idx)


def _check_cuda_batch(bq: int, tiles) -> int:
    """The kernels' batch rules; returns the queries per tile list. (A walk
    of any length is served: a block flushes its 16-bit offered counters
    before they can overflow.)"""
    if bq % _KERNEL_QB:
        raise ValueError(f"bin scan needs a batch that is a multiple of {_KERNEL_QB}")
    tb = bq // tiles.shape[0] if tiles is not None else bq
    if tb % _KERNEL_QB:
        raise ValueError(f"tile lists need query blocks of a multiple of {_KERNEL_QB}")
    return tb


def fused_bin_scan_cuda(
    plane, q, fa_eff, f_rescale, cluster_of, k1x, g1, c_blk, tiles=None, tcount=None,
    *, q_scale=None,
):
    """The CUDA kernel. An f32 query goes in as three bf16 planes
    (:func:`split_bf16x3`, :func:`query_image` "direct"); an int8 query with
    its ``q_scale`` as its bytes (mode DENSE_S8, image "dense_s8"). Counts its
    launches in ``fused_bin_scan_cuda.launches`` by query and walk:
    ``f32_dense``, ``f32_compact``, ``s8_dense`` and ``s8_compact`` (the
    dense walk without tile lists, the compacted one with them)."""
    n, d = plane.shape
    bq = q.shape[0]
    int8_q = q_scale is not None
    want = (
        (plane, torch.int8), (q, torch.int8 if int8_q else torch.float32),
        (fa_eff, torch.float32), (f_rescale, torch.float32), (cluster_of, torch.int32),
        (k1x, torch.float32), (g1, torch.bfloat16), (c_blk, torch.int32),
    )
    if int8_q:
        want += ((q_scale, torch.float32),)
    if tiles is not None:
        want += ((tiles, torch.int32), (tcount, torch.int32))
    _cuda.check_inputs(want, plane.device, "bin scan")
    if d % (128 if int8_q else 64) or plane.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("bin scan needs D % 64 == 0 (an int8 query: D % 128 == 0) and "
                         "16-byte aligned planes")
    tb = _check_cuda_batch(bq, tiles)
    val = torch.empty((bq, n_bins()), dtype=torch.float32, device=q.device)
    idx = torch.empty((bq, n_bins()), dtype=torch.int32, device=q.device)
    offered = torch.zeros((bq, 128), dtype=torch.int32, device=q.device)
    if int8_q:
        q_img = query_image(q, "dense_s8", d)
    else:
        q_img = query_image(split_bf16x3(q), "direct", d)
    fn = _cuda.entry("fused_bin_scan")
    err = fn(
        plane.data_ptr(), q_img.data_ptr(), q_scale.data_ptr() if int8_q else None,
        fa_eff.data_ptr(), f_rescale.data_ptr(),
        cluster_of.data_ptr(), k1x.data_ptr(), g1.data_ptr(), c_blk.data_ptr(),
        tiles.data_ptr() if tiles is not None else None,
        tcount.data_ptr() if tiles is not None else None,
        val.data_ptr(), idx.data_ptr(), offered.data_ptr(),
        n // TN, d, bq, g1.shape[1],
        tiles.shape[1] if tiles is not None else 0, tb,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _cuda.check_launch(err, "fused_bin_scan")
    key = ("s8" if int8_q else "f32") + ("_dense" if tiles is None else "_compact")
    fused_bin_scan_cuda.launches[key] += 1
    return val, idx, offered


fused_bin_scan_cuda.launches = {"f32_dense": 0, "f32_compact": 0, "s8_dense": 0, "s8_compact": 0}


def fused_bin_scan_packed_cuda(
    plane, q, fa_eff, f_rescale, cluster_of, k1x, g1, c_blk, tiles=None, tcount=None,
    *, f_error, g2, q_scale=None,
):
    """The packed-mode CUDA kernel (bf16 query, or int8 with ``q_scale``).
    Counts its launches in ``fused_bin_scan_packed_cuda.launches`` under
    ``bf16_dense``, ``bf16_compact``, ``int8_dense`` and ``int8_compact``."""
    n, db = plane.shape
    bq = q.shape[0]
    int8_q = q_scale is not None
    want = (
        (plane, torch.uint8), (q, torch.int8 if int8_q else torch.bfloat16),
        (fa_eff, torch.float32), (f_rescale, torch.float32), (f_error, torch.float32),
        (cluster_of, torch.int32), (k1x, torch.float32), (g1, torch.bfloat16),
        (g2, torch.bfloat16), (c_blk, torch.int32),
    )
    if int8_q:
        want += ((q_scale, torch.float32),)
    if tiles is not None:
        want += ((tiles, torch.int32), (tcount, torch.int32))
    _cuda.check_inputs(want, plane.device, "bin scan")
    if db % 128 or q.shape[1] != 8 * db or plane.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("packed bin scan needs Db % 128 == 0, q 8 * Db wide, 16-byte aligned")
    tb = _check_cuda_batch(bq, tiles)
    val = torch.empty((bq, n_bins()), dtype=torch.float32, device=q.device)
    idx = torch.empty((bq, n_bins()), dtype=torch.int32, device=q.device)
    offered = torch.zeros((bq, 128), dtype=torch.int32, device=q.device)
    q_img = query_image(q, "bits_s8" if int8_q else "bits_bf16", db)
    fn = _cuda.entry("packed_bin_scan")
    err = fn(
        plane.data_ptr(), q_img.data_ptr(), q_scale.data_ptr() if int8_q else None,
        fa_eff.data_ptr(), f_rescale.data_ptr(), f_error.data_ptr(),
        cluster_of.data_ptr(), k1x.data_ptr(), g1.data_ptr(), g2.data_ptr(),
        c_blk.data_ptr(),
        tiles.data_ptr() if tiles is not None else None,
        tcount.data_ptr() if tiles is not None else None,
        val.data_ptr(), idx.data_ptr(), offered.data_ptr(),
        n // TN, db, bq, g1.shape[1],
        tiles.shape[1] if tiles is not None else 0, tb, int(int8_q),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _cuda.check_launch(err, "packed_bin_scan")
    key = ("int8" if int8_q else "bf16") + ("_dense" if tiles is None else "_compact")
    fused_bin_scan_packed_cuda.launches[key] += 1
    return val, idx, offered


fused_bin_scan_packed_cuda.launches = {
    "bf16_dense": 0, "bf16_compact": 0, "int8_dense": 0, "int8_compact": 0,
}


# ----------------------------------------------------------------------
# selection around the kernel
# ----------------------------------------------------------------------


def compaction_lists(
    fa_eff: torch.Tensor,
    cluster_of: torch.Tensor,
    probe_mask: torch.Tensor,  # [Bp, C] bool, Bp a multiple of tb
    tb: int,
    max_tiles: int,
):
    """Per query block of ``tb`` queries, the row tiles holding an unmasked
    row of a probed cluster, needed-first in ascending order, padded with
    the last valid tile to ``max_tiles``. Returns (tiles [nb, max_tiles]
    int32, tcount [nb] int32)."""
    n = cluster_of.shape[0]
    n_tiles = n // TN
    bp, c = probe_mask.shape
    dev = cluster_of.device
    masked = fa_eff > BIG / 2
    cl = cluster_of.to(torch.int64)
    lo = torch.where(masked, c, cl).reshape(n_tiles, TN).amin(1)
    hi = torch.where(masked, -1, cl).reshape(n_tiles, TN).amax(1)
    nb = bp // tb
    block_probe = probe_mask.reshape(nb, tb, c).any(dim=1)
    ps = torch.cat(
        [
            torch.zeros((nb, 1), dtype=torch.int64, device=dev),
            torch.cumsum(block_probe.to(torch.int64), dim=1),
        ],
        dim=1,
    )
    needed = (ps[:, torch.clamp(hi + 1, 0, c)] - ps[:, torch.clamp(lo, 0, c)]) > 0
    key = torch.where(needed, 0, n_tiles) + torch.arange(n_tiles, device=dev)[None, :]
    order_t = torch.argsort(key, dim=1)[:, :max_tiles]
    tcount = torch.clamp(needed.sum(dim=1), max=max_tiles)
    slot = torch.minimum(
        torch.arange(max_tiles, device=dev)[None, :],
        torch.clamp_min(tcount, 1)[:, None] - 1,
    )
    tiles = torch.gather(order_t, 1, slot)
    return tiles.to(torch.int32).contiguous(), tcount.to(torch.int32).contiguous()


def fused_select(
    q_rot: torch.Tensor,  # [B, D] f32 rotated queries (direct: zero-padded to the plane width)
    plane: torch.Tensor,  # int8 TOTAL plane (direct) or uint8 bit planes (packed)
    fa_eff: torch.Tensor,
    f_rescale: torch.Tensor,
    cluster_of: torch.Tensor,
    k1x: torch.Tensor,  # [B] f32
    g_add: torch.Tensor,  # [B, C] f32
    probe_mask: torch.Tensor,  # [B, C] bool
    c_blk: torch.Tensor,
    rerank: int,  # bins to extract: top_k in direct mode
    max_tiles: int | None = None,
    *,
    f_error: torch.Tensor | None = None,  # [Np] f32 (packed mode)
    g_err: torch.Tensor | None = None,  # [B, C] f32 g_error (packed mode)
    int8_stage1: bool = False,
    direct_plane: bool = True,
    with_values: bool = True,
    q_int8: tuple[torch.Tensor, torch.Tensor] | None = None,  # (codes [B, D] int8, scale [B])
):
    """Bin scan + selection of the ``rerank`` best bins per query. Returns
    (cand_idx [B, R] int32 rows, cand_ok [B, R] bool, cand_val [B, R] f32
    bin minima best-first, probed [B] int32 offered-row counts); without
    ``with_values`` the values are left out, as in the reference.

    ``direct_plane`` (the port's default) is the EXACT mode; there
    ``q_int8``, where given, is ``q_rot`` as an integer grid (``q_rot ==
    codes * scale[:, None]``, an un-rotated int8 or int4 upload), and the
    bin scan takes it in place of the f32 query (its exact integer dot,
    rounded to f32 once). Otherwise ``plane`` holds packed bit planes, the
    query is permuted to bit-plane order in bf16, and ``int8_stage1``
    quantizes it symmetrically per row for the int8 dot."""
    b = q_rot.shape[0]
    tb = min(TB, ((b + 31) // 32) * 32)
    b_pad = ((b + tb - 1) // tb) * tb
    if b_pad != b:
        q_rot = torch.nn.functional.pad(q_rot, (0, 0, 0, b_pad - b))
        if q_int8 is not None:
            codes, scale = q_int8
            q_int8 = (torch.nn.functional.pad(codes, (0, 0, 0, b_pad - b)),
                      torch.nn.functional.pad(scale, (0, b_pad - b)))
        k1x = torch.nn.functional.pad(k1x, (0, b_pad - b))
        g_add = torch.nn.functional.pad(g_add, (0, 0, 0, b_pad - b))
        probe_mask = torch.nn.functional.pad(probe_mask, (0, 0, 0, b_pad - b))
        if g_err is not None:
            g_err = torch.nn.functional.pad(g_err, (0, 0, 0, b_pad - b))
    c = g_add.shape[1]
    c_pad = _pad_clusters(c)
    g1 = torch.where(probe_mask, g_add, BIG)
    if c_pad != c:
        g1 = torch.nn.functional.pad(g1, (0, c_pad - c), value=BIG)
    extra = {}
    if direct_plane and q_int8 is not None:
        q_in = q_int8[0].contiguous()
        extra["q_scale"] = q_int8[1].to(torch.float32).contiguous()
    elif direct_plane:
        q_in = q_rot.to(torch.float32).contiguous()
    else:
        q_in = permute_query(q_rot, q_rot.shape[1]).contiguous()
        if int8_stage1:
            qf = q_in.to(torch.float32)
            q_scale = torch.clamp_min(qf.abs().amax(dim=1), 1e-30) / 127.0
            q_in = torch.clamp(torch.round(qf / q_scale[:, None]), -127, 127).to(torch.int8)
            extra["q_scale"] = q_scale
        g2 = torch.nn.functional.pad(g_err, (0, c_pad - c)) if c_pad != c else g_err
        extra["f_error"] = f_error
        extra["g2"] = g2.to(torch.bfloat16).contiguous()
    n_tiles = plane.shape[0] // TN
    tiles = tcount = None
    if max_tiles is not None:
        max_tiles = min(max_tiles, n_tiles)
    if max_tiles is not None and max_tiles > 0:
        tiles, tcount = compaction_lists(fa_eff, cluster_of, probe_mask, tb, max_tiles)
    bins_val, bins_idx, offered = fused_bin_scan(
        plane,
        q_in,
        fa_eff,
        f_rescale,
        cluster_of,
        k1x.to(torch.float32).contiguous(),
        g1.to(torch.bfloat16).contiguous(),
        c_blk,
        tiles=tiles,
        tcount=tcount,
        **extra,
    )
    r = min(rerank, n_bins())
    neg, pos = top_k(-bins_val, r, site="bins")  # ties keep the lower bin
    vals = -neg
    cand_idx = torch.gather(bins_idx, 1, pos.to(torch.int64))
    cand_ok = (vals < BIG / 2) & (cand_idx >= 0)
    probed = offered.sum(dim=1, dtype=torch.int32)
    if with_values:
        return cand_idx[:b], cand_ok[:b], vals[:b], probed[:b]
    return cand_idx[:b], cand_ok[:b], probed[:b]
