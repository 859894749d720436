"""The survivors' gather-dot: plain version and CUDA kernel.

For ``rows`` [B, R] int64 (row indices, >= 0) and each pair of ``plane``
[Np, Dp] (int8 or int32 codes) and ``q`` [B, D] f32 (``D <= Dp``;
the plane's columns past ``D`` count as zero)::

    dots[b, r] = sum_d f32(plane[rows[b, r], d]) * q[b, d]

in f32, one [B, R] f32 result a pair. Stage 2's re-rank
(``index/scan._stage2_rerank``: the TOTAL plane, the binary and raw ex
planes of the 8-bit branch together, the 1-bit re-score) and the gather scan
(``index/scan._gather_scan``) call :func:`gather_dot`. A CPU tensor runs
:func:`gather_dot_plain`: the code rows gathered, copied to f32 and dotted by
a batched GEMV, where ``max_bytes`` is given a sub-block of queries at a time
so that the f32 copy stays within it (the gather scan's large blocks). A
CUDA tensor runs :func:`gather_dot_kernel`
(``csrc/gather_dot.cu``), one launch for one or two pairs, which reads each
gathered row once and keeps nothing [B, R, D] in device memory. The codes
are exact in f32 and both multiply and add in f32; only the order of the
additions inside one dot differs, so the two agree to within
``2 * D * 2**-24 * sum_d |code_d * q_d|`` (:func:`sum_tolerance`: the
rounding bound of two summation orders).
"""

from __future__ import annotations

import torch

from . import _cuda

_ESIZE = {torch.int8: 1, torch.int32: 4}  # element bytes of the planes the kernel takes


def _check(rows: torch.Tensor, pairs) -> None:
    if not 1 <= len(pairs) <= 2:
        raise ValueError(f"gather_dot takes one or two (plane, q) pairs, got {len(pairs)}")
    if rows.dim() != 2 or rows.dtype != torch.int64:
        raise ValueError(f"gather_dot needs [B, R] int64 rows, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    for plane, q in pairs:
        if plane.dim() != 2 or plane.dtype not in _ESIZE:
            raise ValueError(f"gather_dot needs an [Np, Dp] int8 or int32 plane, got "
                             f"{plane.dtype} {tuple(plane.shape)}")
        if q.dim() != 2 or q.dtype != torch.float32:
            raise ValueError(f"gather_dot needs a [B, D] f32 query, got {q.dtype} "
                             f"{tuple(q.shape)}")
        if q.shape[0] != rows.shape[0]:
            raise ValueError(f"gather_dot: {q.shape[0]} queries for {rows.shape[0]} rows of "
                             "row indices")
        if q.shape[1] > plane.shape[1]:
            raise ValueError(f"gather_dot: a query {q.shape[1]} wide for a plane "
                             f"{plane.shape[1]} wide")


def gather_dot(rows: torch.Tensor, *pairs, max_bytes: int | None = None):
    """One [B, R] f32 dot a ``(plane, q)`` pair (one or two pairs) over the
    rows ``rows`` [B, R] int64 (module docstring): the plain version for a
    CPU tensor (``max_bytes``: its budget of f32 codes a sub-block of
    queries), the kernel for a CUDA one, which holds no codes."""
    if rows.is_cuda:
        return gather_dot_kernel(rows, *pairs)
    _check(rows, pairs)
    return gather_dot_plain(rows, *pairs, max_bytes=max_bytes)


def gather_dot_plain(rows: torch.Tensor, *pairs, max_bytes: int | None = None):
    """The plain version of :func:`gather_dot_kernel`, torch ops on the
    tensors' device: a gather, an f32 copy and a batched GEMV, over the
    whole block, or over sub-blocks of queries whose f32 codes stay within
    ``max_bytes`` (one query at least)."""
    b, r = rows.shape
    out = []
    for plane, q in pairs:
        width = plane.shape[1]
        if q.shape[1] != width:  # width-padded refine plane
            q = torch.nn.functional.pad(q, (0, width - q.shape[1]))
        dots = torch.empty((b, r), dtype=torch.float32, device=rows.device)
        step = b if max_bytes is None else max(1, max_bytes // max(1, r * width * 4))
        for s in range(0, b, step):
            codes = plane[rows[s : s + step]].to(torch.float32)  # [b_s, R, Dp]
            dots[s : s + step] = torch.bmm(codes, q[s : s + step, :, None])[:, :, 0]
        out.append(dots)
    return tuple(out)


def gather_dot_kernel(rows: torch.Tensor, *pairs):
    """The CUDA kernel: every pair in one launch on the current stream, no
    host sync; [B, R] f32 results (a NaN for a row index past the plane).
    ``gather_dot_kernel.launches`` counts its launches by ``one_plane`` and
    ``two_planes``."""
    _check(rows, pairs)
    dev = rows.device
    rows = rows.contiguous()
    qs = [q.contiguous() for _, q in pairs]
    _cuda.check_inputs([(rows, torch.int64)] + [(q, torch.float32) for q in qs], dev,
                       "gather_dot_kernel")
    if len({tuple(q.shape) for q in qs}) != 1:
        raise ValueError("gather_dot_kernel: the pairs' queries differ in shape")
    for plane, _ in pairs:
        if not plane.is_cuda or plane.device != dev:
            raise ValueError("gather_dot_kernel inputs must all lie on one CUDA device")
        if plane.stride(1) != 1 or plane.shape[0] == 0:
            raise ValueError("gather_dot_kernel needs a non-empty plane with unit column stride")
    b, r = rows.shape
    outs = [torch.empty((b, r), dtype=torch.float32, device=dev) for _ in pairs]
    if b and r:
        (p0, _), (p1, _) = pairs[0], pairs[-1]
        two = len(pairs) == 2
        err = _cuda.entry("gather_dot")(
            p0.data_ptr(), p1.data_ptr() if two else None, rows.data_ptr(),
            qs[0].data_ptr(), qs[-1].data_ptr(), outs[0].data_ptr(), outs[-1].data_ptr(),
            p0.stride(0), p1.stride(0), p0.shape[0], p1.shape[0],
            _ESIZE[p0.dtype], _ESIZE[p1.dtype], p0.shape[1], p1.shape[1], b, r, qs[0].shape[1],
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _cuda.check_launch(err, "gather_dot")
        gather_dot_kernel.launches["two_planes" if two else "one_plane"] += 1
    return tuple(outs)


gather_dot_kernel.launches = {"one_plane": 0, "two_planes": 0}


def sum_tolerance(rows: torch.Tensor, plane: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[B, R] f32: how far two f32 sums of the same dot, in two orders, may
    lie apart: ``2 * D * 2**-24 * sum_d |code_d * q_d|`` (f64 inside, over
    sub-blocks of queries of at most 1 GiB of codes)."""
    b, r = rows.shape
    d = q.shape[1]
    mag = torch.empty((b, r), dtype=torch.float64, device=rows.device)
    step = max(1, (1 << 30) // max(1, r * d * 8))
    for s in range(0, b, step):
        codes = plane[rows[s : s + step], :d].to(torch.float64).abs()
        mag[s : s + step] = torch.einsum("brd,bd->br", codes, q[s : s + step].double().abs())
    return (2 * d * 2.0**-24 * mag).to(torch.float32)
