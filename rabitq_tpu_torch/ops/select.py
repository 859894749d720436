"""Top-k selection with ``jax.lax.top_k``'s contract, the port's one
selection: the survivor cut, the centroid ranking, the best bins, the final
top-k, the shard merge, the MSTG closure and the k-means reseed all call
:func:`top_k`, where the JAX package calls ``lax.top_k``.

Order is descending in the total order of the float's bits, read as a
sign-magnitude integer (+NaN > +inf > ... > +0.0 > -0.0 > ... > -inf >
-NaN); among equal keys the lower index comes first. The ascending sites
take ``top_k(-x, k)`` and negate the values back, as the JAX package does.

On the card :func:`top_k` launches ``csrc/select.cu``: for rows that fit
on chip one of its short-row variants (a warp a row, or a bitonic sort of
the row or of a radix select's winners in shared memory), for longer rows
the long-row kernel (radix select, an ordered compaction and a stable radix
sort of the winners); :func:`kernel_path` picks. On a CPU tensor it runs
:func:`top_k_plain`, a stable sort of the same key. The two are bitwise
equal, values and indices.
"""

from __future__ import annotations

import torch

from . import _cuda

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the short-row variants' limits (csrc/select.cu): rows of at most SHORT_N
# entries in shared memory; the warp variant for k <= WARP_K of n <= WARP_N
SHORT_N, WARP_N, WARP_K, SORT_MIN = 8192, 1024, 32, 256
_SHORT_MODES = {"warp": 0, "sort": 1, "select": 2}
# the call sites, each counted apart on the card
SITES = ("survivors", "centroids", "bins", "final", "merge", "closure", "reseed", "other")


def _check(x: torch.Tensor, k: int) -> None:
    if x.dtype not in _DTYPES:
        raise ValueError(f"top_k takes float32 or bfloat16, got {x.dtype}")
    if x.dim() not in (1, 2):
        raise ValueError(f"top_k takes a 1-D or 2-D tensor, got {x.dim()} dimensions")
    if not 0 <= k <= x.shape[-1]:
        raise ValueError(f"top_k needs 0 <= k <= {x.shape[-1]}, got k={k}")


def _bits(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bits as a signed integer tensor of the same width."""
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def _ordered_key(x: torch.Tensor) -> torch.Tensor:
    """int32 key whose ascending order is the total order of ``x``'s floats:
    the bits read as a signed integer, the magnitude bits flipped where the
    sign is set."""
    b = _bits(x).to(torch.int32)
    low = 0x7FFF if x.dtype == torch.bfloat16 else 0x7FFFFFFF
    return torch.where(b < 0, b ^ low, b)


def top_k_plain(x: torch.Tensor, k: int):
    """The plain version: a stable descending sort of the ordered key,
    its first ``k``, and the entries' bits gathered (a float gather may
    rewrite a NaN). Returns (values of x's dtype, int32 indices)."""
    _check(x, k)
    _, order = torch.sort(_ordered_key(x), dim=-1, descending=True, stable=True)
    idx = order[..., :k]
    return torch.gather(_bits(x), -1, idx).view(x.dtype), idx.to(torch.int32)


def top_k(x: torch.Tensor, k: int, *, site: str = "other"):
    """``jax.lax.top_k(x, k)`` along the last axis of a 1-D or 2-D float32
    or bfloat16 tensor: (values, int32 indices), ``k`` of each row in
    descending total order, ties to the lower index. ``site`` names the
    caller for the card's launch counts. A CPU tensor runs
    :func:`top_k_plain`; a CUDA tensor the kernel (a failed build or launch
    raises)."""
    _check(x, k)
    if x.device.type == "cpu":
        return top_k_plain(x, k)
    if not x.is_cuda:
        raise ValueError(f"top_k runs on the CPU or a CUDA device, not {x.device}")
    return top_k_cuda(x, k, site=site)


def _pow2_at_least(m: int) -> int:
    return max(SORT_MIN, 1 << (m - 1).bit_length())


def kernel_path(n: int, k: int) -> str:
    """The variant of the kernel that selects k of each row of n entries
    (either type: both keep 64-bit composites): "warp" (k <= 32 of at most
    1024: a warp a row), "sort" (at most 8192 entries, k above half the
    padded row: a bitonic sort of the row in shared memory), "select" (at
    most 8192 entries otherwise: a radix select in shared memory, then a
    sort of the winners), or "long" (the long-row kernel)."""
    if k <= WARP_K and n <= WARP_N:
        return "warp"
    if n > SHORT_N:
        return "long"
    return "sort" if 2 * _pow2_at_least(k) > _pow2_at_least(n) else "select"


def _segments(x: torch.Tensor, rows: int, n: int, k: int) -> tuple[int, int]:
    """(segments, segment length) of the long-row kernel's first pass where
    the rows are too few to fill the card with one block a row (two blocks
    a multiprocessor stay resident): each segment at least max(4k, 4096)
    entries, its length a multiple of 8 so that segments start on 16 bytes.
    (1, n): one pass."""
    slots = 2 * torch.cuda.get_device_properties(x.device).multi_processor_count
    segments = min(slots // max(rows, 1), n // max(4 * k, 4096))
    if segments < 2:
        return 1, n
    return segments, n // segments // 8 * 8


def _launch(x, values, indices, idx_in, rows, n, seg, segments, k) -> None:
    """One launch of the long-row kernel over ``rows * segments`` blocks."""
    keys = torch.empty((2, rows * segments, k), dtype=torch.int32, device=x.device)
    slots = torch.empty((2, rows * segments, k), dtype=torch.int32, device=x.device)
    err = _cuda.entry("top_k")(
        x.data_ptr(), values.data_ptr(), indices.data_ptr(), keys.data_ptr(), slots.data_ptr(),
        None if idx_in is None else idx_in.data_ptr(), rows, n, seg, segments, k,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _cuda.check_launch(err, "top_k")


def _long_row_kernel(rows: torch.Tensor, k: int, key: str):
    """The long-row kernel on contiguous ``[r, n]`` rows (1 <= k <= n):
    (values, int32 indices) ``[r, k]``. One launch, or two where the rows
    are few and long (each segment's top k, then the top k of those
    candidates, whose indices map back through the first pass's); counted
    under ``key``."""
    r, n = rows.shape
    values = torch.empty((r, k), dtype=rows.dtype, device=rows.device)
    indices = torch.empty((r, k), dtype=torch.int32, device=rows.device)
    segments, seg = _segments(rows, r, n, k)
    idx_in = None
    if segments > 1:
        cand = torch.empty((r, segments * k), dtype=rows.dtype, device=rows.device)
        cand_idx = torch.empty((r, segments * k), dtype=torch.int32, device=rows.device)
        _launch(rows, cand, cand_idx, None, r, n, seg, segments, k)
        top_k_cuda.launches[key] += 1
        rows, idx_in, n = cand, cand_idx, segments * k
    _launch(rows, values, indices, idx_in, r, n, n, 1, k)
    top_k_cuda.launches[key] += 1
    return values, indices


def top_k_cuda(x: torch.Tensor, k: int, *, site: str = "other"):
    """The kernel, in the variant :func:`kernel_path` names: one launch of
    a short-row variant, or the long-row kernel. Counts every launch in
    ``top_k_cuda.launches`` under ``"<site>_<f32|bf16>"``; allocates its
    outputs and scratch with ``torch.empty`` (a graph's pool during a
    capture) and does not synchronise."""
    _check(x, k)
    if site not in SITES:
        raise ValueError(f"unknown top_k site {site!r}")
    n = x.shape[-1]
    if n >= 2**31:
        raise ValueError(f"top_k indexes rows of fewer than 2**31 entries, got {n}")
    rows = x.reshape(x.shape[0] if x.dim() == 2 else 1, n).contiguous()
    _cuda.check_inputs([(rows, x.dtype)], x.device, "top_k")
    r = rows.shape[0]
    key = f"{site}_{_DTYPES[x.dtype]}"
    path = kernel_path(n, k)
    if r and k and path == "long":
        values, indices = _long_row_kernel(rows, k, key)
    else:
        values = torch.empty((r, k), dtype=x.dtype, device=x.device)
        indices = torch.empty((r, k), dtype=torch.int32, device=x.device)
        if r and k:
            err = _cuda.entry("top_k_short")(
                rows.data_ptr(), values.data_ptr(), indices.data_ptr(), r, n, k,
                _SHORT_MODES[path], int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream(x.device).cuda_stream,
            )
            _cuda.check_launch(err, "top_k_short")
            top_k_cuda.launches[key] += 1
    shape = (*x.shape[:-1], k)
    return values.view(shape), indices.view(shape)


top_k_cuda.launches = {f"{s}_{d}": 0 for s in SITES for d in _DTYPES.values()}
