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
the long-row kernel, a persistent grid of thread-block clusters that reads
each row once from HBM, keeps it in the L2 for its later radix passes and
orders the winners on chip (:func:`long_row_plan` sizes the grid);
:func:`kernel_path` picks. On a CPU tensor it runs :func:`top_k_plain`, a
stable sort of the same key. The two are bitwise equal, values and indices.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, NamedTuple

import torch

from . import _cuda

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the short-row variants' limits (csrc/select.cu): rows of at most SHORT_N
# entries in shared memory; the warp variant for k <= WARP_K of n <= WARP_N
SHORT_N, WARP_N, WARP_K, SORT_MIN = 8192, 1024, 32, 256
_SHORT_MODES = {"warp": 0, "sort": 1, "select": 2}
# the long-row kernel (csrc/select.cu): a row's candidates ordered on chip
# (k and the ties at the k-th key, CAND), words of a slot's meta; the bytes
# of the rows in flight that stay within half the L2; cluster sizes; the
# fewest entries a block of a cluster larger than one takes
CAND, META = 8192, 8
L2_BUDGET = 24 << 20
CLUSTER_SIZES = (1, 2, 4, 8, 16)
MIN_SLICE = 16384
# the one-row variant (k <= WARP_K): bytes of the row a block takes (512
# threads x 4 loads of 16 bytes), at most two blocks a multiprocessor
GRID_BLOCK_BYTES = 512 * 4 * 16
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


def kernel_path(n: int, k: int, rows: int | None = None) -> str:
    """The variant of the kernel that selects k of each row of n entries
    (either type: both keep 64-bit composites): "warp" (k <= 32 of at most
    1024: a warp a row), "sort" (at most 8192 entries, k above half the
    padded row: a bitonic sort of the row in shared memory), "select" (at
    most 8192 entries otherwise: a radix select in shared memory, then a
    sort of the winners); for longer rows "grid" (one row, ``rows`` given as
    1, k <= 32: the whole card scans it, each warp keeping its k best),
    "cluster" (k <= CAND: the long-row kernel orders each row's winners on
    chip, unless the ties at the k-th key push them past CAND) or "spill"
    (k > CAND: every row's winners in index order through device scratch
    and a stable sort)."""
    if k <= WARP_K and n <= WARP_N:
        return "warp"
    if n > SHORT_N:
        return _long_variant(k, rows)
    return "sort" if 2 * _pow2_at_least(k) > _pow2_at_least(n) else "select"


def _long_variant(k: int, rows: int | None) -> str:
    if rows == 1 and k <= WARP_K:
        return "grid"
    return "cluster" if k <= CAND else "spill"


class LongRowPlan(NamedTuple):
    """The long-row kernel's grid: ``clusters`` clusters of ``cluster``
    blocks, one row in flight a cluster; for "grid", ``clusters`` blocks
    on the one row."""

    variant: str  # kernel_path's: "grid", "cluster" or "spill"
    cluster: int  # blocks a cluster (each takes a slice of the row)
    clusters: int  # clusters in the grid
    row_bytes: int

    @property
    def blocks(self) -> int:
        return self.cluster * self.clusters

    @property
    def rows_in_flight(self) -> int:
        return 1 if self.variant == "grid" else self.clusters

    @property
    def in_flight_bytes(self) -> int:
        return self.rows_in_flight * self.row_bytes


def long_row_plan(rows: int, n: int, k: int, elem_bytes: int, sms: int,
                  max_clusters: Mapping[int, int]) -> LongRowPlan:
    """The long-row kernel's grid for ``rows`` rows of ``n`` entries of
    ``elem_bytes`` each, on a card of ``sms`` multiprocessors that holds
    ``max_clusters[c]`` clusters of c blocks at once: for one row and k <=
    WARP_K the "grid" variant, a block for every GRID_BLOCK_BYTES of the row
    (at most two a multiprocessor); else the cluster size that keeps the most
    blocks busy (the smaller on a tie: fewer blocks to add up a histogram),
    with at most one block a multiprocessor, at least MIN_SLICE entries a
    block of a cluster larger than one, and as many rows in flight as hold
    at most L2_BUDGET bytes (at least one)."""
    row_bytes = n * elem_bytes
    if _long_variant(k, rows) == "grid":
        blocks = min(2 * sms, max(1, -(-row_bytes // GRID_BLOCK_BYTES)))
        return LongRowPlan("grid", 1, blocks, row_bytes)
    in_flight = max(1, L2_BUDGET // row_bytes)
    best = None
    for cs in CLUSTER_SIZES:
        if cs > 1 and n < cs * MIN_SLICE:
            break
        g = min(rows, in_flight, max_clusters.get(cs, 0), sms // cs)
        if g >= 1 and (best is None or g * cs > best[0] * best[1]):
            best = (g, cs)
    if best is None:
        raise RuntimeError("no cluster of the long-row selection kernel fits on the card")
    g, cs = best
    return LongRowPlan(_long_variant(k, rows), cs, g, row_bytes)


_CLUSTERS: dict = {}  # (device index, bf16) -> {cluster size: clusters the card holds}


def max_clusters(device: torch.device, bf16: bool) -> dict[int, int]:
    """How many clusters of each size in CLUSTER_SIZES of the long-row
    kernel ``device`` holds at once (``cudaOccupancyMaxActiveClusters``;
    0 where the card refuses a size), asked once a device and type."""
    key = (device.index, bool(bf16))
    if key not in _CLUSTERS:
        fn = _cuda.entry("top_k_clusters")
        out = ctypes.c_int()
        found = {}
        with torch.cuda.device(device):
            for cs in CLUSTER_SIZES:
                _cuda.check_launch(fn(cs, int(bf16), ctypes.byref(out)), "top_k_clusters")
                found[cs] = out.value
        _CLUSTERS[key] = found
    return _CLUSTERS[key]


def plan_for(rows: torch.Tensor, k: int) -> LongRowPlan:
    """:func:`long_row_plan` for contiguous ``[r, n]`` rows on their card."""
    r, n = rows.shape
    sms = torch.cuda.get_device_properties(rows.device).multi_processor_count
    if _long_variant(k, r) == "grid":
        return long_row_plan(r, n, k, rows.element_size(), sms, {})
    bf16 = rows.dtype == torch.bfloat16
    return long_row_plan(r, n, k, rows.element_size(), sms, max_clusters(rows.device, bf16))


def _long_row_kernel(rows: torch.Tensor, k: int, key: str):
    """The long-row kernel on contiguous ``[r, n]`` rows (1 <= k <= n):
    (values, int32 indices) ``[r, k]``, one launch, counted under ``key``."""
    r, n = rows.shape
    plan = plan_for(rows, k)
    dev = rows.device
    values = torch.empty((r, k), dtype=rows.dtype, device=dev)
    indices = torch.empty((r, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf16 = int(rows.dtype == torch.bfloat16)
    if plan.variant == "grid":
        part = torch.empty((plan.blocks, WARP_K), dtype=torch.int64, device=dev)
        err = _cuda.entry("top_k_grid")(rows.data_ptr(), values.data_ptr(), indices.data_ptr(),
                                        part.data_ptr(), n, k, plan.blocks, bf16, stream)
        _cuda.check_launch(err, "top_k_grid")
        top_k_cuda.launches[key] += 1
        return values, indices
    cand = torch.empty((plan.blocks, CAND), dtype=torch.int64, device=dev)
    meta = torch.empty((plan.blocks, META), dtype=torch.int32, device=dev)
    slots = min(r, plan.blocks)  # the spill's scratch: one a block that orders rows
    spill_keys = torch.empty((2, slots, k), dtype=torch.int32, device=dev)
    spill_idx = torch.empty((2, slots, k), dtype=torch.int32, device=dev)
    err = _cuda.entry("top_k")(
        rows.data_ptr(), values.data_ptr(), indices.data_ptr(), cand.data_ptr(), meta.data_ptr(),
        spill_keys.data_ptr(), spill_idx.data_ptr(), r, n, k, plan.cluster, plan.clusters, bf16,
        stream,
    )
    _cuda.check_launch(err, "top_k")
    top_k_cuda.launches[key] += 1
    return values, indices


def spilled_rows(device=None, *, reset: bool = False) -> int:
    """Rows the long-row kernel sent through its spill (winners in index
    order through device scratch) on ``device`` (default: the current card)
    since the last reset, counted on the card; ``reset`` sets the count to
    0. Synchronises the device."""
    device = torch.device("cuda" if device is None else device)
    out = ctypes.c_ulonglong()
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        _cuda.check_launch(_cuda.entry("top_k_spilled")(ctypes.byref(out), int(reset)),
                           "top_k_spilled")
    return out.value


def top_k_cuda(x: torch.Tensor, k: int, *, site: str = "other"):
    """The kernel, in the variant :func:`kernel_path` names: one launch of
    a short-row variant or of the long-row kernel. Counts every launch in
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
    if r and k and n > SHORT_N:
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
