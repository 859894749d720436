"""K-means clustering on the device (port of ``rabitq_tpu/ops/kmeans.py``).

Faiss-style sampled Lloyd iterations after the reference pipeline
(lqhl/rabitq-rs ``src/kmeans.rs``): training subsample capped at
``max_points_per_centroid``, k-means++ seeding on a row prefix, blockwise
GEMM assignment, segment-sum update, empty-cluster reseeding from far
points, an objective early stop and multi-restart by objective.

The products stay ``torch.matmul``. Under ``assign_dtype="bf16"`` the
operands are rounded to bf16 and multiplied with f32 accumulation, the
semantics of the JAX package's bf16 dot with an f32 result: on the card the
product runs in TF32 mode, which holds bf16 values exactly, so it uses the
tensor cores without rounding the result. Random draws come from a
``torch.Generator`` seeded like the JAX key, so seeds pick other (equally
good) seeds than the JAX package does.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import rows_on_device, synchronize

RESEED_CANDIDATES = 8  # kmeans.rs:9
DEFAULT_MAX_POINTS_PER_CENTROID = 256  # kmeans.rs:10


@dataclass
class KMeansResult:
    centroids: torch.Tensor  # [k, D] f32 on the data's device
    assignments: np.ndarray  # [N] int32
    objective: float
    iters: int = 0  # Lloyd iterations actually run (< niter on early stop)
    report: dict | None = None  # phase timings {init_s, lloyd_s, assign_s}


def auto_assign_dtype(n: int, dim: int, threshold_elems: int = 1 << 26) -> str:
    """bf16 assignment operands once the dataset passes ~64M elements, f32
    below (the JAX package's ``"auto"`` policy)."""
    return "bf16" if n * dim >= threshold_elems else "f32"


@contextmanager
def _tf32_matmul(enabled: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _block_size(k: int) -> int:
    """Rows per assignment block: keeps the [block, k] distance tile near
    64 MB (power of two, as in the JAX package)."""
    raw = int(max(256, min(32768, (1 << 24) // max(k, 1))))
    return 1 << (raw.bit_length() - 1)


def _centroid_operands(centroids: torch.Tensor, assign_dtype: str):
    """(||c||^2, the product's centroid operand [D, C], bf16?) for the
    assignment distances; ``assign_dtype="bf16"`` rounds the operand to
    bf16 (the norms stay f32)."""
    if assign_dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown assign_dtype {assign_dtype!r}")
    bf16 = assign_dtype == "bf16"
    ct = centroids.T
    if bf16:
        ct = ct.to(torch.bfloat16).to(torch.float32)
    return torch.sum(centroids * centroids, dim=-1), ct.contiguous(), bf16


def _block_dists(xb: torch.Tensor, c_norm, ct, bf16: bool) -> torch.Tensor:
    """[block, C] clamped expansion ||x||^2 + ||c||^2 - 2 x.c
    (``kmeans.rs:496-507``), the row operand rounded to bf16 with ``bf16``."""
    xo = xb.to(torch.bfloat16).to(torch.float32) if bf16 else xb
    x_norm = torch.sum(xb * xb, dim=-1, keepdim=True)
    return torch.clamp_min(x_norm + c_norm[None, :] - 2.0 * (xo @ ct), 0.0)


def _assign_blocks(
    data: torch.Tensor, centroids: torch.Tensor, block: int, assign_dtype: str = "f32"
):
    """Nearest-centroid assignment over row blocks. Returns
    (assignments [N] int64, min_dists [N] f32)."""
    c_norm, ct, bf16 = _centroid_operands(centroids, assign_dtype)
    n = data.shape[0]
    assign = torch.empty(n, dtype=torch.int64, device=data.device)
    dists = torch.empty(n, dtype=torch.float32, device=data.device)
    with _tf32_matmul(bf16):
        for s in range(0, n, block):
            best = torch.min(_block_dists(data[s : s + block], c_norm, ct, bf16), dim=-1)
            dists[s : s + block] = best.values
            assign[s : s + block] = best.indices
    return assign, dists


def _grouped_assign_blocks(
    data: torch.Tensor,  # [N, D]
    centroids: torch.Tensor,  # [C, D] children of many parent clusters
    cent_group: torch.Tensor,  # [C] int32 parent group of each centroid
    row_group: torch.Tensor,  # [N] int32 parent group of each row (-1: not split)
    block: int,
    assign_dtype: str = "f32",
) -> torch.Tensor:
    """Group-restricted nearest-centroid assignment: a row considers only
    the centroids whose ``cent_group`` equals its ``row_group`` (padded
    centroid slots carry group -2 and match no row; a row matching none gets
    0). The distance and the bf16 operand rule are :func:`_assign_blocks`'s.
    Returns [N] int32."""
    c_norm, ct, bf16 = _centroid_operands(centroids, assign_dtype)
    n = data.shape[0]
    assign = torch.empty(n, dtype=torch.int32, device=data.device)
    with _tf32_matmul(bf16):
        for s in range(0, n, block):
            dist = _block_dists(data[s : s + block], c_norm, ct, bf16)
            ok = row_group[s : s + block, None] == cent_group[None, :]
            dist = torch.where(ok, dist, float("inf"))
            assign[s : s + block] = torch.argmin(dist, dim=-1).to(torch.int32)
    return assign


def _kmeanspp_init(
    data: torch.Tensor, gen: torch.Generator, k: int, n_valid: int
) -> torch.Tensor:
    """k-means++ (D^2-weighted) seeding, on the device: each step folds the
    distances to the last chosen centroid into the running minimum and
    samples the next centroid by inverse CDF. No host sync inside."""
    n, d = data.shape
    dev = data.device
    valid = torch.arange(n, device=dev) < n_valid
    first = torch.randint(0, n_valid, (1,), generator=gen, device=dev)
    centroids = torch.zeros((k, d), dtype=torch.float32, device=dev)
    centroids[0:1] = data.index_select(0, first)
    min_d2 = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    x_sq = torch.sum(data * data, dim=-1)
    for i in range(1, k):
        c = centroids[i - 1]
        d2 = x_sq - 2.0 * (data @ c) + torch.sum(c * c)
        min_d2 = torch.minimum(min_d2, torch.clamp_min(d2, 0.0))
        cum = torch.cumsum(torch.where(valid, min_d2, 0.0), dim=0)
        total = cum[-1:]
        u = torch.rand((1,), generator=gen, device=dev) * total
        idx = torch.clamp(torch.searchsorted(cum, u), 0, n_valid - 1)
        idx = torch.where(total > 0, idx, first)
        centroids[i : i + 1] = data.index_select(0, idx)
    return centroids


def _lloyd_step(
    data: torch.Tensor,
    centroids: torch.Tensor,
    k: int,
    block: int,
    n_valid: int,
    spherical: bool,
    assign_dtype: str = "f32",
):
    """One Lloyd iteration: assignment, segment-sum update, empty-cluster
    reseed from far points (``kmeans.rs:564-602``). Returns
    (new_centroids, objective) with the objective against the INPUT
    centroids, as a 0-d device tensor."""
    n, d = data.shape
    dev = data.device
    row_valid = torch.arange(n, device=dev) < n_valid
    assign, dists = _assign_blocks(data, centroids, block, assign_dtype)
    assign = torch.where(row_valid, assign, k)  # padding -> scratch segment
    objective = torch.sum(torch.where(row_valid, dists, 0.0))
    sums = torch.zeros((k + 1, d), dtype=torch.float32, device=dev)
    sums.index_add_(0, assign, data)
    counts = torch.zeros((k + 1,), dtype=torch.float32, device=dev)
    counts.index_add_(0, assign, torch.ones((n,), dtype=torch.float32, device=dev))
    sums, counts = sums[:k], counts[:k]
    new_c = sums / torch.clamp_min(counts, 1.0)[:, None]
    empty = counts == 0
    far_d = torch.where(row_valid, dists, float("-inf"))
    far_idx = torch.topk(far_d, min(RESEED_CANDIDATES, n)).indices
    rank = torch.clamp(torch.cumsum(empty.to(torch.int32), 0) - 1, 0, far_idx.shape[0] - 1)
    reseed = data[far_idx[rank]]
    new_c = torch.where(empty[:, None], reseed, new_c)
    if spherical:
        norms = torch.linalg.norm(new_c, dim=-1, keepdim=True)
        new_c = torch.where(norms > 0, new_c / torch.clamp_min(norms, 1e-30), new_c)
    return new_c, objective


def _init_rows_cap(k: int, n: int) -> int:
    """Row budget of the k-means++ pass: 64 per centroid, at least 65536;
    seeding quality saturates far below the full training set."""
    return max(min(64 * k, n), min(n, 65_536))


def _kmeans_device(
    data: torch.Tensor,
    gen: torch.Generator,
    k: int,
    niter: int,
    block: int,
    n_valid: int,
    spherical: bool,
    assign_dtype: str = "f32",
    tol: float = 0.0,
    timings: dict | None = None,
):
    """k-means++ init + Lloyd steps. ``tol > 0`` stops early once a step
    improves the objective by less than ``tol`` relative; the check reads
    the previous step's objective so the device keeps one step queued."""
    dev = data.device
    t0 = time.perf_counter()
    init_rows = _init_rows_cap(k, n_valid)
    centroids = _kmeanspp_init(data[:init_rows], gen, k, init_rows)
    if timings is not None:
        synchronize(dev)
        timings["init_s"] = round(time.perf_counter() - t0, 2)
        t0 = time.perf_counter()
    iters = 0
    prev_obj = None
    pending = None
    for i in range(niter):
        centroids, obj = _lloyd_step(
            data, centroids, k, block, n_valid, spherical, assign_dtype
        )
        iters = i + 1
        if timings is not None and i == 0:
            synchronize(dev)
            timings["lloyd_first_s"] = round(time.perf_counter() - t0, 2)
        if tol <= 0.0:
            continue
        if pending is not None:
            o = float(pending)  # sync: the PREVIOUS step's objective
            if prev_obj is not None and (prev_obj - o) <= tol * max(abs(prev_obj), 1e-30):
                break
            prev_obj = o
        pending = obj
    if timings is not None:
        synchronize(dev)
        timings["lloyd_s"] = round(time.perf_counter() - t0, 2)
    return centroids, iters


def run_kmeans(
    data: "np.ndarray | torch.Tensor",
    k: int,
    niter: int = 25,
    seed: int = 42,
    nredo: int = 1,
    spherical: bool = False,
    max_points_per_centroid: int = DEFAULT_MAX_POINTS_PER_CENTROID,
    data_dev: torch.Tensor | None = None,
    n_valid: int | None = None,
    assign_dtype: str = "f32",
    tol: float = 0.0,
    with_report: bool = False,
    *,
    device: "str | torch.device | None" = None,
) -> KMeansResult:
    """Run k-means on ``data`` [N, D] (a host array, or a tensor already on
    its device), or on ``data_dev``, the same rows already uploaded, where
    given; ``device`` defaults to the tensor's, else the card. Rows
    ``>= n_valid`` are padding and never trained on or assigned.
    Deterministic for a given seed on a given device."""
    data = rows_on_device(data, data_dev, device)
    dev = data.device
    n_rows, dim = data.shape
    n = n_rows if n_valid is None else n_valid
    if not 0 < k <= n:
        raise ValueError("k must be in (0, len(data)]")
    if niter <= 0:
        raise ValueError("niter must be positive")

    rng = np.random.default_rng(seed)
    # training subset (kmeans.rs:210-226)
    target = max(min(n, k * max_points_per_centroid), k)
    block = _block_size(k)
    if target < n:
        idx = rng.permutation(n)[:target]
        idx.sort()
        train = data.index_select(0, torch.from_numpy(idx).to(dev))
        nt = target
    else:
        train = data[:n]
        nt = n

    best: KMeansResult | None = None
    for redo in range(nredo):
        timings: dict | None = {} if with_report else None
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed * 1_000_003 + redo)
        centroids, iters = _kmeans_device(
            train, gen, k, niter, block, nt, spherical,
            assign_dtype=assign_dtype, tol=tol, timings=timings,
        )
        t0 = time.perf_counter()
        assignments, objective = assign_dataset(
            data, centroids, n_valid=n, assign_dtype=assign_dtype
        )
        if timings is not None:
            timings["assign_s"] = round(time.perf_counter() - t0, 2)
            timings["assign_dtype"] = assign_dtype
        result = KMeansResult(
            centroids=centroids, assignments=assignments,
            objective=objective, iters=iters, report=timings,
        )
        if best is None or result.objective < best.objective:
            best = result
    return best


def assign_dataset(
    data: "np.ndarray | torch.Tensor",
    centroids: "np.ndarray | torch.Tensor",
    block: int | None = None,
    n_valid: int | None = None,
    assign_dtype: str = "f32",
) -> tuple[np.ndarray, float]:
    """Assign every row to its nearest centroid (``kmeans.rs:604-642``).
    Runs on ``data``'s device (host arrays run on the CPU). Returns
    (assignments [N] int32, objective = sum of min squared dists)."""
    data = torch.as_tensor(data, dtype=torch.float32)
    n = data.shape[0] if n_valid is None else n_valid
    centroids = torch.as_tensor(centroids, dtype=torch.float32, device=data.device)
    if block is None:
        block = _block_size(centroids.shape[0])
    assign, dists = _assign_blocks(data[:n], centroids, block, assign_dtype)
    objective = float(torch.sum(dists.to(torch.float64)))
    return assign.to(torch.int32).cpu().numpy(), objective
