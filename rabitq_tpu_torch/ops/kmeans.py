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
tensor cores without rounding the result.

One seed gives one result on every run. The k-means++ draws are the JAX
package's own (``ops/prng.py``: the same ``jax.random`` keys and values,
made on the host), and every segment sum adds its rows in ascending row
order (:func:`segment_sum`: a CUDA kernel on the card, ``index_add_`` on the
CPU, bitwise equal), never with float atomics, and the k-means++ running
sums likewise (:func:`running_sum`). Where every distance and
running sum is exact in f32 the init picks the JAX package's rows; elsewhere
the packages' products and cumulative sums round differently, so a pick can
part from the JAX package's where a draw lands within rounding of a
boundary.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import rows_on_device, synchronize
from ..utils.profiling import Span, span
from . import _cuda, prng
from .select import top_k

RESEED_CANDIDATES = 8  # kmeans.rs:9
DEFAULT_MAX_POINTS_PER_CENTROID = 256  # kmeans.rs:10


@dataclass
class KMeansResult:
    centroids: torch.Tensor  # [k, D] f32 on the data's device
    assignments: np.ndarray  # [N] int32
    objective: float
    iters: int = 0  # Lloyd iterations actually run (< niter on early stop)
    report: dict | None = None  # phase seconds {init_s, lloyd_s, assign_s}, assign_dtype


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


def segment_sum_plain(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """The plain version of :func:`segment_sum_kernel`, on the CPU (the
    inputs are copied there; the result stays there): CPU ``index_add_``,
    which adds the rows one at a time in ascending row order. Ids outside
    ``[0, num_segments)`` are dropped, as ``jax.ops.segment_sum`` drops them."""
    data = data.detach().to("cpu", torch.float32)
    ids = segment_ids.detach().to("cpu", torch.int64)
    keep = (ids >= 0) & (ids < num_segments)
    if not bool(keep.all()):
        data, ids = data[keep], ids[keep]
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=torch.float32)
    return out.index_add_(0, ids, data)


def segment_sum_kernel(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel (``csrc/build_sums.cu``) on ``data`` [N, D] f32 and
    ``segment_ids`` [N] on the card: the rows grouped by a stable sort of
    the ids, then each segment's rows added in ascending row order. Returns
    (sums [num_segments, D] f32, counts [num_segments] int64), ids outside
    ``[0, num_segments)`` dropped. No host sync. ``segment_sum_kernel.launches``
    counts its launches."""
    if not data.is_cuda:
        raise ValueError("segment_sum_kernel needs CUDA tensors")
    dev = data.device
    data = data.to(torch.float32).contiguous()
    ids = segment_ids.to(dev, torch.int64)
    if data.dim() != 2 or ids.shape != data.shape[:1]:
        raise ValueError(f"segment_sum_kernel: rows {tuple(data.shape)}, ids {tuple(ids.shape)}")
    sorted_ids, order = torch.sort(ids, stable=True)
    offsets = torch.searchsorted(
        sorted_ids, torch.arange(num_segments + 1, dtype=torch.int64, device=dev))
    out = torch.zeros((num_segments, data.shape[1]), dtype=torch.float32, device=dev)
    if data.shape[0] and num_segments and data.shape[1]:
        vec4 = data.shape[1] % 4 == 0 and data.data_ptr() % 16 == 0
        err = _cuda.entry("segment_sum")(
            data.data_ptr(), order.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            num_segments, data.shape[1], int(vec4), torch.cuda.current_stream(dev).cuda_stream,
        )
        _cuda.check_launch(err, "segment_sum")
        segment_sum_kernel.launches += 1
    return out, offsets[1:] - offsets[:-1]


segment_sum_kernel.launches = 0


def segment_sum_counts(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(:func:`segment_sum`, the rows in each segment as f32) on ``data``'s
    device. The counts are integers, exact in f32 below 2**24."""
    if data.is_cuda:
        sums, counts = segment_sum_kernel(data, segment_ids, num_segments)
        return sums, counts.to(torch.float32)
    if data.device.type != "cpu":
        raise ValueError(f"no segment sum for device {data.device}")
    ids = segment_ids.to(torch.int64)
    counts = torch.bincount(ids[(ids >= 0) & (ids < num_segments)], minlength=num_segments)
    return segment_sum_plain(data, ids, num_segments), counts.to(torch.float32)


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """``jax.ops.segment_sum(data, segment_ids, num_segments)`` for f32 rows
    [N, D]: [num_segments, D], each segment's rows added one at a time in
    ascending row order, so that a result depends only on its inputs. The
    kernel for a CUDA tensor, the plain version for a CPU tensor; the two
    are bitwise equal."""
    return segment_sum_counts(data, segment_ids, num_segments)[0]


SCAN_THREADS, SCAN_ITEMS = 256, 8  # the running-sum kernel's threads, weights a thread
SCAN_TILE = SCAN_THREADS * SCAN_ITEMS  # weights a block scans


def _warp_inclusive_scan(x: np.ndarray) -> np.ndarray:
    """Kogge-Stone inclusive scan along the last axis (32 lanes, or fewer
    standing for a warp whose other lanes hold zeros), as the kernel's warp
    shuffles do it: at distance d = 1, 2, .., 16 each lane l >= d adds what
    lane l - d held before the step."""
    x = x.copy()
    for d in (1, 2, 4, 8, 16):
        x[..., d:] = x[..., d:] + x[..., :-d]
    return x


def _exclusive(incl: np.ndarray) -> np.ndarray:
    """The exclusive form of an inclusive scan along the last axis (a shift,
    0 first), with no subtraction."""
    out = np.zeros_like(incl)
    out[..., 1:] = incl[..., :-1]
    return out


def _running_sum_np(x: np.ndarray) -> np.ndarray:
    """:func:`running_sum_plain` on a 1-D f32 array."""
    n = x.shape[0]
    tiles = max(1, -(-n // SCAN_TILE))
    padded = np.zeros(tiles * SCAN_TILE, np.float32)
    padded[:n] = x
    local = np.cumsum(padded.reshape(tiles, SCAN_THREADS // 32, 32, SCAN_ITEMS), axis=-1,
                      dtype=np.float32)
    lanes = _warp_inclusive_scan(local[..., -1])  # [tiles, warps, 32]
    warps = _warp_inclusive_scan(lanes[..., -1])  # [tiles, warps]
    carry = np.zeros(1, np.float32) if tiles == 1 else _exclusive(_running_sum_np(warps[:, -1]))
    before = carry[:, None, None] + (_exclusive(warps)[:, :, None] + _exclusive(lanes))
    return (before[..., None] + local).reshape(-1)[:n].copy()


def running_sum_plain(w: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`running_sum_kernel`, on the CPU (the
    result stays there), in the kernel's order and in f32 throughout
    (``torch.cumsum`` on the CPU accumulates in f64; numpy's does not):
    tiles of ``SCAN_TILE`` weights (zeros past the end), in which each
    thread's ``SCAN_ITEMS`` consecutive weights are added in turn, the
    threads' totals scanned in warps of 32 and the warps' totals scanned the
    same way, the last of those the tile's total; each output is
    ``carry + (warp prefix + lane prefix)`` plus the thread's running sum,
    a tile's ``carry`` being the running sum of the earlier tiles' totals in
    this same order (0 for a lone tile)."""
    return torch.from_numpy(_running_sum_np(w.detach().to("cpu", torch.float32).numpy()))


def running_sum_kernel(w: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (``csrc/build_sums.cu``) on a 1-D f32 tensor on the
    card: its inclusive running sum in the order of :func:`running_sum_plain`.
    One launch where ``w`` fits one tile, two up to ``SCAN_TILE`` tiles (the
    tile totals, then the tiles with their carries), and past that the
    totals' own running sum between the two. ``running_sum_kernel.launches``
    counts its launches."""
    if not w.is_cuda or w.dim() != 1:
        raise ValueError("running_sum_kernel needs a 1-D CUDA tensor")
    w = w.to(torch.float32).contiguous()
    out = torch.empty_like(w)
    n = w.numel()
    if n:
        stream = torch.cuda.current_stream(w.device).cuda_stream
        tile_sums, scanned = None, 0
        tiles = -(-n // SCAN_TILE)
        if tiles > 1:
            tile_sums = torch.empty(tiles, dtype=torch.float32, device=w.device)
            err = _cuda.entry("tile_sums")(w.data_ptr(), tile_sums.data_ptr(), n, stream)
            _cuda.check_launch(err, "tile_sums")
            running_sum_kernel.launches += 1
            if tiles > SCAN_TILE:
                tile_sums, scanned = running_sum_kernel(tile_sums), 1
        err = _cuda.entry("running_sum")(
            w.data_ptr(), out.data_ptr(), n, None if tile_sums is None else tile_sums.data_ptr(),
            scanned, stream,
        )
        _cuda.check_launch(err, "running_sum")
        running_sum_kernel.launches += 1
    return out


running_sum_kernel.launches = 0


def running_sum(w: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum of the 1-D f32 ``w`` in one fixed order: the
    kernel for a CUDA tensor, the plain version for a CPU tensor, bitwise
    equal. (A 1-D ``torch.cumsum`` on the card combines its tiles in
    whatever order they finish, so its last bits vary from run to run.)"""
    if w.is_cuda:
        return running_sum_kernel(w)
    if w.device.type != "cpu":
        raise ValueError(f"no running sum for device {w.device}")
    return running_sum_plain(w)


def _kmeanspp_init(
    data: torch.Tensor, key: np.ndarray, k: int, n_valid: int
) -> torch.Tensor:
    """k-means++ (D^2-weighted) seeding, on the device: each step folds the
    distances to the last chosen centroid into the running minimum and
    samples the next centroid by inverse CDF. The draws are the JAX
    package's from ``key`` (``ops/prng.py``): the first row is
    ``randint(key, (), 0, n_valid)``, step i's uniform
    ``uniform(fold_in(key, i))``, all made on the host and uploaded once;
    the running sums are :func:`running_sum`'s, in one order on every run.
    No host sync inside."""
    n, d = data.shape
    dev = data.device
    valid = torch.arange(n, device=dev) < n_valid
    first = prng.randint(key, 0, n_valid)
    uniforms = torch.from_numpy(prng.fold_in_uniforms(key, k)).to(dev)
    centroids = torch.zeros((k, d), dtype=torch.float32, device=dev)
    centroids[0] = data[first]
    min_d2 = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    x_sq = torch.sum(data * data, dim=-1)
    for i in range(1, k):
        c = centroids[i - 1]
        d2 = x_sq - 2.0 * (data @ c) + torch.sum(c * c)
        min_d2 = torch.minimum(min_d2, torch.clamp_min(d2, 0.0))
        cum = running_sum(torch.where(valid, min_d2, 0.0))
        total = cum[-1:]
        u = uniforms[i : i + 1] * total
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
    n = data.shape[0]
    dev = data.device
    row_valid = torch.arange(n, device=dev) < n_valid
    assign, dists = _assign_blocks(data, centroids, block, assign_dtype)
    assign = torch.where(row_valid, assign, k)  # padding -> scratch segment
    objective = torch.sum(torch.where(row_valid, dists, 0.0))
    sums, counts = segment_sum_counts(data, assign, k + 1)
    sums, counts = sums[:k], counts[:k]
    new_c = sums / torch.clamp_min(counts, 1.0)[:, None]
    empty = counts == 0
    far_d = torch.where(row_valid, dists, float("-inf"))
    far_idx = top_k(far_d, min(RESEED_CANDIDATES, n), site="reseed")[1].to(torch.int64)
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
    key: np.ndarray,
    k: int,
    niter: int,
    block: int,
    n_valid: int,
    spherical: bool,
    assign_dtype: str = "f32",
    tol: float = 0.0,
    report: dict | None = None,
):
    """k-means++ init (draws from ``key``, a ``uint32[2]`` JAX key) + Lloyd
    steps. ``tol > 0`` stops early once a step improves the objective by
    less than ``tol`` relative; the check reads the previous step's
    objective so the device keeps one step queued. With ``report``, each
    phase (spans ``kmeans.init``, ``kmeans.lloyd``) ends with the device's
    queue and its seconds go into ``report``."""
    phase = span if report is None else Span
    with phase("kmeans.init") as init:
        init_rows = _init_rows_cap(k, n_valid)
        centroids = _kmeanspp_init(data[:init_rows], key, k, init_rows)
        if report is not None:
            synchronize(data.device)
    iters = 0
    prev_obj = None
    pending = None
    with phase("kmeans.lloyd") as lloyd:
        for i in range(niter):
            centroids, obj = _lloyd_step(
                data, centroids, k, block, n_valid, spherical, assign_dtype
            )
            iters = i + 1
            if tol <= 0.0:
                continue
            if pending is not None:
                o = float(pending)  # sync: the PREVIOUS step's objective
                if prev_obj is not None and (prev_obj - o) <= tol * max(abs(prev_obj), 1e-30):
                    break
                prev_obj = o
            pending = obj
        if report is not None:
            synchronize(data.device)
    if report is not None:
        report["init_s"], report["lloyd_s"] = init.seconds, lloyd.seconds
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
    Deterministic for a given seed on a given device: run ``redo`` draws
    from the JAX package's key ``PRNGKey(seed * 1_000_003 + redo)``, and
    the sums add in a fixed order (:func:`segment_sum`)."""
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
    phase = Span if with_report else span  # a report's phases are timed whether traced or not
    for redo in range(nredo):
        report: dict | None = {} if with_report else None
        key = prng.PRNGKey(seed * 1_000_003 + redo)
        centroids, iters = _kmeans_device(
            train, key, k, niter, block, nt, spherical,
            assign_dtype=assign_dtype, tol=tol, report=report,
        )
        with phase("kmeans.assign") as assign:
            assignments, objective = assign_dataset(
                data, centroids, n_valid=n, assign_dtype=assign_dtype
            )
        if report is not None:
            report["assign_s"] = assign.seconds
            report["assign_dtype"] = assign_dtype
        result = KMeansResult(
            centroids=centroids, assignments=assignments,
            objective=objective, iters=iters, report=report,
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
