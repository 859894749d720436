"""The least time a scan kernel could take, counted from the problem.

Never from the kernel's own tile lists: what a query block needs is fixed by
the rows, the index's cluster membership and nprobe. For each block of
queries:

- bytes: the codes of every cluster that at least one query of the block
  probes, counted once, at the configuration's code width, plus each of
  those rows' factors, the queries in and the top-k results out;
- operations: 2 * D for every probed (query, row) pair.

The least time is the larger of bytes over HBM bandwidth and operations over
the peak of the unit. The probed clusters are the ``nprobe`` nearest cluster
means, each the mean of the rows the index put in that cluster, ranked in
plain float32.

Peaks: NVIDIA's data sheet for the H100 SXM, dense, without sparsity, at
the full 700 W power limit.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.exact_knn import full_f32

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {
    "int8_tensor": 1979e12,
    "fp8_tensor": 1979e12,
    "bf16_tensor": 989e12,
    "tf32_tensor": 495e12,
    "f32": 67e12,
}
RESULT_BYTES = 8  # an id and a distance of a top-k result
MEAN_BLOCK = 1 << 17  # rows a block of the cluster sums


def cluster_means(rows: torch.Tensor, row_ids: np.ndarray, cluster_of: np.ndarray,
                  n_clusters: int) -> tuple[torch.Tensor, np.ndarray]:
    """(means [C, D] f32 on the rows' device, sizes [C]) of the clusters
    the index made: row ``row_ids[i]`` is in cluster ``cluster_of[i]``. An
    empty cluster's mean is +inf, so that it is never nearest."""
    dev = rows.device
    c = torch.as_tensor(cluster_of, dtype=torch.int64, device=dev)
    r = torch.as_tensor(row_ids, dtype=torch.int64, device=dev)
    sums = torch.zeros((n_clusters, rows.shape[1]), dtype=torch.float64, device=dev)
    for s in range(0, r.shape[0], MEAN_BLOCK):
        sums.index_add_(0, c[s : s + MEAN_BLOCK], rows[r[s : s + MEAN_BLOCK]].double())
    sizes = np.bincount(cluster_of, minlength=n_clusters).astype(np.int64)
    n = torch.as_tensor(sizes, dtype=torch.float64, device=dev)[:, None]
    means = torch.where(n > 0, sums / n.clamp(min=1), torch.inf).float()
    return means, sizes


def probes(queries: torch.Tensor, means: torch.Tensor, nprobe: int) -> np.ndarray:
    """[Q, nprobe] the nearest cluster means of each query."""
    with full_f32():
        finite = torch.isfinite(means).all(dim=1)
        m = torch.where(finite[:, None], means, 0.0)
        d = (m * m).sum(dim=1)[None, :] - 2.0 * (queries @ m.T)
        d = torch.where(finite[None, :], d, torch.inf)
    return torch.topk(d, min(nprobe, means.shape[0]), dim=1, largest=False).indices.cpu().numpy()


def block_work(block_probes: np.ndarray, sizes: np.ndarray, dim: int, code_bits: float,
               factor_bytes: int, query_bytes: float, k: int) -> tuple[float, float]:
    """(bytes, operations) one block of queries needs: ``block_probes``
    [b, nprobe] clusters, ``dim`` code dimensions at ``code_bits`` bits,
    ``factor_bytes`` a row, ``query_bytes`` a query."""
    rows = int(sizes[np.unique(block_probes)].sum())
    pairs = int(sizes[block_probes].sum())
    b = block_probes.shape[0]
    n_bytes = rows * (dim * code_bits / 8 + factor_bytes) + b * (query_bytes + k * RESULT_BYTES)
    return float(n_bytes), float(2 * dim * pairs)


def least_seconds(n_bytes: float, ops: float, peak: str) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[peak])


def share_pct(run, pattern, code_bits: float, factor_bytes: int, query_bytes_per_dim: float,
              peak: str):
    """A kernel's roofline share (%) over the traced blocks: the blocks'
    least time over the device time of the kernels whose name matches
    ``pattern`` (a compiled regex); None where the trace holds none."""
    t = run.trace
    if t is None or run.roofline is None:
        return None
    kernel_s = sum(e - s for s, e, name in t.device if pattern.search(name)) / 1e6
    if kernel_s <= 0:
        return None
    rf = run.roofline
    least = 0.0
    for block in t.blocks:
        n_bytes, ops = block_work(rf["probes"][block], rf["sizes"], rf["dim"], code_bits,
                                  factor_bytes, query_bytes_per_dim * rf["dim"], rf["k"])
        least += least_seconds(n_bytes, ops, peak)
    return 100.0 * least / kernel_s
