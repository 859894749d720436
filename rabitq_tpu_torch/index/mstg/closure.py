"""Closure (multi-)assignment with the RNG rule (port of
``rabitq_tpu/index/mstg/closure.py``).

Semantics of the reference ``ClosureAssigner`` (lqhl/rabitq-rs
``mstg/closure.rs:24-107``): a vector joins every centroid within
``(1 + epsilon) * closest_dist``, capped at ``max_replicas``, filtered by
the Relative-Neighborhood-Graph rule — candidate j is skipped if an
already-selected centroid i satisfies ``dist(v, j) > dist(c_i, c_j)``.

Per chunk of rows: one [chunk, C] distance product, the ``max_replicas``
closest centroids by ``ops/select.top_k`` of the negated distances
(``lax.top_k``'s order: ties to the lower centroid), and the RNG rule as an
unrolled R-step mask update over the [chunk, R, R] candidate-pair
distances. The chunks' results stay on the device and come to the host
once.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.select import top_k
from ...utils.device import rows_on_device


def _closure_chunk(
    chunk: torch.Tensor,  # [M, D] vectors
    centroids: torch.Tensor,  # [C, D]
    epsilon: float,
    max_replicas: int,
):
    """Returns (cand_idx [M, R] int64, selected [M, R] bool)."""
    m = chunk.shape[0]
    r = min(max_replicas, centroids.shape[0])

    x_sq = torch.sum(chunk * chunk, dim=-1, keepdim=True)
    c_sq = torch.sum(centroids * centroids, dim=-1)[None, :]
    d2 = torch.clamp_min(x_sq + c_sq - 2.0 * (chunk @ centroids.T), 0.0)  # [M, C]
    neg_d, cand = top_k(-d2, r, site="closure")  # closest first
    cand_d, cand = -neg_d, cand.to(torch.int64)

    # the threshold factor in f32, as the JAX package computes it
    factor = torch.tensor(epsilon, dtype=torch.float32, device=chunk.device) + 1.0
    in_threshold = cand_d <= cand_d[:, :1] * factor

    # pairwise centroid distances among each row's candidates: [M, R, R]
    cc = centroids[cand]  # [M, R, D]
    cc_sq = torch.sum(cc * cc, dim=-1)  # [M, R]
    pair = torch.clamp_min(
        cc_sq[:, :, None] + cc_sq[:, None, :] - 2.0 * torch.bmm(cc, cc.transpose(1, 2)), 0.0
    )

    # RNG rule, unrolled over candidate rank (closest candidate always kept)
    selected = torch.zeros((m, r), dtype=torch.bool, device=chunk.device)
    selected[:, 0] = True
    for j in range(1, r):
        # skip j if any selected i has dist(v, j) > dist(c_i, c_j)
        conflict = selected & (cand_d[:, j : j + 1] > pair[:, :, j])  # [M, R]
        selected[:, j] = in_threshold[:, j] & ~torch.any(conflict, dim=-1)
    return cand, selected


def closure_assign(
    data: "np.ndarray | torch.Tensor",
    centroids: np.ndarray,
    epsilon: float,
    max_replicas: int,
    chunk: int = 8192,
    data_dev: torch.Tensor | None = None,
    *,
    device: "str | torch.device | None" = None,
) -> list[np.ndarray]:
    """Per-cluster member lists (row indices, ascending) after closure
    assignment of the rows of ``data`` (a host array or a tensor), or of
    ``data_dev``, the same rows already uploaded, where given. The work runs
    on ``device``, else the tensor's own, else the card."""
    data_dev = rows_on_device(data, data_dev, device)
    dev = data_dev.device
    centroids = np.ascontiguousarray(centroids, np.float32)
    n = data_dev.shape[0]
    n_clusters = centroids.shape[0]
    r = min(max_replicas, n_clusters)
    cent_dev = torch.from_numpy(centroids).to(dev)
    cand = torch.empty((n, r), dtype=torch.int32, device=dev)
    selected = torch.empty((n, r), dtype=torch.bool, device=dev)
    for s in range(0, n, chunk):
        c, sel = _closure_chunk(data_dev[s : s + chunk], cent_dev, float(epsilon), int(max_replicas))
        cand[s : s + chunk] = c.to(torch.int32)
        selected[s : s + chunk] = sel
    cand, selected = cand.cpu().numpy(), selected.cpu().numpy()
    # flat (cluster, row) pairs in row-major order, grouped by one stable
    # sort: each cluster's member rows stay ascending, the reference's order
    rows, cols = np.nonzero(selected)
    clusters_flat = cand[rows, cols].astype(np.int64)
    order = np.argsort(clusters_flat, kind="stable")
    counts = np.bincount(clusters_flat, minlength=n_clusters)
    return np.split(rows.astype(np.int64)[order], np.cumsum(counts)[:-1])
