"""Hierarchical balanced clustering for MSTG (port of
``rabitq_tpu/index/mstg/clustering.py``).

Semantics of the reference (lqhl/rabitq-rs ``mstg/clustering.rs``):
repeatedly pop any cluster larger than ``max_cluster_size``, split it with
k-means into ``branching_factor`` children, greedily rebalance oversized
children toward undersized ones, and keep going until every cluster fits.
Clusters are index arrays into one [N, D] matrix. The recursion is
level-synchronous, as in the JAX package: every oversized cluster of a level
trains its child centroids on a sampled subset (``ops.kmeans._kmeans_device``),
then one group-restricted assignment (``ops.kmeans._grouped_assign_blocks``)
routes the whole dataset to its children. A global Lloyd polish of the leaf
centroids follows (``refine_iters``), then oversized leaves are split evenly.

Where the rows are read: every step reads one rows tensor, on the device
that does the work. The JAX module reads its host rows in three places (the
rebalance's distances and the two leaf-centroid means); here those read the
tensor too, so a dataset drawn on the card needs no host copy.

Seeds: split ``r`` (counted from 1 across the levels) trains with a
``torch.Generator`` seeded ``(seed + r) * 1_000_003``, where the JAX package
seeds its key, and the sampled subsets come from numpy's ``seed`` as there.
So the hierarchy differs from the JAX package's, while each step computes
the same function.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ...ops.kmeans import (
    DEFAULT_MAX_POINTS_PER_CENTROID,
    _block_size,
    _grouped_assign_blocks,
    _kmeans_device,
)
from ...utils.device import rows_on_device
from ...utils.logging import get_logger
from ..scan import _pad_pow2

_log = get_logger("mstg.clustering")


@dataclass
class ClusterSet:
    """Final clustering: member row indices and centroids, and where the
    time went (``report``: seconds of each level, split count, polish
    seconds)."""

    members: list[np.ndarray]  # per-cluster row indices into the data matrix
    centroids: np.ndarray  # [C, D] f32
    report: dict | None = None


def _partition_means(data_dev: torch.Tensor, parts: list[np.ndarray]) -> torch.Tensor:
    """[len(parts), D] mean of each part's rows, for parts that partition
    the rows of ``data_dev`` (a segment sum on the device)."""
    dev = data_dev.device
    part_of = np.empty(data_dev.shape[0], np.int64)
    part_of[np.concatenate(parts)] = np.repeat(np.arange(len(parts)), [p.size for p in parts])
    sums = torch.zeros((len(parts), data_dev.shape[1]), dtype=torch.float32, device=dev)
    sums.index_add_(0, torch.from_numpy(part_of).to(dev), data_dev)
    counts = torch.tensor([p.size for p in parts], dtype=torch.float32, device=dev)
    return sums / counts[:, None]


def hierarchical_cluster(
    data: "np.ndarray | torch.Tensor",
    max_cluster_size: int,
    branching_factor: int,
    balance_weight: float = 1.0,
    kmeans_iters: int = 25,
    seed: int = 42,
    data_dev: torch.Tensor | None = None,
    refine_iters: int = 12,
    assign_dtype: str = "f32",
    *,
    device: "str | torch.device | None" = None,
) -> ClusterSet:
    """Cluster the rows of ``data`` (a host array or a tensor), or of
    ``data_dev``, the same rows already uploaded, where given, into lists of
    at most ``max_cluster_size`` rows. The work runs on ``device``, else the
    tensor's own, else the card."""
    data_dev = rows_on_device(data, data_dev, device)
    n, d = data_dev.shape
    if n == 0:
        return ClusterSet(members=[], centroids=np.zeros((0, d), np.float32))
    dev = data_dev.device

    rng = np.random.default_rng(seed)
    report = {"levels_s": [], "splits": 0, "polish_s": 0.0}
    active: list[np.ndarray] = [np.arange(n, dtype=np.int64)]
    final: list[np.ndarray] = []
    split_round = 0
    level = 0
    while True:
        oversized = [c for c in active if c.shape[0] > max_cluster_size]
        final.extend(c for c in active if c.shape[0] <= max_cluster_size)
        if not oversized:
            break
        level += 1
        t0 = time.perf_counter()

        # --- per-cluster child centroids from sampled subsets ---
        cents: list[torch.Tensor] = []
        ks: list[int] = []
        for idx in oversized:
            split_round += 1
            m = idx.shape[0]
            k = min(branching_factor, m)
            target = max(min(m, k * DEFAULT_MAX_POINTS_PER_CENTROID), k)
            sel = idx[rng.permutation(m)[:target]]
            train = data_dev.index_select(0, torch.from_numpy(sel).to(dev))
            gen = torch.Generator(device=dev)
            gen.manual_seed((seed + split_round) * 1_000_003)
            cent, _ = _kmeans_device(
                train, gen, k, kmeans_iters, _block_size(k), target, False,
                assign_dtype=assign_dtype,
            )
            cents.append(cent)
            ks.append(k)

        # --- one grouped assignment for the whole level ---
        g_count = len(oversized)
        c_total = int(sum(ks))
        c_pad = _pad_pow2(c_total, floor=8)
        cent_cat = torch.zeros((c_pad, d), dtype=torch.float32, device=dev)
        cent_cat[:c_total] = torch.cat(cents)
        cent_group = np.full(c_pad, -2, np.int32)  # filler: matches no row
        cent_group[:c_total] = np.repeat(np.arange(g_count, dtype=np.int32), ks)
        row_group = np.full(n, -1, np.int32)
        for gi, idx in enumerate(oversized):
            row_group[idx] = gi
        assign = _grouped_assign_blocks(
            data_dev, cent_cat, torch.from_numpy(cent_group).to(dev),
            torch.from_numpy(row_group).to(dev), _block_size(c_pad), assign_dtype,
        ).cpu().numpy()

        # --- split into children + per-group rebalance ---
        child_base = np.concatenate([[0], np.cumsum(ks)])
        next_active: list[np.ndarray] = []
        for gi, idx in enumerate(oversized):
            local = assign[idx] - child_base[gi]
            groups = [idx[local == c] for c in range(ks[gi])]
            if balance_weight > 0.0:
                sub = data_dev.index_select(0, torch.from_numpy(idx).to(dev))
                groups = _rebalance(sub, idx, groups, cents[gi], balance_weight)
            m = idx.shape[0]
            live = [g for g in groups if g.size]
            if len(live) <= 1 or max(g.size for g in live) == m:
                # degenerate split (all rows in one child): force an even
                # partition so the recursion terminates
                parts = max(2, (m + max_cluster_size - 1) // max_cluster_size)
                live = np.array_split(idx, parts)
            next_active.extend(g for g in live if g.size)
        active = next_active
        # the level's assignment came to the host: its device work is done
        report["levels_s"].append(round(time.perf_counter() - t0, 3))
        _log.debug(
            "level %d: %d clusters -> %d children (%.2fs)",
            level, g_count, len(active), time.perf_counter() - t0,
        )
    report["splits"] = split_round

    t0 = time.perf_counter()
    if refine_iters > 0 and len(final) > 1:
        final = _global_polish(
            data_dev, final, max_cluster_size, refine_iters, assign_dtype=assign_dtype
        )
    centroids = _partition_means(data_dev, final).cpu().numpy()
    report["polish_s"] = round(time.perf_counter() - t0, 3)
    return ClusterSet(members=final, centroids=centroids, report=report)


def _polish_step(data, centroids, cent_group, row_group, block, assign_dtype="f32"):
    """One global Lloyd iteration over the LEAF centroids: grouped
    assignment (padded centroid slots carry group -2 and match no row) and
    a segment-sum update. Empty slots keep their old centroid (no reseed:
    the polish must not invent new lists). Returns (assign [N] int32,
    new centroids)."""
    n = data.shape[0]
    c_pad = centroids.shape[0]
    assign = _grouped_assign_blocks(data, centroids, cent_group, row_group, block, assign_dtype)
    seg = torch.where(row_group == 0, assign.to(torch.int64), c_pad)  # padding rows -> scratch
    sums = torch.zeros((c_pad + 1, data.shape[1]), dtype=torch.float32, device=data.device)
    sums.index_add_(0, seg, data)
    counts = torch.zeros(c_pad + 1, dtype=torch.float32, device=data.device)
    counts.index_add_(0, seg, torch.ones(n, dtype=torch.float32, device=data.device))
    sums, counts = sums[:c_pad], counts[:c_pad]
    new_c = torch.where(
        counts[:, None] > 0, sums / torch.clamp_min(counts, 1.0)[:, None], centroids
    )
    return assign, new_c


def _global_polish(
    data_dev: torch.Tensor,
    final: list[np.ndarray],
    max_cluster_size: int,
    refine_iters: int,
    assign_dtype: str = "f32",
) -> list[np.ndarray]:
    """Global Lloyd polish of the leaf partition.

    The level-synchronous recursion assigns each row only within its
    parent's subtree, so rows near an early split boundary end up in a leaf
    far from their globally nearest one. ``refine_iters`` global Lloyd
    iterations seeded from the leaf centroids close that gap; empty leaves
    are dropped and oversized ones evenly re-split afterwards, so
    ``max_cluster_size`` still holds. The reference has no such pass
    (``mstg/clustering.rs`` stops at the subtree partition); it is a
    quality extension of the JAX package.
    """
    n, d = data_dev.shape
    dev = data_dev.device
    c = len(final)
    c_pad = _pad_pow2(c, floor=8)
    cent = torch.zeros((c_pad, d), dtype=torch.float32, device=dev)
    cent[:c] = _partition_means(data_dev, final)
    cent_group = torch.full((c_pad,), -2, dtype=torch.int32, device=dev)
    cent_group[:c] = 0
    row_group = torch.zeros(n, dtype=torch.int32, device=dev)
    block = _block_size(c_pad)
    assign = None
    for _ in range(refine_iters):
        assign, cent = _polish_step(data_dev, cent, cent_group, row_group, block, assign_dtype)
    assign = assign.cpu().numpy()
    order = np.argsort(assign, kind="stable")  # rows stay ascending per list
    counts = np.bincount(assign, minlength=c)
    polished: list[np.ndarray] = []
    for m in np.split(order, np.cumsum(counts)[:-1]):
        if m.size == 0:
            continue
        if m.size > max_cluster_size:
            parts = (m.size + max_cluster_size - 1) // max_cluster_size
            polished.extend(np.array_split(m, parts))
        else:
            polished.append(m)
    return polished


def _rebalance(
    sub: torch.Tensor,
    idx: np.ndarray,
    groups: list[np.ndarray],
    centroids: torch.Tensor,
    balance_weight: float,
) -> list[np.ndarray]:
    """Move the closest vectors from oversized to undersized children
    (``mstg/clustering.rs:133-208``), a batch at a time. ``sub`` holds the
    rows of ``idx``, ``centroids`` the children's centroids, both on one
    device. Each member's position in ``idx`` comes from one sorted lookup,
    not a per-vector table."""
    total = sum(g.size for g in groups)
    k = len(groups)
    target = total // max(k, 1)
    max_allowed = int(target * (1.0 + balance_weight))
    by_id = np.argsort(idx, kind="stable")
    sorted_idx = idx[by_id]

    for _ in range(10):
        sizes = [g.size for g in groups]
        over = next((i for i, s in enumerate(sizes) if s > max_allowed), None)
        under = next((i for i, s in enumerate(sizes) if s < target), None)
        if over is None or under is None:
            break
        need = min(sizes[over] - max_allowed, target - sizes[under])
        need = max(need, 1)
        rows = by_id[np.searchsorted(sorted_idx, groups[over])]
        diff = sub.index_select(0, torch.from_numpy(rows).to(sub.device)) - centroids[under]
        d2 = torch.sum(diff * diff, dim=-1).cpu().numpy()
        move = np.argsort(d2)[:need]
        moved = groups[over][move]
        keep = np.ones(groups[over].size, bool)
        keep[move] = False
        groups[over] = groups[over][keep]
        groups[under] = np.concatenate([groups[under], moved])
    return groups
