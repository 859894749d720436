"""Host-side HNSW builder over MSTG centroids (a copy of
``rabitq_tpu/index/mstg/hnsw_graph.py``).

The index itself navigates centroids with an exact top-ef product
(``index.py``), so no graph is needed at serving time. This builder exists
purely for INTEROP: the reference's ``MstgIndex::load_from_path`` demands
hnsw_rs graph dumps next to the ``.mstg`` body (``mstg/io.rs:104-112``), and
those dumps must describe a real navigable HNSW over the centroids. The
construction parameters mirror the reference's hardcoded ones
(``mstg/hnsw.rs:91-97``): max_nb_connection=32, ef_construction=200,
max_layer=16.

Standard HNSW insertion (Malkov & Yashunin 2016): geometric level
assignment with scale 1/ln(M), greedy descent above the insert level,
ef_construction beam search + M-nearest link selection at and below it.
Distances are true Euclidean (hnsw_rs ``DistL2`` takes the sqrt,
``mstg/hnsw.rs:175-184`` is written to expect that) — the sqrt is
monotone so neighbour SELECTION is unaffected, but the distances stored
in the dump carry it.

Centroid counts are small (~1-5k at the 1M scale: `max_posting_size`
bounds lists at ~900-2000 rows), so a numpy-vectorized host build takes
well under a second; this is not a hot path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

#: reference construction parameters (mstg/hnsw.rs:91-97)
DEFAULT_M = 32
DEFAULT_EF_CONSTRUCTION = 200
#: hnsw_rs serializes only indexes built with max_layer == NB_LAYER_MAX
#: (the reference comments on this exact pitfall, mstg/hnsw.rs:93-95)
NB_LAYER_MAX = 16


@dataclass
class HnswGraph:
    """A built HNSW: per-point levels and per-point per-layer neighbour
    lists (``neighbors[p][l]`` = list of point indexes, layers 0..level)."""

    vectors: np.ndarray  # [N, dim] f32
    levels: np.ndarray  # [N] int32, max layer of each point
    neighbors: list[list[list[int]]] = field(default_factory=list)
    entry_point: int = 0
    m: int = DEFAULT_M
    ef_construction: int = DEFAULT_EF_CONSTRUCTION
    max_layer: int = NB_LAYER_MAX

    def rank_in_layer(self) -> list[np.ndarray]:
        """Points of each layer in insertion order — defines the dump's
        ``p_id.1`` ranks (hnsw_rs assigns rank by arrival in a layer)."""
        by_layer: list[list[int]] = [[] for _ in range(self.max_layer)]
        for p in range(len(self.levels)):
            for l in range(int(self.levels[p]) + 1):
                by_layer[l].append(p)
        return [np.asarray(v, np.int64) for v in by_layer]


def _l2(vectors: np.ndarray, q: np.ndarray, idx: np.ndarray) -> np.ndarray:
    d = vectors[idx] - q[None, :]
    return np.sqrt(np.maximum(np.einsum("nd,nd->n", d, d), 0.0))


def _search_layer(
    vectors: np.ndarray,
    neighbors: list[list[list[int]]],
    q: np.ndarray,
    entry: int,
    entry_dist: float,
    ef: int,
    layer: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Beam search on one layer; returns (ids, dists) of the ef best,
    sorted ascending by distance."""
    visited = {entry}
    # candidates and results as parallel python lists (N is small)
    cand_ids = [entry]
    cand_d = [entry_dist]
    res_ids = [entry]
    res_d = [entry_dist]
    while cand_ids:
        i = int(np.argmin(cand_d))
        c, cd = cand_ids.pop(i), cand_d.pop(i)
        worst = max(res_d)
        if cd > worst and len(res_d) >= ef:
            break
        nbrs = [n for n in neighbors[c][layer] if n not in visited]
        if not nbrs:
            continue
        visited.update(nbrs)
        nb = np.asarray(nbrs, np.int64)
        nd = _l2(vectors, q, nb)
        for n, dist in zip(nbrs, nd):
            if len(res_d) < ef or dist < max(res_d):
                cand_ids.append(n)
                cand_d.append(float(dist))
                res_ids.append(n)
                res_d.append(float(dist))
                if len(res_d) > ef:
                    j = int(np.argmax(res_d))
                    res_ids.pop(j)
                    res_d.pop(j)
    order = np.argsort(res_d, kind="stable")
    return (
        np.asarray(res_ids, np.int64)[order],
        np.asarray(res_d, np.float64)[order],
    )


def _greedy_descend(vectors, neighbors, q, entry, entry_dist, from_l, to_l):
    """ef=1 greedy walk from layer ``from_l`` down to ``to_l`` (exclusive
    lower bound: stops after searching layer to_l+1)."""
    cur, cur_d = entry, entry_dist
    for l in range(from_l, to_l, -1):
        improved = True
        while improved:
            improved = False
            nbrs = neighbors[cur][l]
            if nbrs:
                nb = np.asarray(nbrs, np.int64)
                nd = _l2(vectors, q, nb)
                j = int(np.argmin(nd))
                if nd[j] < cur_d:
                    cur, cur_d = int(nb[j]), float(nd[j])
                    improved = True
    return cur, cur_d


def build_hnsw(
    vectors: np.ndarray,
    m: int = DEFAULT_M,
    ef_construction: int = DEFAULT_EF_CONSTRUCTION,
    max_layer: int = NB_LAYER_MAX,
    seed: int = 0x45,
) -> HnswGraph:
    """Build an HNSW over ``vectors`` (host, numpy). Level scale is
    1/ln(m) (the standard choice, also hnsw_rs's ``LayerGenerator``)."""
    vectors = np.ascontiguousarray(vectors, np.float32)
    n = vectors.shape[0]
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.log(m)
    levels = np.minimum(
        np.floor(-np.log(rng.random(n)) * scale).astype(np.int32),
        max_layer - 1,
    )
    if n:
        levels[0] = max(int(levels[0]), 0)
    neighbors: list[list[list[int]]] = [
        [[] for _ in range(int(levels[p]) + 1)] for p in range(n)
    ]
    g = HnswGraph(
        vectors=vectors,
        levels=levels,
        neighbors=neighbors,
        entry_point=0,
        m=m,
        ef_construction=ef_construction,
        max_layer=max_layer,
    )
    if n == 0:
        return g
    entry = 0
    max_level = int(levels[0])
    for p in range(1, n):
        q = vectors[p]
        lp = int(levels[p])
        cur, cur_d = entry, float(_l2(vectors, q, np.asarray([entry]))[0])
        if max_level > lp:
            cur, cur_d = _greedy_descend(
                vectors, neighbors, q, cur, cur_d, max_level, lp
            )
        for l in range(min(lp, max_level), -1, -1):
            ids, dists = _search_layer(
                vectors, neighbors, q, cur, cur_d, ef_construction, l
            )
            cap = 2 * m if l == 0 else m
            chosen = ids[:m]
            neighbors[p][l] = [int(i) for i in chosen]
            for i, dist in zip(chosen, dists[: len(chosen)]):
                lst = neighbors[int(i)][l]
                lst.append(p)
                if len(lst) > cap:
                    # prune the worst back-link to keep degree bounded
                    nb = np.asarray(lst, np.int64)
                    nd = _l2(vectors, vectors[int(i)], nb)
                    keep = np.argsort(nd, kind="stable")[:cap]
                    neighbors[int(i)][l] = [int(nb[k]) for k in keep]
            cur, cur_d = int(ids[0]), float(dists[0])
        if lp > max_level:
            entry, max_level = p, lp
    g.entry_point = entry
    return g


def search_hnsw(
    g: HnswGraph, q: np.ndarray, k: int, ef: int = 64
) -> tuple[np.ndarray, np.ndarray]:
    """Query the built graph (used by tests to prove navigability —
    serving uses the exact matmul instead)."""
    q = np.asarray(q, np.float32)
    entry = g.entry_point
    cur_d = float(_l2(g.vectors, q, np.asarray([entry]))[0])
    cur, cur_d = _greedy_descend(
        g.vectors, g.neighbors, q, entry, cur_d, int(g.levels[entry]), 0
    )
    ids, dists = _search_layer(
        g.vectors, g.neighbors, q, cur, cur_d, max(ef, k), 0
    )
    return ids[:k], dists[:k]
