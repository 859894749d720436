"""The program's IVF index (``rabitq_tpu_torch.IvfRabitqIndex``) as a
configuration's ``index.kind: "ivf"`` runs it: the only calls into the
program that a cell makes."""

from __future__ import annotations

import numpy as np
from rabitq_tpu_torch import IvfRabitqIndex, Metric, RotatorType, SearchParams


def _params(config: dict):
    s = config["serving"]
    return SearchParams(top_k=s["top_k"], nprobe=s["nprobe"])


def build(config: dict, rows, device):
    """``IvfRabitqIndex.train`` on ``rows`` (a tensor on ``device``), set up
    to serve as the configuration says."""
    ix = config["index"]
    index = IvfRabitqIndex.train(
        rows, nlist=ix["nlist"], total_bits=ix["total_bits"], metric=Metric.from_str(ix["metric"]),
        rotator_type=RotatorType[ix["rotator"]], seed=ix["seed"],
        use_faster_config=ix["faster_config"], scan_dtype=ix["scan_dtype"], device=device,
    )
    index.upload_dtype = config["serving"]["upload_dtype"]
    return index


def batch(index, config: dict, queries: np.ndarray):
    """ann-benchmarks' batch mode: (ids [n, k], distances [n, k])."""
    s = config["serving"]
    return index.batch_search_arrays_pipelined(
        queries, _params(config), batch_size=s["batch_size"], upload_block=s["upload_block"])


def single(index, config: dict, query: np.ndarray):
    """ann-benchmarks' single-query mode: the search's result list."""
    return index.search(query, _params(config))


def result_arrays(results, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(ids [k], distances [k]) of a result list; -1 / inf where it is short."""
    ids = np.full(k, -1, np.int64)
    dists = np.full(k, np.inf, np.float64)
    for j, r in enumerate(results[:k]):
        ids[j], dists[j] = r.id, r.score
    return ids, dists


def build_report(index) -> dict:
    return index.build_report or {}


def membership(index) -> dict:
    """Which rows the index put in which cluster, from its public layout:
    {"row_ids", "cluster_of", "n_clusters", "dim"} (dim: the codes')."""
    lay = index.layout
    ids = lay.ids.cpu().numpy()
    keep = ids >= 0
    return {
        "row_ids": ids[keep].astype(np.int64),
        "cluster_of": lay.cluster_of.cpu().numpy()[keep].astype(np.int64),
        "n_clusters": int(lay.centroids.shape[0]),
        "dim": int(index.padded_dim),
    }
