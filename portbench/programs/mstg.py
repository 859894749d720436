"""The program's MSTG index (``rabitq_tpu_torch.MstgIndex``) as a
configuration's ``index.kind: "mstg"`` runs it: the only calls into the
program that a cell makes. The configuration names the quantities it shares
with the IVF configurations by their keys: ``total_bits`` is
``MstgConfig.rabitq_bits`` and ``nprobe`` is ``MstgSearchParams.ef_search``
(the posting lists a query probes)."""

from __future__ import annotations

import numpy as np
from rabitq_tpu_torch import Metric, MstgConfig, MstgIndex, MstgSearchParams, ScalarPrecision


def _params(config: dict):
    s = config["serving"]
    return MstgSearchParams(top_k=s["top_k"], ef_search=s["nprobe"],
                            pruning_epsilon=s["pruning_epsilon"])


def build(config: dict, rows, device):
    """``MstgIndex.build`` on ``rows`` (a tensor on ``device``), set up to
    serve as the configuration says."""
    ix = config["index"]
    cfg = MstgConfig(
        max_posting_size=ix["max_posting_size"], branching_factor=ix["branching_factor"],
        balance_weight=ix["balance_weight"], closure_epsilon=ix["closure_epsilon"],
        max_replicas=ix["max_replicas"], rabitq_bits=ix["total_bits"],
        faster_config=ix["faster_config"], metric=Metric.from_str(ix["metric"]),
        centroid_precision=ScalarPrecision(ix["centroid_precision"]), refine_ex=ix["refine_ex"],
        refine_iters=ix["refine_iters"], use_rotator=ix["use_rotator"],
    )
    index = MstgIndex.build(rows, cfg, seed=ix["seed"], scan_dtype=ix["scan_dtype"], device=device)
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
    """Which rows the index put in which posting list, from its public
    layout: {"row_ids", "cluster_of", "n_clusters", "dim"} (dim: the codes';
    a replicated row is listed once a list)."""
    lay = index.layout
    ids = lay.ids.cpu().numpy()
    keep = ids >= 0
    return {
        "row_ids": ids[keep].astype(np.int64),
        "cluster_of": lay.cluster_of.cpu().numpy()[keep].astype(np.int64),
        "n_clusters": int(lay.centroids.shape[0]),
        "dim": int(index.quant_dim),
    }
