"""Whether what the timed path returned is correct.

Every answer is held against the reference's exact top-k of its query and
against the exact distance of every id it names:

- ``recall_at_10``: the share of the exact top-k found, over every answer;
- ``dist_gap_mean`` / ``dist_gap_max``: |returned distance - exact distance
  of the returned id|, over the query's exact k-th distance, mean and widest
  over every returned id;
- ``bad_answers``: answers with fewer than k ids, an id outside the rows, an
  id twice, a distance not finite or distances not ascending;
- ``failed``: requests whose call raised, or that got no answer.

The limits are the configuration's (``limits``); ``PERF.md`` gives the
readings each was set from.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import exact_knn


@dataclass
class Group:
    """Answers to the queries ``qidx`` (rows of the check's queries), each
    given ``weight`` times in the run."""

    qidx: np.ndarray  # [m] int
    ids: np.ndarray  # [m, k] int
    dists: np.ndarray  # [m, k] float
    weight: int = 1


def well_formed(ids: np.ndarray, dists: np.ndarray, n_rows: int, k: int) -> np.ndarray:
    """[m] bool: k distinct ids inside the rows, finite ascending distances."""
    if ids.shape[1] != k or dists.shape != ids.shape:
        return np.zeros(ids.shape[0], bool)
    ok = ((ids >= 0) & (ids < n_rows) & np.isfinite(dists)).all(axis=1)
    srt = np.sort(ids, axis=1)
    ok &= (srt[:, 1:] != srt[:, :-1]).all(axis=1)
    with np.errstate(invalid="ignore"):  # inf - inf where a row is padded
        ok &= (np.diff(dists, axis=1) >= 0).all(axis=1)
    return ok


def measure(rows: torch.Tensor, queries: torch.Tensor, groups: list[Group], k: int,
            failed: int) -> dict:
    """The compared numbers of a run's answers. ``queries`` [Q, D] are the
    check's queries on the rows' device."""
    gt_ids, gt_d = exact_knn.top_k(rows, queries, k)
    gt_ids = gt_ids.cpu().numpy()
    kth = gt_d[:, k - 1].cpu().numpy().astype(np.float64)
    n_rows = rows.shape[0]
    hits = total = bad = 0
    gap_sum, gap_n, gap_max = 0.0, 0, 0.0
    for g in groups:
        ids = np.asarray(g.ids).astype(np.int64)
        dists = np.asarray(g.dists, np.float64)
        ok = well_formed(ids, dists, n_rows, k)
        bad += int((~ok).sum()) * g.weight
        total += g.ids.shape[0] * k * g.weight
        if not ok.any():
            continue
        qi, ids, dists = np.asarray(g.qidx)[ok], ids[ok], dists[ok]
        hits += int((ids[:, :, None] == gt_ids[qi][:, None, :]).any(axis=2).sum()) * g.weight
        q_dev = torch.as_tensor(qi, device=rows.device)
        exact = exact_knn.pair_distances(rows, queries[q_dev], torch.as_tensor(ids, device=rows.device))
        gap = np.abs(dists - exact.cpu().numpy().astype(np.float64)) / kth[qi][:, None]
        gap_sum += float(gap.sum()) * g.weight
        gap_n += gap.size * g.weight
        gap_max = max(gap_max, float(gap.max()))
    return {
        "recall_at_10": hits / total if total else 0.0,
        "dist_gap_mean": gap_sum / gap_n if gap_n else float("inf"),
        "dist_gap_max": gap_max if gap_n else float("inf"),
        "bad_answers": bad,
        "failed": failed,
    }


def checks(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit", "ok"}}: a limit ``{"min": x}`` holds where
    the value is at least x, ``{"max": x}`` where it is at most x."""
    out = {}
    for name, value in numbers.items():
        lim = limits[name]
        if "min" in lim:
            ok, limit = value >= lim["min"], f">= {lim['min']}"
        else:
            ok, limit = value <= lim["max"], f"<= {lim['max']}"
        out[name] = {"value": value, "limit": limit, "ok": bool(ok)}
    return out
