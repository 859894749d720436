"""Exact nearest neighbours under squared L2, in plain PyTorch float32.

The reference of every configuration whose metric is L2: it takes only the
rows and queries the benchmark made, and nothing the program made. Matrix
products run with TF32 off. Candidates come from the expansion
``|q|^2 - 2 q.x + |x|^2`` in blocks of queries; the best ``k`` of them are
then chosen again by the direct sum of squared differences, so that the
expansion's cancellation cannot reorder near ties.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

QUERY_BLOCK = 256  # queries a block: a [256, 1M] f32 distance block is 1 GB
CANDIDATES = 64  # candidates a query re-scored directly
PAIR_BLOCK = 16_384  # (query, row) pairs a block of direct distances


@contextmanager
def full_f32():
    """Matrix products in float32 proper (no TF32) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def pair_distances(rows: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """[Q, k] squared L2 distances of ``queries`` [Q, D] to ``rows[ids]``
    (``ids`` [Q, k], every id a valid row), summed directly in float32."""
    q_n, k = ids.shape
    flat_q = torch.arange(q_n, device=ids.device).repeat_interleave(k)
    flat_ids = ids.reshape(-1)
    out = torch.empty(flat_ids.shape[0], dtype=torch.float32, device=ids.device)
    for s in range(0, flat_ids.shape[0], PAIR_BLOCK):
        e = min(s + PAIR_BLOCK, flat_ids.shape[0])
        diff = queries[flat_q[s:e]] - rows[flat_ids[s:e]]
        out[s:e] = (diff * diff).sum(dim=1)
    return out.reshape(q_n, k)


def top_k(rows: torch.Tensor, queries: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids [Q, k] int64, distances [Q, k] f32), nearest first, of each
    query among ``rows``; both tensors on the rows' device."""
    cand = min(max(CANDIDATES, k), rows.shape[0])
    ids_out, d_out = [], []
    with full_f32():
        r_sq = (rows * rows).sum(dim=1)
        for s in range(0, queries.shape[0], QUERY_BLOCK):
            q = queries[s : s + QUERY_BLOCK]
            d = r_sq[None, :] - 2.0 * (q @ rows.T)
            c = torch.topk(d, cand, dim=1, largest=False).indices
            del d
            exact = pair_distances(rows, q, c)
            order = torch.sort(exact, dim=1, stable=True).indices[:, :k]
            ids_out.append(torch.gather(c, 1, order))
            d_out.append(torch.gather(exact, 1, order))
    return torch.cat(ids_out), torch.cat(d_out)
