"""The rows and queries of a cell, drawn from the seed on the run's device.

The recipe is bench.py's ``make_workload`` (as ``chip_smoke.py`` draws it on
the card): overlapping Gaussian blobs, queries from the same mixture,
sigma = 1.5 * (dim / 128) ** 0.25. Its calibration gives GIST-1M's shape of
recall against nprobe. Copied here so that a change to the program cannot
change the yardstick.
"""

from __future__ import annotations

import torch

DRAW_ROWS = 1 << 17  # rows a draw


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def blobs(dataset: dict, n_queries: int, g: torch.Generator, device: torch.device):
    """(rows [N, D], queries [n_queries, D]) f32 on ``device``: the rows
    first, then the queries, from one generator."""
    n, dim, n_centers = dataset["rows"], dataset["dim"], dataset["centers"]
    sigma = 1.5 * (dim / 128.0) ** 0.25
    centers = torch.randn((n_centers, dim), generator=g, device=device)

    def draw(count):
        out = torch.empty((count, dim), device=device)
        for s in range(0, count, DRAW_ROWS):
            e = min(s + DRAW_ROWS, count)
            a = torch.randint(0, n_centers, (e - s,), generator=g, device=device)
            out[s:e] = centers[a] + sigma * torch.randn((e - s, dim), generator=g, device=device)
        return out

    return draw(n), draw(n_queries)
