"""ann-benchmarks' single-query mode: each call is one query's search.

Set-up builds the index and searches ``WARM`` queries, which captures the
one-query graph. Call ``i`` searches query ``i mod (query_sets * n)`` of the
pool.
"""

from __future__ import annotations

import numpy as np

from portbench.judge import Group

WARM = 64  # searches of set-up


class Calls:
    requests = 1

    def __init__(self, ctx):
        self.ctx = ctx
        self.pool = ctx.queries.reshape(-1, ctx.queries.shape[2])
        self.index = ctx.program.build(ctx.config, ctx.rows, ctx.device)
        self.answers = None
        for i in range(WARM):
            self(i)
        self.answers = []  # (query, results) of every call after set-up

    def __call__(self, i: int) -> None:
        qi = i % self.pool.shape[0]
        res = self.ctx.program.single(self.index, self.ctx.config, self.pool[qi])
        if self.answers is not None:
            self.answers.append((qi, res))

    def blocks(self, i: int) -> list:
        return [np.array([i % self.pool.shape[0]])]

    def counters(self) -> dict:
        return {}

    def finish(self):
        k = self.ctx.config["serving"]["top_k"]
        arrays = [self.ctx.program.result_arrays(res, k) for _, res in self.answers]
        qidx = np.array([qi for qi, _ in self.answers], np.int64)
        ids = np.stack([a[0] for a in arrays]) if arrays else np.zeros((0, k), np.int64)
        dists = np.stack([a[1] for a in arrays]) if arrays else np.zeros((0, k))
        return self.pool, [Group(qidx, ids, dists)]
