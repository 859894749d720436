"""ann-benchmarks' batch mode: each call answers one whole query set.

Set-up builds the index and serves every set once, which captures the
graphs of every scan block. Call ``i`` serves set ``i mod query_sets``.
"""

from __future__ import annotations

import numpy as np

from portbench.judge import Group


class Calls:
    def __init__(self, ctx):
        self.ctx = ctx
        self.n_sets, self.requests = ctx.queries.shape[:2]
        self.index = ctx.program.build(ctx.config, ctx.rows, ctx.device)
        self.answers = None
        for s in range(self.n_sets):
            self(s)
        self.answers = []  # (set, ids, distances) of every call after set-up

    def __call__(self, i: int) -> None:
        s = i % self.n_sets
        ids, dists = self.ctx.program.batch(self.index, self.ctx.config, self.ctx.queries[s])
        if self.answers is not None:
            self.answers.append((s, ids, dists))

    def blocks(self, i: int) -> list:
        """Check-query indices of each scan block of call ``i``."""
        first = (i % self.n_sets) * self.requests
        bs = self.ctx.config["serving"]["batch_size"]
        return [np.arange(first + a, first + min(a + bs, self.requests))
                for a in range(0, self.requests, bs)]

    def counters(self) -> dict:
        return {}

    def finish(self):
        """(check queries [sets * n, D], answer groups): each distinct
        answer to a set, weighted by the calls that gave it."""
        variants = [[] for _ in range(self.n_sets)]  # [ids, dists, calls]
        for s, ids, dists in self.answers:
            for v in variants[s]:
                if np.array_equal(v[0], ids) and np.array_equal(v[1], dists, equal_nan=True):
                    v[2] += 1
                    break
            else:
                variants[s].append([ids, dists, 1])
        n = self.requests
        groups = [Group(np.arange(s * n, (s + 1) * n), ids, dists, w)
                  for s in range(self.n_sets) for ids, dists, w in variants[s]]
        return self.ctx.queries.reshape(-1, self.ctx.queries.shape[2]), groups
