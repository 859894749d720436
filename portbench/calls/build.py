"""The index build, repeated: each call trains a new index on the rows.

Before each build the rows on the device are moved by a fresh translation
drawn from the seed (``shift_std`` a dimension), so that no build can be
answered by an earlier one. Set-up is one build on the unmoved rows. After
the window the last index serves query set 0, moved by the same
translation, and those answers are what is judged.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.judge import Group


class Calls:
    requests = 1

    def __init__(self, ctx):
        self.ctx = ctx
        self.shift = torch.zeros(ctx.rows.shape[1], device=ctx.device)
        self.index = ctx.program.build(ctx.config, ctx.rows, ctx.device)
        self.reports = []  # build reports of every call after set-up

    def __call__(self, i: int) -> None:
        t = self.ctx.mix["shift_std"] * torch.randn(
            self.shift.shape, generator=self.ctx.gen, device=self.ctx.device)
        self.ctx.rows.add_(t - self.shift)
        self.shift = t
        self.index = None  # the last index goes before the next is built
        self.index = self.ctx.program.build(self.ctx.config, self.ctx.rows, self.ctx.device)
        self.reports.append(self.ctx.program.build_report(self.index))

    def blocks(self, i: int) -> list:
        return []

    def counters(self) -> dict:
        return {"build_reports": list(self.reports)}

    def finish(self):
        queries = self.ctx.queries[0] + self.shift.cpu().numpy()[None, :]
        ids, dists = self.ctx.program.batch(self.index, self.ctx.config, queries)
        return queries, [Group(np.arange(queries.shape[0]), ids, dists)]
