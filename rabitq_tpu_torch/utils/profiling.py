"""Profiling helpers (counterpart of ``rabitq_tpu/utils/profiling.py``):
a ``torch.profiler`` trace around search or build flows, and a wall-clock
lap timer for benchmark harnesses."""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the enclosed block with ``torch.profiler`` (host ops, and the
    card's kernels and copies where there is a card) and write it to
    ``logdir/trace.json`` as a Chrome trace (chrome://tracing, Perfetto),
    also when the block raises. Yields the profiler (``key_averages()``).

    Usage::

        with device_trace("rabitq_trace"):
            index.batch_search_arrays(queries, params)
    """
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclass
class Timer:
    """Tiny wall-clock timer with named laps, for benchmark harnesses."""

    laps: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def lap(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.laps[name] = self.laps.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> str:
        return ", ".join(f"{k}={v:.3f}s" for k, v in self.laps.items())
