"""Spans and traces (counterpart of ``rabitq_tpu/utils/profiling.py``).

A span times one step of the port on the host's ``time.perf_counter_ns``
clock: its name, start and end, the span it ran inside (``parent``), the
public call it belongs to (``call``: the id of the outermost span open when
it began) and optional integer counts (rows, bytes)::

    with span("serve.encode", rows=n) as sp:
        ...
        sp.add(bytes=nbytes)

The serving steps call :func:`span`. It records while a torch profiler is
active or inside :func:`recording`; otherwise it returns the inert
:data:`OFF` at the cost of two flag reads, allocating nothing. Steps off
the hot path (a build's phases, a graph capture, a download of host codes)
construct :class:`Span` directly: it always times itself, since a build
report reads its duration, and it is kept while recording, or always with
``always=True`` (the graph capture: one after set-up is what an operator
looks for). A span that ends logs its duration at INFO on the package's
logger (``RABITQ_TPU_LOG=info``).

Kept spans go to a ring of at most :data:`RING` entries, the oldest dropped
first: :func:`spans` reads them, :func:`dropped` counts what was lost and
:func:`clear` empties both. Nothing is written to disk except by
:func:`device_trace`, which adds the spans to its Chrome trace as a track of
their own.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from collections import deque

import torch
import torch.autograd.profiler as _autograd_profiler

from .logging import get_logger

RING = 1 << 18  # spans kept at most
SPAN_PID = 1 << 30  # the spans' track in a Chrome trace: no process has this id
_ANCHOR = "rabitq_tpu_torch.anchor"
_ANCHORS = 8  # clock anchors a trace takes

_log = get_logger("span")
_ring: deque = deque(maxlen=RING)
_kept = 0  # spans kept since the last clear(); those not in the ring were dropped
_recording = 0  # depth of open recording() blocks
_ids = itertools.count(1)
_local = threading.local()  # .stack: the spans open in this thread, innermost last


class Span:
    """One timed step; a context manager. Constructed directly it always
    times itself and logs; it is kept while tracing is on (a profiler or
    :func:`recording`), or whatever the switch with ``always``."""

    __slots__ = ("name", "counts", "start_ns", "end_ns", "id", "parent", "call", "_keep")

    def __init__(self, name: str, always: bool = False, **counts: int):
        self.name = name
        self.counts = counts
        self.start_ns = self.end_ns = 0
        self.id = self.parent = self.call = 0
        self._keep = always

    def __enter__(self) -> Span:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.call = self.id
        self._keep = self._keep or bool(_recording or _autograd_profiler._is_profiler_enabled)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _kept
        self.end_ns = time.perf_counter_ns()
        _local.stack.pop()
        if self._keep:
            _ring.append(self)
            _kept += 1
        if _log.isEnabledFor(logging.INFO):
            _log.info("%s: %.3fs", self.label, self.seconds)
        return False

    def add(self, **counts: int) -> None:
        """Add counts known only inside the span."""
        self.counts.update(counts)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def label(self) -> str:
        """The name and the counts, as the log line shows them."""
        return " ".join([self.name] + [f"{k}={v}" for k, v in self.counts.items()])


class _Off:
    """What :func:`span` returns while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add(self, **counts: int) -> None:
        pass


OFF = _Off()


def span(name: str, **counts: int):
    """A kept :class:`Span` while a torch profiler is active or inside
    :func:`recording`; else :data:`OFF`."""
    if _recording or _autograd_profiler._is_profiler_enabled:
        return Span(name, **counts)
    return OFF


@contextlib.contextmanager
def recording():
    """Keep spans inside the block without a profiler (and its cost)."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans() -> list[Span]:
    """The kept spans, oldest end first."""
    return list(_ring)


def dropped() -> int:
    """Spans kept since the last :func:`clear` that the ring no longer holds."""
    return _kept - len(_ring)


def clear() -> None:
    global _kept
    _ring.clear()
    _kept = 0


def _clock_offset_us(events, marks) -> float | None:
    """Trace clock minus host clock (us) from the anchor events and the
    host times taken around each: each pair bounds the offset from both
    sides; the middle of what all the bounds leave is taken."""
    found = sorted((e["ts"], e.get("dur", 0.0)) for e in events
                   if e.get("name") == _ANCHOR and e.get("ph") == "X")
    if len(found) != len(marks):
        return None
    lo = max(ts + dur - b / 1e3 for (ts, dur), (_, b) in zip(found, marks))
    hi = min(ts - a / 1e3 for (ts, _), (a, _) in zip(found, marks))
    return (lo + hi) / 2


def _add_spans(path: str, start_ns: int, marks) -> None:
    """Write the spans that began after ``start_ns`` into the Chrome trace at
    ``path``, on the trace's clock, as the track ``SPAN_PID``."""
    with open(path) as f:
        trace = json.load(f)
    events = trace.setdefault("traceEvents", [])
    offset = _clock_offset_us(events, marks)
    if offset is None:
        return
    events.append({"ph": "M", "name": "process_name", "pid": SPAN_PID, "tid": 0,
                   "args": {"name": "rabitq_tpu_torch spans"}})
    for s in spans():
        if s.start_ns < start_ns:
            continue
        events.append({
            "ph": "X", "cat": "rabitq_span", "name": s.name, "pid": SPAN_PID, "tid": 0,
            "ts": s.start_ns / 1e3 + offset, "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {**s.counts, "id": s.id, "parent": s.parent, "call": s.call},
        })
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the enclosed block with ``torch.profiler`` (host ops, and the
    card's kernels and copies where there is a card) and write it to
    ``logdir/trace.json`` as a Chrome trace (chrome://tracing, Perfetto),
    also when the block raises. The port's spans, which record while the
    profiler runs, are added as their own track ("rabitq_tpu_torch spans"),
    placed on the trace's clock by anchors taken at its start. Yields the
    profiler (``key_averages()``).

    Usage::

        with device_trace("rabitq_trace"):
            index.batch_search_arrays(queries, params)
    """
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    start_ns = time.perf_counter_ns()
    marks = []
    for _ in range(_ANCHORS):
        a = time.perf_counter_ns()
        with record_function(_ANCHOR):
            pass
        marks.append((a, time.perf_counter_ns()))
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path)
        _add_spans(path, start_ns, marks)
