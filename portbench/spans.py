"""The program's spans in a traced run, and the device's idle time split by
them.

The program keeps a span for each step of a public call while a profiler
runs (``rabitq_tpu_torch.utils.profiling.spans()``: name, start and end on
``time.perf_counter_ns``, parent, call id), on the clock the harness times
its windows with. A program without that recorder gives no spans, and every
reader here returns None.

The spans are placed on the device trace's clock by one offset. Its anchor
is the first traced call's start on both clocks: ``traced_window.calls[0][0]``
against the start of the harness's span around the traced calls,
``trace.span[0]``. That span opens a little before the call does, so the
anchor bounds the offset from below; the first host operator, which comes
after the call's start, bounds it from above. A span's edge never falls
inside a host operator, since both nest in one thread's calls: between the
two bounds the offset is the first under which the fewest span edges cut
an operator. A span that hugs an operator (``graph.replay`` around
``cudaGraphLaunch``) pins it to within its own slack. Each idle gap of the device is then named after the
innermost program span open over its middle, as ``trace.idle_gaps`` names it
after a host operator, or ``OUTSIDE`` where none is open.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from portbench import trace as trace_mod

OUTSIDE = "outside"


def program_spans():
    """Every span the program kept, or None without a recorder."""
    try:
        from rabitq_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def _between(lo_s: float, hi_s: float):
    """The program's spans that began between ``lo_s`` and ``hi_s`` (host
    seconds), or None without a recorder."""
    found = program_spans()
    if found is None:
        return None
    lo, hi = lo_s * 1e9, hi_s * 1e9
    return [s for s in found if lo <= s.start_ns <= hi]


def traced(run):
    """The spans of the traced sub-window, or None (no traced calls, no
    recorder)."""
    w = run.traced_window
    if w is None or not w.calls:
        return None
    return _between(w.calls[0][0], w.calls[-1][1])


def self_us(spans) -> list:
    """(span, microseconds of it that none of its children covers)."""
    children = defaultdict(float)
    for s in spans:
        children[s.parent] += s.end_ns - s.start_ns
    return [(s, (s.end_ns - s.start_ns - children[s.id]) / 1e3) for s in spans]


def captures(run):
    """``graph.capture`` spans begun from the window's start to the traced
    sub-window's end, or None without a recorder."""
    w = run.traced_window if run.traced_window is not None else run.window
    found = _between(run.window.start, w.end)
    return None if found is None else sum(s.name == "graph.capture" for s in found)


def clock_offset_us(run, spans) -> float:
    """Trace clock minus host clock, in microseconds (see the module's
    docstring)."""
    tr, w = run.trace, run.traced_window
    t0_us = w.calls[0][0] * 1e6
    lo = tr.span[0] - t0_us
    ops = sorted((s, e) for s, e, _ in tr.host if tr.span[0] <= s and e <= tr.span[1])
    if not ops or ops[0][0] - t0_us < lo:
        return lo
    hi = ops[0][0] - t0_us
    starts = [s for s, _ in ops]
    longest = max(e - s for s, e in ops)
    # an edge x of a span cuts the operator (s, e) for offsets in (s - x, e - x)
    cuts = []
    for sp in spans:
        for x in (sp.start_ns / 1e3, sp.end_ns / 1e3):
            i = bisect.bisect_left(starts, x + lo - longest)
            for s, e in ops[i:bisect.bisect_right(starts, x + hi)]:
                if e - x > lo:
                    cuts += [(max(s - x, lo), 1), (min(e - x, hi), -1)]
    cuts.sort()
    best, at, depth, x0 = None, lo, 0, lo
    for x, step in cuts + [(hi, 0)]:
        if x > x0 and (best is None or depth < best):
            best, at = depth, (x0 + x) / 2
        depth += step
        x0 = x
    return at


def idle_by_span(run):
    """{innermost program span, or ``OUTSIDE``: idle device seconds} over
    the traced sub-window; None without device events or a recorder."""
    tr = run.trace
    if tr is None or tr.span is None or not tr.device:
        return None
    spans = traced(run)
    if spans is None:
        return None
    d = clock_offset_us(run, spans) if spans else 0.0
    placed = sorted(((s.start_ns / 1e3 + d, s.end_ns / 1e3 + d, s.name) for s in spans),
                    key=lambda p: (p[0], -p[1]))  # of two that begin together, the outer first
    lo, hi = tr.span
    edges = [lo] + [x for iv in trace_mod.merged(tr.device) for x in iv] + [hi]
    out = defaultdict(float)
    active, nxt = [], 0  # spans begun, latest start last
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        while nxt < len(placed) and placed[nxt][0] <= mid:
            active.append(placed[nxt])
            nxt += 1
        while active and active[-1][1] < mid:
            active.pop()
        out[active[-1][2] if active else OUTSIDE] += (b - a) / 1e6
    return dict(out)


def idle_pct(run, name: str):
    """Share (%) of the traced window in which the device idled inside the
    span ``name`` (innermost), or with none open (``OUTSIDE``)."""
    idle = idle_by_span(run)
    if idle is None or run.trace.window_s <= 0:
        return None
    return 100.0 * idle.get(name, 0.0) / run.trace.window_s
