"""The device trace of a bounded sub-window, and the arithmetic on it.

``torch.profiler`` records every kernel, copy and memset the device ran and
every operator the host ran. From them: the device's busy seconds (the union
of its intervals), device time by name, and the idle gaps, each named by
what the host was doing in it. The arithmetic is ``chip_smoke.py``'s
``profile_dispatches`` / ``device_rows``, with busy time taken as a union of
intervals rather than a sum, so that overlapping copies and kernels count
once.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

SPAN = "portbench.traced"  # the harness's span around the traced calls
PROFILER_OWN = ("Activity Buffer Request",)  # host events of the profiler itself


@dataclass
class Trace:
    window_s: float  # host clock, from the first traced call to the synchronised end
    span: tuple  # (start_us, end_us) of the traced calls on the profiler's clock
    device: list  # (start_us, end_us, name) of every device activity
    host: list  # (start_us, end_us, name) of every host operator
    requests: int = 0  # queries (or builds) the traced calls made
    blocks: list = field(default_factory=list)  # query indices of each scan block


def record(calls, device: torch.device) -> Trace:
    """Run ``calls()`` under the profiler; ``calls`` returns the requests it
    made."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        with record_function(SPAN):
            t0 = time.perf_counter()
            requests = calls()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t0
    dev, host, span = [], [], None
    for ev in prof.events():
        interval = (ev.time_range.start, ev.time_range.end, ev.name)
        if getattr(ev, "is_user_annotation", False) or ev.name == SPAN:
            # a span's shadow on the device's timeline is no device work
            if ev.name == SPAN and ev.device_type == DeviceType.CPU:
                span = interval[:2]
        elif ev.device_type == DeviceType.CUDA:
            dev.append(interval)
        elif ev.name not in PROFILER_OWN:
            host.append(interval)
    return Trace(window_s, span, dev, host, requests)


def merged(intervals) -> list:
    """Union of (start, end, ...) intervals as sorted disjoint (start, end)."""
    out = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(trace: Trace) -> float:
    """Seconds in which the device ran anything (0 without device events)."""
    return sum(e - s for s, e in merged(trace.device)) / 1e6


def device_ops(trace: Trace) -> dict:
    """{name: device seconds}, summed over launches."""
    out = defaultdict(float)
    for s, e, name in trace.device:
        out[name] += (e - s) / 1e6
    return dict(out)


def idle_gaps(trace: Trace) -> dict:
    """{what the host was doing: idle device seconds}: each gap between the
    device's busy intervals inside the traced span is named after the
    innermost host operator that covers its middle, or where none does,
    "after" the host operator that ended last before it."""
    if trace.span is None or not trace.device:
        return {}
    lo, hi = trace.span
    edges = [lo] + [x for iv in merged(trace.device) for x in iv] + [hi]
    host = sorted(trace.host)
    ended = sorted((e, name) for _, e, name in host)
    ends = [e for e, _ in ended]
    out = defaultdict(float)
    active, nxt = [], 0  # host operators begun, latest start last
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        while nxt < len(host) and host[nxt][0] <= mid:
            active.append(host[nxt])
            nxt += 1
        while active and active[-1][1] < mid:
            active.pop()
        if active:
            name = active[-1][2]
        else:
            j = bisect.bisect_right(ends, mid) - 1
            name = f"after {ended[j][1]}" if j >= 0 else "before any host operator"
        out[name] += (b - a) / 1e6
    return dict(out)


def top(d: dict, n: int = 10) -> list:
    return [[name, sec] for name, sec in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def idle_pct(trace: Trace | None):
    """Share (%) of the traced window in which the device ran nothing; None
    without device events."""
    if trace is None or not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s(trace) / trace.window_s)
