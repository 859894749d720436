"""The one traffic generator: a closed loop of one client.

A mix (``traffic/<mix>.json``) names its kind of call (``call``:
``calls/<call>.py``), how many query sets it cycles (``query_sets``) and how
many calls its traced sub-window makes (``traced_calls``). The client sends
the next call when the last returns; the window ends with the first call
that ends after the run's seconds.
"""

from __future__ import annotations

import sys
import time
import traceback
from dataclasses import dataclass, field

from portbench import trace as trace_mod


@dataclass
class Window:
    start: float
    end: float = 0.0
    calls: list = field(default_factory=list)  # (t0, t1, requests, ok) per call

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def answered(self) -> int:
        return sum(r for _, _, r, ok in self.calls if ok)

    @property
    def attempted(self) -> int:
        return sum(r for _, _, r, _ in self.calls)

    @property
    def latencies_s(self) -> list:
        return [t1 - t0 for t0, t1, _, ok in self.calls if ok]

    def summary(self, parts: int = 5) -> str:
        """One line: calls, call-time median and mean, and the rate in each
        of ``parts`` equal stretches of the window (host clock)."""
        lat = sorted(self.latencies_s) or [0.0]
        edges = [self.start + self.seconds * j / parts for j in range(parts + 1)]
        rates = []
        for a, b in zip(edges, edges[1:]):
            done = sum(r for _, t1, r, ok in self.calls if ok and a < t1 <= b)
            rates.append(round(done / (b - a), 1))
        return (f"window: {len(self.calls)} calls in {self.seconds:.3f} s; call ms median "
                f"{1e3 * lat[len(lat) // 2]:.3f} mean {1e3 * sum(lat) / len(lat):.3f}; "
                f"rate by fifths {rates}")


def one_call(calls, i: int) -> bool:
    """``calls(i)``; a call that raises is a failed request, reported on
    standard error, and the loop goes on."""
    try:
        calls(i)
        return True
    except Exception:  # noqa: BLE001 - the loop must keep running; counted as failed
        traceback.print_exc(file=sys.stderr)
        return False


def closed_loop(calls, seconds: float) -> Window:
    """Call ``calls(0)``, ``calls(1)``, ... back to back for ``seconds``."""
    w = Window(time.perf_counter())
    i = 0
    while True:
        t0 = time.perf_counter()
        ok = one_call(calls, i)
        t1 = time.perf_counter()
        w.calls.append((t0, t1, calls.requests, ok))
        i += 1
        if t1 - w.start >= seconds:
            w.end = t1
            return w


def traced(calls, n: int, first: int, device) -> tuple[trace_mod.Trace, Window]:
    """``n`` calls from index ``first`` under the profiler."""
    w = Window(time.perf_counter())

    def run():
        for i in range(first, first + n):
            t0 = time.perf_counter()
            ok = one_call(calls, i)
            w.calls.append((t0, time.perf_counter(), calls.requests, ok))
        return sum(r for *_, r, ok in w.calls if ok)

    tr = trace_mod.record(run, device)
    w.end = time.perf_counter()
    tr.blocks = [b for i in range(first, first + n) for b in calls.blocks(i)]
    return tr, w
