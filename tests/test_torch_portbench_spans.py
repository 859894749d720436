"""The benchmark's readings of the port's spans (``portbench/spans.py`` and
its metrics) in a traced rehearsal of each cell on the CPU, through
``portbench/run.py``: every metric that reads the spans, the build report or
the capture count reports a finite value; those that read the device trace
report none, since the CPU has no device trace."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import spec

ROOT = Path(__file__).resolve().parent.parent
SPAN_METRICS = {"encode_ms_per_kq", "idle_encode_pct.batch", "idle_outside_pct.batch",
                "dispatch_us.single", "idle_outside_pct.single", "graph_captures", "lloyd_s"}


@pytest.mark.parametrize("cell", ["gist1m-ivf7.batch", "gist1m-ivf8.batch", "gist1m-ivf7.single",
                                  "gist1m-ivf7.build"])
def test_traced_rehearsal_reads_the_span_metrics(cell):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", "3000000019",
         "--seconds", "0.5", "--trace", "1", "--rehearse"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    mine = [m for m in spec.load_cell(cell).per_layer if m["name"] in SPAN_METRICS]
    assert mine
    for m in mine:
        if m["source"] == "device_trace":
            assert m["name"] not in result["metrics"], m["name"]
        else:
            assert math.isfinite(result["metrics"][m["name"]]["value"]), m["name"]
    if "graph_captures" in result["metrics"]:
        assert result["metrics"]["graph_captures"]["value"] == 0
    if cell.endswith(".batch"):
        assert result["metrics"]["encode_ms_per_kq"]["value"] > 0
    if cell.endswith(".single"):
        assert result["metrics"]["dispatch_us.single"]["value"] > 0
