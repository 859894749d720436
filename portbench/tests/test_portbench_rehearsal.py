"""Each traffic driver rehearsed on the CPU through ``run.py``, at the
configurations' rehearsal sizes, through the program's plain versions of its
kernels; and the runs that must print no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import spec

ROOT = spec.ROOT


def cli(*args, cwd=ROOT, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("cell, trace", [
    ("gist1m-ivf7.batch", 0), ("gist1m-ivf8.batch", 1), ("gist1m-ivf7.single", 0),
    ("gist1m-ivf7.single", 1), ("gist1m-ivf7.build", 0), ("gist1m-ivf7.build", 1)])
def test_rehearsal_on_the_cpu(cell, trace):
    p = cli("--workload", cell, "--seed", "2147483659", "--seconds", "0.5", "--trace", str(trace),
            "--rehearse")
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert result["device"] == {"platform": "cpu", "kind": "cpu", "count": 0,
                                "memory_peak_bytes": None}
    assert "breakdown" not in result
    c = spec.load_cell(cell)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    device_metrics = {m["name"] for m in c.per_layer if m["source"] == "device_trace"}
    assert set(result["metrics"]) <= want and not set(result["metrics"]) & device_metrics
    if not trace:
        assert set(result["metrics"]) == want
    tail = p.stderr.strip().splitlines()[-len(result["checks"]):]
    assert [line.split(":")[0] for line in tail] == [f"check {n}" for n in result["checks"]]


def test_no_card_means_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = cli("--workload", "gist1m-ivf7.batch", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert p.returncode == 2 and p.stdout == ""


def test_benchmark_files_alone_print_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = cli("--workload", "gist1m-ivf7.batch", "--seed", "1", "--seconds", "1", "--trace", "0",
            "--rehearse", cwd=tmp_path)
    assert p.returncode != 0 and p.stdout == ""
