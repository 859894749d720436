"""The MSTG cell (``gist1m-mstg7.batch``, configuration ``mstg-gist1m-7b``,
``programs/mstg.py``) rehearsed on the CPU: through ``run.py`` traced and
untraced, its int4 control, and a planted altered id, which must each read
``correct`` false."""

import json
import types

import pytest

from portbench import spec
from portbench.limits import control_config

from test_portbench_control import run
from test_portbench_rehearsal import cli

CELL = "gist1m-mstg7.batch"
MSTG_METRICS = {"k1_roofline_pct.mstg", "rest_ms_per_kq.mstg", "device_idle_pct.mstg",
                "idle_outside_pct.mstg", "walk_tiles_pct.mstg"}


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_of_the_mstg_cell(trace):
    p = cli("--workload", CELL, "--seed", "3190000013", "--seconds", "0.5", "--trace", str(trace),
            "--rehearse")
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert result["device"]["platform"] == "cpu" and "breakdown" not in result
    c = spec.load_cell(CELL)
    assert {m["name"] for m in c.end_to_end} == {"qps", "recall_at_10", "setup_s"}
    assert {m["name"] for m in c.per_layer} == MSTG_METRICS
    if trace:
        # the CPU has no device trace: only the program's counter is read
        assert set(result["metrics"]) == {"walk_tiles_pct.mstg"}
        assert 0 < result["metrics"]["walk_tiles_pct.mstg"]["value"] <= 100
    else:
        assert set(result["metrics"]) == {"qps", "recall_at_10", "setup_s"}


def test_the_int4_control_is_not_correct():
    config = control_config(spec.load_cell(CELL).config)
    assert config["serving"]["upload_dtype"] == "int4"
    result = run(CELL, seed=13, config=config)
    assert not result["correct"]
    assert not result["checks"]["dist_gap_mean"]["ok"]


def test_a_planted_altered_id_is_not_correct(monkeypatch):
    real = spec.program_kind("mstg")
    ns = types.SimpleNamespace(**{k: getattr(real, k) for k in dir(real) if not k.startswith("__")})

    def batch(index, config, queries):
        ids, dists = real.batch(index, config, queries)
        ids = ids.copy()
        ids[1, 0] = (ids[1, 0] + len(index) // 2) % len(index)
        return ids, dists

    ns.batch = batch
    assert run(CELL, seed=13)["correct"]
    result = run(CELL, seed=13, program=ns, monkeypatch=monkeypatch)
    assert not result["correct"], result["checks"]
