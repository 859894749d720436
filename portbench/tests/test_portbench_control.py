"""The comparison that decides ``correct``, shown to fail: the control (the
program with int4 query uploads in place of int8) and the faults a cell can
have, planted under a run on the CPU at the configurations' rehearsal
sizes. The run's look for a card is skipped (``device`` is the CPU); the
rest of the run is the benchmark's own."""

import copy
import time
import types

import numpy as np
import pytest
import torch

from portbench import harness, spec
from portbench.limits import control_config

CPU = torch.device("cpu")


def run(cell_name, seed=5, seconds=0.5, program=None, config=None, monkeypatch=None,
        device=CPU):
    cell = spec.load_cell(cell_name)
    if config is not None:
        cell = copy.copy(cell)
        cell.config = config
    if program is not None:
        monkeypatch.setattr(spec, "program_kind", lambda kind, bench_dir=None: program)
    return harness.run_cell(cell, seed, seconds, False, device, time.perf_counter())


def planted(**overrides):
    """The IVF program module with some of its calls replaced."""
    real = spec.program_kind("ivf")
    ns = types.SimpleNamespace(**{k: getattr(real, k) for k in dir(real) if not k.startswith("__")})
    for name, make in overrides.items():
        setattr(ns, name, make(getattr(real, name)))
    return ns


@pytest.mark.parametrize("cell", ["gist1m-ivf7.batch", "gist1m-ivf8.batch"])
def test_program_passes_and_control_fails(cell):
    sound = run(cell, seed=11)
    assert sound["correct"], sound["checks"]
    config = control_config(spec.load_cell(cell).config)
    assert config["serving"]["upload_dtype"] == "int4"
    control = run(cell, seed=11, config=config)
    assert not control["correct"]
    assert not control["checks"]["dist_gap_mean"]["ok"]


def _alter_batch(real):
    def batch(index, config, queries):
        ids, dists = real(index, config, queries)
        ids = ids.copy()
        ids[1, 0] = (ids[1, 0] + len(index) // 2) % len(index)
        return ids, dists
    return batch


def _half_batch(real):
    def batch(index, config, queries):
        ids, dists = real(index, config, queries)
        ids, dists = ids.copy(), dists.copy()
        ids[len(ids) // 2:], dists[len(ids) // 2:] = -1, np.inf
        return ids, dists
    return batch


def _alter_single(real):
    def single(index, config, query):
        res = list(real(index, config, query))
        res[0] = type(res[0])(id=(res[0].id + len(index) // 2) % len(index), score=res[0].score)
        return res
    return single


def _stale_build(real):
    built = []

    def build(config, rows, device):
        if not built:
            built.append(real(config, rows, device))
        return built[0]
    return build


@pytest.mark.parametrize("cell, fault", [
    ("gist1m-ivf7.batch", {"batch": _alter_batch}),
    ("gist1m-ivf8.batch", {"batch": _alter_batch}),
    ("gist1m-ivf7.batch", {"batch": _half_batch}),
    ("gist1m-ivf7.single", {"single": _alter_single}),
    ("gist1m-ivf7.build", {"batch": _alter_batch}),
    ("gist1m-ivf7.build", {"build": _stale_build}),
], ids=["answer-altered-7b", "answer-altered-8b", "half-left-out", "single-altered",
        "build-answer-altered", "build-state-unchanged"])
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    result = run(cell, program=planted(**fault), monkeypatch=monkeypatch)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
def test_program_and_control_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = spec.load_cell("gist1m-ivf7.batch")
    small = harness.rehearsal_config(cell.config)
    dev = torch.device("cuda", 0)
    assert run("gist1m-ivf7.batch", seed=21, config=small, device=dev)["correct"]
    assert not run("gist1m-ivf7.batch", seed=21, config=control_config(small), device=dev)["correct"]
