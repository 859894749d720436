"""The gather scan and the environment switches of the IVF search, against
the JAX package on the CPU.

A JAX index (4000 x 64, nlist 64, 7 bits, fused8) is carried into the port
with ``from_host_arrays``; with ``RABITQ_GATHER=1`` both packages score
every probed row exactly through a row gather, the query rounded to bf16
and the codes exact, so ids must be equal and distances agree to rtol 1e-5
(atol 1e-3: f32 sums in another order). Each of the JAX package's five
switches (``RABITQ_FUSED_EXACT``, ``RABITQ_FUSED_COMPACT``,
``RABITQ_LOCALITY``, ``RABITQ_GATHER``, ``RABITQ_GATHER_MAX``), set with
monkeypatch, must send both packages down the same path to equal ids.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import rabitq_tpu as jr
import rabitq_tpu.index.scan as jscan
import rabitq_tpu_torch as tr
import rabitq_tpu_torch.index.scan as tscan

N, DIM, NLIST = 4000, 64, 64
SWITCHES = ("RABITQ_FUSED_EXACT", "RABITQ_FUSED_COMPACT", "RABITQ_LOCALITY", "RABITQ_GATHER",
            "RABITQ_GATHER_MAX")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


def _carry(jidx, scan_dtype="fused8") -> tr.IvfRabitqIndex:
    h = jidx.host
    return tr.IvfRabitqIndex.from_host_arrays(
        dim=jidx.dim, padded_dim=jidx.padded_dim,
        metric=tr.Metric.from_str(jidx.metric.value), ex_bits=jidx.ex_bits,
        rotator_type=tr.RotatorType(int(jidx.rotator.rotator_type)),
        rotator_bytes=jidx.rotator.serialize(),
        binary_bits=h.binary_bits, ex_codes=h.ex_codes, f_add=h.f_add,
        f_rescale=h.f_rescale, f_error=h.f_error, f_add_ex=h.f_add_ex,
        f_rescale_ex=h.f_rescale_ex, delta=h.delta, vl=h.vl, ids=h.ids,
        cluster_offsets=h.cluster_offsets, centroids=h.centroids,
        scan_dtype=scan_dtype, device="cpu",
    )


_PAIRS: dict = {}


def _pair(metric: str):
    """(data, JAX index, the port's carried copy), built once a metric."""
    if metric not in _PAIRS:
        data = np.random.default_rng(0).standard_normal((N, DIM)).astype(np.float32)
        jidx = jr.IvfRabitqIndex.train(
            data, nlist=NLIST, total_bits=7, metric=jr.Metric.from_str(metric), seed=3,
            scan_dtype="fused8",
        )
        _PAIRS[metric] = (data, jidx, _carry(jidx))
    return _PAIRS[metric]


@pytest.fixture(params=["l2", "ip"])
def pair(request):
    return _pair(request.param)


@pytest.fixture
def l2_pair():
    return _pair("l2")


def _search(jidx, tidx, queries, top_k, nprobe, filter_ids=None):
    """Both packages' (ids, dists) on fresh per-call caches (the JAX
    package caches gate decisions that the switches change)."""
    jidx._max_tiles_cache = {}
    jidx._gather_cache = {}
    j = jidx.batch_search_arrays(queries, jr.SearchParams(top_k, nprobe), filter_ids)
    t = tidx.batch_search_arrays(queries, tr.SearchParams(top_k, nprobe), filter_ids)
    return j, t


def _assert_same(j, t):
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_allclose(t[1], j[1], rtol=1e-5, atol=1e-3)


def test_budget_helpers_match_jax():
    for sizes in ([100, 50, 200, 10], [0, 0, 3], np.random.default_rng(1).integers(0, 900, 40)):
        for nprobe in (1, 2, 4, 7, 100):
            assert tscan.gather_rows_bound(sizes, nprobe) == jscan.gather_rows_bound(sizes, nprobe)
            assert tscan.gather_budget_bucket(sizes, nprobe) == jscan.gather_budget_bucket(
                sizes, nprobe)
    assert tscan.gather_budget_bucket([100, 50, 200, 10], 2) == 512
    assert tscan.gather_budget_bucket([0, 0], 1) is None
    assert tscan.gather_budget_bucket([5, 5], torch.tensor(1)) is None  # no integer nprobe


def test_gather_matches_jax(pair, monkeypatch):
    data, jidx, tidx = pair
    monkeypatch.setenv("RABITQ_GATHER", "1")
    assert tidx._plan.gather_rows(tidx.scan_dtype, 4) == jidx._gather_budget(4) == 512
    _assert_same(*_search(jidx, tidx, data[:32] + 0.01, 10, 4))
    # the gather scan, not the bin scan, served the port's search
    calls = []
    real = tscan._gather_scan
    monkeypatch.setattr(tscan, "_gather_scan", lambda *a, **k: calls.append(k) or real(*a, **k))
    tidx.search(data[0], tr.SearchParams(10, 4))
    assert calls and calls[0]["gather_rows"] == 512


def test_gather_filtered_search(pair, monkeypatch):
    data, jidx, tidx = pair
    monkeypatch.setenv("RABITQ_GATHER", "1")
    even = np.arange(0, N, 2)
    j, t = _search(jidx, tidx, data[:4], 10, 10, filter_ids=even)
    _assert_same(j, t)
    assert np.all(t[0] % 2 == 0) and t[0][0, 0] == 0 and t[0][2, 0] == 2


def test_gather_gate_declines_where_jax_declines(l2_pair, monkeypatch):
    data, jidx, tidx = l2_pair

    def decisions():
        jidx._gather_cache = {}
        return [(tidx._plan.gather_rows(tidx.scan_dtype, p), jidx._gather_budget(p))
                for p in (1, 4, 16, 40)]

    assert all(t is None and j is None for t, j in decisions())  # opt-in
    monkeypatch.setenv("RABITQ_GATHER", "1")
    got = decisions()
    assert all(t == j for t, j in got) and got[1][0] is not None
    assert got[3] == (None, None)  # half the rows and more
    monkeypatch.setenv("RABITQ_GATHER_MAX", "256")
    got = decisions()
    assert all(t == j for t, j in got) and got[1] == (None, None)
    monkeypatch.delenv("RABITQ_GATHER_MAX")
    tidx.scan_dtype = jidx.scan_dtype = "bf16"  # a permuted layout: no gather
    try:
        assert decisions() == [(None, None)] * 4
    finally:
        tidx.scan_dtype = jidx.scan_dtype = "fused8"
    wide = tr.IvfRabitqIndex.train(data[:1500], nlist=16, total_bits=8, seed=3,
                                   scan_dtype="fused8", device="cpu")
    assert wide._plan.gather_rows(wide.scan_dtype, 4) is None  # raw ex codes: no TOTAL plane


def test_gather_single_query_and_batch_agree(l2_pair, monkeypatch):
    data, _, tidx = l2_pair
    monkeypatch.setenv("RABITQ_GATHER", "1")
    params = tr.SearchParams(top_k=5, nprobe=4)
    batch = tidx.batch_search(data[:6], params)
    for qi in range(6):
        assert [h.id for h in tidx.search(data[qi], params)] == [h.id for h in batch[qi]]
    # diagnostics take the two-stage scan as the JAX package's do: its
    # survivor cut skips rows, which the gather scan never does
    _, diag = tidx.search_with_diagnostics(data[0], tr.SearchParams(5, 16, rerank=20))
    assert diag.skipped_by_lower_bound > 0


@pytest.mark.parametrize("env", [
    {"RABITQ_FUSED_EXACT": "0"},
    {"RABITQ_FUSED_COMPACT": "0"},
    {"RABITQ_FUSED_COMPACT": "force"},
    {"RABITQ_LOCALITY": "2"},
    {"RABITQ_GATHER": "1"},
    {"RABITQ_GATHER": "1", "RABITQ_GATHER_MAX": "256"},
], ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items()))
def test_switches_take_the_jax_path(l2_pair, monkeypatch, env):
    data, jidx, tidx = l2_pair
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jidx._max_tiles_cache = {}
    jidx._gather_cache = {}
    nprobe = 4
    plan = tidx._plan
    assert plan.fused_exact(tidx.scan_dtype) == jidx._fused_exact_ok()
    assert plan.gather_rows(tidx.scan_dtype, nprobe) == jidx._gather_budget(nprobe)
    for batch in (1, 16):
        t_tiles = plan.max_tiles(tidx.scan_dtype, nprobe)
        j_tiles = jidx._fused_max_tiles(nprobe, batch)
        assert (t_tiles is None) == (j_tiles is None)
        if env.get("RABITQ_FUSED_COMPACT") == "force":
            assert t_tiles == j_tiles == 8  # every 512-row tile of 4000 rows
    seen = []
    # the index's fused search calls the scan module's scan_kernel
    real = tscan.scan_kernel
    monkeypatch.setattr(tscan, "scan_kernel", lambda *a, **k: seen.append(k) or real(*a, **k))
    j, t = _search(jidx, tidx, data[:16] + 0.01, 10, nprobe)
    assert seen[0]["locality_depth"] == int(env.get("RABITQ_LOCALITY", "1"))
    assert seen[0]["fused_exact"] == (env.get("RABITQ_FUSED_EXACT") != "0")
    _assert_same(j, t)
