"""The port's brute-force index against the JAX package's, on the CPU.

Both build from the same seeded numpy data. Codes: bits equal; ex codes
equal on >= 99.9% of entries and off by <= 1 elsewhere (an f32 sum in
another order can move a coordinate across a level, as in
``tests/test_torch_quantize.py``); factors rtol 1e-5 on the rows whose
codes are equal. Searches compared for equal ids and scores (rtol 1e-5, atol 1e-3:
distances of ~1e2 that cancel through the L2 shift) run the f32
configuration with exact selection (scores of the rows whose codes are
equal). The "packed" scan runs the packed
lower-bound kernel's plain version at one cluster in the port and
``packed_lb_scan`` in interpret mode in the JAX package; their survivor
sets come from bf16 planes, so there the top-10 lists must agree on >= 9
ids a query and >= 0.98 on average. An index given a host by assignment
(the JAX package's ``host`` is a plain attribute) serves as the JAX index.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import rabitq_tpu as jr
import rabitq_tpu.ops.quantize as jq
import rabitq_tpu_torch as tr
from rabitq_tpu_torch.index import brute_force as tbf
from rabitq_tpu_torch.index import scan as tscan
from rabitq_tpu_torch.ops.rotation import deserialize_rotator

N, DIM = 1000, 64
FIELDS = ("delta", "vl", "f_add", "f_rescale", "f_error", "residual_norm", "f_add_ex",
          "f_rescale_ex")


def _data():
    return np.random.default_rng(11).standard_normal((N, DIM)).astype(np.float32)


def _pair(metric, faster, monkeypatch, total_bits=7):
    if faster:
        # the constant t comes from an argmax over a grid that may tie
        # differently in the two packages; hold it equal
        monkeypatch.setattr(
            tbf, "compute_const_scaling_factor",
            lambda dim, ex_bits, seed, device: jq.compute_const_scaling_factor(dim, ex_bits, seed),
        )
    data = _data()
    kw = dict(total_bits=total_bits, seed=3, use_faster_config=faster, scan_dtype="f32")
    j = jr.BruteForceRabitqIndex.train(data, metric=jr.Metric.from_str(metric), **kw)
    t = tr.BruteForceRabitqIndex.train(data, metric=tr.Metric.from_str(metric), device="cpu", **kw)
    return data, j, t


def _hits(hits):
    return [[h.id for h in r] for r in hits], [[h.score for h in r] for r in hits]


@pytest.mark.parametrize("faster", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_codes_and_search_match_jax(metric, faster, monkeypatch):
    """Codes equal; ids and reported scores equal, L2 scores with the
    reference's ||q||^2 shift (``brute_force.rs:571``)."""
    data, j, t = _pair(metric, faster, monkeypatch)
    jh, th = j.host, t.host
    np.testing.assert_array_equal(th.binary_bits, jh.binary_bits)
    ex_t, ex_j = th.ex_codes.astype(np.int64), jh.ex_codes.astype(np.int64)
    assert np.mean(ex_t == ex_j) >= 0.999 and np.abs(ex_t - ex_j).max() <= 1
    same = (ex_t == ex_j).all(axis=1)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(th, f)[same], getattr(jh, f)[same], rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    queries = data[:12] + 0.1
    j_ids, j_s = _hits(j.batch_search(queries, jr.BruteForceSearchParams(top_k=10)))
    t_ids, t_s = _hits(t.batch_search(queries, tr.BruteForceSearchParams(top_k=10)))
    assert t_ids == j_ids
    kept = same[np.array(t_ids)]  # a moved code legitimately moves its row's score
    np.testing.assert_allclose(np.array(t_s)[kept], np.array(j_s)[kept], rtol=1e-5, atol=1e-3)
    if metric == "l2":
        # the scores are ||v - q||^2 - ||q||^2 estimates: near the true ones
        true = ((data[t_ids[0]] - queries[0]) ** 2).sum(1) - (queries[0] ** 2).sum()
        np.testing.assert_allclose(t_s[0], true, rtol=0.05, atol=5.0)
    assert t.search(queries[3], tr.BruteForceSearchParams(top_k=10))[0].id == t_ids[3][0]
    assert t.batch_search(queries, tr.BruteForceSearchParams(top_k=0)) == [[]] * 12


def test_filtered_search_matches_jax(monkeypatch):
    data, j, t = _pair("l2", False, monkeypatch)
    params = (tr.BruteForceSearchParams(top_k=8), jr.BruteForceSearchParams(top_k=8))
    even = np.arange(0, N, 2)
    mask = np.zeros(N, bool)
    mask[::3] = True
    for allowed in (even, mask, np.array([5, 17, N + 40, -1])):
        t_ids = [h.id for h in t.search_filtered(data[5], params[0], allowed)]
        j_ids = [h.id for h in j.search_filtered(data[5], params[1], allowed)]
        assert t_ids == j_ids
        ok = set(np.flatnonzero(allowed)) if allowed.dtype == bool else set(allowed.tolist())
        assert t_ids and set(t_ids) <= ok
    assert t_ids == [5, 17]


def test_fused_scan_dtypes_fall_back_to_bf16(monkeypatch):
    data, j, t = _pair("l2", True, monkeypatch)
    for sd in ("fused", "fused8"):
        j.scan_dtype = t.scan_dtype = sd
        t_ids, _ = _hits(t.batch_search(data[:6], tr.BruteForceSearchParams(top_k=5)))
        j_ids, _ = _hits(j.batch_search(data[:6], jr.BruteForceSearchParams(top_k=5)))
        assert t.scan_dtype == j.scan_dtype == "bf16"
        assert [r[0] for r in t_ids] == list(range(6))
        assert np.mean([len(set(a) & set(b)) for a, b in zip(t_ids, j_ids)]) >= 4.9


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_packed_scan_matches_jax(metric, monkeypatch):
    """"packed" builds the bit planes and runs the packed lower-bound scan
    over every row at one cluster (the port: ``packed_lb_plane`` with a
    [B, 1] g table, all rows in cluster 0)."""
    data, j, t = _pair(metric, True, monkeypatch)
    j.scan_dtype = t.scan_dtype = "packed"
    calls = []
    real = tscan.packed_lb_plane

    def spy(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(tscan, "packed_lb_plane", spy)
    queries = data[:24] + 0.05
    t_ids, _ = _hits(t.batch_search(queries, tr.BruteForceSearchParams(top_k=10)))
    j_ids, _ = _hits(j.batch_search(queries, jr.BruteForceSearchParams(top_k=10)))
    g_add, cluster_of, probe = calls[0][5], calls[0][8], calls[0][9]
    assert g_add.shape == (32, 1) and bool((cluster_of == 0).all()) and bool(probe.all())
    assert t._packed is not None and t._packed.shape[1] == 128
    overlaps = [len(set(a) & set(b)) / 10 for a, b in zip(t_ids, j_ids)]
    assert min(overlaps) >= 0.9 and np.mean(overlaps) >= 0.98, overlaps


def test_host_assignment_matches_jax():
    """The JAX package's ``host`` is a plain attribute. A port index made in
    the JAX shape with no codes, then given the JAX index's host, lays
    itself out from it at its first search and returns the JAX index's ids
    and scores (f32, exact selection). A later assignment leaves the built
    layout alone, as the JAX attribute does."""
    data = _data()[:400]
    j = jr.BruteForceRabitqIndex.train(data, total_bits=7, seed=3, scan_dtype="f32")
    rotator = deserialize_rotator(j.dim, j.padded_dim, tr.RotatorType(int(
        j.rotator.rotator_type)), j.rotator.serialize())
    t = tr.BruteForceRabitqIndex(j.dim, j.padded_dim, tr.Metric.L2, rotator, j.ex_bits,
                                 None, "f32", device="cpu")
    assert len(t) == 0
    t.host = tbf.BruteForceHost(**{f.name: np.array(getattr(j.host, f.name))
                                   for f in dataclasses.fields(j.host)})
    assert len(t) == len(j) == 400 and t._layout is None
    queries = data[:16] + 0.1
    j_ids, j_s = _hits(j.batch_search(queries, jr.BruteForceSearchParams(top_k=10)))
    t_ids, t_s = _hits(t.batch_search(queries, tr.BruteForceSearchParams(top_k=10)))
    assert t_ids == j_ids
    np.testing.assert_allclose(t_s, j_s, rtol=1e-5, atol=1e-3)
    layout = t.layout
    t.host = dataclasses.replace(t.host, vl=t.host.vl * 2)
    assert t.layout is layout


def test_input_errors():
    data = _data()[:300]
    with pytest.raises(tr.InvalidConfig):
        tr.BruteForceRabitqIndex.train(data, total_bits=0, device="cpu")
    with pytest.raises(tr.InvalidConfig):
        tr.BruteForceRabitqIndex.train(data[:0], total_bits=7, device="cpu")
    t = tr.BruteForceRabitqIndex.train(data, total_bits=1, device="cpu")
    assert len(t) == 300 and t.search(data[4], tr.BruteForceSearchParams(top_k=3))[0].id == 4
    with pytest.raises(tr.DimensionMismatch):
        t.search(data[0, :10], tr.BruteForceSearchParams(top_k=3))
