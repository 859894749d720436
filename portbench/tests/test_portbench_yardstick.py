"""The yardstick on the CPU: the reference against a numpy brute force, the
data recipe, the roofline counts on a hand-worked example, the trace
arithmetic and the judge."""

import numpy as np
import pytest
import torch

from portbench import data, judge, roofline
from portbench import trace as trace_mod
from portbench.reference import exact_knn


def _rows(n=500, dim=48, q=37, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, dim, generator=g), torch.randn(q, dim, generator=g)


def test_exact_top_k_against_numpy_brute_force():
    rows, queries = _rows()
    ids, dists = exact_knn.top_k(rows, queries, 10)
    r, q = rows.double().numpy(), queries.double().numpy()
    full = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    want = np.argsort(full, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(ids.numpy(), want)
    np.testing.assert_allclose(dists.numpy(), np.take_along_axis(full, want, 1), rtol=1e-5)


def test_pair_distances_are_direct_sums():
    rows, queries = _rows(n=64, dim=8, q=5)
    ids = torch.tensor([[3, 7], [0, 63], [5, 5], [1, 2], [10, 11]])
    got = exact_knn.pair_distances(rows, queries, ids).numpy()
    want = ((queries[:, None, :] - rows[ids]) ** 2).sum(-1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_data_recipe_is_deterministic_by_seed():
    ds = {"rows": 300, "dim": 16, "centers": 8}
    seed = 3_000_000_019  # beyond 32 signed bits
    a = data.blobs(ds, 20, data.generator(seed, torch.device("cpu")), torch.device("cpu"))
    b = data.blobs(ds, 20, data.generator(seed, torch.device("cpu")), torch.device("cpu"))
    c = data.blobs(ds, 20, data.generator(seed + 1, torch.device("cpu")), torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (300, 16) and a[1].shape == (20, 16)


def test_roofline_counts_a_hand_worked_block():
    # clusters of 10, 20 and 30 rows; query 0 probes 0 and 1, query 1 probes 1 and 2
    sizes = np.array([10, 20, 30])
    probes = np.array([[0, 1], [1, 2]])
    n_bytes, ops = roofline.block_work(probes, sizes, dim=64, code_bits=7, factor_bytes=8,
                                       query_bytes=256, k=10)
    # 60 distinct rows x (64 * 7 / 8 + 8) bytes + 2 queries x (256 + 10 x 8) bytes
    assert n_bytes == 60 * (56 + 8) + 2 * (256 + 80)
    # (10 + 20) + (20 + 30) probed pairs x 2 x 64
    assert ops == 80 * 2 * 64
    assert roofline.least_seconds(n_bytes, ops, "int8_tensor") == pytest.approx(
        max(n_bytes / 3.35e12, ops / 1979e12))
    assert roofline.least_seconds(3.35e12, 0, "f32") == pytest.approx(1.0)


def test_cluster_means_and_probes():
    rows = torch.tensor([[0.0, 0.0], [2.0, 0.0], [10.0, 10.0], [12.0, 10.0], [100.0, 0.0]])
    means, sizes = roofline.cluster_means(rows, np.array([0, 1, 2, 3, 4]),
                                          np.array([0, 0, 1, 1, 2]), 4)
    np.testing.assert_allclose(means[:3].numpy(), [[1, 0], [11, 10], [100, 0]])
    assert sizes.tolist() == [2, 2, 1, 0] and torch.isinf(means[3]).all()
    p = roofline.probes(torch.tensor([[1.0, 1.0], [90.0, 0.0]]), means, 2)
    assert p.tolist() == [[0, 1], [2, 1]]


def test_trace_arithmetic():
    t = trace_mod.Trace(
        window_s=10e-6, span=(0.0, 10.0),
        device=[(1.0, 3.0, "k"), (2.0, 4.0, "copy"), (6.0, 7.0, "k")],
        host=[(0.0, 10.0, "outer"), (4.5, 5.5, "aten::pin_memory"), (7.0, 8.0, "aten::cat")])
    assert trace_mod.merged(t.device) == [[1.0, 4.0], [6.0, 7.0]]
    assert trace_mod.busy_s(t) == pytest.approx(4e-6)
    assert trace_mod.idle_pct(t) == pytest.approx(60.0)
    assert trace_mod.device_ops(t) == pytest.approx({"k": 3e-6, "copy": 2e-6})
    gaps = trace_mod.idle_gaps(t)
    assert gaps == pytest.approx({"outer": 4e-6, "aten::pin_memory": 2e-6})
    t.host = [(4.2, 4.4, "aten::copy_")]
    assert trace_mod.idle_gaps(t) == pytest.approx(
        {"before any host operator": 1e-6, "after aten::copy_": 5e-6})
    assert trace_mod.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0], ["c", 2.0]]
    assert trace_mod.idle_pct(None) is None


def test_judge_numbers():
    rows, queries = _rows(n=200, dim=16, q=6)
    gt_ids, gt_d = exact_knn.top_k(rows, queries, 10)
    good = judge.Group(np.arange(6), gt_ids.numpy(), gt_d.numpy(), weight=3)
    n = judge.measure(rows, queries, [good], 10, failed=0)
    assert n["recall_at_10"] == 1.0 and n["bad_answers"] == 0
    assert n["dist_gap_mean"] < 1e-6 and n["dist_gap_max"] < 1e-6
    ids = gt_ids.numpy().copy()
    ids[0, 0] = (ids[0, 0] + 1) % 200  # an altered id keeps its old distance
    n = judge.measure(rows, queries, [judge.Group(np.arange(6), ids, gt_d.numpy())], 10, 0)
    assert n["recall_at_10"] < 1.0 and n["dist_gap_max"] > 0.01
    half = gt_ids.numpy().copy()
    half[3:] = -1
    n = judge.measure(rows, queries, [judge.Group(np.arange(6), half, gt_d.numpy())], 10, 0)
    assert n["bad_answers"] == 3 and n["recall_at_10"] == pytest.approx(0.5)
    unsorted = gt_d.numpy()[:, ::-1].copy()
    assert not judge.well_formed(gt_ids.numpy(), unsorted, 200, 10).any()
    dup = gt_ids.numpy().copy()
    dup[:, 1] = dup[:, 0]
    assert not judge.well_formed(dup, gt_d.numpy(), 200, 10).any()
    checks = judge.checks({"recall_at_10": 0.96, "failed": 1},
                          {"recall_at_10": {"min": 0.95}, "failed": {"max": 0}})
    assert checks["recall_at_10"]["ok"] and not checks["failed"]["ok"]
