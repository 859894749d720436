"""Estimator, quantizer and code building of the port against the JAX
package on the CPU, from the same numpy inputs.

Tolerances: estimator terms rtol 1e-5; binary codes equal; ex codes equal
on >= 99.9% of entries and off by <= 1 elsewhere (f32 sums in another order
can move a coordinate across a level); the factors rtol 1e-4 on every row
whose codes are equal (a moved code legitimately moves its row's factors).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabitq_tpu.index import build as jbuild
from rabitq_tpu.ops import estimator as jest
from rabitq_tpu.ops import quantize as jq
from rabitq_tpu.ops.rotation import FhtKacRotator as JRot
from rabitq_tpu.types import Metric as JMetric
from rabitq_tpu_torch.index import build as tbuild
from rabitq_tpu_torch.ops import estimator as tes
from rabitq_tpu_torch.ops import quantize as tq
from rabitq_tpu_torch.ops.rotation import FhtKacRotator as TRot
from rabitq_tpu_torch.types import Metric as TMetric

FACTORS = ("f_add", "f_rescale", "f_error", "f_add_ex", "f_rescale_ex", "delta", "vl")


def _metrics(name):
    return JMetric.from_str(name), TMetric.from_str(name)


def _check_codes(t, j):
    np.testing.assert_array_equal(t["binary"], j["binary"])
    ex_t, ex_j = t["ex"].astype(np.int64), j["ex"].astype(np.int64)
    assert np.mean(ex_t == ex_j) >= 0.999
    assert np.abs(ex_t - ex_j).max() <= 1
    same = (ex_t == ex_j).all(axis=1)
    assert same.mean() >= 0.9
    for name in FACTORS:
        np.testing.assert_allclose(
            t[name][same], j[name][same], rtol=1e-4, atol=1e-4, err_msg=name
        )


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_estimator_terms_match_jax(metric):
    jm, tm = _metrics(metric)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((9, 64)).astype(np.float32)
    c = rng.standard_normal((13, 64)).astype(np.float32)
    jc = jest.query_constants(jnp.asarray(q), 6)
    tc = tes.query_constants(torch.from_numpy(q), 6)
    for a, b in zip(tc[:3], jc[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    assert tc.binary_scale == jc.binary_scale
    for a, b in zip(tes.g_terms(torch.from_numpy(q), torch.from_numpy(c), tm),
                    jest.g_terms(jnp.asarray(q), jnp.asarray(c), jm)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)
    args = [rng.standard_normal((4, 5)).astype(np.float32) for _ in range(6)]
    np.testing.assert_allclose(
        tes.est_extended(*map(torch.from_numpy, args[:5]), 64.0, torch.from_numpy(args[5])).numpy(),
        np.asarray(jest.est_extended(*map(jnp.asarray, args[:5]), 64.0, jnp.asarray(args[5]))),
        rtol=1e-5,
    )


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("t_const", [1.7, 9.0])
def test_quantize_block_matches_jax(metric, t_const):
    jm, tm = _metrics(metric)
    rng = np.random.default_rng(2)
    data = rng.standard_normal((300, 128)).astype(np.float32)
    cents = (0.3 * rng.standard_normal((300, 128))).astype(np.float32)
    kw = dict(t_const=t_const, use_t_const=True)
    j = jq.quantize_block(jnp.asarray(data), jnp.asarray(cents), 6, jm, **kw)
    t = tq.quantize_block(torch.from_numpy(data), torch.from_numpy(cents), 6, tm, **kw)
    _check_codes(
        {k: getattr(t, k).numpy() for k in ("binary", "ex") + FACTORS},
        {k: np.asarray(getattr(j, k)) for k in ("binary", "ex") + FACTORS},
    )


def _objective(o, t, ex_bits):
    c = np.clip(np.floor(t[:, None] * o + 1e-5), 0, (1 << ex_bits) - 1)
    return ((c + 0.5) * o).sum(1) / np.sqrt(0.25 * o.shape[1] + (c * c + c).sum(1))


def test_rescale_factors_match_jax():
    assert tq.compute_const_scaling_factor(128, 6, 42, device="cpu") == pytest.approx(
        jq.compute_const_scaling_factor(128, 6, 42), rel=1e-3
    )
    o = np.abs(np.random.default_rng(3).standard_normal((50, 64)))
    o = (o / np.linalg.norm(o, axis=1, keepdims=True)).astype(np.float32)
    np.testing.assert_array_equal(
        tq.best_rescale_factor_exact(o, 6), jq.best_rescale_factor_exact(o, 6)
    )
    # the grid search's argmax may pick another of two grid points whose
    # objectives tie to f32 rounding: most rows agree, all are optimal
    t_t = tq.grid_best_t(torch.from_numpy(o), 6).numpy()
    t_j = np.asarray(jq.grid_best_t(jnp.asarray(o), 6))
    assert np.mean(np.isclose(t_t, t_j, rtol=1e-5)) >= 0.9
    o64 = o.astype(np.float64)
    np.testing.assert_allclose(_objective(o64, t_t, 6), _objective(o64, t_j, 6), rtol=1e-5)


@pytest.mark.parametrize("exact_t", [False, True])
def test_build_codes_match_jax(exact_t):
    """Same centroids and assignments -> the same codes, in the faster
    (constant t) mode and the exact per-row t mode."""
    rng = np.random.default_rng(4)
    dim, n, c = 96, 700, 12
    data = rng.standard_normal((n, dim)).astype(np.float32)
    cents = rng.standard_normal((c, dim)).astype(np.float32) * 0.5
    assign = rng.integers(0, c, n)
    order = np.argsort(assign, kind="stable")
    jrot = JRot(dim, seed=5)
    trot = TRot(dim, seed=5)
    rc_j = np.asarray(jrot.rotate(jnp.asarray(cents)))
    rc_t = trot.rotate(torch.from_numpy(cents))
    kw = dict(ex_bits=6, metric=JMetric.L2, use_t_const=not exact_t, order=order)
    if exact_t:
        t_j = jbuild.exact_t_rows(data, cents, assign[order], order, jrot, 6)
        t_t = tbuild.exact_t_rows(data, cents, assign[order], order, trot, 6)
        np.testing.assert_allclose(t_t, t_j, rtol=1e-6)
        kw["t_rows"] = t_j
    else:
        kw["t_const"] = 5.3
    j = jbuild.build_codes(data, rc_j, assign[order], rotator=jrot, **kw)
    kw["metric"] = TMetric.L2
    t = tbuild.build_codes_device(
        torch.from_numpy(data), rc_t, assign[order], rotator=trot, **kw
    )
    _check_codes({k: v.numpy() for k, v in t.items()}, j)


@pytest.mark.parametrize("faster", [True, False])
def test_train_with_clusters_matches_jax(faster, monkeypatch):
    from rabitq_tpu import IvfRabitqIndex as JIndex
    from rabitq_tpu_torch import IvfRabitqIndex as TIndex
    from rabitq_tpu_torch.index import ivf as tivf

    # the constant t of the faster mode comes from an argmax that may tie
    # differently (test_rescale_factors_match_jax); give both the JAX value
    monkeypatch.setattr(
        tivf, "compute_const_scaling_factor",
        lambda dim, ex_bits, seed, device: jq.compute_const_scaling_factor(dim, ex_bits, seed),
    )
    rng = np.random.default_rng(6)
    data = rng.standard_normal((1200, 64)).astype(np.float32)
    cents = data[:16].copy()
    assign = np.argmin(((data[:, None, :] - cents[None]) ** 2).sum(-1), axis=1)
    kw = dict(seed=9, use_faster_config=faster, scan_dtype="fused8")
    jidx = JIndex.train_with_clusters(data, cents, assign, 7, **kw)
    tidx = TIndex.train_with_clusters(data, cents, assign, 7, device="cpu", **kw)
    h, lay, n = jidx.host, tidx.layout, len(jidx)
    np.testing.assert_array_equal(tidx._ids, h.ids)
    np.testing.assert_array_equal(tidx._offsets, h.cluster_offsets)
    np.testing.assert_allclose(lay.centroids.numpy(), h.centroids, rtol=1e-5, atol=1e-5)
    total = lay.ex.numpy()[:n, : jidx.padded_dim].astype(np.int64)
    _check_codes(
        {"binary": total >> 6, "ex": total & 63,
         **{k: getattr(lay, k).numpy()[:n] for k in FACTORS}},
        {"binary": h.binary_bits, "ex": h.ex_codes,
         **{k: getattr(h, k) for k in FACTORS}},
    )
