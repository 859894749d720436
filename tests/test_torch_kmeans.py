"""k-means of the port against the JAX package on the CPU.

The two packages draw their k-means++ seeds from different generators, so
single steps are compared from the same centroids (assignments equal but
for near-ties: >= 99.5%) and whole runs by objective (within 3%).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabitq_tpu.ops import kmeans as jk
from rabitq_tpu_torch.ops import kmeans as tk


def _blobs(seed, n=4096, dim=32, k=20, spread=3.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim)).astype(np.float32) * spread
    data = centers[rng.integers(0, k, n)] + rng.standard_normal((n, dim)).astype(np.float32)
    return data.astype(np.float32), rng


@pytest.mark.parametrize("assign_dtype", ["f32", "bf16"])
def test_lloyd_step_matches_jax(assign_dtype):
    data, rng = _blobs(0)
    k = 20
    init = data[rng.choice(len(data), k, replace=False)]
    # an empty cluster exercises the far-point reseed
    init[3] = 1e3
    block = 1024
    jc, jobj = jk._lloyd_step(
        jnp.asarray(data), jnp.asarray(init), k, block, len(data), False, assign_dtype
    )
    tc, tobj = tk._lloyd_step(
        torch.from_numpy(data), torch.from_numpy(init), k, block, len(data), False, assign_dtype
    )
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-4)
    assert float(tobj) == pytest.approx(float(jobj), rel=1e-5)
    ja, jo = jk.assign_dataset(data, np.asarray(jc), assign_dtype=assign_dtype)
    ta, to = tk.assign_dataset(data, tc, assign_dtype=assign_dtype)
    assert np.mean(ta == ja) >= 0.995
    assert to == pytest.approx(jo, rel=1e-4)


def test_spherical_step_matches_jax():
    data, rng = _blobs(1)
    init = data[:20].copy()
    jc, _ = jk._lloyd_step(jnp.asarray(data), jnp.asarray(init), 20, 512, len(data), True)
    tc, _ = tk._lloyd_step(torch.from_numpy(data), torch.from_numpy(init), 20, 512, len(data), True)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)


def test_run_kmeans_objective_matches_jax():
    # 6 separated blobs under 24 centroids: every blob is seeded, so the
    # objective hardly depends on the seeds drawn
    data, _ = _blobs(2, n=6000, k=6, spread=8.0)
    j = jk.run_kmeans(data, 24, niter=20, seed=5, tol=1e-4)
    t = tk.run_kmeans(data, 24, niter=20, seed=5, tol=1e-4, device="cpu", with_report=True)
    assert t.centroids.shape == (24, 32) and t.assignments.shape == (6000,)
    assert t.objective == pytest.approx(j.objective, rel=0.03)
    assert 1 <= t.iters <= 20 and {"init_s", "lloyd_s", "assign_s"} <= set(t.report)
    # the subsample + init-prefix path and the early stop
    j2 = jk.run_kmeans(data, 24, niter=20, seed=5, max_points_per_centroid=40)
    t2 = tk.run_kmeans(data, 24, niter=20, seed=5, max_points_per_centroid=40, device="cpu")
    assert t2.objective == pytest.approx(j2.objective, rel=0.03)
    assert tk._init_rows_cap(4096, 1_000_000) == jk._init_rows_cap(4096, 1_000_000)
    assert tk.auto_assign_dtype(1_000_000, 960) == jk.auto_assign_dtype(1_000_000, 960) == "bf16"
    assert tk._block_size(4096) == jk._block_size(4096)


def test_run_kmeans_takes_data_dev_in_the_jax_shape():
    """``data_dev`` at the JAX package's position 7: the rows already on
    the device are what k-means runs on (``data`` is not read), the same
    result as those rows passed as ``data``; ``n_valid`` after it."""
    data, _ = _blobs(4, n=1500, k=8)
    rows = torch.from_numpy(data)
    want = tk.run_kmeans(rows, 8, niter=10, seed=3)
    for got in (tk.run_kmeans(data, 8, 10, 3, 1, False, 256, rows),
                tk.run_kmeans(None, 8, niter=10, seed=3, data_dev=rows)):
        np.testing.assert_array_equal(got.centroids.numpy(), want.centroids.numpy())
        np.testing.assert_array_equal(got.assignments, want.assignments)
        assert got.objective == want.objective
    part = tk.run_kmeans(data, 8, 10, 3, 1, False, 256, rows, 1000)
    assert part.assignments.shape == (1000,)
    j = jk.run_kmeans(data, 8, 10, 3, 1, False, 256, jnp.asarray(data), 1000)
    assert np.asarray(j.assignments).shape == part.assignments.shape
