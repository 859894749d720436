"""k-means of the port against the JAX package on the CPU.

Both packages draw their k-means++ seeds from the same ``jax.random`` keys
(the port's copy: ``ops/prng.py``). On integer-valued rows, where every
distance and running sum is exact in f32, the init picks the same rows and
one Lloyd step gives bitwise-equal centroids. Elsewhere the packages'
products and cumulative sums round differently, so single steps are
compared from the same centroids (assignments equal but for near-ties:
>= 99.5%) and whole runs by objective (within 3%). ``segment_sum``'s CPU
form adds in ascending row order: bitwise equal to a row-by-row f32 loop
and to ``index_add_``, and to ``jax.ops.segment_sum`` within f32 rounding.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabitq_tpu.ops import kmeans as jk
from rabitq_tpu_torch.ops import kmeans as tk
from rabitq_tpu_torch.ops import prng


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


def _exact_rows(seed, n=4096, dim=32):
    """Integer coordinates in [-4, 4]: every squared distance, dot product
    and running sum of the k-means++ init stays an integer below 2**24."""
    return np.random.default_rng(seed).integers(-4, 5, (n, dim)).astype(np.float32)


@pytest.mark.parametrize("seed,n_valid", [(0, 4096), (1, 4096), (5, 4000), (42, 4097)])
def test_kmeanspp_init_picks_the_jax_rows(seed, n_valid):
    """The same key gives the same first row and the same uniforms, so on
    exact rows the same 64 picks (rows >= n_valid are padding)."""
    data = _exact_rows(seed, n=max(n_valid, 4096))
    key = seed * 1_000_003
    want = np.asarray(jk._kmeanspp_init(jnp.asarray(data), jax.random.PRNGKey(key), 64, n_valid))
    got = tk._kmeanspp_init(torch.from_numpy(data), prng.PRNGKey(key), 64, n_valid)
    np.testing.assert_array_equal(got.numpy(), want)
    rows = {r.tobytes() for r in data[:n_valid]}
    assert all(c.tobytes() in rows for c in got.numpy())


@pytest.mark.parametrize("mppc", [256, 40])
def test_run_kmeans_one_step_equals_jax_on_exact_rows(mppc):
    """``run_kmeans`` draws from ``PRNGKey(seed * 1_000_003 + redo)`` as the
    JAX function does: on exact rows one Lloyd step (integer sums, one
    division) gives bitwise-equal centroids and equal assignments, with and
    without the training subsample, and with a second restart."""
    data = _exact_rows(9)
    for nredo in (1, 2):
        j = jk.run_kmeans(data, 24, niter=1, seed=3, nredo=nredo, max_points_per_centroid=mppc)
        t = tk.run_kmeans(data, 24, niter=1, seed=3, nredo=nredo, max_points_per_centroid=mppc,
                          device="cpu")
        np.testing.assert_array_equal(t.centroids.numpy(), np.asarray(j.centroids))
        np.testing.assert_array_equal(t.assignments, j.assignments)


def test_run_kmeans_same_seed_same_result():
    data, _ = _blobs(6, n=3000, k=10)
    a = tk.run_kmeans(data, 16, niter=8, seed=11, device="cpu")
    b = tk.run_kmeans(data, 16, niter=8, seed=11, device="cpu")
    np.testing.assert_array_equal(a.centroids.numpy(), b.centroids.numpy())
    np.testing.assert_array_equal(a.assignments, b.assignments)
    c = tk.run_kmeans(data, 16, niter=8, seed=12, device="cpu")
    assert not np.array_equal(a.centroids.numpy(), c.centroids.numpy())


@pytest.mark.parametrize("n,dim,k", [(5000, 33, 7), (3000, 960, 5), (700, 1, 3), (0, 4, 2)])
def test_segment_sum_adds_in_ascending_row_order(n, dim, k):
    """The CPU form against a row-by-row f32 loop (bitwise) and against
    ``jax.ops.segment_sum`` (f32 rounding); rows of ~1e3 with mixed signs
    make the order show."""
    rng = np.random.default_rng(n + dim)
    data = (rng.standard_normal((n, dim)) * rng.exponential(1e3, (n, 1))).astype(np.float32)
    ids = rng.integers(0, k, n)
    want = np.zeros((k, dim), np.float32)
    for r in range(n):
        want[ids[r]] += data[r]
    got = tk.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), k)
    assert got.dtype == torch.float32 and got.shape == (k, dim)
    np.testing.assert_array_equal(got.numpy(), want)
    by_index_add = torch.zeros((k, dim)).index_add_(0, torch.from_numpy(ids), torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), by_index_add.numpy())
    j = np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), num_segments=k))
    scale = np.abs(data).sum() / max(k, 1) + 1.0
    np.testing.assert_allclose(got.numpy(), j, rtol=1e-5, atol=1e-6 * scale)
    sums, counts = tk.segment_sum_counts(torch.from_numpy(data), torch.from_numpy(ids), k)
    np.testing.assert_array_equal(sums.numpy(), want)
    np.testing.assert_array_equal(counts.numpy(), np.bincount(ids, minlength=k).astype(np.float32))


def test_segment_sum_drops_ids_outside_the_segments_like_jax():
    rng = np.random.default_rng(2)
    data = rng.standard_normal((400, 8)).astype(np.float32)
    ids = rng.integers(-2, 7, 400)
    got = tk.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 5)
    j = np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), num_segments=5))
    np.testing.assert_allclose(got.numpy(), j, rtol=1e-5, atol=1e-5)
    _, counts = tk.segment_sum_counts(torch.from_numpy(data), torch.from_numpy(ids), 5)
    np.testing.assert_array_equal(counts.numpy(), [np.sum(ids == s) for s in range(5)])
    with pytest.raises(ValueError, match="CUDA"):
        tk.segment_sum_kernel(torch.from_numpy(data), torch.from_numpy(ids), 5)


def _running_sum_by_scalars(w: np.ndarray) -> np.ndarray:
    """The order the running-sum kernel states, one f32 scalar add at a
    time: tiles of ``SCAN_THREADS`` threads x ``SCAN_ITEMS`` weights; a
    thread adds its weights in turn, each warp scans its 32 totals
    Kogge-Stone (at distance d, lane l adds lane l - d's value from before
    the step), warp 0 scans the warp totals the same way and the last of
    those is the tile's total; an output is carry + (warp prefix + lane
    prefix) plus the thread's running sum, and a tile's carry is the entry
    before it of this same running sum taken over the tile totals (0 for
    the first tile)."""
    f = np.float32
    threads, items = tk.SCAN_THREADS, tk.SCAN_ITEMS
    tile = threads * items

    def kogge_stone(x):
        for d in (1, 2, 4, 8, 16):
            x = [f(x[i] + x[i - d]) if i >= d else x[i] for i in range(len(x))]
        return x

    n = len(w)
    tiles = max(1, -(-n // tile))
    scans, totals = [], []
    for base in range(0, tiles * tile, tile):
        local, thread_totals = [], []
        for t in range(threads):
            acc, row = None, []
            for i in range(items):
                j = base + t * items + i
                x = w[j] if j < n else f(0.0)
                acc = x if acc is None else f(acc + x)
                row.append(acc)
            local.append(row)
            thread_totals.append(acc)
        lane_before, warp_totals = [], []
        for wp in range(threads // 32):
            incl = kogge_stone(thread_totals[32 * wp : 32 * wp + 32])
            lane_before += [f(0.0)] + incl[:-1]
            warp_totals.append(incl[-1])
        incl = kogge_stone(warp_totals)
        warp_before = [f(0.0)] + incl[:-1]
        scans.append((local, lane_before, warp_before))
        totals.append(incl[-1])
    carries = [f(0.0)]
    if tiles > 1:
        carries += list(_running_sum_by_scalars(np.array(totals, np.float32))[:-1])
    out = np.empty(n, np.float32)
    for b, (local, lane_before, warp_before) in enumerate(scans):
        for t in range(threads):
            before = f(carries[b] + f(warp_before[t // 32] + lane_before[t]))
            for i in range(items):
                j = b * tile + t * items + i
                if j < n:
                    out[j] = f(before + local[t][i])
    return out


@pytest.mark.parametrize("n", [0, 1, 5, 1024, 2048, 2049, 16_385, 40_000, 262_147])
def test_running_sum_adds_in_its_fixed_order(n):
    """The init's running sum on the CPU: bitwise equal to the order the
    kernel states, rebuilt here one scalar add at a time, and equal to
    ``torch.cumsum`` where every sum is exact (integer weights). The sizes
    take one tile, a tile and one weight, and many tiles."""
    rng = np.random.default_rng(n)
    w = (rng.exponential(1.0, n) * rng.choice([1.0, 1e3], n)).astype(np.float32)
    got = tk.running_sum(torch.from_numpy(w))
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _running_sum_by_scalars(w))
    ints = torch.from_numpy(rng.integers(0, 100, n).astype(np.float32))
    assert torch.equal(tk.running_sum(ints), torch.cumsum(ints, 0))
    with pytest.raises(ValueError, match="CUDA"):
        tk.running_sum_kernel(ints)


def test_running_sum_order_past_a_tile_of_tiles(monkeypatch):
    """Past ``SCAN_TILE`` tiles the carries come from the running sum of the
    tile totals, which itself has carries: three levels, shown on a smaller
    tile (one warp of 32 threads x 2 weights: 64) so that the scalar
    rebuild stays quick."""
    monkeypatch.setattr(tk, "SCAN_THREADS", 32)
    monkeypatch.setattr(tk, "SCAN_ITEMS", 2)
    monkeypatch.setattr(tk, "SCAN_TILE", 64)
    w = np.random.default_rng(7).exponential(1.0, 64 * 64 + 65).astype(np.float32)
    np.testing.assert_array_equal(tk.running_sum(torch.from_numpy(w)).numpy(),
                                  _running_sum_by_scalars(w))


def test_running_sum_within_recursive_summation_bounds():
    """Against a float64 cumulative sum over 262,147 non-negative weights:
    each output's error within the longest chain of f32 adds that forms it
    times 2**-24 of the exact sum. A weight reaches a tile's total through
    7 adds in its thread, 5 in the lanes' scan and 3 in the warps' (8
    warps): 15. Within its own tile it reaches an output through those and
    the three joins (warp + lane prefix, the carry, the thread's sum): 18.
    From an earlier tile it reaches the tile total (15), then the carry
    through the totals' one-tile running sum (18, as 129 totals fit one
    tile), then the last two joins: 35."""
    n = 262_147
    assert -(-n // tk.SCAN_TILE) <= tk.SCAN_TILE
    w = np.random.default_rng(3).exponential(1.0, n).astype(np.float32)
    got = tk.running_sum(torch.from_numpy(w)).numpy().astype(np.float64)
    ref = np.cumsum(w.astype(np.float64))
    to_total = (tk.SCAN_ITEMS - 1) + 5 + int(np.log2(tk.SCAN_THREADS // 32))
    one_tile = to_total + 3
    chain = to_total + one_tile + 2
    assert chain == 35
    assert np.all(np.abs(got - ref) <= chain * 2.0**-24 * ref)
