"""Bin scan of the port (plain version, on the CPU) against the JAX
package's Pallas ``fused_bin_scan`` in interpret mode and its
``fused_select``: dense walk and compacted tile lists, rows wrapping the
8192 bins, duplicate rows forcing ties, masked rows and unprobed clusters.

Tolerances: ``offered`` equal; bin values rtol 1e-5 (the f32 dot sums in
another order); ``bins_idx`` equal on >= 99.5% of bins (a reordered sum can
flip a near-tie inside a bin)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabitq_tpu.ops import pallas_fused_scan as jfs
from rabitq_tpu_torch.ops import fused_scan as tfs

N_TILES, D = 24, 128
# (clusters, duplicate rows): 96 clusters share one window and rows 8192
# apart are duplicated (same bin, same value: the first row must win);
# 300 clusters move the windows
CASES = [(96, True), (300, False)]


def _inputs(seed, bq=64, c=96, dup=True):
    rng = np.random.default_rng(seed)
    n = N_TILES * tfs.TN
    plane = rng.integers(0, 128, (n, D)).astype(np.int8)
    sizes = rng.multinomial(n - 300, np.ones(c) / c)
    cluster_of = np.zeros(n, np.int32)
    cluster_of[: n - 300] = np.repeat(np.arange(c, dtype=np.int32), sizes)
    valid = np.arange(n) < n - 300
    fa = rng.normal(size=n).astype(np.float32) * 10
    fr = rng.normal(size=n).astype(np.float32) * 0.05
    if dup:
        for a in (plane, fa, fr, cluster_of):
            a[8192:8192 + 700] = a[:700]
    allowed = valid & (rng.random(n) > 0.05)
    fa_eff = np.where(allowed, fa, tfs.BIG).astype(np.float32)
    q = rng.normal(size=(bq, D)).astype(np.float32)
    k1x = (-63.5 * q.sum(1)).astype(np.float32)
    g_add = (rng.random((bq, c)) * 50).astype(np.float32)
    probe = rng.random((bq, c)) < 0.3
    c_blk = tfs.tile_cluster_blocks(cluster_of, allowed)
    return dict(plane=plane, fa_eff=fa_eff, fr=fr, cluster_of=cluster_of, q=q, k1x=k1x,
                g_add=g_add, probe=probe, c_blk=c_blk)


def _g1(x):
    c = x["g_add"].shape[1]
    g1 = np.full((x["q"].shape[0], tfs._pad_clusters(c)), tfs.BIG, np.float32)
    g1[:, :c] = np.where(x["probe"], x["g_add"], tfs.BIG)
    return g1


def _compare_bins(j_out, t_out):
    jv, ji, jo = (np.asarray(a) for a in j_out)
    tv, ti, to = (a.numpy() for a in t_out)
    np.testing.assert_array_equal(to, jo)
    filled = jv < tfs.BIG / 2
    np.testing.assert_array_equal(tv < tfs.BIG / 2, filled)
    np.testing.assert_allclose(tv[filled], jv[filled], rtol=1e-5, atol=1e-4)
    assert np.mean(ti == ji) >= 0.995
    return jo.sum()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("compact", [False, True])
def test_bin_scan_matches_jax(compact, case):
    x = _inputs(5, c=case[0], dup=case[1])
    g1 = _g1(x)
    bq = x["q"].shape[0]
    tiles = tcount = None
    if compact:
        # one ascending list per 64-query block, skipping a few tiles and
        # padding with the last valid one, as fused_select builds them
        rng = np.random.default_rng(9)
        keep = np.sort(rng.choice(N_TILES, 18, replace=False)).astype(np.int32)
        tiles = np.concatenate([keep, np.full(6, keep[-1], np.int32)])[None, :]
        tcount = np.array([18], np.int32)
    j_out = jfs.fused_bin_scan(
        jnp.asarray(x["plane"]), jnp.asarray(x["q"]), jnp.asarray(x["fa_eff"]),
        jnp.asarray(x["fr"]), jnp.zeros(x["fr"].shape, jnp.float32),
        jnp.asarray(x["cluster_of"]), jnp.asarray(x["k1x"]),
        jnp.asarray(g1, jnp.bfloat16), jnp.zeros(g1.shape, jnp.bfloat16),
        jnp.asarray(x["c_blk"]),
        tiles=None if tiles is None else jnp.asarray(tiles),
        tcount=None if tcount is None else jnp.asarray(tcount),
    )
    t_out = tfs.fused_bin_scan(
        torch.from_numpy(x["plane"]), torch.from_numpy(x["q"]), torch.from_numpy(x["fa_eff"]),
        torch.from_numpy(x["fr"]), torch.from_numpy(x["cluster_of"]),
        torch.from_numpy(x["k1x"]), torch.from_numpy(g1).to(torch.bfloat16),
        torch.from_numpy(x["c_blk"]),
        tiles=None if tiles is None else torch.from_numpy(tiles),
        tcount=None if tcount is None else torch.from_numpy(tcount),
    )
    assert t_out[0].shape == (bq, tfs.n_bins())
    assert _compare_bins(j_out, t_out) > 0


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("max_tiles", [None, 32])
def test_fused_select_matches_jax(max_tiles, case):
    x = _inputs(7, bq=40, c=case[0], dup=case[1])  # pads to the query tiles of each package
    top_k = 10
    j = jfs.fused_select(
        jnp.asarray(x["q"]), jnp.asarray(x["plane"]), jnp.asarray(x["fa_eff"]),
        jnp.asarray(x["fr"]), jnp.zeros(x["fr"].shape, jnp.float32),
        jnp.asarray(x["cluster_of"]), jnp.asarray(x["k1x"]), jnp.asarray(x["g_add"]),
        jnp.zeros(x["g_add"].shape, jnp.float32), jnp.asarray(x["probe"]),
        jnp.asarray(x["c_blk"]), top_k, D, max_tiles=max_tiles,
        direct_plane=True, with_values=True,
    )
    j_idx, j_ok, j_val, j_probed = (np.asarray(a) for a in j)
    t = tfs.fused_select(
        torch.from_numpy(x["q"]), torch.from_numpy(x["plane"]),
        torch.from_numpy(x["fa_eff"]), torch.from_numpy(x["fr"]),
        torch.from_numpy(x["cluster_of"]), torch.from_numpy(x["k1x"]),
        torch.from_numpy(x["g_add"]), torch.from_numpy(x["probe"]),
        torch.from_numpy(x["c_blk"]), top_k, max_tiles=max_tiles,
    )
    t_idx, t_ok, t_val, t_probed = (a.numpy() for a in t)
    np.testing.assert_array_equal(t_probed, j_probed)
    np.testing.assert_array_equal(t_ok, j_ok)
    np.testing.assert_allclose(t_val[j_ok], j_val[j_ok], rtol=1e-5, atol=1e-4)
    assert np.mean(t_idx == j_idx) >= 0.995


def test_compaction_lists_cover_probed_tiles():
    x = _inputs(3, bq=64, c=300, dup=False)
    probe = torch.from_numpy(x["probe"])
    tiles, tcount = tfs.compaction_lists(
        torch.from_numpy(x["fa_eff"]), torch.from_numpy(x["cluster_of"]), probe, 32, N_TILES
    )
    assert tiles.shape == (2, N_TILES) and tcount.shape == (2,)
    cl = x["cluster_of"].reshape(N_TILES, tfs.TN)
    ok = (x["fa_eff"] < tfs.BIG / 2).reshape(N_TILES, tfs.TN)
    for j in range(2):
        union = x["probe"][32 * j : 32 * (j + 1)].any(0)
        needed = [t for t in range(N_TILES) if union[cl[t][ok[t]]].any()]
        got = tiles[j, : tcount[j]].tolist()
        assert got == needed  # ascending, exactly the needed tiles
        assert (tiles[j, tcount[j]:] == got[-1]).all()


def test_cuda_wrapper_refuses_cpu_tensors():
    x = _inputs(1, bq=32)
    args = (
        torch.from_numpy(x["plane"]), torch.from_numpy(x["q"]), torch.from_numpy(x["fa_eff"]),
        torch.from_numpy(x["fr"]), torch.from_numpy(x["cluster_of"]),
        torch.from_numpy(x["k1x"]), torch.from_numpy(_g1(x)).to(torch.bfloat16),
        torch.from_numpy(x["c_blk"]),
    )
    with pytest.raises(ValueError):
        tfs.fused_bin_scan_cuda(*args)
