"""The pieces of the port's MSTG build on the CPU, each against the JAX
package's on the same inputs: centroid scalar quantization (byte-equal),
the group-restricted assignment (equal), one polish step (assignments equal,
centroids atol 1e-5), closure assignment (member lists equal), the rebalance
(equal moves) and, since the split k-means seeds differ, the whole
hierarchical clustering by its invariants and objective (within 3%). Then
the JAX package's call shapes: clustering and closure given host rows and
``data_dev``, and the ``MstgIndex.host`` setter."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rabitq_tpu.index.mstg import clustering as jcl
from rabitq_tpu.index.mstg import closure as jclo
from rabitq_tpu.index.mstg import index as jmi
from rabitq_tpu.index.mstg import scalar_quant as jsq
from rabitq_tpu.index.mstg.config import ScalarPrecision as JPrec
from rabitq_tpu.ops import kmeans as jk
from rabitq_tpu_torch.index.mstg import clustering as tcl
from rabitq_tpu_torch.index.mstg import closure as tclo
from rabitq_tpu_torch.index.mstg import index as tmi
from rabitq_tpu_torch.index.mstg import scalar_quant as tsq
from rabitq_tpu_torch.index import scan as tscan
from rabitq_tpu_torch.index.mstg.config import ScalarPrecision as TPrec
from rabitq_tpu_torch.ops import kmeans as tk


def _blobs(n, dim, centers=12, sigma=0.4, seed=42):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, dim)).astype(np.float32) * 3
    return (c[rng.integers(0, centers, n)] + sigma * rng.standard_normal((n, dim))).astype(
        np.float32
    )


def _bridged(seed=7, dim=64, per=250, n_centers=8, n_bridge=400):
    """Isotropic blobs plus rows at midpoints of pairs of blob centres (the
    bench's replicated recipe): the midpoints pass the RNG rule."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, dim)).astype(np.float32) * 2
    blobs = np.concatenate([c + 0.3 * rng.standard_normal((per, dim)) for c in centers])
    pa = rng.integers(0, n_centers, n_bridge)
    pb = (pa + 1 + rng.integers(0, n_centers - 1, n_bridge)) % n_centers
    mid = 0.5 * (centers[pa] + centers[pb]) + 0.3 * rng.standard_normal((n_bridge, dim))
    return np.concatenate([blobs, mid]).astype(np.float32), centers


@pytest.mark.parametrize("prec", [p.value for p in TPrec])
def test_scalar_quant_bytes_equal_jax(prec):
    cents = _blobs(40, 96) * np.float32(7.3)
    cents[3] = 0.0  # an all-zero centroid (int8's scale floor)
    j_stored, j_deq = jsq.quantize_centroids(cents, JPrec(prec))
    t_stored, t_deq = tsq.quantize_centroids(cents, TPrec(prec))
    assert set(t_stored) == set(j_stored)
    for key in j_stored:
        assert t_stored[key].dtype == j_stored[key].dtype
        assert t_stored[key].tobytes() == j_stored[key].tobytes()
    assert t_deq.tobytes() == j_deq.tobytes()
    assert tsq.dequantize_centroids(t_stored, TPrec(prec)).tobytes() == j_deq.tobytes()
    assert tsq.apply_centroid_precision(t_deq, TPrec(prec)).tobytes() == t_deq.tobytes()
    assert tsq.fp32_to_bf16_bits(cents).tobytes() == jsq.fp32_to_bf16_bits(cents).tobytes()
    assert TPrec(prec).bytes_per_dim == JPrec(prec).bytes_per_dim


def _group_inputs(seed=3, n=2048, dim=64, groups=5):
    rng = np.random.default_rng(seed)
    data = _blobs(n, dim, seed=seed)
    ks = rng.integers(2, 6, groups)
    cents = data[rng.choice(n, int(ks.sum()), replace=False)] + 0.1
    c_pad = tscan._pad_pow2(int(ks.sum()), floor=8)
    cent = np.zeros((c_pad, dim), np.float32)
    cent[: ks.sum()] = cents
    cent_group = np.full(c_pad, -2, np.int32)
    cent_group[: ks.sum()] = np.repeat(np.arange(groups, dtype=np.int32), ks)
    row_group = rng.integers(-1, groups, n).astype(np.int32)  # -1: not split
    return data, cent, cent_group, row_group


@pytest.mark.parametrize("assign_dtype", ["f32", "bf16"])
def test_grouped_assign_matches_jax(assign_dtype):
    data, cent, cg, rg = _group_inputs()
    j = np.asarray(jk._grouped_assign_blocks(
        jnp.asarray(data), jnp.asarray(cent), jnp.asarray(cg), jnp.asarray(rg), 256, assign_dtype))
    t = tk._grouped_assign_blocks(
        torch.from_numpy(data), torch.from_numpy(cent), torch.from_numpy(cg),
        torch.from_numpy(rg), 256, assign_dtype).numpy()
    assert t.dtype == np.int32
    if assign_dtype == "f32":
        np.testing.assert_array_equal(t, j)
    else:  # bf16 operands: f32 sums in another order may flip a near tie
        assert np.mean(t == j) >= 0.998
    split = rg >= 0
    assert (cg[t[split]] == rg[split]).all()  # only the row's own group
    assert (t[~split] == 0).all()  # no centroid matches: the first slot
    for floor, n in ((256, 1), (256, 300), (8, 5), (8, 4096)):
        assert tscan._pad_pow2(n, floor=floor) == jk._pad_pow2(n, floor=floor)


def test_polish_step_matches_jax():
    data, cent, cg, _ = _group_inputs(seed=4)
    cg = np.where(cg >= 0, 0, -2).astype(np.int32)  # one group: the global polish
    rg = np.zeros(data.shape[0], np.int32)
    rg[-48:] = -1  # padding rows
    ja, jc = jcl._polish_step(jnp.asarray(data), jnp.asarray(cent), jnp.asarray(cg),
                              jnp.asarray(rg), 256, "f32")
    ta, tc = tcl._polish_step(torch.from_numpy(data), torch.from_numpy(cent),
                              torch.from_numpy(cg), torch.from_numpy(rg), 256, "f32")
    np.testing.assert_array_equal(ta.numpy()[:-48], np.asarray(ja)[:-48])
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tc.numpy()[cg == -2], cent[cg == -2])  # filler kept


@pytest.mark.parametrize("case", ["bridged", "blobs", "ties"])
def test_closure_assign_matches_jax(case):
    if case == "bridged":
        data, cents = _bridged()
        eps, reps = 0.9, 4
    elif case == "blobs":
        data = _blobs(3000, 64)
        cents = data[::97].copy()
        eps, reps = 0.3, 8
    else:  # duplicated centroids: ties fall to the lower index, as lax.top_k
        data = _blobs(1000, 32, seed=9)
        cents = np.repeat(data[::100], 2, axis=0)
        eps, reps = 0.5, 5
    j = jclo.closure_assign(data, cents, eps, reps, chunk=1024)
    t = tclo.closure_assign(torch.from_numpy(data), cents, eps, reps, chunk=1024)
    assert len(t) == len(j) == cents.shape[0]
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    total = sum(m.size for m in t)
    assert total >= data.shape[0]
    if case == "bridged":
        assert total > data.shape[0] * 1.05  # the midpoints replicate
    jc, js = jclo._closure_chunk(jnp.asarray(data[:512]), jnp.asarray(cents), eps, reps)
    tc, ts = tclo._closure_chunk(torch.from_numpy(data[:512]), torch.from_numpy(cents), eps, reps)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_rebalance_matches_jax():
    rng = np.random.default_rng(11)
    n, dim = 1000, 48
    data = _blobs(n, dim, seed=11)
    idx = rng.permutation(5000)[:n].astype(np.int64)  # unsorted row ids
    sub = data
    sizes = [700, 40, 200, 60]  # target 250, max_allowed 500
    cuts = np.cumsum(sizes)[:-1]
    groups = [g.copy() for g in np.split(idx, cuts)]
    cents = np.stack([data[s - 1] for s in np.cumsum(sizes)]) + 0.05
    want = jcl._rebalance(sub, idx, [g.copy() for g in groups], cents, 1.0)
    got = tcl._rebalance(
        torch.from_numpy(sub), idx, [g.copy() for g in groups], torch.from_numpy(cents), 1.0)
    assert [g.size for g in want] != sizes  # rows did move
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _objective(data, members):
    return float(sum(((data[m] - data[m].mean(axis=0)) ** 2).sum() for m in members))


@pytest.mark.parametrize("refine_iters", [0, 4])
def test_hierarchical_cluster_against_jax(refine_iters):
    data = _blobs(4000, 64, centers=20, sigma=0.8)
    kw = dict(max_cluster_size=200, branching_factor=4, seed=5, refine_iters=refine_iters)
    j = jcl.hierarchical_cluster(data, **kw)
    t = tcl.hierarchical_cluster(torch.from_numpy(data), **kw)
    sizes = np.array([m.size for m in t.members])
    assert sizes.max() <= 200 and sizes.min() > 0
    np.testing.assert_array_equal(np.sort(np.concatenate(t.members)), np.arange(4000))
    assert t.centroids.shape == (len(t.members), 64) and t.centroids.dtype == np.float32
    for m, c in zip(t.members[::7], t.centroids[::7]):
        np.testing.assert_allclose(c, data[m].mean(axis=0), rtol=1e-5, atol=1e-5)
    assert _objective(data, t.members) == pytest.approx(_objective(data, j.members), rel=0.03)
    assert len(t.members) == pytest.approx(len(j.members), rel=0.25)
    empty = tcl.hierarchical_cluster(torch.zeros((0, 8)), 10, 4)
    assert empty.members == [] and empty.centroids.shape == (0, 8)


def test_closure_assign_takes_host_rows_in_the_jax_shape():
    """Host rows, and the JAX package's ``data_dev`` in its position: the
    same lists as the rows given as a tensor, and as the JAX function's."""
    data, cents = _bridged(n_bridge=120, per=100)
    j = jclo.closure_assign(data, cents, 0.9, 4, 256, jnp.asarray(data))
    host = tclo.closure_assign(data, cents, 0.9, 4, 256, device="cpu")
    on_dev = tclo.closure_assign(data, cents, 0.9, 4, 256, torch.from_numpy(data))
    tensor = tclo.closure_assign(torch.from_numpy(data), cents, 0.9, 4, 256)
    for lists in (host, on_dev):
        assert len(lists) == len(tensor) == len(j)
        for a, b, c in zip(lists, tensor, j):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_hierarchical_cluster_takes_host_rows_in_the_jax_shape():
    """Host rows, and ``data_dev`` at the JAX package's position 6: the
    same clusters as the rows given as a tensor; against the JAX function's
    as the whole clustering is held above (objective within 3%)."""
    data = _blobs(1200, 32, centers=10, sigma=0.8)
    args = (data, 150, 4, 1.0, 25, 5)
    j = jcl.hierarchical_cluster(*args, None, 2)
    host = tcl.hierarchical_cluster(*args, None, 2, device="cpu")
    on_dev = tcl.hierarchical_cluster(*args, torch.from_numpy(data), 2)
    tensor = tcl.hierarchical_cluster(torch.from_numpy(data), *args[1:], refine_iters=2)
    for got in (host, on_dev):
        assert len(got.members) == len(tensor.members)
        for a, b in zip(got.members, tensor.members):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.centroids, tensor.centroids)
    assert _objective(data, host.members) == pytest.approx(_objective(data, j.members), rel=0.03)


def test_mstg_host_setter_matches_jax():
    """The same host assigned to both packages' indexes: ``len``, the host
    ids and list offsets and the directory equal, and a layout already
    built stays (as the JAX setter leaves it). Then lists of another index:
    the port's ``len``, directory and replica test follow them (the JAX
    package's directory keeps its first lists)."""
    j = jmi.MstgIndex.build(_blobs(500, 32, seed=4),
                            jmi.MstgConfig(max_posting_size=64, faster_config=True), seed=4,
                            scan_dtype="f32")
    h = j.host
    host = tmi.MstgHost(**{f.name: None if getattr(h, f.name) is None else np.array(getattr(h, f.name))
                           for f in dataclasses.fields(h)})
    t = tmi.MstgIndex(tmi.MstgConfig(max_posting_size=64, faster_config=True), j.dim, host,
                      "f32", device="cpu")
    layout = t.layout
    new_j = dataclasses.replace(j.host, ids=np.asarray(j.host.ids) * 3 + 2)
    new_t = dataclasses.replace(t.host, ids=np.asarray(t.host.ids) * 3 + 2)
    j.host, t.host = new_j, new_t
    assert len(t) == len(j) == 3 * 499 + 3 and t.total_rows == j.total_rows
    np.testing.assert_array_equal(t.host.ids, j.host.ids)
    np.testing.assert_array_equal(t.host.list_offsets, j.host.list_offsets)
    assert [dataclasses.astuple(e) for e in t.directory.entries] == [
        dataclasses.astuple(e) for e in j.directory.entries]
    assert t.layout is layout and not t._has_replicas()
    other = tmi.MstgIndex.build(
        _bridged(per=40, n_bridge=60)[0][:, :32],
        tmi.MstgConfig(max_posting_size=32, closure_epsilon=0.9), seed=1, device="cpu")
    t.host = other.host
    assert len(t) == len(other) and t.posting_list_count() == other.posting_list_count()
    assert t.directory == other.directory and t._has_replicas() and other._has_replicas()
