"""The port's one-dispatch search (``index/scan.make_fused_search``) and the
last functions it took from the JAX package (``utils/transfer.warm_session``,
``index/build.build_codes``, ``DeviceLayout.scan_args``), on the CPU against
the JAX package, from the same numpy inputs.

A JAX index is carried across with ``from_host_arrays``, so both packages
search the same codes in the same device row order. Tolerances, as
``tests/test_torch_scan_paths.py``: ``f32`` with exact selection is the
oracle configuration, ids equal per query and distances rtol 1e-5 (the f32
sums run in another order); the fused EXACT scan rounds the query's terms to
bf16, so its top-10 lists overlap >= 0.9 per query and >= 0.98 on average,
common distances rtol 1e-3. Code building as ``tests/test_torch_quantize.py``.

On the CPU the fused search runs its eager body; its CUDA graphs need the
card (``tests/test_torch_cuda.py``). What the graphs rest on is held here:
the key, the launch counters, and every call that replaces a tensor the
graphs read dropping them."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rabitq_tpu as jr
import rabitq_tpu_torch as tr
from rabitq_tpu.index import build as jbuild
from rabitq_tpu.index import scan as jscan
from rabitq_tpu.ops.rotation import FhtKacRotator as JRot
from rabitq_tpu.utils import transfer as jtransfer
from rabitq_tpu_torch.index import build as tbuild
from rabitq_tpu_torch.index import scan as tscan
from rabitq_tpu_torch.ops.rotation import FhtKacRotator as TRot
from rabitq_tpu_torch.utils import transfer as ttransfer

N, DIM, NLIST = 2000, 64, 16
TOP_K, NPROBE = 10, 6
BS = 16  # queries a window


def _data(n=N, dim=DIM, seed=42):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((NLIST, dim)).astype(np.float32)
    rows = centers[rng.integers(0, NLIST, n)] + 0.5 * rng.standard_normal((n, dim))
    return rows.astype(np.float32)


def _carry(jidx, scan_dtype) -> tr.IvfRabitqIndex:
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


def _agree(j_ids, j_d, t_ids, t_d, exact):
    if exact:
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_allclose(t_d, j_d, rtol=1e-5, atol=1e-4)
        return
    overlaps = []
    for i in range(len(j_ids)):
        overlaps.append(len(set(j_ids[i].tolist()) & set(t_ids[i].tolist())) / j_ids.shape[1])
        jm = dict(zip(j_ids[i].tolist(), j_d[i].tolist()))
        for rid, dist in zip(t_ids[i].tolist(), t_d[i].tolist()):
            if rid in jm and np.isfinite(dist):
                assert dist == pytest.approx(jm[rid], rel=1e-3, abs=1e-3), (i, rid)
    assert min(overlaps) >= 0.9 and np.mean(overlaps) >= 0.98, overlaps


@pytest.fixture(scope="module")
def indexes():
    """A 7-bit JAX index per scan_dtype ("f32": exact selection; "fused8":
    the fused EXACT scan) and the port's index carried from it."""
    data = _data()
    out = {}
    for scan_dtype in ("f32", "fused8"):
        jidx = jr.IvfRabitqIndex.train(data, nlist=NLIST, total_bits=7, seed=3,
                                       scan_dtype=scan_dtype)
        out[scan_dtype] = (jidx, _carry(jidx, scan_dtype))
    return data, out


def _to_torch(x):
    """A numpy upload block (bf16 as ml_dtypes) as the same torch tensor."""
    if x is None:
        return None
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("offset", [0, BS])
@pytest.mark.parametrize("rotate", [True, False])
@pytest.mark.parametrize("upload", ["f32", "bf16", "int8", "int4"])
def test_fused_search_matches_jax(indexes, upload, rotate, offset):
    """The port's make_fused_search against the JAX package's on one upload
    block of 2 * BS queries, scanning the BS-row window at ``offset``, with
    the index's rotation or none (the queries taken as already rotated, as
    for MSTG's unrotated default), through the f32 oracle scan."""
    data, idx = indexes
    jidx, tidx = idx["f32"]
    jidx.upload_dtype = upload
    q_np, qs_np = jidx._pad_queries(data[:2 * BS] + 0.01, 2 * BS)
    jf = jscan.make_fused_search(jidx.rotator.rotate if rotate else None, dim=DIM)
    tf = tscan.make_fused_search(tidx.rotator.rotate if rotate else None, dim=DIM)
    kw = dict(top_k=TOP_K, nprobe=NPROBE, rerank=100, ex_bits=jidx.ex_bits, scan_dtype="f32",
              approx_topk=False)
    dev, _, _ = jidx._scan_inputs(None)
    j_ids, j_d = jf(q_np, dev.centroids, *dev.scan_args(), qscale=qs_np, offset=np.int32(offset),
                    sub_block=BS, metric=jidx.metric, **kw)
    lay = tidx.layout
    t_ids, t_d = tf(_to_torch(q_np), lay.centroids, *lay.scan_args(), qscale=_to_torch(qs_np),
                    offset=offset, sub_block=BS, metric=tidx.metric, **kw)
    assert t_ids.shape == (BS, TOP_K)
    _agree(np.asarray(j_ids), np.asarray(j_d), t_ids.numpy(), t_d.numpy(), exact=True)
    if rotate:  # the window's own queries come first
        np.testing.assert_array_equal(t_ids[:, 0].numpy(), np.arange(offset, offset + BS))


def test_fused_search_int4_needs_dim():
    fused = tscan.make_fused_search(None)
    with pytest.raises(ValueError, match="int4"):
        fused(torch.zeros((2, 4), dtype=torch.uint8), None)


@pytest.mark.parametrize("scan_dtype", ["f32", "fused8"])
@pytest.mark.parametrize("path", ["pipelined", "resident"])
def test_ivf_windows_match_jax(indexes, scan_dtype, path):
    """The IVF serving loops that scan upload superblocks in windows
    (pipelined with an upload block, and resident queries) on carried-over
    state against the JAX index's, int8 uploads."""
    data, idx = indexes
    jidx, tidx = idx[scan_dtype]
    jidx.upload_dtype = tidx.upload_dtype = "int8"
    queries = data[:100] + 0.01
    params = (TOP_K, NPROBE)
    if path == "pipelined":
        j_ids, j_d = jidx.batch_search_arrays_pipelined(
            queries, jr.SearchParams(*params), batch_size=BS, upload_block=64)
        t_ids, t_d = tidx.batch_search_arrays_pipelined(
            queries, tr.SearchParams(*params), batch_size=BS, upload_block=64)
    else:
        j_ids, j_d = jidx.batch_search_resident(
            jidx.upload_queries(queries), jr.SearchParams(*params), batch_size=BS)
        t_ids, t_d = tidx.batch_search_resident(
            tidx.upload_queries(queries), tr.SearchParams(*params), batch_size=BS)
    assert t_ids.shape == (100, TOP_K)
    _agree(j_ids, j_d, t_ids, t_d, exact=scan_dtype == "f32")


def _scan_kw(tidx, **over):
    lay = tidx.layout
    scan = dict(zip(tscan._SCAN_NAMES, (lay.centroids, *lay.scan_args())))
    scan.update(tscan._SCAN_DEFAULTS, top_k=TOP_K, rerank=100, metric=tidx.metric,
                ex_bits=tidx.ex_bits, scan_dtype="f32", nprobe=NPROBE)
    scan.update(over)
    return scan


def test_graph_key_freezes_scalars_and_addresses(indexes):
    """What a graph freezes is in its key: a Python scalar the body reads
    (nprobe, prune_epsilon, the tile budget), an optional tensor's presence,
    a shape, and the address of a tensor read in place. The query window,
    its scale and the row mask are copied in at every call: their contents
    and addresses are not in the key."""
    _, idx = indexes
    _, tidx = idx["f32"]
    q = torch.zeros((BS, DIM))
    key = tscan._graph_key(q, None, _scan_kw(tidx))
    assert tscan._graph_key(torch.ones((BS, DIM)), None, _scan_kw(tidx)) == key
    mask = tidx.layout.valid.clone()
    mask[::2] = False
    assert tscan._graph_key(q, None, _scan_kw(tidx, row_allowed=mask)) == key
    for over in (dict(nprobe=NPROBE + 1), dict(prune_epsilon=0.5), dict(max_tiles=4),
                 dict(f_add=tidx.layout.f_add.clone()),
                 dict(fused_cblk=torch.zeros(4, dtype=torch.int32))):
        assert tscan._graph_key(q, None, _scan_kw(tidx, **over)) != key, over
    assert tscan._graph_key(torch.zeros((2 * BS, DIM)), None, _scan_kw(tidx)) != key
    assert tscan._graph_key(q.to(torch.bfloat16), None, _scan_kw(tidx)) != key
    assert tscan._graph_key(q, torch.ones(BS), _scan_kw(tidx)) != key


def test_launch_counts_add_and_take_back():
    """A graph adds the launches its capture counted at each replay, and
    takes the capture's own counts back: one slot per wrapper counter."""
    from rabitq_tpu_torch.ops.fht import fht_kernel
    from rabitq_tpu_torch.ops.fused_scan import fused_bin_scan_cuda, fused_bin_scan_packed_cuda
    from rabitq_tpu_torch.ops.gather_dot import gather_dot_kernel
    from rabitq_tpu_torch.ops.select import top_k_cuda

    before = tscan._read_launches()
    n_sel = len(top_k_cuda.launches)  # the selection: a slot a site and type
    assert len(before) == 11 + n_sel + 2  # the gather-dot: one plane, two planes
    delta = list(range(1, len(before) + 1))
    tscan._add_launches(delta)
    after = tscan._read_launches()
    assert [a - b for a, b in zip(after, before)] == delta
    assert fht_kernel.launches == before[0] + 1
    assert list(fused_bin_scan_cuda.launches.values()) == [
        b + d for b, d in zip(before[3:7], delta[3:7])]
    assert list(fused_bin_scan_packed_cuda.launches.values()) == [
        b + d for b, d in zip(before[7:11], delta[7:11])]
    assert list(top_k_cuda.launches.values()) == [
        b + d for b, d in zip(before[11 : 11 + n_sel], delta[11 : 11 + n_sel])]
    assert list(gather_dot_kernel.launches.values()) == [
        b + d for b, d in zip(before[11 + n_sel :], delta[11 + n_sel :])]
    tscan._add_launches(delta, -1)
    assert tscan._read_launches() == before


def _with_sentinel(index):
    """Mark the index's fused search as holding a graph."""
    index._fused_scan._graphs["held"] = object()
    return index


def _dropped(index) -> bool:
    return not index._fused_scan._graphs


def _ivf(scan_dtype="f32", data=None):
    data = _data() if data is None else data
    return tr.IvfRabitqIndex.train(data, nlist=NLIST, total_bits=7, seed=3,
                                   scan_dtype=scan_dtype, device="cpu")


def _relayout_ivf(tmp_path):
    index = _with_sentinel(_ivf("f32"))
    index.scan_dtype = "fused8"  # the sorted layout, built at the next use
    index._scan_inputs(None)
    return index


def _rematerialize_ivf(tmp_path):
    index = _ivf("fused8")
    index.host  # the host copy the layout is laid out again from
    index._layout = None
    _with_sentinel(index)
    index.layout
    return index


def _streamed_release(tmp_path):
    index = _with_sentinel(_ivf("fused8"))
    tr.StreamedIvfIndex(index, chunk_rows=1024)
    assert index._layout is None
    return index


def _loaded_ivf(tmp_path):
    index = _with_sentinel(_ivf("fused8"))
    index.save_to_path(tmp_path / "ivf.rbq")
    loaded = tr.IvfRabitqIndex.load_from_path(tmp_path / "ivf.rbq", scan_dtype="fused8",
                                              device="cpu")
    assert loaded._fused_scan is not index._fused_scan
    return loaded


def _brute_force(scan_dtype="bf16"):
    return tr.BruteForceRabitqIndex.train(_data(500), total_bits=7, seed=3,
                                          scan_dtype=scan_dtype, device="cpu")


def _bf_layout(tmp_path):
    _brute_force().save_to_path(tmp_path / "bf.rbf")
    index = tr.BruteForceRabitqIndex.load_from_path(tmp_path / "bf.rbf", device="cpu")
    _with_sentinel(index)
    index.layout  # assembled from the loaded host arrays
    return index


def _bf_packed(tmp_path):
    index = _with_sentinel(_brute_force("bf16"))
    index.scan_dtype = "packed"
    index.batch_search(_data(4), tr.BruteForceSearchParams(top_k=5))
    assert index._packed is not None
    return index


def _mstg_relayout(tmp_path):
    cfg = tr.MstgConfig(max_posting_size=100, faster_config=True, use_rotator=True)
    index = tr.MstgIndex.build(_data(1000), cfg, seed=3, scan_dtype="fused8", device="cpu")
    index.layout
    _with_sentinel(index)
    index.scan_dtype = "packed"  # the permuted layout, laid out at the next use
    index.layout
    return index


@pytest.mark.parametrize("replace", [
    _relayout_ivf, _rematerialize_ivf, _streamed_release, _loaded_ivf, _bf_layout, _bf_packed,
    _mstg_relayout,
], ids=lambda f: f.__name__.strip("_"))
def test_replacing_a_layout_drops_the_graphs(replace, tmp_path):
    """Every call that replaces a tensor the graphs read (a new layout, the
    layout released, the packed plane) drops the index's graphs."""
    assert _dropped(replace(tmp_path))


def test_fused_search_is_the_index_search(monkeypatch):
    """IVF, brute-force and MSTG searches all go through the index's fused
    search, as in the JAX package."""
    calls = []
    real = tscan.FusedSearch.__call__
    monkeypatch.setattr(tscan.FusedSearch, "__call__",
                        lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    data = _data(1000)
    ivf = _ivf("fused8", data)
    ivf.batch_search_arrays(data[:4], tr.SearchParams(TOP_K, NPROBE))
    ivf.batch_search_arrays_pipelined(data[:40], tr.SearchParams(TOP_K, NPROBE), batch_size=16)
    ivf.search_with_diagnostics(data[0], tr.SearchParams(TOP_K, NPROBE))
    assert len(calls) == 1 + 3 + 1
    _brute_force().batch_search(data[:4], tr.BruteForceSearchParams(top_k=5))
    assert len(calls) == 6
    cfg = tr.MstgConfig(max_posting_size=100, faster_config=True, use_rotator=True)
    mstg = tr.MstgIndex.build(data, cfg, seed=3, scan_dtype="fused8", device="cpu")
    mstg.batch_search(data[:4], tr.MstgSearchParams(top_k=5, ef_search=4))
    assert len(calls) == 7


def test_scan_args_match_jax(indexes):
    """DeviceLayout.scan_args: the JAX package's tuple, in its order, on the
    carried layout."""
    _, idx = indexes
    jidx, tidx = idx["f32"]
    j_args = jidx.device.scan_args()
    t_args = tidx.layout.scan_args()
    assert len(t_args) == len(j_args) == 10
    for t, j in zip(t_args, j_args):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert t_args[8] is tidx.layout.valid and t_args[9] is tidx.layout.ids


def test_build_codes_match_jax():
    """build_codes: host arrays with the JAX package's types and values from
    the same rows, rotated centroids and assignments (constant t)."""
    rng = np.random.default_rng(4)
    dim, n, c = 96, 700, 12
    data = rng.standard_normal((n, dim)).astype(np.float32)
    cents = rng.standard_normal((c, dim)).astype(np.float32) * 0.5
    assign = rng.integers(0, c, n)
    jrot, trot = JRot(dim, seed=5), TRot(dim, seed=5)
    rc = np.asarray(jrot.rotate(jnp.asarray(cents)))
    kw = dict(ex_bits=6, use_t_const=True, t_const=5.3)
    j = jbuild.build_codes(data, rc, assign, rotator=jrot, metric=jr.Metric.L2, **kw)
    t = tbuild.build_codes(data, rc, assign, rotator=trot, metric=tr.Metric.L2, device="cpu",
                           **kw)
    assert set(t) == set(j)
    for name in j:
        assert t[name].dtype == j[name].dtype and t[name].shape == j[name].shape, name
    np.testing.assert_array_equal(t["binary"], j["binary"])
    ex_t, ex_j = t["ex"].astype(np.int64), j["ex"].astype(np.int64)
    assert np.mean(ex_t == ex_j) >= 0.999 and np.abs(ex_t - ex_j).max() <= 1
    same = (ex_t == ex_j).all(axis=1)
    for name in ("f_add", "f_rescale", "f_error", "f_add_ex", "f_rescale_ex", "delta", "vl"):
        np.testing.assert_allclose(t[name][same], j[name][same], rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_warm_session_matches_jax():
    """warm_session: one synchronized device op, its seconds rounded to 0.01
    as the JAX package's; the port's names its device (the CPU here)."""
    for s in (jtransfer.warm_session(), ttransfer.warm_session("cpu")):
        assert isinstance(s, float) and s >= 0.0 and round(s, 2) == s
