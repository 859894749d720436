"""The port's copies of the MSTG reference-format modules
(``rabitq_tpu_torch/index/mstg/{hnsw_graph,hnswio,ref_io}.py``): the cases of
``tests/test_mstg_hnswio.py`` against them, the same graph and the same dump
bytes as the JAX package's, and reference-format files (``.mstg`` body and
hnsw side files) written by either package read by the other."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import rabitq_tpu as jr
import rabitq_tpu_torch as tr
from rabitq_tpu.index.mstg import hnsw_graph as jg
from rabitq_tpu.index.mstg import hnswio as jio
from rabitq_tpu_torch.index.mstg import ref_io as tref
from rabitq_tpu_torch.index.mstg.hnsw_graph import NB_LAYER_MAX, build_hnsw, search_hnsw
from rabitq_tpu_torch.index.mstg.hnswio import (
    DIST_L2_NAME,
    MAGICDATAP,
    MAGICDESCR,
    HnswDumpError,
    dump_hnsw,
    parse_hnsw_dump,
)

HOST_FIELDS = ("binary_bits", "ex_codes", "f_add", "f_rescale", "f_add_ex", "f_rescale_ex",
               "delta", "vl", "ids", "list_offsets", "centroids", "f_error", "residual_norm")


@pytest.fixture(scope="module")
def small_graph():
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((400, 24)).astype(np.float32)
    return vecs, build_hnsw(vecs, seed=11)


def test_builder_structure_and_jax_parity(small_graph):
    vecs, g = small_graph
    n = vecs.shape[0]
    assert g.levels.shape == (n,)
    assert int(g.levels[g.entry_point]) == int(g.levels.max())
    for p in range(n):
        assert len(g.neighbors[p]) == int(g.levels[p]) + 1
        for l, lst in enumerate(g.neighbors[p]):
            assert len(lst) <= (2 * g.m if l == 0 else g.m)
            assert p not in lst
            for q in lst:
                assert int(g.levels[q]) >= l
    j = jg.build_hnsw(vecs, seed=11)  # the same graph as the JAX package's
    np.testing.assert_array_equal(g.levels, j.levels)
    assert g.neighbors == j.neighbors and g.entry_point == j.entry_point


def test_builder_navigable(small_graph):
    vecs, g = small_graph
    rng = np.random.default_rng(5)
    queries = rng.standard_normal((32, vecs.shape[1])).astype(np.float32)
    d2 = ((queries[:, None, :] - vecs[None, :, :]) ** 2).sum(-1)
    exact = np.argsort(d2, axis=1)[:, :10]
    hits = 0
    for qi, q in enumerate(queries):
        ids, _ = search_hnsw(g, q, k=10, ef=64)
        hits += len(set(int(i) for i in ids) & set(int(i) for i in exact[qi]))
    assert hits / (32 * 10) >= 0.95


def test_dump_parse_roundtrip_and_jax_bytes(tmp_path, small_graph):
    vecs, g = small_graph
    base = str(tmp_path / "centroids")
    gp, dp = dump_hnsw(base, g)
    assert gp.endswith(".hnsw.graph") and dp.endswith(".hnsw.data")
    jbase = str(tmp_path / "jax")
    jgp, jdp = jio.dump_hnsw(jbase, jg.build_hnsw(vecs, seed=11))
    assert open(gp, "rb").read() == open(jgp, "rb").read()
    assert open(dp, "rb").read() == open(jdp, "rb").read()

    parsed = parse_hnsw_dump(base)
    n = vecs.shape[0]
    assert parsed["nb_point"] == n and parsed["dimension"] == vecs.shape[1]
    assert parsed["max_nb_connection"] == g.m and parsed["nb_layer"] == NB_LAYER_MAX
    assert parsed["ef_construction"] == g.ef_construction
    assert parsed["distname"] == DIST_L2_NAME and parsed["t_name"] == "f32"
    assert parsed["dumpmode"] == 1
    assert set(parsed["vectors"].keys()) == set(range(n))
    for p in range(0, n, 37):
        np.testing.assert_array_equal(parsed["vectors"][p], vecs[p])
        assert parsed["levels"][p] == int(g.levels[p])
        nb = parsed["neighbors"][p]
        assert len(nb) == int(g.levels[p]) + 1
        for l, lst in enumerate(nb):
            assert [i for i, _ in lst] == g.neighbors[p][l]
            for i, dist in lst:
                assert dist == pytest.approx(float(np.linalg.norm(vecs[p] - vecs[i])), rel=1e-5)
    j_parsed = jio.parse_hnsw_dump(base)
    assert j_parsed["levels"] == parsed["levels"] and j_parsed["ranks"] == parsed["ranks"]


def test_dump_detects_corruption(tmp_path, small_graph):
    _, g = small_graph
    base = str(tmp_path / "c")
    gp, _ = dump_hnsw(base, g)
    raw = bytearray(open(gp, "rb").read())
    raw[0] ^= 0xFF  # clobber the description magic
    open(gp, "wb").write(bytes(raw))
    with pytest.raises(HnswDumpError, match="description magic"):
        parse_hnsw_dump(base)


def test_magic_constants_layout(tmp_path, small_graph):
    vecs, g = small_graph
    gp, dp = dump_hnsw(str(tmp_path / "anchor"), g)
    graw, draw = open(gp, "rb").read(), open(dp, "rb").read()
    assert graw[:4] == MAGICDESCR.to_bytes(4, "little")
    assert (graw[4], graw[5], graw[6]) == (1, 32, 16)
    assert int.from_bytes(graw[7:15], "little") == 200
    assert int.from_bytes(graw[15:23], "little") == vecs.shape[0]
    assert int.from_bytes(graw[23:31], "little") == vecs.shape[1]
    namelen = int.from_bytes(graw[31:39], "little")
    assert graw[39 : 39 + namelen].decode() == DIST_L2_NAME
    assert draw[:4] == MAGICDATAP.to_bytes(4, "little")
    assert int.from_bytes(draw[4:12], "little") == vecs.shape[0]
    assert int.from_bytes(draw[12:20], "little") == vecs.shape[1]


def _jax_index(use_rotator=False):
    rng = np.random.default_rng(9)
    data = rng.standard_normal((600, 32)).astype(np.float32)
    cfg = jr.MstgConfig(max_posting_size=128, rabitq_bits=7, use_rotator=use_rotator,
                        faster_config=True)
    return data, jr.MstgIndex.build(data, cfg, seed=4, scan_dtype="f32")


def _carry(jidx, scan_dtype="f32"):
    kw = {f.name: getattr(jidx.config, f.name) for f in dataclasses.fields(jidx.config)}
    kw["metric"] = tr.Metric.from_str(jidx.config.metric.value)
    kw["centroid_precision"] = tr.ScalarPrecision(jidx.config.centroid_precision.value)
    h = jidx.host
    return tr.MstgIndex.from_host_arrays(
        config=tr.MstgConfig(**kw), dim=jidx.dim, **{f: getattr(h, f) for f in HOST_FIELDS},
        rotator_bytes=jidx.rotator.serialize() if jidx.rotator is not None else b"",
        scan_dtype=scan_dtype, device="cpu",
    )


def test_reference_save_emits_three_files(tmp_path):
    data, jidx = _jax_index()
    index = _carry(jidx)
    base = str(tmp_path / "interop")
    index.save_to_path(base, format="reference")
    for suffix in (".mstg", ".hnsw.graph", ".hnsw.data"):
        assert (tmp_path / f"interop{suffix}").exists(), suffix
    parsed = parse_hnsw_dump(base)
    n_lists = index.posting_list_count()
    assert parsed["nb_point"] == n_lists
    for i in range(n_lists):
        np.testing.assert_array_equal(parsed["vectors"][i], index.host.centroids[i])
    loaded = tref.load_reference_mstg(base + ".mstg", device="cpu")
    assert loaded.posting_list_count() == n_lists
    with pytest.raises(tr.InvalidPersistence):
        _carry(_jax_index(use_rotator=True)[1]).save_to_path(str(tmp_path / "rot"),
                                                             format="reference")


def test_reference_files_cross_read(tmp_path):
    """The three files written by each package are byte-equal, and each
    package loads the other's ``.mstg`` (through ``load_from_path``'s
    version-1 branch) to the same host arrays, searched alike."""
    data, jidx = _jax_index()
    tidx = _carry(jidx)
    jbase, tbase = str(tmp_path / "jax"), str(tmp_path / "port")
    jidx.save_to_path(jbase, format="reference")
    tidx.save_to_path(tbase, format="reference")
    for suffix in (".mstg", ".hnsw.graph", ".hnsw.data"):
        assert open(tbase + suffix, "rb").read() == open(jbase + suffix, "rb").read(), suffix
    t_from_j = tr.MstgIndex.load_from_path(jbase + ".mstg", scan_dtype="f32", device="cpu")
    j_from_t = jr.MstgIndex.load_from_path(tbase + ".mstg", scan_dtype="f32")
    assert t_from_j.config.refine_ex is False and t_from_j.rotator is None
    for f in HOST_FIELDS:
        np.testing.assert_array_equal(getattr(t_from_j.host, f), getattr(j_from_t.host, f), f)
        np.testing.assert_array_equal(getattr(t_from_j.host, f), getattr(jidx.host, f), f)
    again = str(tmp_path / "again")
    t_from_j.save_to_path(again, format="reference")
    assert open(again + ".mstg", "rb").read() == open(jbase + ".mstg", "rb").read()
    params = dict(top_k=5, ef_search=16)
    want = j_from_t.batch_search(data[:4], jr.MstgSearchParams(**params))
    got = t_from_j.batch_search(data[:4], tr.MstgSearchParams(**params))
    assert [[h.id for h in r] for r in got] == [[h.id for h in r] for r in want]
