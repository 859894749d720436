"""The port's RBQ1 / RBF1 files against the JAX package's, on the CPU.

The golden files load in the port and search as in the JAX package; the
port rewrites them, and files written by either package, byte for byte.
Searches compared for equal ids run the f32 configuration with exact
selection (``approx_topk=False``), where both packages score and rank the
same codes the same way. ``fetch_embedding`` agrees with the JAX package's
to 1e-5 (rtol and atol: the two inverse FHTs round alike, the products
with the codes may not). Malformed files raise ``InvalidPersistence`` with
the JAX package's message.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import pytest

import rabitq_tpu as jr
import rabitq_tpu_torch as tr

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
IVF, BF = os.path.join(GOLDEN, "tiny_ivf.rbq"), os.path.join(GOLDEN, "tiny_bf.rbf")


@pytest.fixture(scope="module")
def tiny_data():
    return np.load(os.path.join(GOLDEN, "tiny_data.npy"))


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


def _ids(hits):
    return [[h.id for h in row] for row in hits]


@pytest.fixture(scope="module")
def jax_index():
    data = np.random.default_rng(5).standard_normal((900, 64)).astype(np.float32)
    return data, jr.IvfRabitqIndex.train(data, nlist=6, total_bits=7, seed=21, scan_dtype="f32")


def test_golden_files_load_and_search_as_in_jax(tiny_data):
    t = tr.IvfRabitqIndex.load_from_path(IVF, scan_dtype="f32", device="cpu")
    j = jr.IvfRabitqIndex.load_from_path(IVF, scan_dtype="f32")
    assert (t.dim, t.cluster_count(), len(t), t.ex_bits) == (64, 4, 96, 6)
    assert t.metric is tr.Metric.L2 and not t.approx_topk
    for nprobe in (1, 4):
        t_ids, t_d = t.batch_search_arrays(tiny_data[:16], tr.SearchParams(5, nprobe))
        j_ids, j_d = j.batch_search_arrays(tiny_data[:16], jr.SearchParams(5, nprobe))
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_allclose(t_d, j_d, rtol=1e-5, atol=1e-4)
    assert t_ids[:, 0].tolist() == list(range(16))

    tb = tr.BruteForceRabitqIndex.load_from_path(BF, scan_dtype="f32", device="cpu")
    jb = jr.BruteForceRabitqIndex.load_from_path(BF, scan_dtype="f32")
    assert (tb.dim, len(tb), tb.ex_bits, tb.metric) == (64, 96, 2, tr.Metric.InnerProduct)
    t_hits = tb.batch_search(tiny_data[:16], tr.BruteForceSearchParams(top_k=5))
    j_hits = jb.batch_search(tiny_data[:16], jr.BruteForceSearchParams(top_k=5))
    assert _ids(t_hits) == _ids(j_hits)
    np.testing.assert_allclose([[h.score for h in r] for r in t_hits],
                               [[h.score for h in r] for r in j_hits], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("scan_dtype", ["f32", "fused8"])
def test_golden_files_rewrite_byte_identical(tmp_path, scan_dtype):
    """load -> save reproduces both golden files from the host copy the
    load keeps; the IVF file also, with that copy dropped, from the device
    layout of either layout mode."""
    for name, load in (("tiny_ivf.rbq", tr.IvfRabitqIndex.load_from_path),
                       ("tiny_bf.rbf", tr.BruteForceRabitqIndex.load_from_path)):
        src = os.path.join(GOLDEN, name)
        index = load(src, scan_dtype=scan_dtype, device="cpu")
        index.save_to_path(tmp_path / name)
        assert (tmp_path / name).read_bytes() == open(src, "rb").read(), name
    index = tr.IvfRabitqIndex.load_from_path(IVF, scan_dtype=scan_dtype, device="cpu")
    index.layout  # noqa: B018  (lays the codes out on the device)
    index._host = None
    index.save_to_path(tmp_path / "again.rbq")
    assert (tmp_path / "again.rbq").read_bytes() == open(IVF, "rb").read()


@pytest.mark.parametrize("rt", ["FhtKacRotator", "MatrixRotator"])
def test_jax_files_round_trip_through_the_port(tmp_path, rt):
    """A JAX-trained index: the JAX save, loaded and saved by the port, is
    the same file; the port's save of the index carried across with
    ``from_host_arrays`` is that file too; and a port save loads in the JAX
    package with equal search ids."""
    data = np.random.default_rng(7).standard_normal((700, 48)).astype(np.float32)
    jidx = jr.IvfRabitqIndex.train(
        data, nlist=5, total_bits=5, seed=4, rotator_type=jr.RotatorType[rt], scan_dtype="f32"
    )
    jidx.save_to_path(tmp_path / "jax.rbq")
    tr.IvfRabitqIndex.load_from_path(tmp_path / "jax.rbq", device="cpu").save_to_path(
        tmp_path / "port.rbq")
    assert (tmp_path / "port.rbq").read_bytes() == (tmp_path / "jax.rbq").read_bytes()
    _carry(jidx, "bf16").save_to_path(tmp_path / "carried.rbq")
    assert (tmp_path / "carried.rbq").read_bytes() == (tmp_path / "jax.rbq").read_bytes()
    back = jr.IvfRabitqIndex.load_from_path(tmp_path / "carried.rbq", scan_dtype="f32")
    params = (10, 3)
    np.testing.assert_array_equal(
        back.batch_search_arrays(data[:12], jr.SearchParams(*params))[0],
        tr.IvfRabitqIndex.load_from_path(tmp_path / "carried.rbq", scan_dtype="f32",
                                         device="cpu").batch_search_arrays(
            data[:12], tr.SearchParams(*params))[0],
    )


@pytest.mark.parametrize("total_bits", [1, 3, 5, 7])
@pytest.mark.parametrize("rt", [tr.RotatorType.FhtKacRotator, tr.RotatorType.MatrixRotator])
def test_port_index_round_trip(tmp_path, total_bits, rt):
    """An index the port trained, saved and loaded: equal codes, a second
    save identical to the first, equal ids, and the JAX package reads the
    same file to the same ids."""
    data = np.random.default_rng(total_bits).standard_normal((500, 64)).astype(np.float32)
    index = tr.IvfRabitqIndex.train(
        data, nlist=6, total_bits=total_bits, rotator_type=rt, seed=21, scan_dtype="f32",
        device="cpu",
    )
    index.save_to_path(tmp_path / "a.rbq")
    loaded = tr.IvfRabitqIndex.load_from_path(tmp_path / "a.rbq", scan_dtype="f32", device="cpu")
    h0, h1 = index.host, loaded.host
    for f in ("binary_bits", "ex_codes", "ids", "cluster_offsets", "centroids", "f_add",
              "f_rescale", "f_error", "f_add_ex", "f_rescale_ex", "delta", "vl"):
        np.testing.assert_array_equal(getattr(h0, f), getattr(h1, f), err_msg=f)
    loaded.save_to_path(tmp_path / "b.rbq")
    assert (tmp_path / "a.rbq").read_bytes() == (tmp_path / "b.rbq").read_bytes()
    params = tr.SearchParams(top_k=10, nprobe=6)
    want = index.batch_search_arrays(data[:8], params)[0]
    np.testing.assert_array_equal(loaded.batch_search_arrays(data[:8], params)[0], want)
    jidx = jr.IvfRabitqIndex.load_from_path(tmp_path / "a.rbq", scan_dtype="f32")
    np.testing.assert_array_equal(
        jidx.batch_search_arrays(data[:8], jr.SearchParams(top_k=10, nprobe=6))[0], want)


def test_brute_force_files_cross_load(tmp_path, tiny_data):
    """RBF1 written by either package loads in the other with equal ids."""
    jb = jr.BruteForceRabitqIndex.train(tiny_data, total_bits=4, seed=2, scan_dtype="f32")
    jb.save_to_path(tmp_path / "jax.rbf")
    tb = tr.BruteForceRabitqIndex.load_from_path(tmp_path / "jax.rbf", scan_dtype="f32",
                                                 device="cpu")
    params = (tr.BruteForceSearchParams(top_k=7), jr.BruteForceSearchParams(top_k=7))
    assert _ids(tb.batch_search(tiny_data[:10], params[0])) == _ids(
        jb.batch_search(tiny_data[:10], params[1]))
    tb.save_to_path(tmp_path / "port.rbf")
    assert (tmp_path / "port.rbf").read_bytes() == (tmp_path / "jax.rbf").read_bytes()
    own = tr.BruteForceRabitqIndex.train(tiny_data, total_bits=4, seed=2, scan_dtype="f32",
                                         device="cpu")
    own.save_to_path(tmp_path / "own.rbf")  # the host copy downloaded from the layout
    back = jr.BruteForceRabitqIndex.load_from_path(tmp_path / "own.rbf", scan_dtype="f32")
    assert _ids(back.batch_search(tiny_data[:10], params[1])) == _ids(
        own.batch_search(tiny_data[:10], params[0]))
    tr.BruteForceRabitqIndex.load_from_path(tmp_path / "own.rbf", device="cpu").save_to_path(
        tmp_path / "own2.rbf")
    assert (tmp_path / "own2.rbf").read_bytes() == (tmp_path / "own.rbf").read_bytes()


def _resealed(body: bytes) -> bytes:
    """A file with its CRC recomputed over ``body`` (magic + version +
    hashed fields)."""
    return body + struct.pack("<I", zlib.crc32(body[8:]))


def _malformed(path):
    raw = open(path, "rb").read()
    body = raw[:-4]
    out = {
        "bad magic": b"XXXX" + raw[4:],
        "bad version": raw[:4] + struct.pack("<I", 9) + raw[8:],
        "corrupted": raw[:200] + bytes([raw[200] ^ 0xFF]) + raw[201:],
        "truncated, old crc": raw[:-40],
        "truncated, resealed": _resealed(body[:-40]),
        "too short": raw[:10],
        # header: dim at 8, padded_dim at 12, tags at 16..19 (metric,
        # rotator, ex_bits, total_bits), vector count at 20
        "zero dim": _resealed(body[:8] + struct.pack("<I", 0) + body[12:]),
        "rotator tag": _resealed(body[:17] + bytes([7]) + body[18:]),
        "total_bits mismatch": _resealed(body[:19] + bytes([body[19] + 1]) + body[20:]),
    }
    if raw[:4] == b"RBQ1":
        # the first cluster's size field follows the cluster count, the
        # rotator and the first centroid
        rot_len = struct.unpack("<Q", body[36:44])[0]
        at = 44 + rot_len + 4 * struct.unpack("<I", body[12:16])[0]
        out["huge cluster"] = _resealed(body[:at] + struct.pack("<Q", 2_000_000) + body[at + 8:])
        out["vector count"] = _resealed(body[:20] + struct.pack("<Q", 95) + body[28:])
    return out


@pytest.mark.parametrize("which", ["ivf", "bf"])
def test_malformed_files_raise_as_in_jax(tmp_path, which):
    path, t_load, j_load = {
        "ivf": (IVF, tr.IvfRabitqIndex.load_from_path, jr.IvfRabitqIndex.load_from_path),
        "bf": (BF, tr.BruteForceRabitqIndex.load_from_path,
               jr.BruteForceRabitqIndex.load_from_path),
    }[which]
    for case, raw in _malformed(path).items():
        bad = tmp_path / f"{case.replace(' ', '_')}.bin"
        bad.write_bytes(raw)
        with pytest.raises(jr.InvalidPersistence) as j_err:
            j_load(bad)
        with pytest.raises(tr.InvalidPersistence) as t_err:
            t_load(bad, device="cpu")
        assert str(t_err.value) == str(j_err.value), case


@pytest.mark.parametrize("scan_dtype", ["fused8", "bf16"])
def test_fetch_embedding_matches_jax(jax_index, scan_dtype):
    """From the host copy, and from the device layout (cluster-sorted for
    fused8, permuted for bf16) once it is dropped."""
    data, jidx = jax_index
    tidx = _carry(jidx, scan_dtype)
    ids = [0, 7, 450, 899]
    want = [jidx.fetch_embedding(i) for i in ids]
    for _ in range(2):
        for i, w in zip(ids, want):
            got = tidx.fetch_embedding(i)
            assert got.shape == (64,) and got.dtype == np.float32
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5)
        tidx.layout  # noqa: B018
        tidx._host = None
    assert tidx.fetch_embedding(10_000) is None and jidx.fetch_embedding(10_000) is None
    rel = np.linalg.norm(want[0] - data[0]) / np.linalg.norm(data[0])
    assert rel < 0.05  # 7-bit codes rebuild the row closely


def test_load_index_picks_the_type(tmp_path):
    ivf = tr.load_index(IVF, device="cpu")
    bf = tr.load_index(BF, scan_dtype="f32", device="cpu")
    assert ivf.is_ivf and not ivf.is_brute_force and ivf.kind == "ivf"
    assert isinstance(ivf.as_ivf(), tr.IvfRabitqIndex) and len(ivf) == 96
    assert bf.is_brute_force and isinstance(bf.as_brute_force(), tr.BruteForceRabitqIndex)
    assert bf.scan_dtype == "f32" and ivf.cluster_count() == 4  # passed through
    with pytest.raises(TypeError):
        bf.as_ivf()
    (tmp_path / "x.bin").write_bytes(b"NOPE" + bytes(16))
    with pytest.raises(tr.InvalidPersistence, match="unrecognized file header"):
        tr.load_index(tmp_path / "x.bin", device="cpu")
