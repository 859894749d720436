"""The port's front ends on the CPU, against the JAX package's: the
binding-parity classes (``rabitq_tpu_torch.bindings``), fvecs/ivecs I/O and
the CLI (``python -m rabitq_tpu_torch``, run in-process through ``main``).

The bindings are compared on the same codes: a JAX index, trained or built
by the JAX binding, is carried into the port's binding with
``from_host_arrays`` (the two packages' k-means draw other seeds). Both
serve the f32 oracle configuration, so ids are equal per query; distances
rtol 1e-5 with an absolute floor of 1e-5 of the largest distance (f32 sums
in another order). Files are compared byte for byte.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

import rabitq_tpu as jr
import rabitq_tpu.__main__ as jcli
import rabitq_tpu_torch as tr
from rabitq_tpu import bindings as jb
from rabitq_tpu.io import vecio as jvecio
from rabitq_tpu_torch import bindings as tb
from rabitq_tpu_torch import io as tio
from rabitq_tpu_torch.__main__ import main

DIM = 32
MSTG_FIELDS = ("binary_bits", "ex_codes", "f_add", "f_rescale", "f_add_ex", "f_rescale_ex",
               "delta", "vl", "ids", "list_offsets", "centroids", "f_error", "residual_norm")


def _data(n=800, dim=DIM, seed=42):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)


def _same(t_arrays, j_arrays):
    for t, j in zip(t_arrays, j_arrays):
        np.testing.assert_array_equal(t[:, 0], j[:, 0])
        scale = np.abs(j[:, 1]).max(initial=1.0)
        np.testing.assert_allclose(t[:, 1], j[:, 1], rtol=1e-5, atol=1e-5 * scale)


def _carry_ivf(jidx) -> tr.IvfRabitqIndex:
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
        scan_dtype=jidx.scan_dtype, device="cpu",
    )


def _carry_mstg(jidx) -> tr.MstgIndex:
    kw = {f.name: getattr(jidx.config, f.name) for f in dataclasses.fields(jidx.config)}
    kw["metric"] = tr.Metric.from_str(jidx.config.metric.value)
    kw["centroid_precision"] = tr.ScalarPrecision(jidx.config.centroid_precision.value)
    return tr.MstgIndex.from_host_arrays(
        config=tr.MstgConfig(**kw), dim=jidx.dim,
        **{f: getattr(jidx.host, f) for f in MSTG_FIELDS},
        rotator_bytes=jidx.rotator.serialize() if jidx.rotator is not None else b"",
        scan_dtype=jidx.scan_dtype, device="cpu",
    )


@pytest.mark.parametrize("metric", ["euclidean", "angular"])
def test_ivf_binding_matches_jax(metric):
    data = _data()
    j = jb.IvfRabitqIndex(DIM, metric=metric)
    j.fit(data, nlist=8, total_bits=7, rotator_type="fht", seed=1, scan_dtype="f32")
    t = tb.IvfRabitqIndex(DIM, metric=metric, device="cpu")
    assert t.metric.value == j.metric.value and len(t) == 0
    t.index = _carry_ivf(j.index)
    assert (len(t), t.cluster_count(), repr(t)) == (len(j), j.cluster_count(), repr(j))
    _same([t.query(data[0], 5, 8)], [j.query(data[0], 5, 8)])
    assert int(t.query(data[0], 5, 8)[0, 0]) == 0
    # <= 256 queries: one batch; more: the pipelined loop
    for queries in (data[:4], np.concatenate([data, data])[:300]):
        t_res, j_res = t.batch_query(queries, 5, 8), j.batch_query(queries, 5, 8)
        assert len(t_res) == len(j_res) == len(queries)
        assert all(r.shape == (5, 2) and r.dtype == np.float32 for r in t_res)
        _same(t_res, j_res)


def test_ivf_binding_surface(tmp_path):
    data = _data(400)
    index = tb.IvfRabitqIndex(DIM, device="cpu")
    with pytest.raises(RuntimeError):
        index.query(data[0], 5, 4)
    with pytest.raises(ValueError):
        tb.IvfRabitqIndex(DIM, metric="cosine", device="cpu")
    with pytest.raises(ValueError):
        index.fit(data[:, :16], nlist=8)
    index.fit(data, nlist=8, total_bits=7, rotator_type="fht", seed=1)
    assert index.index.device.type == "cpu" and index.index.scan_dtype == "bf16"
    assert index.cluster_count() == 8 and len(index) == 400
    res = index.query(data[0], k=5, nprobe=8)
    assert res.shape == (5, 2) and int(res[0, 0]) == 0
    p = str(tmp_path / "i.rbq")
    index.save(p)
    other = tb.IvfRabitqIndex(DIM, device="cpu")
    other.load(p)
    np.testing.assert_array_equal(other.query(data[0], 5, 8)[:, 0], res[:, 0])
    # the JAX binding reads the port's file
    j = jb.IvfRabitqIndex(DIM)
    j.load(p)
    assert len(j) == 400 and int(j.query(data[0], 5, 8)[0, 0]) == 0
    km = jr.ops.kmeans.run_kmeans(data, 8, niter=10, seed=3)
    clustered = tb.IvfRabitqIndex(DIM, device="cpu")
    clustered.fit_with_clusters(data, km.centroids, km.assignments, total_bits=5)
    assert len(clustered) == 400 and clustered.cluster_count() == 8
    assert int(clustered.query(data[3], 3, 8)[0, 0]) == 3


def _jax_mstg(data):
    j = jb.MstgIndex(DIM, max_posting_size=100, branching_factor=4)
    j.fit(data)
    # the f32 oracle configuration on the same codes
    j.index = jr.MstgIndex(j.index.config, j.index.dim, j.index.host, "f32",
                           rotator=j.index.rotator)
    return j


def test_mstg_binding_matches_jax():
    data = _data()
    j = _jax_mstg(data)
    t = tb.MstgIndex(DIM, max_posting_size=100, branching_factor=4, device="cpu")
    assert {f.name: getattr(t.config, f.name) for f in dataclasses.fields(t.config)
            if f.name not in ("metric", "centroid_precision")} == {
        f.name: getattr(j.config, f.name) for f in dataclasses.fields(j.config)
        if f.name not in ("metric", "centroid_precision")}
    t.index = _carry_mstg(j.index)
    assert (len(t), repr(t)) == (len(j), repr(j))
    assert t.get_memory_usage() == j.get_memory_usage() > 0
    for ef, eps in ((16, 0.6), (40, 0.3)):
        t.set_query_arguments(ef_search=ef, pruning_epsilon=eps)
        j.set_query_arguments(ef_search=ef, pruning_epsilon=eps)
        assert t.index.config.default_ef_search == ef and t.index.config.pruning_epsilon == eps
        _same([t.query(data[2], 5)], [j.query(data[2], 5)])
        for queries in (data[:3], np.concatenate([data, data])[:300]):
            _same(t.batch_query(queries, 5), j.batch_query(queries, 5))


def test_mstg_binding_surface(tmp_path):
    data = _data(400)
    index = tb.MstgIndex(DIM, max_posting_size=100, branching_factor=4, device="cpu")
    with pytest.raises(RuntimeError):
        index.query(np.zeros(DIM, np.float32), 5)
    with pytest.raises(ValueError):
        tb.MstgIndex(DIM, metric="cosine", device="cpu")
    with pytest.raises(ValueError):
        tb.MstgIndex(DIM, centroid_precision="fp64", device="cpu")
    index.set_query_arguments(ef_search=50, pruning_epsilon=0.3)
    assert index.config.default_ef_search == 50 and index.config.pruning_epsilon == 0.3
    index.fit(data)
    assert len(index) == 400 and index.index.device.type == "cpu"
    res = index.query(data[0], k=5)
    assert res.shape == (5, 2) and res.dtype == np.float32 and int(res[0, 0]) == 0
    with pytest.raises(ValueError):
        index.query(data[:2], 5)
    with pytest.raises(ValueError):
        index.batch_query(data[0], 5)
    assert tb.MstgIndex(DIM, metric="angular", max_posting_size=100, device="cpu") is not None
    p = str(tmp_path / "m.mstg")
    index.save(p)
    loaded = tb.MstgIndex.load(p, device="cpu")
    assert len(loaded) == 400 and loaded.index.device.type == "cpu"
    assert loaded.config.max_posting_size == 100
    np.testing.assert_array_equal(loaded.query(data[2], 5)[:, 0], index.query(data[2], 5)[:, 0])
    assert len(jb.MstgIndex.load(p)) == 400  # the JAX binding reads the port's file


def test_vecio_round_trips_both_packages(tmp_path):
    rng = np.random.default_rng(1)
    data = rng.standard_normal((50, 16)).astype(np.float32)
    ints = rng.integers(0, 1000, (50, 10)).astype(np.int32)
    for name, t_write, j_write, arr in (("x.fvecs", tio.write_fvecs, jvecio.write_fvecs, data),
                                        ("x.ivecs", tio.write_ivecs, jvecio.write_ivecs, ints)):
        t_write(tmp_path / f"t{name}", arr)
        j_write(tmp_path / f"j{name}", arr)
        assert (tmp_path / f"t{name}").read_bytes() == (tmp_path / f"j{name}").read_bytes()
    f, i = tmp_path / "tx.fvecs", tmp_path / "tx.ivecs"
    for read_t, read_j, path, arr in ((tio.read_fvecs, jvecio.read_fvecs, f, data),
                                      (tio.read_ivecs, jvecio.read_ivecs, i, ints),
                                      (tio.read_groundtruth, jvecio.read_groundtruth, i, ints)):
        got = read_t(path)
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got, arr)
        np.testing.assert_array_equal(read_j(path), got)
        np.testing.assert_array_equal(read_t(path, limit=10), arr[:10])
    tio.write_ivecs(tmp_path / "ids.ivecs", ints[:, :1])
    np.testing.assert_array_equal(tio.read_ids(tmp_path / "ids.ivecs"), ints[:, 0].astype(np.int64))
    np.testing.assert_array_equal(tio.read_ids(tmp_path / "ids.ivecs"),
                                  jvecio.read_ids(tmp_path / "ids.ivecs"))
    (tmp_path / "empty.fvecs").write_bytes(b"")
    assert tio.read_fvecs(tmp_path / "empty.fvecs").shape == (0, 0)


def test_vecio_errors(tmp_path):
    """The same ``InvalidPersistence`` cases as the JAX package's reader."""
    good = tmp_path / "g.fvecs"
    tio.write_fvecs(good, np.ones((4, 8), np.float32))
    raw = good.read_bytes()
    bad = {
        "truncated": raw[:-3],
        "short": raw[:2],
        "dim": np.array([0], "<i4").tobytes() + raw[4:],
        "rows": raw[:36] + np.array([9], "<i4").tobytes() + raw[40:],
    }
    for name, blob in bad.items():
        p = tmp_path / f"{name}.fvecs"
        p.write_bytes(blob)
        with pytest.raises(tr.InvalidPersistence):
            tio.read_fvecs(p)
        with pytest.raises(jr.InvalidPersistence):
            jvecio.read_fvecs(p)
    neg = tmp_path / "neg.ivecs"
    tio.write_ivecs(neg, np.array([[1], [-2]], np.int32))
    for reader in (tio.read_ids, tio.read_groundtruth):
        with pytest.raises(tr.InvalidPersistence):
            reader(neg)
    two = tmp_path / "two.ivecs"
    tio.write_ivecs(two, np.ones((3, 2), np.int32))
    with pytest.raises(tr.InvalidPersistence):
        tio.read_ids(two)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    data = _data(400)
    queries = data[:8] + 0.01
    d2 = ((data[None, :, :] - queries[:, None, :]) ** 2).sum(-1)
    paths = {k: str(tmp / f) for k, f in (("base", "base.fvecs"), ("q", "q.fvecs"),
                                          ("gt", "gt.ivecs"), ("index", "index.rbq"))}
    tio.write_fvecs(paths["base"], data)
    tio.write_fvecs(paths["q"], queries)
    tio.write_ivecs(paths["gt"], np.argsort(d2, axis=1)[:, :10].astype(np.int32))
    paths["tmp"] = tmp
    return paths


def test_cli_build_info_query(files, capsys):
    main(["build", "--data", files["base"], "--output", files["index"], "--nlist", "8",
          "--total-bits", "7", "--device", "cpu"])
    capsys.readouterr()
    main(["info", "--index", files["index"], "--device", "cpu"])
    info = json.loads(capsys.readouterr().out)
    assert info == {"kind": "ivf", "vectors": 400, "dim": DIM, "clusters": 8,
                    "padded_dim": 64, "ex_bits": 6, "metric": "l2"}
    main(["query", "--index", files["index"], "--queries", files["q"], "--k", "10",
          "--nprobe", "8", "--groundtruth", files["gt"], "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["k"] == 10 and out["recall"] >= 0.9 and out["qps"] > 0
    main(["query", "--index", files["index"], "--queries", files["q"], "--device", "cpu",
          "--nprobe", "8", "--show", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith("0 [(0, ")
    # the JAX CLI's info line for the same file, but for the loaded index's state
    j_index, kind = jcli._open_index(files["index"])
    assert kind == "ivf" and j_index.cluster_count() == info["clusters"]


@pytest.mark.parametrize("index_type,extra,kind", [
    ("brute_force", [], "brute_force"),
    ("mstg", ["--max-posting-size", "100", "--branching-factor", "4"], "mstg"),
])
def test_cli_other_index_types(files, capsys, index_type, extra, kind):
    out = str(files["tmp"] / f"{index_type}.idx")
    main(["build", "--data", files["base"], "--output", out, "--index-type", index_type,
          "--total-bits", "5", "--device", "cpu", *extra])
    capsys.readouterr()
    main(["info", "--index", out, "--device", "cpu"])
    info = json.loads(capsys.readouterr().out)
    assert info["kind"] == kind and info["vectors"] == 400 and info["dim"] == DIM
    main(["query", "--index", out, "--queries", files["q"], "--k", "10", "--ef-search", "16",
          "--groundtruth", files["gt"], "--device", "cpu"])
    assert json.loads(capsys.readouterr().out)["recall"] >= 0.8


def test_cli_sweep_csv_schema(files, capsys):
    """``sweep`` writes the reference's CSV schema, row for row the JAX
    CLI's format (its ``cmd_sweep`` run in-process on the same files for
    the IVF rows)."""
    out_csv = str(files["tmp"] / "sweep.csv")
    argv = ["sweep", "--data", files["base"], "--queries", files["q"], "--groundtruth",
            files["gt"], "--method", "both", "--nlist", "8", "--nprobes", "4", "8",
            "--efs", "16", "--epsilons", "0.8", "--max-posting-size", "100", "--k", "10",
            "--stream-reps", "1", "--output", out_csv]
    main([*argv, "--device", "cpu"])
    rows = open(out_csv).read().strip().splitlines()
    assert rows[0] == "method,config,recall_at_10,latency_ms,qps"
    assert [r.split(",")[0] for r in rows[1:]] == ["IVF", "IVF", "MSTG"]
    assert rows[1].startswith("IVF,nprobe=4,") and rows[3].startswith('MSTG,"ef=16, eps=0.8",')
    for row in rows[1:]:
        rec, lat, qps = (float(x) for x in row.rsplit(",", 3)[1:])
        assert rec >= 0.8 and lat > 0 and qps > 0, row
    j_csv = str(files["tmp"] / "sweep_jax.csv")
    j_argv = [a for a in argv if a not in ("both",)]
    j_argv[j_argv.index("--method") + 1 : j_argv.index("--method") + 1] = ["ivf"]
    j_argv[j_argv.index("--output") + 1] = j_csv
    j_args = _jax_sweep_args(j_argv)
    jcli.cmd_sweep(j_args)
    j_rows = open(j_csv).read().strip().splitlines()
    assert j_rows[0] == rows[0]
    assert [r.rsplit(",", 3)[0] for r in j_rows[1:]] == [r.rsplit(",", 3)[0] for r in rows[1:3]]
    capsys.readouterr()


def _jax_sweep_args(argv):
    """The JAX CLI's parsed ``sweep`` arguments, without its ``main`` (which
    also switches on JAX's persistent compilation cache)."""
    import argparse

    ap = argparse.ArgumentParser()
    for flag, kw in (("--data", {}), ("--queries", {}), ("--groundtruth", {}),
                     ("--output", {}), ("--method", {}), ("--k", {"type": int}),
                     ("--nlist", {"type": int}), ("--total-bits", {"type": int, "default": 7}),
                     ("--seed", {"type": int, "default": 42}),
                     ("--nprobes", {"type": int, "nargs": "+"}),
                     ("--efs", {"type": int, "nargs": "+"}),
                     ("--epsilons", {"type": float, "nargs": "+"}),
                     ("--max-posting-size", {"type": int}),
                     ("--branching-factor", {"type": int, "default": 10}),
                     ("--limit", {"type": int, "default": None}),
                     ("--query-limit", {"type": int, "default": None}),
                     ("--scan-dtype", {"default": "bf16"}), ("--rerank", {"type": int}),
                     ("--index", {"default": None}), ("--stream-reps", {"type": int})):
        ap.add_argument(flag, **kw)
    return ap.parse_args(argv[1:])
