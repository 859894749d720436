"""The port's ann-benchmarks modules (``ann_benchmarks/rabitq-tpu-torch-*``),
loaded by path as ann-benchmarks loads them, on the CPU (``device`` from
``index_params``): the BaseANN surface, and the same results as the JAX
package's modules where both serve the same codes."""

import importlib.util
import os

import numpy as np
import pytest
import yaml

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    path = os.path.join(_ROOT, "ann_benchmarks", name, "module.py")
    spec = importlib.util.spec_from_file_location(name.replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def workload():
    rng = np.random.default_rng(7)
    data = rng.standard_normal((1000, 64)).astype(np.float32)
    queries = data[:8] + 0.01 * rng.standard_normal((8, 64)).astype(np.float32)
    return data, queries


def test_ivf_module_fit_query(workload):
    data, queries = workload
    mod = _load("rabitq-tpu-torch-ivf")
    algo = mod.RabitqTorchIvf("euclidean", {"nlist": 16, "total_bits": 5, "device": "cpu"})
    assert algo.device == "cpu" and "device" not in algo.index_params
    algo.fit(data)
    assert algo.index.index.device.type == "cpu"
    algo.set_query_arguments(8)
    ids = algo.query(queries[0], 10)
    assert ids.shape == (10,) and ids.dtype == np.int64 and ids[0] == 0
    algo.batch_query(queries, 10)
    batch = algo.get_batch_results()
    assert len(batch) == len(queries)
    assert all(r.shape == (10,) and r.dtype == np.int64 for r in batch)
    assert sum(int(i in batch[i]) for i in range(len(queries))) >= 6
    assert str(algo) == "IVF-TORCH-L16-B5-nprobe8"
    algo.set_query_arguments({"nprobe": 4})
    assert algo.nprobe == 4 and algo.query(queries[0], 5).shape == (5,)


def test_ivf_module_matches_jax_module(workload):
    """Both modules over the same codes (the JAX module's index carried
    into the port's binding): equal ids through query and batch_query."""
    import rabitq_tpu_torch as tr

    data, queries = workload
    jmod, tmod = _load("rabitq-tpu-ivf"), _load("rabitq-tpu-torch-ivf")
    j = jmod.RabitqTpuIvf("euclidean", {"nlist": 16, "total_bits": 7, "scan_dtype": "f32"})
    j.fit(data)
    t = tmod.RabitqTorchIvf("euclidean", {"nlist": 16, "device": "cpu"})
    t.index = tr.bindings.IvfRabitqIndex(64, device="cpu")
    jidx, h = j.index.index, j.index.index.host
    t.index.index = tr.IvfRabitqIndex.from_host_arrays(
        dim=64, padded_dim=jidx.padded_dim, metric=tr.Metric.L2, ex_bits=jidx.ex_bits,
        rotator_type=tr.RotatorType(int(jidx.rotator.rotator_type)),
        rotator_bytes=jidx.rotator.serialize(), binary_bits=h.binary_bits,
        ex_codes=h.ex_codes, f_add=h.f_add, f_rescale=h.f_rescale, f_error=h.f_error,
        f_add_ex=h.f_add_ex, f_rescale_ex=h.f_rescale_ex, delta=h.delta, vl=h.vl,
        ids=h.ids, cluster_offsets=h.cluster_offsets, centroids=h.centroids,
        scan_dtype="f32", device="cpu",
    )
    for algo in (j, t):
        algo.set_query_arguments({"nprobe": 6})
        algo.batch_query(queries, 10)
    np.testing.assert_array_equal(t.query(queries[1], 10), j.query(queries[1], 10))
    for a, b in zip(t.get_batch_results(), j.get_batch_results()):
        np.testing.assert_array_equal(a, b)


def test_mstg_module_fit_query(workload):
    data, queries = workload
    mod = _load("rabitq-tpu-torch-mstg")
    algo = mod.RabitqTorchMstg(
        "euclidean", {"max_posting_size": 128, "rabitq_bits": 5, "device": "cpu"}
    )
    algo.fit(data)
    assert algo.index.index.device.type == "cpu"
    algo.set_query_arguments({"ef_search": 16, "pruning_epsilon": 0.6})
    assert algo.index.config.default_ef_search == 16
    ids = algo.query(queries[0], 10)
    assert ids.shape == (10,) and ids.dtype == np.int64 and ids[0] == 0
    algo.batch_query(queries, 10)
    batch = algo.get_batch_results()
    assert len(batch) == len(queries)
    assert all(r.shape == (10,) and r.dtype == np.int64 for r in batch)
    assert algo.get_memory_usage() > 0
    assert str(algo) == "MSTG-TORCH-P128-B5"
    algo.set_query_arguments(8)  # ann-benchmarks sometimes passes a scalar
    assert algo.index.config.default_ef_search == 8 and algo.query(queries[1], 5).shape == (5,)


@pytest.mark.parametrize("kind", ["ivf", "mstg"])
def test_configs_name_the_port(kind):
    """The port's config.yml beside the JAX package's: the same run groups,
    its own constructor, name, module and docker tag, so that both can be
    installed side by side."""
    def cfg(name):
        with open(os.path.join(_ROOT, "ann_benchmarks", name, "config.yml")) as f:
            return yaml.safe_load(f)["float"]["any"][0]

    j, t = cfg(f"rabitq-tpu-{kind}"), cfg(f"rabitq-tpu-torch-{kind}")
    assert t["run_groups"] == j["run_groups"]
    assert t["name"] == f"rabitq-tpu-torch-{kind}" != j["name"]
    assert t["docker_tag"] == f"ann-benchmarks-rabitq-tpu-torch-{kind}" != j["docker_tag"]
    assert t["module"] == f"ann_benchmarks.algorithms.rabitq-tpu-torch-{kind}"
    mod = _load(f"rabitq-tpu-torch-{kind}")
    assert hasattr(mod, t["constructor"]) and t["constructor"] != j["constructor"]
