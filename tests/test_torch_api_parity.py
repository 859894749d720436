"""Every public call of the JAX package, in its own shape, binds the same
way on the port.

The walk covers every module of ``rabitq_tpu`` and, in each, the functions
and classes it defines: constructors, public methods, classmethods and
staticmethods, properties and their setters, and the other public class
attributes (dataclass defaults, enum members). The port's counterpart is
the module of the same path (the three Pallas modules map to the port's
kernel modules; ``ops.rotation``'s ``fht`` / ``fht_np`` live in
``ops/fht.py``). For each name the counterpart must exist; every JAX
parameter must exist in the port, keep a default where JAX has one, and
every positional one must sit at the same index under the same name; a
parameter the port adds must have a default and be keyword-only or come
after all of JAX's positionals; a ``device`` parameter with a default
defaults to ``None`` (the card); and a JAX setter has a port setter.

``ALLOWED`` lists the standing deviations, each with its reason and the
test that covers it; an entry that no longer deviates fails
``test_allow_list_entry_still_deviates``. Then the attributes the JAX
package lets a caller assign are assigned on small CPU indexes of both
packages, which must then search alike.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import pkgutil
from pathlib import Path

import numpy as np
import pytest
import torch

import rabitq_tpu as jr
import rabitq_tpu_torch as tr
from rabitq_tpu_torch.index.brute_force import BruteForceHost
from rabitq_tpu_torch.index.ivf import HostCodes
from rabitq_tpu_torch.index.mstg.index import MstgHost
from rabitq_tpu_torch.ops import _cuda
from rabitq_tpu_torch.ops.rotation import deserialize_rotator

ROOT = Path(__file__).resolve().parent.parent
JAX, PORT = "rabitq_tpu", "rabitq_tpu_torch"
MODULE_MAP = {
    "ops.pallas_fht": "ops.fht",
    "ops.pallas_fused_scan": "ops.fused_scan",
    "ops.pallas_scan": "ops.packed_scan",
}
NAME_MAP = {("ops.rotation", "fht"): "ops.fht", ("ops.rotation", "fht_np"): "ops.fht"}

_DEVICE_PROPERTY = (
    "the port's `device` is the torch device the index lives on; the JAX property "
    "(the device layout) is the port's `layout`",
    "tests/test_torch_api_parity.py::test_device_is_the_torch_device",
)
_OPERAND_LAYOUTS = "a kernel wrapper: takes the port's operand layouts for the CUDA kernel"
ALLOWED = {
    "index.ivf:IvfRabitqIndex.device": _DEVICE_PROPERTY,
    "index.brute_force:BruteForceRabitqIndex.device": _DEVICE_PROPERTY,
    "index.mstg.index:MstgIndex.device": _DEVICE_PROPERTY,
    "utils.compile_cache": (
        "no counterpart: the kernel libraries are cached by source hash in `_build/`",
        "tests/test_torch_api_parity.py::test_kernel_libraries_are_cached_by_source_hash",
    ),
    "utils": (
        "no `timed` or `Timer`: the port's spans (`utils.profiling.span`) time its steps",
        "tests/test_torch_profiling.py::test_spans_nest_with_parent_and_call_id",
    ),
    "utils.logging:timed": (
        "a span (`utils.profiling.Span`) logs its duration at INFO as `timed` did",
        "tests/test_torch_profiling.py::test_a_span_logs_its_duration",
    ),
    **{f"utils.profiling:Timer{member}": (
        "the port's spans (`utils.profiling.span`, `recording`, `spans`) stand in for the lap timer",
        "tests/test_torch_profiling.py::test_spans_nest_with_parent_and_call_id",
    ) for member in ("", ".__init__", ".lap", ".summary")},
    "ops.pallas_fused_scan:fused_fits_vmem": (
        "TPU VMEM geometry: the port's width limits stand in",
        "tests/test_torch_scan_paths.py::test_routing_thresholds_match_jax",
    ),
    "ops.pallas_fused_scan:vmem_step_bytes": (
        "TPU VMEM geometry: the port's width limits stand in",
        "tests/test_torch_scan_paths.py::test_routing_thresholds_match_jax",
    ),
    "ops.pallas_fht:fht_pallas": (
        "the Pallas entry point; its counterpart is `fht`, the FHT kernel's wrapper",
        "tests/test_torch_fht_rotation.py::test_fht_bitwise_matches_jax",
    ),
    "ops.pallas_fht:fht_supported": (
        f"{_OPERAND_LAYOUTS} (no VMEM batch limit)",
        "tests/test_torch_fht_rotation.py::test_fht_sizes_and_limits",
    ),
    "ops.pallas_fused_scan:fused_bin_scan": (
        _OPERAND_LAYOUTS, "tests/test_torch_bin_scan.py::test_bin_scan_matches_jax",
    ),
    "ops.pallas_fused_scan:fused_select": (
        _OPERAND_LAYOUTS, "tests/test_torch_bin_scan.py::test_fused_select_matches_jax",
    ),
    "index.scan:scan_kernel": (
        "no `approx_recall_target`: there is no approx_max_k; approx_topk=True takes an "
        "exact torch.topk of the bf16 plane",
        "tests/test_torch_scan_paths.py::test_scan_path_matches_jax",
    ),
}
# calls once refused in the JAX shape; they may never be allow-listed
REPAIRED = (
    "index.ivf:IvfRabitqIndex.__init__", "index.mstg.index:MstgIndex.host",
    "index.mstg.closure:closure_assign", "index.mstg.clustering:hierarchical_cluster",
    "ops.kmeans:run_kmeans", "index.layout:assemble_host_chunks",
    "index.layout:assemble_device_layout", "utils.transfer:upload_dataset",
    "ops.quantize:compute_const_scaling_factor",
)
_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
_VARIADIC = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
_MISSING = object()


def _jax_modules() -> list[str]:
    """Every module of the JAX package (dotted, relative; "" is the package
    itself), private ones (compiled helpers) left out."""
    found = [m.name[len(JAX) + 1:] for m in pkgutil.walk_packages(jr.__path__, JAX + ".")]
    return [""] + sorted(
        n for n in found
        if not any(p.startswith("_") and p not in ("__init__", "__main__") for p in n.split("."))
    )


def _module(prefix: str, rel: str):
    return importlib.import_module(f"{prefix}.{rel}" if rel else prefix)


def _walk() -> dict:
    """{key: (kind, module, name, member, JAX object)} for every public name."""
    names = {}
    for rel in _jax_modules():
        names[rel or "__init__"] = ("module", rel, None, None, None)
        mod = _module(JAX, rel)
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
                continue
            if not callable(obj):
                continue
            names[f"{rel}:{name}"] = ("class" if inspect.isclass(obj) else "function",
                                     rel, name, None, obj)
            if not inspect.isclass(obj):
                continue
            for attr, val in vars(obj).items():
                if attr.startswith("_") and attr != "__init__":
                    continue
                kind = ("property" if isinstance(val, property)
                        else "method" if callable(val) or isinstance(val, (classmethod, staticmethod))
                        else "attribute")
                names[f"{rel}:{name}.{attr}"] = (kind, rel, name, attr, val)
    return names


NAMES = _walk()


def _port_module(rel: str, name: str | None = None):
    target = NAME_MAP.get((rel, name), MODULE_MAP.get(rel, rel))
    return _module(PORT, target)


def _function(obj):
    return obj.__func__ if isinstance(obj, (classmethod, staticmethod)) else obj


def _signature_deviations(j, t) -> list[str]:
    try:
        sj, st = inspect.signature(_function(j)), inspect.signature(_function(t))
    except (TypeError, ValueError) as e:
        return [f"no signature: {e}"]
    pj, pt = list(sj.parameters.values()), list(st.parameters.values())
    by_name = {p.name: p for p in pt}
    out = []
    for p in pj:
        if p.kind in _VARIADIC:
            if not any(q.kind == p.kind for q in pt):
                out.append(f"no *{p.name}")
        elif p.name not in by_name:
            out.append(f"no parameter {p.name}")
        elif p.default is not p.empty and by_name[p.name].default is p.empty:
            out.append(f"{p.name} has no default")
    jpos = [p for p in pj if p.kind in _POSITIONAL]
    tpos = [p for p in pt if p.kind in _POSITIONAL]
    for i, p in enumerate(jpos):
        got = tpos[i].name if i < len(tpos) else None
        if got != p.name:
            out.append(f"position {i} is {got}, not {p.name}")
    jnames = {p.name for p in pj}
    for i, q in enumerate(pt):
        if q.kind in _VARIADIC:
            continue
        if q.name == "device" and q.default is not q.empty and q.default is not None:
            out.append(f"device defaults to {q.default!r}, not None (the card)")
        if q.name in jnames:
            continue
        if q.default is q.empty:
            out.append(f"added parameter {q.name} has no default")
        elif q.kind in _POSITIONAL and i < len(jpos):
            out.append(f"added parameter {q.name} sits among the JAX positionals")
    return out


def _deviations(key: str) -> list[str]:
    kind, rel, name, attr, jobj = NAMES[key]
    try:
        tmod = _port_module(rel, name)
    except ImportError as e:
        return [f"no counterpart module: {e}"]
    if kind == "module":
        jmod = _module(JAX, rel)
        return [f"no {n} (in __all__)" for n in getattr(jmod, "__all__", ())
                if not hasattr(tmod, n)]
    tobj = getattr(tmod, name, _MISSING)
    if tobj is _MISSING:
        return [f"no {name} in {tmod.__name__}"]
    if kind == "function":
        return _signature_deviations(jobj, tobj)
    if kind == "class":
        return [] if inspect.isclass(tobj) else [f"{name} is not a class"]
    tval = inspect.getattr_static(tobj, attr, _MISSING)
    if tval is _MISSING:
        return [f"no {name}.{attr}"]
    if kind == "property":
        if not isinstance(tval, property):
            return [f"{name}.{attr} is not a property"]
        if jobj.fset is not None and tval.fset is None:
            return [f"{name}.{attr} has no setter"]
        return []
    if kind == "method":
        if type(jobj) is not type(tval):
            return [f"{name}.{attr} is a {type(tval).__name__}, not a {type(jobj).__name__}"]
        return _signature_deviations(jobj, tval)
    return []  # a plain class attribute: it exists


def _allowed(key: str) -> bool:
    """On the allow-list itself, or a name of an allow-listed module."""
    return key in ALLOWED or key.split(":")[0] in ALLOWED


@pytest.mark.parametrize("key", sorted(k for k in NAMES if not _allowed(k)))
def test_signature_matches_jax(key):
    found = _deviations(key)
    assert not found, found


@pytest.mark.parametrize("key", sorted(ALLOWED))
def test_allow_list_entry_still_deviates(key):
    assert key in NAMES, f"{key} is not a public name of the JAX package"
    assert key not in REPAIRED
    assert _deviations(key), f"{key} no longer deviates: take it off the allow-list"
    reason, covering = ALLOWED[key]
    path, test = covering.split("::")
    assert reason and f"def {test}(" in (ROOT / path).read_text(), covering


def test_walk_covers_every_module_and_the_repaired_calls():
    modules = {k for k, v in NAMES.items() if v[0] == "module"}
    assert len(modules) == len(_jax_modules()) > 30
    assert set(REPAIRED) <= set(NAMES)
    assert not any(_allowed(k) for k in REPAIRED)


def test_kernel_libraries_are_cached_by_source_hash(tmp_path, monkeypatch):
    """The port's stand-in for the JAX compile cache: a kernel library is
    named by the hash of its source and the shared headers, so an edited
    kernel gets a new library and an unchanged one is reused."""
    paths = {name: _cuda.library_path(name) for name in _cuda.SOURCES}
    for name, path in paths.items():
        assert path.parent == _cuda.BUILD_DIR and path.name.startswith(f"lib{name}-")
        assert path == _cuda.library_path(name)
    for src in _cuda.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    assert _cuda.library_path("fht") == paths["fht"]
    (tmp_path / "fht.cu").write_bytes((tmp_path / "fht.cu").read_bytes() + b"\n")
    assert _cuda.library_path("fht") != paths["fht"]
    assert _cuda.library_path("fused_bin_scan") == paths["fused_bin_scan"]
    (tmp_path / "mma_tile.cuh").write_bytes(b"// another header\n")
    assert _cuda.library_path("fused_bin_scan") != paths["fused_bin_scan"]


# ----------------------------------------------------------------------
# assignable attributes, on small CPU indexes of both packages
# ----------------------------------------------------------------------

N, DIM, TOP_K = 600, 32, 10


def _data(n=N, seed=8):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((12, DIM)).astype(np.float32) * 2
    return (centers[rng.integers(0, 12, n)] + 0.5 * rng.standard_normal((n, DIM))).astype(
        np.float32)


def _port_copy(cls, host):
    return cls(**{f.name: None if getattr(host, f.name) is None else np.array(getattr(host, f.name))
                  for f in dataclasses.fields(host)})


def _rotator(j):
    return deserialize_rotator(j.dim, j.rotator.padded_dim, tr.RotatorType(int(
        j.rotator.rotator_type)), j.rotator.serialize())


def _ivf():
    j = jr.IvfRabitqIndex.train(_data(), nlist=4, total_bits=7, seed=3, scan_dtype="f32")
    t = tr.IvfRabitqIndex(j.dim, j.padded_dim, tr.Metric.L2, _rotator(j), j.ex_bits,
                          _port_copy(HostCodes, j.host), "f32", device="cpu")
    return j, t


def _brute_force():
    j = jr.BruteForceRabitqIndex.train(_data(), total_bits=7, seed=3, scan_dtype="f32")
    t = tr.BruteForceRabitqIndex(j.dim, j.padded_dim, tr.Metric.L2, _rotator(j), j.ex_bits,
                                 _port_copy(BruteForceHost, j.host), "f32", device="cpu")
    return j, t


def _mstg():
    cfg = jr.MstgConfig(max_posting_size=64, faster_config=True)
    j = jr.MstgIndex.build(_data(), cfg, seed=3, scan_dtype="f32")
    tcfg = tr.MstgConfig(max_posting_size=64, faster_config=True)
    t = tr.MstgIndex(tcfg, j.dim, _port_copy(MstgHost, j.host), "f32", device="cpu")
    return j, t


MAKERS = {"ivf": _ivf, "brute_force": _brute_force, "mstg": _mstg}


@pytest.fixture(scope="module")
def pairs():
    made = {}

    def get(kind):
        if kind not in made:
            made[kind] = MAKERS[kind]()
        return made[kind]

    return get


def _search(index, kind, pkg, queries):
    """(ids, distances or scores) of the queries, through the call that
    reads every assignable attribute (the pipelined uploads where there
    are any)."""
    if kind == "brute_force":
        rows = index.batch_search(queries, pkg.BruteForceSearchParams(top_k=TOP_K))
        return (np.array([[h.id for h in r] for r in rows]),
                np.array([[h.score for h in r] for r in rows]))
    if kind == "ivf":
        params = pkg.SearchParams(top_k=TOP_K, nprobe=3)
    else:
        params = pkg.MstgSearchParams(top_k=TOP_K, ef_search=8, pruning_epsilon=0.6)
    return index.batch_search_arrays_pipelined(queries, params, batch_size=8, upload_block=16)


def _agree(j, t, exact):
    (j_ids, j_d), (t_ids, t_d) = j, t
    if exact:
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_allclose(t_d, j_d, rtol=1e-5, atol=1e-3)
        return
    overlap = [len(set(a) & set(b)) / TOP_K for a, b in zip(t_ids.tolist(), j_ids.tolist())]
    assert min(overlap) >= 0.9 and np.mean(overlap) >= 0.98, overlap


def _remapped(host, shift):
    """The same codes under other ids."""
    return dataclasses.replace(host, ids=np.asarray(host.ids) * 2 + shift)


ASSIGNMENTS = [
    ("ivf", "scan_dtype", "bf16"), ("ivf", "upload_dtype", "int8"), ("ivf", "approx_topk", True),
    ("brute_force", "scan_dtype", "packed"), ("brute_force", "approx_topk", True),
    ("brute_force", "host", None),
    ("mstg", "scan_dtype", "fused8"), ("mstg", "upload_dtype", "bf16"),
    ("mstg", "approx_topk", True), ("mstg", "host", None),
]


@pytest.mark.parametrize("kind,attr,value", ASSIGNMENTS,
                         ids=[f"{k}-{a}" for k, a, _ in ASSIGNMENTS])
def test_assigned_attribute_searches_as_jax(pairs, kind, attr, value):
    j, t = pairs(kind)
    queries = _data(24, seed=99)
    if attr == "host":
        # a fresh index of each package, in the JAX shape, given the other
        # codes before its first search: it lays itself out from them
        if kind == "brute_force":
            j = jr.BruteForceRabitqIndex(j.dim, j.padded_dim, j.metric, j.rotator, j.ex_bits,
                                         None, "f32")
            t = tr.BruteForceRabitqIndex(t.dim, t.padded_dim, t.metric, t.rotator, t.ex_bits,
                                         None, "f32", device="cpu")
            src = pairs(kind)[0].host
            j.host, t.host = src, _port_copy(BruteForceHost, src)
            assert len(t) == len(j) == N
        else:
            j = jr.MstgIndex(j.config, j.dim, j.host, "f32")
            t = tr.MstgIndex(t.config, t.dim, t.host, "f32", device="cpu")
            j.host, t.host = _remapped(j.host, 1), _remapped(t.host, 1)
            assert len(t) == len(j) == 2 * N and (t.host.ids % 2 == 1).all()
        _agree(_search(j, kind, jr, queries), _search(t, kind, tr, queries), exact=True)
        return
    before = getattr(t, attr)
    setattr(j, attr, value)
    setattr(t, attr, value)
    try:
        assert getattr(t, attr) == value
        # each value leaves the f32 oracle configuration: bf16 or int8 rounding
        # somewhere, or survivors selected from bf16 values
        _agree(_search(j, kind, jr, queries), _search(t, kind, tr, queries), exact=False)
    finally:
        setattr(j, attr, before)
        setattr(t, attr, before)


@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_device_is_the_torch_device(pairs, kind):
    """A standing deviation: the port's ``device`` names the torch device,
    and its ``layout`` is what the JAX ``device`` property returns (the
    same rows in the same order)."""
    j, t = pairs(kind)
    assert t.device == torch.device("cpu")
    np.testing.assert_array_equal(t.layout.ids.numpy(), np.asarray(j.device.ids))
    np.testing.assert_array_equal(t.layout.valid.numpy(), np.asarray(j.device.valid))
