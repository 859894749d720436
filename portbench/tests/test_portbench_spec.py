"""BENCHMARK.json against the contract's shapes, names found by files, and
the import walk that keeps JAX and the JAX package out of the benchmark."""

import ast
import json
import re
import shutil

import pytest

from portbench import spec
from portbench.run import FORBIDDEN, forbidden_modules

ROOT = spec.ROOT
BENCH = spec.BENCH_DIR
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_spec()


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16 and len(bench["command"]) <= 32
    for path in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and not path.endswith("_torch")
    for word in bench["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word


def test_names_units_and_lines(bench):
    entries = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names)), kind
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert LINE.match(m["layer"])


def test_every_name_is_found_by_its_file(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for c in bench["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and path.is_relative_to(BENCH)
        assert json.loads(path.read_text())["name"] == c["name"]
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        spec.call_kind(cell.mix["call"])
        spec.program_kind(cell.config["index"]["kind"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
        assert all(w in {c["name"] for c in bench["workloads"]} for w in m.get("workloads", []))


def test_a_new_cell_config_mix_and_metric_need_only_new_files(tmp_path, bench):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((BENCH / "configs" / "ivf-gist1m-7b.json").read_text())
    cfg["name"] = "tiny-cfg"
    (root / "portbench/configs/tiny-cfg.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/tiny-mix.json").write_text(
        json.dumps({"call": "batch", "query_sets": 2, "traced_calls": 1}))
    (root / "portbench/metrics/tiny_metric.py").write_text("def read(run):\n    return 42.0\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "tiny-cfg", "source": "x", "file": "portbench/configs/tiny-cfg.json",
                           "reduced": [], "why": "x"})
    new["workloads"].append({"name": "tiny.cell", "config": "tiny-cfg", "traffic": "tiny-mix",
                             "chips": 1, "why": "x"})
    new["per_layer"].append({"name": "tiny_metric", "unit": "s", "better": "lower",
                             "source": "program_span", "layer": "x", "moves": "qps",
                             "workloads": ["tiny.cell"]})
    new["end_to_end"][0].setdefault("workloads", []).append("tiny.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    cell = spec.load_cell("tiny.cell", root=root, bench_dir=root / "portbench")
    assert cell.config["name"] == "tiny-cfg" and cell.mix["query_sets"] == 2
    assert [m["name"] for m in cell.per_layer] == ["tiny_metric"]
    assert spec.metric_reader("tiny_metric", root / "portbench")(None) == 42.0
    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()
             and p.relative_to(root) in before}
    assert after == before  # no file that was there changed


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_import_walk():
    sources = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert sources
    for path in sources:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
    for path in (BENCH / "reference").rglob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN + ("rabitq_tpu_torch",), (path, name)
            assert top != "portbench" or name.startswith("portbench.reference"), (path, name)


def test_forbidden_modules_compares_whole_top_level_names():
    allowed = ["rabitq_tpu_torch", "rabitq_tpu_torch.ops.select", "jaxtyping", "numpy", "flaxen"]
    assert forbidden_modules(allowed) == []
    found = ["rabitq_tpu.ops.kmeans", "jax.numpy", "jaxlib", "flax.linen", "torch"]
    assert forbidden_modules(allowed + found) == ["flax", "jax", "jaxlib", "rabitq_tpu"]
