"""Names in ``BENCHMARK.json`` -> the files that hold them.

A cell names a configuration and a traffic mix; the configuration's entry
names its file, the mix is ``traffic/<mix>.json``, a metric is read by
``metrics/<metric>.py``, a mix's kind of call is ``calls/<call>.py`` and a
configuration's kind of index is ``programs/<kind>.py``. Nothing here lists
a cell, a configuration, a mix or a metric: adding one means adding files
and entries, never editing this module.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, read."""

    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list = field(default_factory=list)  # metric entries this cell reports
    per_layer: list = field(default_factory=list)


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries, name, what):
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    spec = load_spec(root)
    entry = _by_name(spec["workloads"], name, "cell")
    cfg_entry = _by_name(spec["configs"], entry["config"], "configuration")
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(bench_dir / "traffic" / f"{entry['traffic']}.json") as f:
        mix = json.load(f)
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [
        m for m in spec["per_layer"]
        if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)
    ]
    return Cell(name, int(entry["chips"]), config, mix, e2e, per_layer)


def _load_file(path: Path, prefix: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(path)
    mod_name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    return _load_file(bench_dir / "metrics" / f"{name}.py", "portbench_metric_").read


def call_kind(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return _load_file(bench_dir / "calls" / f"{name}.py", "portbench_call_")


def program_kind(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return _load_file(bench_dir / "programs" / f"{name}.py", "portbench_program_")
