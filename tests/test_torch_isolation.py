"""The port stands alone: importing it loads neither JAX nor the JAX
package, its sources and ``chip_smoke.py`` import neither, and its entry
points never drop to the CPU on their own."""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "rabitq_tpu_torch"

_PROBE = """
import sys, importlib, pkgutil
import rabitq_tpu_torch
for m in pkgutil.walk_packages(rabitq_tpu_torch.__path__, "rabitq_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "rabitq_tpu" or m.startswith("rabitq_tpu."))
print("LOADED:" + ",".join(bad))
"""


def test_import_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED:\n" in out.stdout, out.stdout


def test_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax\b|rabitq_tpu(\.|\s|$))", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    files += sorted((ROOT / "ann_benchmarks").glob("rabitq-tpu-torch-*/module.py"))
    assert len(files) > 10 and sum("ann_benchmarks" in str(p) for p in files) == 2
    for path in files:
        hits = pattern.findall(path.read_text())
        assert not hits, (path, hits)


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from rabitq_tpu_torch import (
        BruteForceRabitqIndex,
        IvfRabitqIndex,
        MstgConfig,
        MstgIndex,
        load_index,
    )
    from rabitq_tpu_torch.ops.kmeans import run_kmeans

    data = np.random.default_rng(0).standard_normal((600, 32)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IvfRabitqIndex.train(data, nlist=4, total_bits=7)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IvfRabitqIndex.train_with_clusters(data, data[:4], np.arange(600) % 4, 7)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_kmeans(data, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BruteForceRabitqIndex.train(data, total_bits=7)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MstgIndex.build(data, MstgConfig(max_posting_size=100))
    for name in ("tiny_ivf.rbq", "tiny_bf.rbf"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_index(ROOT / "tests" / "golden" / name)
    from rabitq_tpu_torch import StreamedIvfIndex, bindings
    from rabitq_tpu_torch.__main__ import main

    for make in (lambda: bindings.IvfRabitqIndex(32), lambda: bindings.MstgIndex(32)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["info", "--index", str(ROOT / "tests" / "golden" / "tiny_ivf.rbq")])
    on_cpu = IvfRabitqIndex.train(data, nlist=4, total_bits=7, device="cpu")
    # the JAX package's call shapes, which name no device
    from rabitq_tpu_torch.index.layout import assemble_device_layout
    from rabitq_tpu_torch.ops.quantize import compute_const_scaling_factor
    from rabitq_tpu_torch.utils.transfer import upload_dataset

    h = on_cpu.host
    for make in (
        lambda: upload_dataset(data),
        lambda: assemble_device_layout(
            n=600, ex_bits=6, binary=h.binary_bits, ex=h.ex_codes, f_add=h.f_add,
            f_rescale=h.f_rescale, f_add_ex=h.f_add_ex, f_rescale_ex=h.f_rescale_ex,
            f_error=h.f_error, cluster_sizes=np.diff(h.cluster_offsets), ids=h.ids,
            centroids=h.centroids),
        lambda: compute_const_scaling_factor(128, 6, 42),
        lambda: IvfRabitqIndex(on_cpu.dim, on_cpu.padded_dim, on_cpu.metric, on_cpu.rotator,
                               on_cpu.ex_bits, h),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    on_cpu.device = torch.device("cuda")  # as if trained on a card that is gone
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamedIvfIndex(on_cpu, chunk_rows=256)
    from rabitq_tpu_torch.parallel import sharding

    on_cpu.device = torch.device("cpu")
    mstg = MstgIndex.build(data, MstgConfig(max_posting_size=100), device="cpu")
    for make in (sharding.make_mesh, lambda: sharding.make_mesh(devices=["cuda"] * 2),
                 lambda: sharding.ShardedIvfIndex(on_cpu),
                 lambda: sharding.ShardedIvfIndex.train(data, nlist=4, total_bits=7),
                 lambda: sharding.ShardedMstgIndex(mstg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    # asking for the CPU works
    assert len(IvfRabitqIndex.train(data, nlist=4, total_bits=7, device="cpu")) == 600
    assert len(bindings.IvfRabitqIndex(32, device="cpu")) == 0
    assert len(mstg) == 600
    cpu_mesh = sharding.make_mesh(devices=["cpu"] * 2)
    assert sharding.ShardedIvfIndex(on_cpu, cpu_mesh).mesh.shape[sharding.SHARD_AXIS] == 2


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cwd = ROOT
    if alone:  # the script without the rest of the repository
        (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
        cwd = tmp_path
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True, timeout=300
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
