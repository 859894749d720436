"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so these tests need an NVIDIA GPU and skip
elsewhere. They import no JAX; on a machine with a card run them without
the suite's JAX conftest:

    python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

Tolerances: the FHT is bitwise equal; ``offered`` equal; ``bins_idx``
>= 99.9% equal; bin values rtol 1e-5 with atol 1e-3: the f32 dot sums in
another order, and its terms (~1e3 here, scaled by f_rescale) leave ~1e-4
absolute noise on distances that cancel to near zero.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rabitq_tpu_torch import IvfRabitqIndex, SearchParams
from rabitq_tpu_torch.ops import fused_scan as fs
from rabitq_tpu_torch.ops.fht import fht_kernel, fht_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 2, 4, 32, 64, 128, 512, 2048, 8192])
def test_fht_kernel_bitwise(cuda, n):
    for rows in (1, 3, 257):
        x = torch.randn((rows, n), device=cuda, generator=torch.Generator(device=cuda).manual_seed(n))
        before = fht_kernel.launches
        assert torch.equal(fht_kernel(x), fht_plain(x))
        assert fht_kernel.launches == before + 1


def test_fht_kernel_limits(cuda):
    with pytest.raises(NotImplementedError):
        fht_kernel(torch.zeros((2, 16384), device=cuda))
    with pytest.raises(ValueError):
        fht_kernel(torch.zeros((2, 96), device=cuda))
    with pytest.raises(ValueError):
        fht_kernel(torch.zeros((4, 256), device=cuda)[:, :128])  # not contiguous


def _bin_inputs(device, bq, n_tiles=24, d=256, c=300, seed=0):
    rng = np.random.default_rng(seed)
    n = n_tiles * fs.TN
    sizes = rng.multinomial(n - 200, np.ones(c) / c)
    cluster_of = np.zeros(n, np.int32)
    cluster_of[: n - 200] = np.repeat(np.arange(c, dtype=np.int32), sizes)
    allowed = (np.arange(n) < n - 200) & (rng.random(n) > 0.05)
    fa = np.where(allowed, rng.normal(size=n) * 10, fs.BIG).astype(np.float32)
    probe = rng.random((bq, c)) < 0.3
    g1 = np.full((bq, fs._pad_clusters(c)), fs.BIG, np.float32)
    g1[:, :c] = np.where(probe, rng.random((bq, c)) * 50, fs.BIG)
    q = rng.normal(size=(bq, d)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return dict(
        plane=t(rng.integers(0, 128, (n, d)).astype(np.int8)), q=t(q), fa=t(fa),
        fr=t((rng.normal(size=n) * 0.05).astype(np.float32)), cl=t(cluster_of),
        k1x=t((-63.5 * q.sum(1)).astype(np.float32)),
        g1=t(g1).to(torch.bfloat16), c_blk=t(fs.tile_cluster_blocks(cluster_of, allowed)),
        probe=t(probe),
    )


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("bq", [32, 96])
def test_bin_scan_kernel_matches_plain(cuda, compact, bq):
    x = _bin_inputs(cuda, bq)
    tiles = tcount = None
    if compact:
        tiles, tcount = fs.compaction_lists(x["fa"], x["cl"], x["probe"], 32, 24)
    args = (x["plane"], x["q"], x["fa"], x["fr"], x["cl"], x["k1x"], x["g1"], x["c_blk"],
            tiles, tcount)
    kv, ki, ko = fs.fused_bin_scan_cuda(*args)
    pv, pi, po = fs.fused_bin_scan_plain(*args)
    assert torch.equal(ko, po) and int(ko.sum()) > 0
    filled = pv < fs.BIG / 2
    assert torch.equal(kv < fs.BIG / 2, filled)
    torch.testing.assert_close(kv[filled], pv[filled], rtol=1e-5, atol=1e-3)
    assert float((ki == pi).float().mean()) >= 0.999


def test_index_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(1)
    data = rng.standard_normal((4000, 200)).astype(np.float32)
    cents = data[:40].copy()
    assign = ((data[:, None, :] - cents[None]) ** 2).sum(-1).argmin(1)
    kw = dict(seed=3, use_faster_config=False, scan_dtype="fused8")
    gpu = IvfRabitqIndex.train_with_clusters(data, cents, assign, 7, device=cuda, **kw)
    cpu = IvfRabitqIndex.train_with_clusters(data, cents, assign, 7, device="cpu", **kw)
    for nprobe in (2, 40):
        params = SearchParams(top_k=10, nprobe=nprobe)
        g_ids, g_d = gpu.batch_search_arrays_pipelined(data[:64], params, batch_size=32)
        c_ids, c_d = cpu.batch_search_arrays(data[:64], params)
        overlap = np.mean([len(set(g_ids[i]) & set(c_ids[i])) / 10 for i in range(64)])
        assert overlap >= 0.98
        assert np.all(g_ids[:, 0] == np.arange(64))
