"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so these tests need an NVIDIA GPU and skip
elsewhere. They import no JAX; on a machine with a card run them without
the suite's JAX conftest:

    python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

Tolerances: the FHT is bitwise equal; ``offered`` equal; ``bins_idx``
>= 99.9% equal; bin values rtol 1e-5 with atol 1e-3: the f32 dot sums in
another order, and its terms (~1e3 here, scaled by f_rescale) leave ~1e-4
absolute noise on distances that cancel to near zero. The packed bin scan
with an int8 query has an exact dot: values rtol 1e-6. The packed
lower-bound plane is bf16: every entry within one bf16 ulp of the plain
version's (a reordered f32 sum can move a value across a rounding
boundary) and >= 99% bitwise equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rabitq_tpu_torch import IvfRabitqIndex, SearchParams
from rabitq_tpu_torch.ops import fused_scan as fs
from rabitq_tpu_torch.ops import packed_scan as ps
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


def _packed_inputs(device, bq, int8_q, db=128, seed=0):
    """Packed-mode inputs over the geometry of ``_bin_inputs``: bit planes,
    a bit-plane-ordered query (bf16, or int8 with its scale), f_error and g2."""
    x = _bin_inputs(device, bq, seed=seed)
    rng = np.random.default_rng(seed + 100)
    n = x["plane"].shape[0]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    x["plane"] = t(rng.integers(0, 256, (n, db)).astype(np.uint8))
    q = t(rng.normal(size=(bq, 8 * db)).astype(np.float32))
    x["k1x"] = -0.5 * q.sum(1)
    x["q_scale"] = None
    if int8_q:
        x["q_scale"] = q.abs().amax(1) / 127.0
        x["q"] = torch.clamp(torch.round(q / x["q_scale"][:, None]), -127, 127).to(torch.int8)
    else:
        x["q"] = q.to(torch.bfloat16)
    x["fe"] = t(np.abs(rng.normal(size=n)).astype(np.float32) * 0.37)
    x["g2"] = t((rng.random(x["g1"].shape) * 7).astype(np.float32)).to(torch.bfloat16)
    return x


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("int8_q", [False, True])
@pytest.mark.parametrize("bq", [32, 96])
def test_packed_bin_scan_kernel_matches_plain(cuda, compact, int8_q, bq):
    x = _packed_inputs(cuda, bq, int8_q)
    tiles = tcount = None
    if compact:
        tiles, tcount = fs.compaction_lists(x["fa"], x["cl"], x["probe"], 32, 24)
    args = (x["plane"], x["q"], x["fa"], x["fr"], x["cl"], x["k1x"], x["g1"], x["c_blk"],
            tiles, tcount)
    kw = dict(f_error=x["fe"], g2=x["g2"], q_scale=x["q_scale"])
    key = ("int8" if int8_q else "bf16") + ("_compact" if compact else "_dense")
    before = fs.fused_bin_scan_packed_cuda.launches[key]
    kv, ki, ko = fs.fused_bin_scan(*args, **kw)
    assert fs.fused_bin_scan_packed_cuda.launches[key] == before + 1
    pv, pi, po = fs.fused_bin_scan_plain(*args, **kw)
    assert torch.equal(ko, po) and int(ko.sum()) > 0
    filled = pv < fs.BIG / 2
    assert torch.equal(kv < fs.BIG / 2, filled)
    if int8_q:
        torch.testing.assert_close(kv[filled], pv[filled], rtol=1e-6, atol=1e-6)
    else:
        torch.testing.assert_close(kv[filled], pv[filled], rtol=1e-5, atol=1e-3)
    assert float((ki == pi).float().mean()) >= 0.999


@pytest.mark.parametrize("b", [8, 300])
def test_packed_lb_scan_kernel_matches_plain(cuda, b):
    rng = np.random.default_rng(b)
    n, db = 4096 + 128, 128
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    packed = t(rng.integers(0, 256, (n, db)).astype(np.uint8))
    q = t(rng.normal(size=(b, 8 * db)).astype(np.float32))
    args = (
        packed, q.to(torch.bfloat16), t(rng.normal(size=n).astype(np.float32) * 10),
        t(rng.normal(size=n).astype(np.float32) * 0.05), -0.5 * q.sum(1),
        t(rng.normal(size=(b, n)).astype(np.float32) * 20).to(torch.bfloat16),
    )
    before = ps.packed_lb_scan_cuda.launches
    got = ps.packed_lb_scan(*args)
    assert ps.packed_lb_scan_cuda.launches == before + 1
    assert got.shape == (b, n) and got.dtype == torch.bfloat16
    want = ps.packed_lb_scan_plain(*args).float()
    gotf = got.float()
    assert bool(((gotf - want).abs() <= 2.0 ** -7 * want.abs() + 1e-3).all())
    assert float((gotf == want).float().mean()) >= 0.99


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


@pytest.mark.parametrize("scan_dtype", ["fused8", "fused", "packed", "bf16", "int8", "f32"])
def test_8bit_index_on_the_card_matches_the_cpu(cuda, scan_dtype):
    """total_bits=8 keeps raw ex codes, so the fused scans run two-stage
    (the packed bin kernel) and "packed" runs the lower-bound kernel."""
    rng = np.random.default_rng(2)
    data = rng.standard_normal((4000, 200)).astype(np.float32)
    cents = data[:40].copy()
    assign = ((data[:, None, :] - cents[None]) ** 2).sum(-1).argmin(1)
    kw = dict(seed=3, use_faster_config=True, scan_dtype=scan_dtype)
    gpu = IvfRabitqIndex.train_with_clusters(data, cents, assign, 8, device=cuda, **kw)
    cpu = IvfRabitqIndex.train_with_clusters(data, cents, assign, 8, device="cpu", **kw)
    assert not gpu._fused_exact_ok()
    counters = fs.fused_bin_scan_packed_cuda.launches
    before = sum(counters.values()) + ps.packed_lb_scan_cuda.launches
    for nprobe in (2, 40):
        params = SearchParams(top_k=10, nprobe=nprobe)
        g_ids, g_d = gpu.batch_search_arrays_pipelined(data[:64], params, batch_size=32)
        c_ids, c_d = cpu.batch_search_arrays(data[:64], params)
        overlap = np.mean([len(set(g_ids[i]) & set(c_ids[i])) / 10 for i in range(64)])
        assert overlap >= 0.98
        assert np.all(g_ids[:, 0] == np.arange(64))
    after = sum(counters.values()) + ps.packed_lb_scan_cuda.launches
    assert (after > before) == (scan_dtype in ("fused8", "fused", "packed"))
    if scan_dtype == "fused8":
        gpu.scan_dtype = "packed"  # re-laid on the card from the sorted layout
        g_ids, _ = gpu.batch_search_arrays(data[:64], SearchParams(top_k=10, nprobe=40))
        assert np.all(g_ids[:, 0] == np.arange(64))
        assert gpu.layout.packed is None and gpu._packed is not None
