"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so these tests need an NVIDIA GPU and skip
elsewhere. They import no JAX; on a machine with a card run them without
the suite's JAX conftest:

    python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

Tolerances: the FHT is bitwise equal; ``offered`` equal; ``bins_idx``
>= 99.9% equal; bin values rtol 1e-5 with atol 1e-3: the f32 dot sums in
another order, and its terms (~1e3 here, scaled by f_rescale) leave ~1e-4
absolute noise on distances that cancel to near zero. The packed bin scan
with an int8 query has an exact dot: values rtol 1e-6. The direct bin scan
with an int8 query (mode DENSE_S8) computes what its plain version computes,
in the same order: bins_val, bins_idx and offered bitwise equal. The packed
lower-bound planes are bf16: +-inf entries equal, every finite entry within
one bf16 ulp of the plain version's (a reordered f32 sum can move a value
across a rounding boundary) and >= 99% bitwise equal.
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
    # rows longer than the shared-memory segment finish in device memory
    for n in (16384, 32768):
        x = torch.randn((5, n), device=cuda, generator=torch.Generator(device=cuda).manual_seed(n))
        assert torch.equal(fht_kernel(x), fht_plain(x))
    with pytest.raises(ValueError):
        fht_kernel(torch.zeros((2, 96), device=cuda))
    with pytest.raises(ValueError):
        fht_kernel(torch.zeros((4, 256), device=cuda)[:, :128])  # not contiguous


@pytest.mark.parametrize("log_n", range(18))
def test_fht_kernel_bitwise_every_length(cuda, log_n):
    n = 1 << log_n
    rows = 3 if n > 8192 else 37
    x = torch.randn((rows, n), device=cuda, generator=torch.Generator(device=cuda).manual_seed(n))
    assert torch.equal(fht_kernel(x), fht_plain(x))


def test_fht_kernel_takes_more_than_2_31_elements(cuda):
    """8 GiB in and 8 GiB out in one call; checked against the plain version
    a slice at a time."""
    n = 512
    rows = (1 << 31) // n + 8
    x = torch.empty((rows, n), device=cuda)
    step = 1 << 20
    g = torch.Generator(device=cuda).manual_seed(3)
    for s in range(0, rows, step):
        x[s : s + step].normal_(generator=g)
    y = fht_kernel(x)
    for s in range(0, rows, step):
        assert torch.equal(y[s : s + step], fht_plain(x[s : s + step]))
    del x, y
    torch.cuda.empty_cache()


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


def _as_s8(x):
    """``x``'s f32 query as an integer grid, as an int8 upload makes it:
    ``x["q"]`` int8 codes, ``x["q_scale"]`` the per-query scales."""
    q = x["q"]
    x["q_scale"] = torch.clamp_min(q.abs().amax(1), 1e-30) / 127.0
    x["q"] = torch.clamp(torch.round(q / x["q_scale"][:, None]), -127, 127).to(torch.int8)
    return x


def _assert_bitwise(kernel_out, plain_out):
    for k, p in zip(kernel_out, plain_out):
        assert k.dtype == p.dtype and torch.equal(k.view(torch.int32), p.view(torch.int32))
    assert int(kernel_out[2].sum()) > 0


def _assert_bins_match(kernel_out, plain_out, exact_dot=False, atol=1e-3):
    (kv, ki, ko), (pv, pi, po) = kernel_out, plain_out
    assert torch.equal(ko, po) and int(ko.sum()) > 0
    filled = pv < fs.BIG / 2
    assert torch.equal(kv < fs.BIG / 2, filled)
    if exact_dot:
        torch.testing.assert_close(kv[filled], pv[filled], rtol=1e-6, atol=1e-6)
    else:
        torch.testing.assert_close(kv[filled], pv[filled], rtol=1e-5, atol=atol)
    assert float((ki == pi).float().mean()) >= 0.999


# (row tiles, plane width): the base case; the narrowest plane; dim 960 padded
# to 1024 columns on a tile count that is no multiple of the 16 bin groups; the
# widest plane the EXACT scan serves
@pytest.mark.parametrize("shape", [(24, 256), (21, 64), (19, 1024), (18, 2560)])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("bq", [32, 96])
def test_bin_scan_kernel_matches_plain(cuda, compact, bq, shape):
    n_tiles, d = shape
    x = _bin_inputs(cuda, bq, n_tiles=n_tiles, d=d)
    if d == 1024:
        x["q"][:, 960:] = 0.0
        x["plane"][:, 960:] = 0
    tiles = tcount = None
    if compact:
        tiles, tcount = fs.compaction_lists(x["fa"], x["cl"], x["probe"], 32, n_tiles)
    args = (x["plane"], x["q"], x["fa"], x["fr"], x["cl"], x["k1x"], x["g1"], x["c_blk"],
            tiles, tcount)
    # At 2560 columns the dots are ~3500 and two f32 sums of them differ by more:
    # against float64 the kernel is off by up to 0.0051 and the plain version by
    # 0.0071 (test_bin_scan_dot_against_float64), times f_rescale (up to 0.2
    # here): 0.0029 seen.
    _assert_bins_match(fs.fused_bin_scan_cuda(*args), fs.fused_bin_scan_plain(*args),
                       atol=4e-3 if d == 2560 else 1e-3)


def _k1_launches() -> int:
    """K1's launches, every query kind and walk."""
    return sum(fs.fused_bin_scan_cuda.launches.values())


def _s8_bitwise(args, q_scale):
    """The DENSE_S8 kernel once, held bitwise to the plain version; the
    launch counted under its walk."""
    key = "s8_dense" if args[8] is None else "s8_compact"
    counts = dict(fs.fused_bin_scan_cuda.launches)
    got = fs.fused_bin_scan(*args, q_scale=q_scale)
    want = fs.fused_bin_scan_plain(*args, q_scale=q_scale)
    _assert_bitwise(got, want)
    assert fs.fused_bin_scan_cuda.launches == {**counts, key: counts[key] + 1}
    assert _k1_launches() == sum(counts.values()) + 1


# (row tiles, plane width): the base case; dim 960 padded to 1024 columns;
# 1536 and the widest the EXACT scan serves
@pytest.mark.parametrize("shape", [(24, 256), (19, 1024), (18, 1536), (18, 2560)])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("bq", [32, 96])
def test_bin_scan_s8_kernel_bitwise(cuda, compact, bq, shape):
    n_tiles, d = shape
    x = _bin_inputs(cuda, bq, n_tiles=n_tiles, d=d)
    if d == 1024:
        x["q"][:, 960:] = 0.0
        x["plane"][:, 960:] = 0
    _as_s8(x)
    tiles = tcount = None
    if compact:
        tiles, tcount = fs.compaction_lists(x["fa"], x["cl"], x["probe"], 32, n_tiles)
    args = (x["plane"], x["q"], x["fa"], x["fr"], x["cl"], x["k1x"], x["g1"], x["c_blk"],
            tiles, tcount)
    _s8_bitwise(args, x["q_scale"])


@pytest.mark.parametrize("compact", [False, True])
def test_bin_scan_s8_kernel_at_the_mstg_cell_shape(cuda, compact):
    """The MSTG cell's dense walk: 962 lists over 1,000,448 rows (1,954 tiles),
    960 columns padded to 1,024, a 256-query block."""
    n_tiles, bq = 1954, 256
    x = _bin_inputs(cuda, bq, n_tiles=n_tiles, d=1024, c=962)
    x["q"][:, 960:] = 0.0
    x["plane"][:, 960:] = 0
    _as_s8(x)
    tiles = tcount = None
    if compact:
        g = torch.Generator(device=cuda).manual_seed(1)
        fewer = x["probe"] & (torch.rand(x["probe"].shape, generator=g, device=cuda) < 0.05)
        tiles, tcount = fs.compaction_lists(x["fa"], x["cl"], fewer, 32, n_tiles)
    args = (x["plane"], x["q"], x["fa"], x["fr"], x["cl"], x["k1x"], x["g1"], x["c_blk"],
            tiles, tcount)
    _s8_bitwise(args, x["q_scale"])


@pytest.mark.parametrize("mode,width", [("direct", 1024), ("direct", 2560), ("bf16", 128),
                                        ("bf16", 384)])
def test_bin_scan_dot_against_float64(cuda, mode, width):
    """The kernels' dot alone (one cluster, all probed, fa = 0, fr = 1, k1x = 0,
    g = 0, 16 tiles: bin n is row n's dot) against a float64 product. The
    tensor cores truncate as they accumulate; the kernel must stay within
    three times the error of an f32 product (run with -s for the errors;
    1.9 times seen at most, on the bit planes at width 384)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    n, bq = 16 * fs.TN, 32
    z = torch.zeros(n, device=cuda)
    kw = {}
    if mode == "direct":
        plane = torch.randint(0, 128, (n, width), generator=g, device=cuda, dtype=torch.int8)
        q = torch.randn((bq, width), generator=g, device=cuda)
        codes = plane
    else:
        plane = torch.randint(0, 256, (n, width), generator=g, device=cuda, dtype=torch.uint8)
        q = torch.randn((bq, 8 * width), generator=g, device=cuda).to(torch.bfloat16)
        codes = ps.unpack_bitplanes(plane)
        kw = dict(f_error=z, g2=torch.zeros((bq, 256), dtype=torch.bfloat16, device=cuda))
    args = (plane, q, z, torch.ones(n, device=cuda), torch.zeros(n, dtype=torch.int32, device=cuda),
            torch.zeros(bq, device=cuda), torch.zeros((bq, 256), dtype=torch.bfloat16, device=cuda),
            torch.zeros(16, dtype=torch.int32, device=cuda), None, None)
    exact = q.double() @ codes.double().T
    k_err = float((fs.fused_bin_scan(*args, **kw)[0].double() - exact).abs().max())
    p_err = float((fs.fused_bin_scan_plain(*args, **kw)[0].double() - exact).abs().max())
    mm_err = float(((q.float() @ codes.float().T).double() - exact).abs().max())
    print(f"\ndot {mode} width {width}: mean |dot| {float(exact.abs().mean()):.1f}; max |err| "
          f"against float64: kernel {k_err:.3g}, plain version {p_err:.3g}, f32 torch.mm "
          f"{mm_err:.3g}")
    assert k_err <= 3 * max(mm_err, p_err)


def _stray_lists(device, n_blocks, n_tiles):
    """Tile lists as no caller builds them but the contract allows: slots
    out of range (skipped), every bin group mixed (each block takes its own),
    and slots past tcount that must not be walked."""
    rng = np.random.default_rng(4)
    tiles = np.full((n_blocks, n_tiles + 6), -1, np.int32)
    tcount = np.zeros(n_blocks, np.int32)
    for b in range(n_blocks):
        keep = np.sort(rng.choice(n_tiles, n_tiles - 5, replace=False)).astype(np.int32)
        row = np.concatenate([keep[:4], [-1, n_tiles + 3], keep[4:]])
        tiles[b, : len(row)] = row
        tiles[b, len(row):] = keep[0]  # past tcount: never walked
        tcount[b] = len(row)
    return torch.from_numpy(tiles).to(device), torch.from_numpy(tcount).to(device)


@pytest.mark.parametrize("int8_q", [False, True])
def test_bin_scan_kernel_skips_stray_list_slots(cuda, int8_q):
    x = _bin_inputs(cuda, 64, n_tiles=21)
    kw = {"q_scale": _as_s8(x)["q_scale"]} if int8_q else {}
    tiles, tcount = _stray_lists(cuda, 2, 21)
    args = (x["plane"], x["q"], x["fa"], x["fr"], x["cl"], x["k1x"], x["g1"], x["c_blk"],
            tiles, tcount)
    got, want = fs.fused_bin_scan_cuda(*args, **kw), fs.fused_bin_scan_plain(*args, **kw)
    if int8_q:
        _assert_bitwise(got, want)
    else:
        _assert_bins_match(got, want)


@pytest.mark.parametrize("mode", ["direct", "direct_s8", "bf16", "int8"])
@pytest.mark.parametrize("compact", [False, True])
def test_bin_scan_kernels_first_row_wins_a_tie(cuda, compact, mode):
    """Rows 8192 apart share a bin. Copies of tile 0's rows in tiles 16 and
    32 reach exactly its values: the bin must keep tile 0's row."""
    n_tiles, bq = 35, 32
    direct = mode.startswith("direct")
    x = _bin_inputs(cuda, bq, n_tiles=n_tiles, c=1) if direct else _packed_inputs(
        cuda, bq, mode == "int8", n_tiles=n_tiles, c=1)
    x["g1"][:, 0] = 25.0  # every query probes the one cluster
    per_row = [x["plane"], x["fa"], x["fr"]] + ([] if direct else [x["fe"]])
    for a in per_row:
        a[8192:8192 + fs.TN] = a[: fs.TN]
        a[16384:16384 + fs.TN] = a[: fs.TN]
    tiles = tcount = None
    if compact:
        tiles = torch.arange(n_tiles, dtype=torch.int32, device=cuda)[None, :].contiguous()
        tcount = torch.tensor([n_tiles], dtype=torch.int32, device=cuda)
    args = (x["plane"], x["q"], x["fa"], x["fr"], x["cl"], x["k1x"], x["g1"], x["c_blk"],
            tiles, tcount)
    if direct:
        kw = {"q_scale": _as_s8(x)["q_scale"]} if mode == "direct_s8" else {}
        args = (x["plane"], x["q"]) + args[2:]
    else:
        kw = dict(f_error=x["fe"], g2=x["g2"], q_scale=x["q_scale"])
    kv, ki, ko = fs.fused_bin_scan(*args, **kw)
    pv, pi, po = fs.fused_bin_scan_plain(*args, **kw)
    # (the plain version's batched product on the card need not give a row's
    # copies bitwise equal dots, so only the kernel is held to the rule)
    first = ki[:, : fs.TN]
    own = torch.arange(fs.TN, dtype=torch.int32, device=cuda)[None, :]
    assert bool((first == own).float().mean() > 0.9)  # most bins filled
    assert bool(((first == own) | (first == -1)).all())
    assert torch.equal(ko, po)
    filled = pv < fs.BIG / 2
    assert torch.equal(kv < fs.BIG / 2, filled)
    torch.testing.assert_close(kv[filled], pv[filled], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("mode", ["direct", "direct_s8", "int8"])
def test_bin_scan_offered_counts_past_16_bits(cuda, mode):
    """A compacted list of 70000 slots that all name tile 0: the blocks of
    its bin group walk the tile 70000 times, so each offered count passes
    65535. The kernels flush their 16-bit counters inside the walk; the plain
    version walks every slot too."""
    n_tiles, bq, slots = 16, 32, 70000
    direct = mode.startswith("direct")
    x = _bin_inputs(cuda, bq, n_tiles=n_tiles, c=1) if direct else _packed_inputs(
        cuda, bq, True, n_tiles=n_tiles, c=1)
    x["g1"][:, 0] = 25.0  # every query probes the one cluster
    tiles = torch.zeros((1, slots), dtype=torch.int32, device=cuda)
    tcount = torch.tensor([slots], dtype=torch.int32, device=cuda)
    args = (x["plane"], x["q"], x["fa"], x["fr"], x["cl"], x["k1x"], x["g1"], x["c_blk"],
            tiles, tcount)
    if direct:
        kw = {"q_scale": _as_s8(x)["q_scale"]} if mode == "direct_s8" else {}
        args = (x["plane"], x["q"]) + args[2:]
    else:
        kw = dict(f_error=x["fe"], g2=x["g2"], q_scale=x["q_scale"])
    kv, ki, ko = fs.fused_bin_scan(*args, **kw)
    pv, pi, po = fs.fused_bin_scan_plain(*args, **kw)
    assert int(ko.max()) > 0xFFFF
    if mode == "direct_s8":
        _assert_bitwise((kv, ki, ko), (pv, pi, po))
    else:
        _assert_bins_match((kv, ki, ko), (pv, pi, po), exact_dot=mode == "int8")


def _packed_inputs(device, bq, int8_q, db=128, seed=0, **geometry):
    """Packed-mode inputs over the geometry of ``_bin_inputs``: bit planes,
    a bit-plane-ordered query (bf16, or int8 with its scale), f_error and g2."""
    x = _bin_inputs(device, bq, seed=seed, **geometry)
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


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("int8_q", [False, True])
@pytest.mark.parametrize("bq", [32, 96])
def test_packed_bin_scan_kernel_matches_plain(cuda, compact, int8_q, bq, wide):
    # wide: the widest planes each query type serves, on a tile count that is
    # no multiple of the 16 bin groups
    n_tiles = 21 if wide else 24
    db = (896 if int8_q else 384) if wide else 128
    x = _packed_inputs(cuda, bq, int8_q, db=db, n_tiles=n_tiles)
    tiles = tcount = None
    if compact:
        tiles, tcount = fs.compaction_lists(x["fa"], x["cl"], x["probe"], 32, n_tiles)
    args = (x["plane"], x["q"], x["fa"], x["fr"], x["cl"], x["k1x"], x["g1"], x["c_blk"],
            tiles, tcount)
    kw = dict(f_error=x["fe"], g2=x["g2"], q_scale=x["q_scale"])
    key = ("int8" if int8_q else "bf16") + ("_compact" if compact else "_dense")
    before = fs.fused_bin_scan_packed_cuda.launches[key]
    kv, ki, ko = fs.fused_bin_scan(*args, **kw)
    assert fs.fused_bin_scan_packed_cuda.launches[key] == before + 1
    _assert_bins_match((kv, ki, ko), fs.fused_bin_scan_plain(*args, **kw), exact_dot=int8_q)


@pytest.mark.parametrize("int8_q", [False, True])
def test_packed_bin_scan_kernel_skips_stray_list_slots(cuda, int8_q):
    x = _packed_inputs(cuda, 64, int8_q, n_tiles=21)
    tiles, tcount = _stray_lists(cuda, 2, 21)
    args = (x["plane"], x["q"], x["fa"], x["fr"], x["cl"], x["k1x"], x["g1"], x["c_blk"],
            tiles, tcount)
    kw = dict(f_error=x["fe"], g2=x["g2"], q_scale=x["q_scale"])
    _assert_bins_match(fs.fused_bin_scan(*args, **kw), fs.fused_bin_scan_plain(*args, **kw),
                       exact_dot=int8_q)


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


def _lb_plane_inputs(device, n, b, c=300, seed=0):
    """Stage-1 inputs of the "packed" scan in the permuted layout (rows of
    random clusters), with filtered rows, unprobed clusters and non-finite g
    terms in probed clusters."""
    rng = np.random.default_rng(seed)
    db = 128
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    q = rng.normal(size=(b, 8 * db)).astype(np.float32)
    g_add = (rng.normal(size=(b, c)) * 30).astype(np.float32)
    g_err = (np.abs(rng.normal(size=(b, c))) * 4).astype(np.float32)
    probe = rng.random((b, c)) < 0.3
    g_add[b // 2, 7] = np.inf
    g_err[b - 1, 11] = np.nan
    probe[b // 2, 7] = probe[b - 1, 11] = True
    cl = rng.integers(0, c, n).astype(np.int32)
    cl[:64] = 7  # rows of the clusters with non-finite terms
    cl[64:128] = 11
    return (
        t(rng.integers(0, 256, (n, db)).astype(np.uint8)), t(q).to(torch.bfloat16),
        t(rng.normal(size=n).astype(np.float32) * 10),
        t(rng.normal(size=n).astype(np.float32) * 0.05), t(-0.5 * q.sum(1)), t(g_add), t(g_err),
        t(np.abs(rng.normal(size=n)).astype(np.float32) * 0.4), t(cl), t(probe),
        t(rng.random(n) > 0.1),
    )


def _assert_plane_matches(got, want):
    """+-inf entries equal, finite ones within one bf16 ulp, >= 99% equal."""
    got, want = got.float(), want.float()
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf) and torch.equal(got[inf], want[inf])
    fin = ~inf
    assert bool(((got[fin] - want[fin]).abs() <= 2.0 ** -7 * want[fin].abs() + 1e-3).all())
    assert float((got[fin] == want[fin]).float().mean()) >= 0.99


@pytest.mark.parametrize("n", [128, 4096 + 128, 65536 + 384])
@pytest.mark.parametrize("b", [8, 40, 300])
def test_packed_lb_plane_kernel_matches_plain(cuda, n, b):
    args = _lb_plane_inputs(cuda, n, b, seed=n + b)
    before = ps.packed_lb_plane_cuda.launches
    got = ps.packed_lb_plane(*args)
    assert ps.packed_lb_plane_cuda.launches == before + 1
    assert got.shape == (b, n) and got.dtype == torch.bfloat16
    want = ps.packed_lb_plane_plain(*args)
    assert bool((want == float("inf")).any()) and bool((want == -float("inf")).any())
    _assert_plane_matches(got, want)


@pytest.mark.parametrize("n", [128, 65536 + 384])
@pytest.mark.parametrize("b", [32, 96])
def test_packed_lb_scan_kernel_special_values(cuda, n, b):
    """G_PLANE on a g_comb built as the "packed" scan builds it, with its
    non-finite entries: the TPU contract passes them through unmasked."""
    packed, q, fa, fr, k1x, g_add, g_err, fe, cl, _, _ = _lb_plane_inputs(cuda, n, b, seed=n)
    g_comb = (g_add.to(torch.bfloat16)[:, cl] - fe[None, :] * g_err.to(torch.bfloat16)[:, cl])
    g_comb = g_comb.to(torch.bfloat16)
    got = ps.packed_lb_scan(packed, q, fa, fr, k1x, g_comb)
    want = ps.packed_lb_scan_plain(packed, q, fa, fr, k1x, g_comb)
    assert bool(torch.isnan(want.float()).any()) and bool(torch.isinf(want.float()).any())
    nan = torch.isnan(want.float())
    assert torch.equal(torch.isnan(got.float()), nan)
    _assert_plane_matches(torch.where(nan, 0.0, got.float()), torch.where(nan, 0.0, want.float()))


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
    (the packed bin kernel) and "packed" runs the lower-bound kernel (its
    G_TABLE epilogue)."""
    rng = np.random.default_rng(2)
    data = rng.standard_normal((4000, 200)).astype(np.float32)
    cents = data[:40].copy()
    assign = ((data[:, None, :] - cents[None]) ** 2).sum(-1).argmin(1)
    kw = dict(seed=3, use_faster_config=True, scan_dtype=scan_dtype)
    gpu = IvfRabitqIndex.train_with_clusters(data, cents, assign, 8, device=cuda, **kw)
    cpu = IvfRabitqIndex.train_with_clusters(data, cents, assign, 8, device="cpu", **kw)
    assert not gpu._plan.fused_exact(gpu.scan_dtype)
    counters = fs.fused_bin_scan_packed_cuda.launches
    before = sum(counters.values()) + ps.packed_lb_plane_cuda.launches
    for nprobe in (2, 40):
        params = SearchParams(top_k=10, nprobe=nprobe)
        g_ids, g_d = gpu.batch_search_arrays_pipelined(data[:64], params, batch_size=32)
        c_ids, c_d = cpu.batch_search_arrays(data[:64], params)
        overlap = np.mean([len(set(g_ids[i]) & set(c_ids[i])) / 10 for i in range(64)])
        assert overlap >= 0.98
        assert np.all(g_ids[:, 0] == np.arange(64))
    after = sum(counters.values()) + ps.packed_lb_plane_cuda.launches
    assert (after > before) == (scan_dtype in ("fused8", "fused", "packed"))
    if scan_dtype == "fused8":
        gpu.scan_dtype = "packed"  # re-laid on the card from the sorted layout
        g_ids, _ = gpu.batch_search_arrays(data[:64], SearchParams(top_k=10, nprobe=40))
        assert np.all(g_ids[:, 0] == np.arange(64))
        assert gpu.layout.packed is None and gpu._plan.packed is not None


@pytest.mark.parametrize("n", [4096 + 128, 65536 + 384])
@pytest.mark.parametrize("b", [8, 300])
def test_packed_lb_plane_one_cluster_matches_plain(cuda, n, b):
    """G_TABLE as the brute-force index runs it: one cluster (a [B, 1] g
    table, every row in cluster 0, every query probing it) and a filter
    that masks some rows."""
    args = list(_lb_plane_inputs(cuda, n, b, seed=n + b))
    args[5], args[6] = args[5][:, :1].clone(), args[6][:, :1].clone()  # g terms of cluster 0
    args[5][b // 3, 0] = float("inf")  # a query whose lower bounds are not finite
    args[8] = torch.zeros(n, dtype=torch.int32, device=cuda)
    args[9] = torch.ones((b, 1), dtype=torch.bool, device=cuda)
    before = ps.packed_lb_plane_cuda.launches
    got = ps.packed_lb_plane(*args)
    assert ps.packed_lb_plane_cuda.launches == before + 1
    want = ps.packed_lb_plane_plain(*args)
    assert bool((want == -float("inf")).any()) and bool((want == float("inf")).any())
    _assert_plane_matches(got, want)


def _cpu_and_card_indexes(cuda, total_bits=7, scan_dtype="fused8"):
    """An index built on the CPU and the same codes carried to the card."""
    rng = np.random.default_rng(4)
    cents = (rng.standard_normal((80, 200)) * 2).astype(np.float32)  # 80 blobs of 50 rows
    data = (cents[np.arange(4000) % 80] + rng.standard_normal((4000, 200))).astype(np.float32)
    assign = ((data[:, None, :] - cents[None]) ** 2).sum(-1).argmin(1)
    cpu = IvfRabitqIndex.train_with_clusters(
        data, cents, assign, total_bits, seed=3, scan_dtype=scan_dtype, device="cpu")
    h = cpu.host
    card = IvfRabitqIndex.from_host_arrays(
        dim=cpu.dim, padded_dim=cpu.padded_dim, metric=cpu.metric, ex_bits=cpu.ex_bits,
        rotator_type=cpu.rotator.rotator_type, rotator_bytes=cpu.rotator.serialize(),
        binary_bits=h.binary_bits, ex_codes=h.ex_codes, f_add=h.f_add, f_rescale=h.f_rescale,
        f_error=h.f_error, f_add_ex=h.f_add_ex, f_rescale_ex=h.f_rescale_ex, delta=h.delta,
        vl=h.vl, ids=h.ids, cluster_offsets=h.cluster_offsets, centroids=h.centroids,
        scan_dtype=scan_dtype, device=cuda,
    )
    return data, cpu, card


def test_gather_scan_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """The gather scan (torch ops and the FHT kernel) on the card against the
    same scan on the CPU over the same codes: top-10 lists agree on >= 99%
    of ids (sums in another order may swap near ties), common distances to
    rtol 1e-4 or 1e-2 absolute (a query's distance to itself is ~0, the
    difference of terms of ~4e2: 2.5e-5 of them)."""
    from rabitq_tpu_torch.index import scan

    monkeypatch.setenv("RABITQ_GATHER", "1")
    data, cpu, card = _cpu_and_card_indexes(cuda)
    calls = []
    real = scan._gather_scan
    monkeypatch.setattr(scan, "_gather_scan", lambda *a, **k: calls.append(1) or real(*a, **k))
    params = SearchParams(top_k=10, nprobe=4)
    assert card._plan.gather_rows(card.scan_dtype, 4) == cpu._plan.gather_rows(
        cpu.scan_dtype, 4) is not None
    g_ids, g_d = card.batch_search_arrays(data[:64], params)
    c_ids, c_d = cpu.batch_search_arrays(data[:64], params)
    # the CPU's search, and on the card the warm-up and the capture of the
    # graph that served the block
    assert len(calls) == 3
    assert np.mean([len(set(g_ids[i]) & set(c_ids[i])) / 10 for i in range(64)]) >= 0.99
    assert np.all(g_ids[:, 0] == np.arange(64))
    for i in range(64):
        want = dict(zip(c_ids[i].tolist(), c_d[i].tolist()))
        for rid, d in zip(g_ids[i].tolist(), g_d[i].tolist()):
            if rid in want:
                assert d == pytest.approx(want[rid], rel=1e-4, abs=1e-2)


def test_rbq1_from_the_card_loads_on_the_cpu(cuda, tmp_path):
    """An index trained on the card, saved (its host copy downloaded from the
    card's layout), loads on the CPU with the same codes and answers with
    the same ids."""
    rng = np.random.default_rng(6)
    data = rng.standard_normal((4000, 200)).astype(np.float32)
    card = IvfRabitqIndex.train(data, nlist=40, total_bits=7, seed=3, scan_dtype="fused8",
                                device=cuda)
    card.save_to_path(tmp_path / "card.rbq")
    cpu = IvfRabitqIndex.load_from_path(tmp_path / "card.rbq", scan_dtype="fused8", device="cpu")
    np.testing.assert_array_equal(cpu.host.ex_codes, card.host.ex_codes)
    np.testing.assert_array_equal(cpu.host.ids, card.host.ids)
    params = SearchParams(top_k=10, nprobe=8)
    g_ids, _ = card.batch_search_arrays(data[:64], params)
    c_ids, _ = cpu.batch_search_arrays(data[:64], params)
    assert np.mean([len(set(g_ids[i]) & set(c_ids[i])) / 10 for i in range(64)]) >= 0.99
    assert np.all(c_ids[:, 0] == np.arange(64)) and np.all(g_ids[:, 0] == np.arange(64))


def _bridged_rows():
    """5000 rows in 24 blobs and 500 rows between pairs of them, which
    closure (epsilon 0.9) puts into more than one posting list."""
    rng = np.random.default_rng(8)
    centers = (rng.standard_normal((24, 200)) * 2).astype(np.float32)
    data = centers[rng.integers(0, 24, 5000)] + 0.5 * rng.standard_normal((5000, 200))
    pa = rng.integers(0, 24, 500)
    pb = (pa + 1 + rng.integers(0, 23, 500)) % 24
    bridges = 0.5 * (centers[pa] + centers[pb]) + 0.3 * rng.standard_normal((500, 200))
    return np.concatenate([data, bridges]).astype(np.float32)


@pytest.mark.parametrize("scan_dtype,refine", [("fused8", True), ("fused", False), ("packed", True)])
def test_mstg_built_on_the_card_matches_the_cpu(cuda, scan_dtype, refine, tmp_path):
    """A small MSTG index (rotated, with closure replicas) built on the card,
    its codes carried to the CPU: each scan on the card through its kernel
    (the EXACT bin scan for "fused8", the packed bin scan for "fused" without
    refinement, the packed lower-bound plane for "packed") against the plain
    versions on the CPU: top-10 lists agree on >= 98% of ids, no id twice in
    a row. The index's native file, written from the card, loads on the CPU
    with the same arrays."""
    from rabitq_tpu_torch import MstgConfig, MstgIndex, MstgSearchParams

    data = _bridged_rows()
    cfg = MstgConfig(max_posting_size=200, faster_config=True, use_rotator=True,
                     closure_epsilon=0.9, refine_ex=refine)
    card = MstgIndex.build(data, cfg, seed=3, scan_dtype=scan_dtype, device=cuda)
    assert card.replication_factor() > 1.0
    h = card.host
    cpu = MstgIndex.from_host_arrays(
        config=cfg, dim=card.dim, rotator_bytes=card.rotator.serialize(),
        scan_dtype=scan_dtype, device="cpu",
        **{f: getattr(h, f) for f in ("binary_bits", "ex_codes", "f_add", "f_rescale",
                                      "f_add_ex", "f_rescale_ex", "delta", "vl", "ids",
                                      "list_offsets", "centroids", "f_error", "residual_norm")},
    )
    counters = {
        "fused8": _k1_launches,
        "fused": lambda: sum(fs.fused_bin_scan_packed_cuda.launches.values()),
        "packed": lambda: ps.packed_lb_plane_cuda.launches,
    }[scan_dtype]
    before, fht_before = counters(), fht_kernel.launches
    queries = np.concatenate([data[:48], data[-16:]]) + 0.01
    params = MstgSearchParams(top_k=10, ef_search=12, pruning_epsilon=0.8)
    g_ids, _ = card.batch_search_arrays_pipelined(queries, params, batch_size=32)
    c_ids, _ = cpu.batch_search_arrays_pipelined(queries, params, batch_size=32)
    assert counters() > before and fht_kernel.launches > fht_before
    assert card.scan_dtype == scan_dtype
    assert card._plan.fused_exact(scan_dtype) == (scan_dtype == "fused8")
    assert np.mean([len(set(g_ids[i]) & set(c_ids[i])) / 10 for i in range(64)]) >= 0.98
    for row in g_ids:
        assert len(set(row.tolist())) == 10
    card.save_to_path(tmp_path / "card.mstg")
    loaded = MstgIndex.load_from_path(tmp_path / "card.mstg", scan_dtype=scan_dtype, device="cpu")
    np.testing.assert_array_equal(loaded.host.ex_codes, h.ex_codes)
    np.testing.assert_array_equal(loaded.host.ids, h.ids)


def test_upload_of_a_tensor_on_the_card_is_the_tensor(cuda):
    """A dataset already on the card crosses no link: ``device="cuda"`` and
    ``cuda:N`` name the card it is on, so the rows are used as they are (not
    copied through the host, not rounded by an upload encoding)."""
    from rabitq_tpu_torch.utils.transfer import upload_dataset

    x = torch.randn((1 << 20, 160), device=cuda)  # 640 MB: "auto" would send bf16
    for device in ("cuda", cuda, torch.device("cuda", torch.cuda.current_device())):
        out, report = upload_dataset(x, "auto", device=device)
        assert out.data_ptr() == x.data_ptr() and report["encoding"] == "resident"


@pytest.mark.parametrize("b", [1, 8, 300])
def test_streamed_tier_on_the_card_matches_the_cpu(cuda, b):
    """The streamed tier on the card (pinned slabs, side-stream uploads, the
    packed bin kernel with an int8 query, the FHT) against the same tier on
    the CPU over the same codes: top-10 lists agree on >= 99% of ids (sums
    in another order may swap near ties), and every query finds itself."""
    from rabitq_tpu_torch import StreamedIvfIndex

    data, cpu, card = _cpu_and_card_indexes(cuda)
    c_tier = StreamedIvfIndex(cpu, chunk_rows=1024)
    g_tier = StreamedIvfIndex(card, chunk_rows=1024)
    assert g_tier.n_chunks == c_tier.n_chunks == 4
    assert all(t.is_pinned() for c in g_tier._chunks for t in c.values())
    assert "binary" not in g_tier._chunks[0] and card._layout is None
    k3 = fs.fused_bin_scan_packed_cuda.launches
    before = (k3["int8_dense"] + k3["int8_compact"], fht_kernel.launches)
    for nprobe in (2, 80):
        params = SearchParams(top_k=10, nprobe=nprobe)
        g_ids, g_d = g_tier.batch_search_arrays(data[:b], params)
        c_ids, c_d = c_tier.batch_search_arrays(data[:b], params)
        assert g_ids.shape == (b, 10) and np.all(g_ids[:, 0] == np.arange(b))
        assert np.mean([len(set(g_ids[i]) & set(c_ids[i])) / 10 for i in range(b)]) >= 0.99
        for i in range(b):  # common ids: rtol 1e-4, or 1e-2 absolute near 0
            want = dict(zip(c_ids[i].tolist(), c_d[i].tolist()))
            for rid, dist in zip(g_ids[i].tolist(), g_d[i].tolist()):
                if rid in want:
                    assert dist == pytest.approx(want[rid], rel=1e-4, abs=1e-2)
    after = (k3["int8_dense"] + k3["int8_compact"], fht_kernel.launches)
    assert after[0] >= before[0] + 8 and after[1] > before[1]


def test_one_chunk_on_the_card_equals_in_memory_two_stage(cuda, monkeypatch):
    """One chunk holding every row serves exactly what the in-memory index
    serves through its two-stage fused scan (f32 query uploads on both):
    the same layout, bins and re-rank. Afterwards the index lays itself out
    again and serves the same ids."""
    from rabitq_tpu_torch import StreamedIvfIndex

    monkeypatch.setenv("RABITQ_FUSED_EXACT", "0")
    data, _, card = _cpu_and_card_indexes(cuda)
    queries = data[:300] + 0.05
    want = {nprobe: card.batch_search_arrays(queries, SearchParams(top_k=10, nprobe=nprobe))
            for nprobe in (4, 80)}
    tier = StreamedIvfIndex(card, chunk_rows=8192)
    assert tier.n_chunks == 1
    for nprobe, (w_ids, w_d) in want.items():
        ids, d = tier.batch_search_arrays(queries, SearchParams(top_k=10, nprobe=nprobe))
        np.testing.assert_array_equal(ids, w_ids)
        np.testing.assert_allclose(d, w_d, rtol=1e-5)
    ids, _ = card.batch_search_arrays(queries, SearchParams(top_k=10, nprobe=4))
    np.testing.assert_array_equal(ids, want[4][0])


def test_streamed_slab_freed_during_its_scan_is_not_reused(cuda):
    """The record_stream trap: a slab uploaded on the side stream and freed
    while its scan still waits in the compute stream must not be handed to
    the next allocation on the side stream. The compute stream is held
    back, the slab dropped, and same-sized tensors filled with junk on the
    side stream: they get other memory, and the scan's result equals the
    one of a plain upload."""
    from rabitq_tpu_torch import StreamedIvfIndex

    data, _, card = _cpu_and_card_indexes(cuda)
    tier = StreamedIvfIndex(card, chunk_rows=1024)
    params = SearchParams(top_k=10, nprobe=8)
    b, q_rot = tier._rotate(data[:256])
    kw = dict(allowed=None, max_tiles=tier._plan.max_tiles(tier._scan_dtype, 8), probe_k=None)
    plain = {k: v.to(cuda) for k, v in tier._chunks[0].items()}
    want = [t.cpu() for t in tier._scan_chunk(plain, q_rot, params, **kw)]
    uploads = tier._uploads()
    cur = next(uploads)
    shapes = [(t.shape, t.dtype) for t in cur.values()]
    freed = {t.data_ptr() for t in cur.values()}
    torch.cuda._sleep(200_000_000)  # hold the compute stream back
    got = tier._scan_chunk(cur, q_rot, params, **kw)
    del cur
    uploads.close()  # the generator drops its reference: the slab is freed
    with torch.cuda.stream(tier._copy_stream):
        junk = [torch.full(s, 3, dtype=d, device=cuda) for s, d in shapes]
    assert not freed & {t.data_ptr() for t in junk}
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("total_bits,scan_dtype", [(7, "fused8"), (8, "fused8"), (8, "packed")])
def test_four_shards_on_the_card_match_the_cpu(cuda, total_bits, scan_dtype):
    """Four shards on one card (the bin kernels, or the packed lower-bound
    kernel, on each shard's row slice, and the FHT) against four shards on
    the CPU over the same codes (the plain versions): top-10 lists agree on
    >= 99% of ids (sums in another order may swap near ties), and every
    query finds itself."""
    from rabitq_tpu_torch.parallel.sharding import ShardedIvfIndex

    data, cpu, card = _cpu_and_card_indexes(cuda, total_bits, scan_dtype)
    g_sh = ShardedIvfIndex(card, devices=[cuda] * 4)
    c_sh = ShardedIvfIndex(cpu, devices=["cpu"] * 4)
    assert g_sh._slab_rows == c_sh._slab_rows and g_sh.mesh.devices[0].type == "cuda"
    counters = fs.fused_bin_scan_packed_cuda.launches

    def launches():
        return (_k1_launches() + sum(counters.values()) + ps.packed_lb_plane_cuda.launches,
                fht_kernel.launches)

    before = launches()
    for nprobe in (2, 80):
        params = SearchParams(top_k=10, nprobe=nprobe)
        g_ids, _ = g_sh.batch_search_arrays(data[:64], params)
        c_ids, _ = c_sh.batch_search_arrays(data[:64], params)
        assert np.all(g_ids[:, 0] == np.arange(64))
        assert np.mean([len(set(g_ids[i]) & set(c_ids[i])) / 10 for i in range(64)]) >= 0.99
    after = launches()
    assert after[0] >= before[0] + 8 and after[1] > before[1]  # 4 shards x 2 batches


def test_one_shard_on_the_card_equals_the_index(cuda):
    """A one-shard mesh on the card serves exactly what the index does."""
    from rabitq_tpu_torch.parallel.sharding import ShardedIvfIndex

    data, _, card = _cpu_and_card_indexes(cuda)
    one = ShardedIvfIndex(card, devices=[cuda])
    queries = data[:300] + 0.05
    for nprobe in (4, 80):
        params = SearchParams(top_k=10, nprobe=nprobe)
        ids, d = one.batch_search_arrays(queries, params)
        w_ids, w_d = card.batch_search_arrays(queries, params)
        np.testing.assert_array_equal(ids, w_ids)
        np.testing.assert_array_equal(d, w_d)


def test_shard_merge_tie_order_on_the_card(cuda):
    """The merge of four shards' candidates on the card keeps the lower
    column among equal distances (a stable ascending sort, the order of
    ``lax.top_k``)."""
    from rabitq_tpu_torch.parallel.sharding import _merge_topk

    rng = np.random.default_rng(0)
    dists = rng.integers(0, 4, (300, 4 * 10)).astype(np.float32)  # many ties
    dists[0, :3] = np.inf
    ids = rng.integers(0, 1 << 20, dists.shape).astype(np.int32)
    g_ids, g_d = _merge_topk(
        list(torch.from_numpy(ids).to(cuda).split(10, dim=1)),
        list(torch.from_numpy(dists).to(cuda).split(10, dim=1)), 10, cuda,
    )
    order = np.argsort(dists, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(g_ids.cpu().numpy(), np.take_along_axis(ids, order, 1))
    np.testing.assert_array_equal(g_d.cpu().numpy(), np.take_along_axis(dists, order, 1))


def test_sharded_mstg_rotates_on_the_card(cuda):
    """The sharded MSTG wrapper rotates its queries on the card (the FHT
    kernel runs on that path): one shard returns the index's ids through
    the dedup (the index has closure replicas), and four shards agree with
    it on >= 98% of ids."""
    from rabitq_tpu_torch import MstgConfig, MstgIndex, MstgSearchParams
    from rabitq_tpu_torch.parallel.sharding import ShardedMstgIndex

    data = _bridged_rows()
    cfg = MstgConfig(max_posting_size=200, faster_config=True, use_rotator=True,
                     closure_epsilon=0.9)
    card = MstgIndex.build(data, cfg, seed=3, scan_dtype="fused8", device=cuda)
    assert card.replication_factor() > 1.0
    queries = np.concatenate([data[:48], data[-16:]]) + 0.01
    params = MstgSearchParams(top_k=10, ef_search=12, pruning_epsilon=0.8)
    want = [[h.id for h in row] for row in card.batch_search(queries, params)]
    fht_before = fht_kernel.launches
    one = ShardedMstgIndex(card, devices=[cuda]).batch_search(queries, params)
    assert fht_kernel.launches > fht_before
    assert [[h.id for h in row] for row in one] == want
    four = ShardedMstgIndex(card, devices=[cuda] * 4).batch_search(queries, params)
    assert np.mean([len({h.id for h in a} & set(b)) / 10 for a, b in zip(four, want)]) >= 0.98


# ----------------------------------------------------------------------
# the fused search as CUDA graphs: every serving dispatch one replay
# ----------------------------------------------------------------------


class _Eager:
    """An index's fused search run as its eager body (no graph): the witness
    the graphs are held against."""

    def __init__(self, fused):
        self.fused = fused

    def __call__(self, *a, **k):
        return self.fused.eager(*a, **k)

    def clear(self):
        self.fused.clear()


def _eagerly(index, run):
    """``run()`` with the index's searches served by the eager body."""
    fused = index._fused_scan
    index._fused_scan = _Eager(fused)
    try:
        return run()
    finally:
        index._fused_scan = fused


def _entries_during(run, monkeypatch):
    """(run()'s result, the kernels the wrappers launched in it, by entry
    point name): every wrapper looks its kernel up in ``_cuda.entry`` just
    before it launches, which a replay never does."""
    from rabitq_tpu_torch.ops import _cuda

    calls = []
    real = _cuda.entry
    monkeypatch.setattr(_cuda, "entry", lambda name: calls.append(name) or real(name))
    out = run()
    torch.cuda.synchronize()
    monkeypatch.setattr(_cuda, "entry", real)
    return out, calls


def _ivf_case(cuda, total_bits, scan_dtype, nprobe):
    data, _, card = _cpu_and_card_indexes(cuda, total_bits, scan_dtype)
    card.upload_dtype = "int8"
    params = SearchParams(top_k=10, nprobe=nprobe)
    queries = data[:128] + 0.01
    return card, lambda: card.batch_search_arrays_pipelined(
        queries, params, batch_size=32, upload_block=64)


def _bf_case(cuda):
    from rabitq_tpu_torch import BruteForceRabitqIndex, BruteForceSearchParams

    data = _bridged_rows()
    card = BruteForceRabitqIndex.train(data, total_bits=7, seed=3, use_faster_config=True,
                                       scan_dtype="packed", device=cuda)
    params = BruteForceSearchParams(top_k=10)

    def run():
        hits = card.batch_search(data[:64] + 0.01, params)
        return (np.array([[h.id for h in row] for row in hits]),
                np.array([[h.score for h in row] for row in hits]))

    return card, run


def _mstg_case(cuda):
    from rabitq_tpu_torch import MstgConfig, MstgIndex, MstgSearchParams

    data = _bridged_rows()
    cfg = MstgConfig(max_posting_size=200, faster_config=True, use_rotator=True,
                     closure_epsilon=0.9)
    card = MstgIndex.build(data, cfg, seed=3, scan_dtype="fused8", device=cuda)
    assert card._has_replicas()
    card.upload_dtype = "int8"
    queries = np.concatenate([data[:48], data[-16:]]) + 0.01
    params = MstgSearchParams(top_k=10, ef_search=12, pruning_epsilon=0.8)
    return card, lambda: card.batch_search_arrays_pipelined(
        queries, params, batch_size=32, upload_block=64)


@pytest.mark.parametrize("case", ["ivf7_compacted", "ivf7_dense", "ivf8_fused8", "ivf8_packed",
                                  "brute_force_packed", "mstg_dedup"])
def test_graphs_equal_the_eager_body(cuda, case, monkeypatch):
    """Each serving path on the card through its CUDA graphs equals the eager
    body on the same blocks, ids and distances; once its keys are captured,
    a run launches no kernel outside a graph (one replay a block) but the
    query encoding of its int8 uploads (one launch an upload block)."""
    if case == "ivf7_compacted":
        monkeypatch.setenv("RABITQ_FUSED_COMPACT", "force")
        index, run = _ivf_case(cuda, 7, "fused8", 4)
    elif case == "ivf7_dense":
        index, run = _ivf_case(cuda, 7, "fused8", 40)
    elif case == "ivf8_fused8":
        index, run = _ivf_case(cuda, 8, "fused8", 4)
    elif case == "ivf8_packed":
        index, run = _ivf_case(cuda, 8, "packed", 40)
    elif case == "brute_force_packed":
        index, run = _bf_case(cuda)
    else:
        index, run = _mstg_case(cuda)
    first = run()  # captures
    fused = index._fused_scan
    replays = fused.stats["replays"]
    got, entries = _entries_during(run, monkeypatch)
    blocks = {"brute_force_packed": 0, "mstg_dedup": 1}.get(case, 2)  # int8 upload blocks of 64
    assert entries == ["encode_queries"] * blocks
    assert fused.stats["replays"] > replays and fused._graphs
    want = _eagerly(index, run)
    for g, f, w in zip(got, first, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(f, w)
    if case == "ivf7_compacted":
        k1 = fs.fused_bin_scan_cuda.launches
        assert k1["f32_compact"] + k1["s8_compact"] > 0


def test_graph_outputs_survive_later_replays(cuda):
    """Six blocks served under one key before a single fetch: each keeps its
    own results (the outputs are cloned before the next replay)."""
    data, _, card = _cpu_and_card_indexes(cuda)
    params = SearchParams(top_k=10, nprobe=8)
    queries = data[:192] + 0.01
    ids, d = card.batch_search_arrays_pipelined(queries, params, batch_size=32)
    assert len(card._fused_scan._graphs) == 1 and card._fused_scan.stats["replays"] == 6
    w_ids, w_d = _eagerly(card, lambda: card.batch_search_arrays_pipelined(
        queries, params, batch_size=32))
    np.testing.assert_array_equal(ids, w_ids)
    np.testing.assert_array_equal(d, w_d)
    assert np.all(ids[:, 0] == np.arange(192))


def test_two_filters_in_a_row_under_one_key(cuda):
    """The row mask is an input copied into the graph at each call: two
    filters in a row under one key each hold."""
    data, _, card = _cpu_and_card_indexes(cuda)
    params = SearchParams(top_k=10, nprobe=80)
    for keep in (0, 1):
        allowed = np.arange(keep, 4000, 2)
        ids, d = card.batch_search_arrays(data[:64], params, filter_ids=allowed)
        assert (ids >= 0).all() and (ids % 2 == keep).all()
        w_ids, w_d = _eagerly(card, lambda: card.batch_search_arrays(
            data[:64], params, filter_ids=allowed))
        np.testing.assert_array_equal(ids, w_ids)
        np.testing.assert_array_equal(d, w_d)
    assert len(card._fused_scan._graphs) == 1


def test_relayout_then_search_reads_the_new_layout(cuda):
    """A search, a re-layout (scan_dtype to "packed" and back): the graphs are
    dropped with the old layout and the next search captures against the
    new tensors, equal to the eager body."""
    data, _, card = _cpu_and_card_indexes(cuda, 8, "fused8")
    params = SearchParams(top_k=10, nprobe=8)
    before, _ = card.batch_search_arrays(data[:64], params)
    for scan_dtype in ("packed", "fused8"):
        card.scan_dtype = scan_dtype
        ids, d = card.batch_search_arrays(data[:64], params)
        assert len(card._fused_scan._graphs) == 1
        w_ids, w_d = _eagerly(card, lambda: card.batch_search_arrays(data[:64], params))
        np.testing.assert_array_equal(ids, w_ids)
        np.testing.assert_array_equal(d, w_d)
    assert len(card._fused_scan.stats["capture_s"]) == 3  # one a layout
    np.testing.assert_array_equal(ids, before)


def test_launch_counters_count_replays(cuda):
    """A replay adds the launches its capture recorded: N replays of one key
    add N times the graph's counts, the capture adds none of its own."""
    from rabitq_tpu_torch.index import scan

    data, _, card = _cpu_and_card_indexes(cuda)
    params = SearchParams(top_k=10, nprobe=8)
    queries = data[:128] + 0.01
    start = scan._read_launches()
    card.batch_search_arrays_pipelined(queries[:32], params, batch_size=32)  # warm-up + capture
    (graph,) = card._fused_scan._graphs.values()
    per_replay = graph.launches
    k1 = [n for (d, _), n in zip(scan._launch_counters(), per_replay)
          if d is fs.fused_bin_scan_cuda.launches]
    assert per_replay[0] > 0 and sum(k1) == 1  # FHT; one bin scan
    after_first = scan._read_launches()
    # the warm-up launched once, the capture recorded once and ran once at its replay
    assert [a - s for a, s in zip(after_first, start)] == [2 * n for n in per_replay]
    card.batch_search_arrays_pipelined(queries, params, batch_size=32)
    assert [a - b for a, b in zip(scan._read_launches(), after_first)] == [
        4 * n for n in per_replay]


def test_jax_shaped_index_on_the_card_matches_the_cpu(cuda):
    """``IvfRabitqIndex(dim, padded_dim, metric, rotator, ex_bits, host)``,
    the JAX package's shape, on the card over a CPU index's host codes:
    laid out at its first search, through the FHT and the bin-scan kernels,
    with ids and distances equal to the same codes carried by
    ``from_host_arrays`` and top-10 lists as the CPU index's (>= 98%)."""
    data, cpu, card = _cpu_and_card_indexes(cuda)
    made = IvfRabitqIndex(cpu.dim, cpu.padded_dim, cpu.metric, cpu.rotator, cpu.ex_bits,
                          cpu.host, "fused8", device=cuda)
    assert made._layout is None and made.device.type == "cuda"
    before = (fht_kernel.launches, _k1_launches())
    for nprobe in (2, 40):
        params = SearchParams(top_k=10, nprobe=nprobe)
        m_ids, m_d = made.batch_search_arrays_pipelined(data[:64], params, batch_size=32)
        k_ids, k_d = card.batch_search_arrays_pipelined(data[:64], params, batch_size=32)
        c_ids, _ = cpu.batch_search_arrays(data[:64], params)
        np.testing.assert_array_equal(m_ids, k_ids)
        np.testing.assert_array_equal(m_d, k_d)
        assert np.mean([len(set(m_ids[i]) & set(c_ids[i])) / 10 for i in range(64)]) >= 0.98
    after = (fht_kernel.launches, _k1_launches())
    assert after[0] > before[0] and after[1] > before[1]


def test_mstg_build_steps_take_host_rows_on_the_card(cuda):
    """``hierarchical_cluster`` and ``closure_assign`` given host rows (the
    JAX package's shape) on the card: the lists equal those of the same
    call with the rows on the card. Every segment sum adds in one fixed
    order (the segment-sum kernel), so the calls agree without any
    deterministic-algorithms switch."""
    from rabitq_tpu_torch.index.mstg.closure import closure_assign
    from rabitq_tpu_torch.index.mstg.clustering import hierarchical_cluster

    data = _bridged_rows()
    rows = torch.from_numpy(data).to(cuda)
    host = hierarchical_cluster(data, 200, 8, 1.0, 25, 3, None, 4)
    on_card = hierarchical_cluster(data, 200, 8, 1.0, 25, 3, rows, 4)
    tensor = hierarchical_cluster(rows, 200, 8, seed=3, refine_iters=4)
    for got in (host, on_card):
        assert len(got.members) == len(tensor.members) > 1
        for a, b in zip(got.members, tensor.members):
            np.testing.assert_array_equal(a, b)
    lists = [closure_assign(data, tensor.centroids, 0.9, 8),
             closure_assign(data, tensor.centroids, 0.9, 8, 8192, rows),
             closure_assign(rows, tensor.centroids, 0.9, 8)]
    assert sum(m.size for m in lists[0]) > data.shape[0]  # the bridges replicate
    for got in lists[:2]:
        for a, b in zip(got, lists[2]):
            np.testing.assert_array_equal(a, b)


def test_brute_force_on_the_card_after_a_host_assignment(cuda):
    """A brute-force index made on the card without codes and given a CPU
    index's host (the JAX package assigns the attribute) lays itself out at
    its first search and serves ``packed`` through the lower-bound kernel:
    top-10 lists as the CPU index's (>= 98%)."""
    from rabitq_tpu_torch import BruteForceRabitqIndex, BruteForceSearchParams

    data = _bridged_rows()
    cpu = BruteForceRabitqIndex.train(data, total_bits=7, seed=3, use_faster_config=True,
                                      scan_dtype="packed", device="cpu")
    card = BruteForceRabitqIndex(cpu.dim, cpu.padded_dim, cpu.metric, cpu.rotator, cpu.ex_bits,
                                 None, "packed", device=cuda)
    card.host = cpu.host
    assert len(card) == len(cpu) and card._layout is None
    before = ps.packed_lb_plane_cuda.launches
    params = BruteForceSearchParams(top_k=10)
    g = [[h.id for h in row] for row in card.batch_search(data[:64] + 0.01, params)]
    c = [[h.id for h in row] for row in cpu.batch_search(data[:64] + 0.01, params)]
    assert ps.packed_lb_plane_cuda.launches > before
    assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(g, c)]) >= 0.98


# ----------------------------------------------------------------------
# one seed, one build: the segment-sum kernel and the JAX package's draws
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n,dim,segments", [(20000, 960, 257), (5000, 33, 7), (3000, 32, 4097),
                                            (1, 4, 1), (0, 8, 3)])
def test_segment_sum_kernel_bitwise(cuda, n, dim, segments):
    """The kernel against its plain version (CPU ``index_add_``, ascending
    row order): bitwise equal, counts equal, one launch; rows of ~1e3 with
    mixed signs make any other order show."""
    from rabitq_tpu_torch.ops import kmeans as km

    rng = np.random.default_rng(n + dim)
    data = (rng.standard_normal((n, dim)) * rng.exponential(1e3, (n, 1))).astype(np.float32)
    ids = rng.integers(0, segments, n)
    before = km.segment_sum_kernel.launches
    sums, counts = km.segment_sum_kernel(torch.from_numpy(data).to(cuda),
                                         torch.from_numpy(ids).to(cuda), segments)
    assert km.segment_sum_kernel.launches == before + (1 if n else 0)
    want = km.segment_sum_plain(torch.from_numpy(data), torch.from_numpy(ids), segments)
    assert torch.equal(sums.cpu(), want)
    np.testing.assert_array_equal(counts.cpu().numpy(), np.bincount(ids, minlength=segments))
    # the same through the dispatcher, and on rows that are not 16-byte aligned
    assert torch.equal(km.segment_sum(torch.from_numpy(data).to(cuda), torch.from_numpy(ids).to(cuda),
                                      segments).cpu(), want)
    if n > 1 and dim % 4 == 0:
        flat = torch.zeros(n * dim + 1, device=cuda)
        flat[1:] = torch.from_numpy(data).to(cuda).reshape(-1)
        odd = flat[1:].view(n, dim)
        assert odd.data_ptr() % 16
        got = km.segment_sum_kernel(odd, torch.from_numpy(ids).to(cuda), segments)[0]
        assert torch.equal(got.cpu(), want)


def test_segment_sum_kernel_drops_ids_outside_the_segments(cuda):
    from rabitq_tpu_torch.ops import kmeans as km

    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.standard_normal((3000, 64)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-3, 12, 3000))
    sums, counts = km.segment_sum_kernel(data.to(cuda), ids.to(cuda), 9)
    assert torch.equal(sums.cpu(), km.segment_sum_plain(data, ids, 9))
    np.testing.assert_array_equal(counts.cpu().numpy(), [int((ids == s).sum()) for s in range(9)])


def test_run_kmeans_twice_on_the_card_is_bitwise_equal(cuda):
    """Two runs of one seed: the same centroids bit for bit and the same
    assignments; the Lloyd steps went through the segment-sum kernel."""
    from rabitq_tpu_torch.ops import kmeans as km

    rng = np.random.default_rng(5)
    centers = rng.standard_normal((40, 128)).astype(np.float32) * 3
    data = (centers[rng.integers(0, 40, 60000)] + rng.standard_normal((60000, 128))).astype(
        np.float32)
    rows = torch.from_numpy(data).to(cuda)
    before = km.segment_sum_kernel.launches
    a = km.run_kmeans(rows, 256, niter=10, seed=7, assign_dtype="bf16")
    assert km.segment_sum_kernel.launches >= before + 10
    b = km.run_kmeans(rows, 256, niter=10, seed=7, assign_dtype="bf16")
    assert torch.equal(a.centroids, b.centroids)
    np.testing.assert_array_equal(a.assignments, b.assignments)
    assert a.objective == b.objective


def test_hierarchical_cluster_twice_on_the_card_gives_equal_lists(cuda):
    from rabitq_tpu_torch.index.mstg.clustering import hierarchical_cluster

    rows = torch.from_numpy(_bridged_rows()).to(cuda)
    a = hierarchical_cluster(rows, 200, 8, seed=3, refine_iters=4)
    b = hierarchical_cluster(rows, 200, 8, seed=3, refine_iters=4)
    assert len(a.members) == len(b.members) > 1
    for x, y in zip(a.members, b.members):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.centroids, b.centroids)


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 262_144, 262_147, 1_000_003, 4_194_305])
def test_running_sum_kernel_bitwise(cuda, n):
    """The k-means++ init's running-sum kernel against its plain version
    (CPU, the same tiles and order): bitwise equal; one launch within a
    tile, two up to a tile of tiles (the totals, then the tiles), four past
    it (the totals' own running sum between); the same bits in ten runs (a
    1-D ``torch.cumsum`` on the card is not), and the same from a start
    that is not 16-byte aligned."""
    from rabitq_tpu_torch.ops import kmeans as km

    w = torch.from_numpy(np.random.default_rng(n).exponential(1.0, n).astype(np.float32))
    tiles = -(-n // km.SCAN_TILE)
    before = km.running_sum_kernel.launches
    first = km.running_sum_kernel(w.to(cuda))
    assert km.running_sum_kernel.launches == before + (
        1 if tiles == 1 else 2 if tiles <= km.SCAN_TILE else 4)
    assert torch.equal(first.cpu(), km.running_sum_plain(w))
    for _ in range(9):
        assert torch.equal(km.running_sum(w.to(cuda)), first)
    # an unaligned start takes the kernel's scalar loads
    buf = torch.zeros(n + 1, device=cuda)
    buf[1:] = w.to(cuda)
    assert torch.equal(km.running_sum_kernel(buf[1:]), first)


@pytest.mark.parametrize("seed", [0, 42])
def test_kmeanspp_picks_on_the_card_equal_the_cpu(cuda, seed):
    """On integer-valued rows (every distance and running sum exact in f32,
    TF32 off as by default) the card's k-means++ init picks the CPU's rows:
    both take their draws from the same key on the host."""
    from rabitq_tpu_torch.ops import kmeans as km
    from rabitq_tpu_torch.ops import prng

    assert not torch.backends.cuda.matmul.allow_tf32
    data = torch.from_numpy(
        np.random.default_rng(seed).integers(-4, 5, (4096, 32)).astype(np.float32))
    key = prng.PRNGKey(seed * 1_000_003)
    on_card = km._kmeanspp_init(data.to(cuda), key, 64, 4096)
    on_cpu = km._kmeanspp_init(data, key, 64, 4096)
    assert torch.equal(on_card.cpu(), on_cpu)


def _tied_plane(shape, dtype, cuda, seed, masked=0.0, nans=False):
    """Values with very many ties (quarters in [-50, 50), then rounded to
    ``dtype``), about 1% each of +0.0, -0.0, +inf and -inf, where
    ``masked`` is given that share of -inf, as a probe mask leaves a
    survivor plane, and with ``nans`` about 1% each of four NaNs (both
    signs, two payloads each)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randint(-200, 200, shape, generator=g, device=cuda).to(torch.float32) / 4
    r = torch.rand(shape, generator=g, device=cuda)
    for lo, v in ((0.00, 0.0), (0.01, -0.0), (0.02, float("inf")), (0.03, float("-inf"))):
        x = torch.where((r >= lo) & (r < lo + 0.01), torch.tensor(v, device=cuda), x)
    x = torch.where(r >= 1.0 - masked, float("-inf"), x)
    x = x.to(dtype)
    if nans:
        bits = _bits(x)
        pats = ((0x7FC0, 0x7FC1, -0x40, -0x3F) if dtype == torch.bfloat16 else
                (0x7FC00000, 0x7FC00001, -0x400000, -0x3FFFFF))  # -0x400000: 0xFFC00000
        for i, p in enumerate(pats):
            hit = (r >= 0.04 + 0.01 * i) & (r < 0.05 + 0.01 * i)
            bits = torch.where(hit, torch.tensor(p, dtype=bits.dtype, device=cuda), bits)
        x = bits.view(dtype)
    return x


def _lower_bounds(shape, dtype, cuda, seed, masked=0.0):
    """Rows as a survivor plane holds them: negated distances of one
    magnitude (1000 +- 50), rounded to ``dtype``, ``masked`` of them -inf.
    Ties at the top stay few (the tail is thin): the long-row kernel orders
    these rows' winners on chip."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = -(1000.0 + 50.0 * torch.randn(shape, generator=g, device=cuda))
    x = torch.where(torch.rand(shape, generator=g, device=cuda) < masked, float("-inf"), x)
    return x.to(dtype)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _check_top_k(x, k, spilled=None):
    """The kernel against its plain version: values bitwise, indices equal,
    one launch for any rows, short or long; where ``spilled`` is given, that
    many rows took the long-row kernel's spill (every row where k > CAND)."""
    from rabitq_tpu_torch.ops import select

    rows = x.shape[0] if x.dim() == 2 else 1
    if spilled is None and select.kernel_path(x.shape[-1], k) == "spill":
        spilled = rows
    select.spilled_rows(x.device, reset=True)
    before = sum(select.top_k_cuda.launches.values())
    v, i = select.top_k(x, k)
    assert sum(select.top_k_cuda.launches.values()) == before + 1
    if spilled is not None:
        assert select.spilled_rows(x.device) == spilled
    pv, pi = select.top_k_plain(x, k)
    assert v.dtype == x.dtype and i.dtype == torch.int32 and v.shape == (*x.shape[:-1], k)
    assert torch.equal(i, pi), float((i == pi).float().mean())
    assert torch.equal(_bits(v), _bits(pv))
    return v, i


@pytest.mark.parametrize("k", [1, 10, 400, 10_000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_top_k_kernel_bitwise_at_the_survivor_shape(cuda, dtype, k):
    """[256, 1,000,448], the dense scans' survivor plane, with ties, signed
    zeros and infinities (about 10,000 +inf a row: the k-th key's ties
    exceed CAND and every row spills); then lower bounds as the scans give
    them, ordered on chip (none spilled) up to k = 400; k = 10,000 orders
    more winners than a block's shared memory holds (every row spills)."""
    from rabitq_tpu_torch.ops import select

    _check_top_k(_tied_plane((256, 1_000_448), dtype, cuda, k), k)
    _check_top_k(_lower_bounds((256, 1_000_448), dtype, cuda, k), k,
                 spilled=0 if k <= select.CAND else 256)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_top_k_kernel_bitwise_on_a_masked_plane(cuda, dtype):
    """94% -inf, as at nprobe 256 of 4096 clusters: the tied plane, and
    lower bounds ordered on chip (none spilled)."""
    _check_top_k(_tied_plane((256, 1_000_448), dtype, cuda, 7, masked=0.94), 400)
    _check_top_k(_lower_bounds((256, 1_000_448), dtype, cuda, 7, masked=0.94), 400, spilled=0)


@pytest.mark.parametrize("shape,k", [((256, 4096), 4096), ((256, 4096), 16), ((256, 8192), 400),
                                     ((256, 400), 10), ((1_000_000,), 8), ((1_000_000,), 5000),
                                     ((4, 1_000_448), 400), ((3, 1001), 1001), ((5, 33), 7),
                                     ((2, 1), 1), ((1, 2), 2), ((256, 8193), 400),
                                     ((256, 1024), 32), ((256, 1024), 33), ((256, 1025), 32),
                                     ((7, 8192), 8192), ((7, 8192), 4096), ((7, 8192), 4097),
                                     ((9, 3000), 2999), ((256, 40), 10), ((1, 8192), 8)])
def test_top_k_kernel_bitwise_at_the_other_shapes(cuda, shape, k):
    """The centroid ranking (k = n and a probe bucket), the best bins, the
    final top-k, the shard merge, the k-means reseed (1-D), few long rows
    (clusters left idle; k = 5,000 of one row), both sides of each
    limit of the short-row variants (n 8192 / 8193; k 32 / 33 at n 1024,
    n 1025; sort against select at n 8192), k = n not a power of two, and
    rows whose length is no multiple of 8 (scalar loads), in both types,
    with NaNs among the ties."""
    for dtype in (torch.float32, torch.bfloat16):
        _check_top_k(_tied_plane(shape, dtype, cuda, k + len(shape)), k)
        _check_top_k(_tied_plane(shape, dtype, cuda, k + 7, nans=True), k)
    x = torch.randn(shape, device=cuda)  # few ties
    _check_top_k(x, k)
    if x.dim() == 2 and x.shape[1] > 1:
        _check_top_k(x[:, 1:], k - 1 if k == x.shape[1] else k)  # a strided view is copied


@pytest.mark.parametrize("rows", [256, 3, 1])
def test_top_k_kernel_two_calls_and_a_graph_give_equal_bits(cuda, rows):
    """Long rows: 256 (more rows than clusters in flight, several waves), 3
    and 1 (clusters left idle) give equal bits in two calls, and a CUDA
    graph replayed on new rows equals eager calls on them."""
    from rabitq_tpu_torch.ops import select

    shape = (rows, 1_000_448)
    x = _tied_plane(shape, torch.bfloat16, cuda, 3, masked=0.5)
    v1, i1 = select.top_k(x, 400)
    v2, i2 = select.top_k(x, 400)
    assert torch.equal(_bits(v1), _bits(v2)) and torch.equal(i1, i2)
    static = x.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        select.top_k(static, 400)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gv, gi = select.top_k(static, 400)
    for seed in (3, 4):
        static.copy_(_tied_plane(shape, torch.bfloat16, cuda, seed, masked=0.5))
        graph.replay()
        ev, ei = select.top_k(static, 400)
        assert torch.equal(_bits(gv), _bits(ev)) and torch.equal(gi, ei)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_top_k_kernel_ties_at_the_kth_key_against_the_capacity(cuda, dtype):
    """Rows whose k-th key is tied by CAND + 1 entries, more than the
    long-row kernel orders on chip, take the spill, every row counted; rows
    whose tie bin holds exactly CAND order on chip, none spilled. Both
    bitwise equal to the plain version, and a graph of the spilling call
    equals eager."""
    from rabitq_tpu_torch.ops import select

    def tie_top(seed, m):  # m entries a row, in random places, tied above the rest
        g = torch.Generator(device=cuda).manual_seed(seed)
        x = (torch.randint(-2000, 2000, (64, 1_000_448), generator=g, device=cuda) / 4).to(dtype)
        pos = torch.argsort(torch.rand(x.shape, generator=g, device=cuda), dim=-1)[:, :m]
        return x.scatter_(1, pos, torch.full(pos.shape, 5000.0, dtype=dtype, device=cuda))

    beyond = tie_top(21, select.CAND + 1)
    _check_top_k(beyond, 400, spilled=64)
    _check_top_k(tie_top(22, select.CAND), 400, spilled=0)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        select.top_k(beyond, 400)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gv, gi = select.top_k(beyond, 400)
    graph.replay()
    ev, ei = select.top_k(beyond, 400)
    assert torch.equal(_bits(gv), _bits(ev)) and torch.equal(gi, ei)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_top_k_kernel_winners_below_the_hinted_digit(cuda, dtype):
    """Rows where the most frequent first digit (the long-row kernel's hint,
    counted in registers and not buffered) holds 60% of the keys and lies
    below the k-th key's: its keys are winners too. Several rows a cluster,
    so the hint is learnt from the row before; one row of the same kind."""
    g = torch.Generator(device=cuda).manual_seed(31)
    x = torch.randn((300, 10_000), generator=g, device=cuda)
    x = torch.where(torch.rand(x.shape, generator=g, device=cuda) < 0.6, 1000.0, x).to(dtype)
    _check_top_k(x, 7000, spilled=0)
    _check_top_k(x[:4].reshape(-1)[:39_999].contiguous(), 5000)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_top_k_short_rows_in_a_graph_equal_eager(cuda, dtype):
    """The short-row variants (warp, sort, select) captured in one CUDA
    graph, replayed on new rows: values and indices equal to eager calls
    on those rows."""
    from rabitq_tpu_torch.ops import select

    cases = (((256, 400), 10), ((256, 4096), 4096), ((256, 8192), 400))
    assert [select.kernel_path(s[-1], k) for s, k in cases] == ["warp", "sort", "select"]
    static = [_tied_plane(s, dtype, cuda, 1) for s, _ in cases]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for x, (_, k) in zip(static, cases):
            select.top_k(x, k)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [select.top_k(x, k) for x, (_, k) in zip(static, cases)]
    for seed in (2, 3):
        for x, (shape, _) in zip(static, cases):
            x.copy_(_tied_plane(shape, dtype, cuda, seed, nans=seed == 3))
        graph.replay()
        for x, (_, k), (gv, gi) in zip(static, cases, outs):
            ev, ei = select.top_k(x, k)
            assert torch.equal(_bits(gv), _bits(ev)) and torch.equal(gi, ei)


def test_top_k_kernel_refuses_what_it_does_not_take(cuda):
    from rabitq_tpu_torch.ops import select

    with pytest.raises(ValueError):
        select.top_k(torch.zeros((2, 8), device=cuda, dtype=torch.float16), 1)
    with pytest.raises(ValueError):
        select.top_k(torch.zeros((2, 8), device=cuda), 9)
    v, i = select.top_k(torch.zeros((2, 8), device=cuda), 0)
    assert v.shape == i.shape == (2, 0)


# ----------------------------------------------------------------------
# query encoding on the card (ops/encode.py, scan.QueryStage)
# ----------------------------------------------------------------------


def _special_queries(n: int, dim: int, top: float) -> np.ndarray:
    """``n`` random rows, the first few replaced (as far as ``n`` allows) by a
    zero row, a row that lands on k + 0.5 after scaling (|x| max ``top``,
    qmax, makes the scale 1.0), a row of one large value, a subnormal row,
    a row holding a NaN and one holding +-inf."""
    rng = np.random.default_rng(5)
    q = (rng.standard_normal((n, dim)) * 3).astype(np.float32)
    halves = np.resize(np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 6.5, -6.5], np.float32), dim)
    halves[0] = top
    large = np.zeros(dim, np.float32)
    large[dim // 3] = -3.0e38
    nan, inf = q[0].copy(), q[0].copy()
    nan[1] = np.nan
    inf[2], inf[5] = np.inf, -np.inf
    special = [np.zeros(dim, np.float32), halves, large, q[0] * np.float32(1e-40), nan, inf]
    for i, row in enumerate(special[: max(n - 1, 0)]):
        q[1 + i] = row
    return q


def _assert_encoding_equal(got, want):
    """Codes bitwise equal, padding rows included; scales bitwise equal, and
    NaN where the other's is NaN (a NaN's bits are the platform's)."""
    (got_q, got_s), (want_q, want_s) = (tuple(t.cpu() for t in got), want)
    assert got_q.dtype == want_q.dtype and got_q.shape == want_q.shape
    assert torch.equal(got_q.view(torch.uint8), want_q.view(torch.uint8))
    nan = torch.isnan(want_s)
    assert torch.equal(torch.isnan(got_s), nan)
    assert torch.equal(got_s[~nan].view(torch.int32), want_s[~nan].view(torch.int32))


@pytest.mark.parametrize("dim", [960, 33])
@pytest.mark.parametrize("n,b_pad", [(1000, 1024), (70, 128), (1, 1)])
@pytest.mark.parametrize("upload", ["int8", "int4"])
def test_encode_kernel_bitwise(cuda, upload, n, b_pad, dim):
    """The encode kernel against its plain version and the host's numpy
    encoding, bit for bit, one launch a block; at one row, once for each
    kind of row."""
    from rabitq_tpu_torch.index.scan import _encode
    from rabitq_tpu_torch.ops.encode import BITS, encode_rows_kernel, encode_rows_plain

    bits = BITS[upload]
    rows = _special_queries(max(n, 7), dim, float((1 << (bits - 1)) - 1))
    blocks = [rows[:n]] if n > 1 else [rows[i : i + 1] for i in range(7)]
    for q in blocks:
        before = encode_rows_kernel.launches
        got = encode_rows_kernel(torch.from_numpy(q).to(cuda), b_pad, bits)
        torch.cuda.synchronize()
        assert encode_rows_kernel.launches == before + 1
        _assert_encoding_equal(got, encode_rows_plain(torch.from_numpy(q), b_pad, bits))
        with np.errstate(invalid="ignore"):
            _assert_encoding_equal(got, _encode(q, b_pad, dim, upload))


def test_encode_kernel_refuses_what_it_does_not_take(cuda):
    from rabitq_tpu_torch.ops.encode import encode_rows_kernel

    with pytest.raises(ValueError):
        encode_rows_kernel(torch.zeros((4, 8), device=cuda), 2, 8)  # more rows than the block
    with pytest.raises(ValueError):
        encode_rows_kernel(torch.zeros((4, 8), device=cuda, dtype=torch.float16), 4, 8)
    with pytest.raises(ValueError):
        encode_rows_kernel(torch.zeros((4, 8)), 4, 8)  # on the CPU


def _host_encoded(card, queries, params, batch_size, upload_block):
    """The host's path: each upload block encoded by numpy, copied to the
    card, and its scan blocks dispatched as the pipelined search does."""
    from rabitq_tpu_torch.index.scan import _fetch, encode_queries

    row_allowed = card._scan_inputs(None)
    b = queries.shape[0]
    pending = []
    for s in range(0, b, upload_block):
        q, qscale = encode_queries(queries[s : s + upload_block], upload_block, card.dim,
                                   card.upload_dtype)
        q, qscale = q.to(card.device), None if qscale is None else qscale.to(card.device)
        for off in range(0, min(upload_block, b - s), batch_size):
            pending.append(card._dispatch_scan(q, qscale, params, row_allowed, offset=off,
                                               sub_block=batch_size))
    return _fetch(pending, b)


@pytest.mark.parametrize("route", ["slot", "pageable"])
@pytest.mark.parametrize("upload", ["int8", "int4", "f32", "bf16"])
def test_pipelined_batch_encodes_on_the_card(cuda, upload, route, monkeypatch):
    """A pipelined batch of three upload blocks: every row encoded on the
    card (``on_card`` of ``serve.encode``, one kernel launch a block where the
    upload has codes, the raw rows' bytes over the link, the copy inside the
    encode span), ids and distances bitwise equal to encoding each block on
    the host and dispatching the same blocks, and no graph captured again;
    the blocks through the stage's pinned slots (as the 1,000-row blocks of a
    batch) or copied from pageable memory (as one query, or a whole call
    above the slots' size)."""
    from rabitq_tpu_torch.index import scan
    from rabitq_tpu_torch.ops.encode import encode_rows_kernel
    from rabitq_tpu_torch.utils import profiling

    if route == "slot":
        monkeypatch.setattr(scan, "SMALL_BYTES", 0)
    else:
        monkeypatch.setattr(scan, "SLOT_BYTES", 0)
    data, _, card = _cpu_and_card_indexes(cuda)
    card.upload_dtype = upload
    params = SearchParams(top_k=10, nprobe=8)
    queries = data[:150] + 0.01

    def run():
        return card.batch_search_arrays_pipelined(queries, params, batch_size=32, upload_block=64)

    run()  # captures
    captures = len(card._fused_scan.stats["capture_s"])
    before = encode_rows_kernel.launches
    profiling.clear()
    try:
        with profiling.recording():
            ids, d = run()
        found = profiling.spans()
    finally:
        profiling.clear()
    enc = [s for s in found if s.name == "serve.encode"]
    assert [(s.counts["rows"], s.counts["on_card"], s.counts["bytes"]) for s in enc] == [
        (n, n, n * 200 * 4) for n in (64, 64, 22)]
    copies = [s for s in found if s.name == "serve.copy_in"]
    assert [s.parent for s in copies] == [s.id for s in enc]
    assert encode_rows_kernel.launches == before + (3 if upload in ("int8", "int4") else 0)
    assert (card._stage._slots[0] is None) == (route == "pageable")
    h_ids, h_d = _host_encoded(card, queries, params, 32, 64)
    np.testing.assert_array_equal(ids, h_ids)
    np.testing.assert_array_equal(d, h_d)
    assert len(card._fused_scan.stats["capture_s"]) == captures


def test_staging_block_is_reused_safely(cuda, monkeypatch):
    """Calls in a row with different query sets (the last a view with a
    negative stride), pipelined and in one block, each give their own answers
    (those of the host's path); a second call of the same shape pins no new
    memory: the stage keeps the same blocks. A block above the slots' size
    is copied from pageable memory and leaves the slots as they were."""
    from rabitq_tpu_torch.index import scan

    monkeypatch.setattr(scan, "SMALL_BYTES", 0)
    monkeypatch.setattr(scan, "SLOT_BYTES", 100 * 200 * 4)
    data, _, card = _cpu_and_card_indexes(cuda)
    card.upload_dtype = "int8"
    params = SearchParams(top_k=10, nprobe=8)
    sets = [data[:150] + 0.01, data[1000:1150] - 0.01, (data[3000:3150] * 1.01)[::-1]]
    piped = [card.batch_search_arrays_pipelined(sets[0], params, batch_size=32, upload_block=64)]
    slots = [s.data_ptr() for s in card._stage._slots]
    piped += [card.batch_search_arrays_pipelined(q, params, batch_size=32, upload_block=64)
              for q in sets[1:]]
    assert [s.data_ptr() for s in card._stage._slots] == slots
    for (ids, d), q in zip(piped, sets):
        h_ids, h_d = _host_encoded(card, q, params, 32, 64)
        np.testing.assert_array_equal(ids, h_ids)
        np.testing.assert_array_equal(d, h_d)
    whole = [card.batch_search_arrays(q, params) for q in sets]  # one block of 150 rows each
    assert [tuple(s.shape) for s in card._stage._slots] == [(64, 200), (64, 200)]
    for (ids, d), q in zip(whole, sets):
        h_ids, h_d = _host_encoded(card, q, params, 256, 256)
        np.testing.assert_array_equal(ids, h_ids)
        np.testing.assert_array_equal(d, h_d)


# ----------------------------------------------------------------------
# stage 2's gather-dot (csrc/gather_dot.cu)
# ----------------------------------------------------------------------
# Tolerance: the kernel and its plain version (the torch chain: gather, f32
# copy, cuBLAS batched GEMV in full f32) multiply and add in f32 and differ
# only in the order of the additions inside a dot, so each dot lies within
# ops.gather_dot.sum_tolerance: 2 * D * 2**-24 * sum_d |code_d * q_d|.


def _gather_dot_case(cuda, case):
    """(rows, pairs) on the card: the 8-bit cell's block (binary and raw ex
    planes, 256 x 400 survivors, 1,024 columns), the TOTAL plane at 7 bits
    (960 columns of a plane padded to 1,024), int32 raw ex codes at 9 bits,
    one query, a ragged slot count, the gather scan's block, and planes
    whose rows are not 16-byte aligned (width 100, int8 and int32)."""
    n = 1 << 17
    b, r, dim, width = {"cell": (256, 400, 1024, 1024), "total7": (256, 400, 960, 1024),
                        "int32_9bit": (64, 400, 1024, 1024), "one_query": (1, 400, 1024, 1024),
                        "ragged": (37, 67, 1024, 1024), "gather": (128, 4096, 960, 1024),
                        "unaligned": (19, 33, 100, 100), "unaligned_int32": (19, 33, 99, 99)}[case]
    g = torch.Generator(device=cuda).manual_seed(len(case))

    def codes(lo, hi, w, dtype):
        return torch.randint(lo, hi, (n, w), generator=g, device=cuda).to(dtype)

    rows = torch.randint(0, n, (b, r), generator=g, device=cuda)
    rows[0, 0], rows[-1, -1] = 0, n - 1
    q_rot = torch.randn((b, dim), generator=g, device=cuda)
    q_op = q_rot.to(torch.bfloat16).to(torch.float32)
    binary = codes(0, 2, width, torch.int8)
    if case in ("cell", "one_query", "ragged"):
        return rows, ((binary, q_op), (codes(0, 128, width, torch.int8), q_rot))
    if case == "int32_9bit":
        return rows, ((binary, q_op), (codes(0, 512, width, torch.int32), q_rot))
    if case == "unaligned":
        return rows, ((codes(-128, 128, width, torch.int8), q_rot),)
    if case == "unaligned_int32":
        return rows, ((binary, q_op), (codes(-1 << 20, 1 << 20, width, torch.int32), q_rot))
    return rows, ((codes(0, 128, width, torch.int8), q_op),)  # TOTAL codes


@pytest.mark.parametrize("case", ["cell", "total7", "int32_9bit", "one_query", "ragged",
                                  "gather", "unaligned", "unaligned_int32"])
def test_gather_dot_kernel_matches_plain(cuda, case, monkeypatch):
    from rabitq_tpu_torch.ops import gather_dot as gd

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rows, pairs = _gather_dot_case(cuda, case)
    key = "two_planes" if len(pairs) == 2 else "one_plane"
    before = gd.gather_dot_kernel.launches[key]
    got = gd.gather_dot(rows, *pairs)
    assert gd.gather_dot_kernel.launches[key] == before + 1
    again = gd.gather_dot_kernel(rows, *pairs)
    want = gd.gather_dot_plain(rows, *pairs, max_bytes=1 << 30)
    torch.cuda.synchronize()
    for (plane, q), g_, a, w in zip(pairs, got, again, want):
        assert g_.shape == w.shape and torch.isfinite(g_).all()
        assert torch.equal(g_, a)  # one fixed order of additions
        assert (g_ - w).abs().le(gd.sum_tolerance(rows, plane, q)).all()


def test_gather_dot_kernel_in_a_graph_and_past_the_plane(cuda):
    """A captured launch replays to the eager bits; a row index past the
    plane gives NaN in that slot only."""
    from rabitq_tpu_torch.ops import gather_dot as gd

    rows, pairs = _gather_dot_case(cuda, "ragged")
    eager = gd.gather_dot_kernel(rows, *pairs)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        out = gd.gather_dot_kernel(rows, *pairs)
    graph.replay()
    torch.cuda.synchronize()
    for o, e in zip(out, eager):
        assert torch.equal(o, e)
    rows = rows.clone()
    rows[3, 5] = pairs[0][0].shape[0]
    past = gd.gather_dot_kernel(rows, *pairs)
    for p, e in zip(past, eager):
        assert torch.isnan(p[3, 5]) and int(torch.isnan(p).sum()) == 1
        assert torch.equal(p[:3], e[:3]) and torch.equal(p[4:], e[4:])


def test_gather_dot_kernel_refuses_what_it_does_not_take(cuda):
    from rabitq_tpu_torch.ops import gather_dot as gd

    plane = torch.zeros((10, 64), dtype=torch.int8, device=cuda)
    rows = torch.zeros((3, 5), dtype=torch.int64, device=cuda)
    q = torch.zeros((3, 64), device=cuda)
    for bad in ((plane.float(), q), (plane, torch.zeros((3, 65), device=cuda)),
                (plane, torch.zeros((4, 64), device=cuda)), (plane.t(), q[:, :10]),
                (plane.cpu(), q)):
        with pytest.raises(ValueError):
            gd.gather_dot_kernel(rows, bad)
    with pytest.raises(ValueError):  # the two queries differ in shape
        gd.gather_dot_kernel(rows, (plane, q), (plane, q[:, :32].contiguous()))


def _stage2_case(cuda, case, monkeypatch):
    """(index, run, the gather-dot key the run must move) for each CUDA path
    that used to reach stage 2's dot or the gather scan's."""
    from rabitq_tpu_torch import StreamedIvfIndex
    from rabitq_tpu_torch.parallel.sharding import ShardedIvfIndex

    params = SearchParams(top_k=10, nprobe=8)
    if case.startswith("ivf8_"):
        data, _, card = _cpu_and_card_indexes(cuda, 8, case[5:])
        return lambda: card.batch_search_arrays(data[:64], params), "two_planes"
    if case == "brute_force_packed":
        index, run = _bf_case(cuda)
        return run, "one_plane"
    if case == "ivf7_two_stage":
        monkeypatch.setenv("RABITQ_FUSED_EXACT", "0")
    if case == "ivf7_gather":
        monkeypatch.setenv("RABITQ_GATHER", "1")
    data, _, card = _cpu_and_card_indexes(cuda, 8 if case == "sharded8" else 7)
    if case == "streamed7":
        tier = StreamedIvfIndex(card, chunk_rows=1024)
        return lambda: tier.batch_search_arrays(data[:64], params), "one_plane"
    if case == "sharded8":
        sh = ShardedIvfIndex(card, devices=[cuda] * 4)
        return lambda: sh.batch_search_arrays(data[:64], params), "two_planes"
    return lambda: card.batch_search_arrays(data[:64], params), "one_plane"


@pytest.mark.parametrize("case", ["ivf8_fused8", "ivf8_fused", "ivf8_packed", "ivf8_bf16",
                                  "ivf8_int8", "ivf8_f32", "ivf7_two_stage", "ivf7_gather",
                                  "brute_force_packed", "streamed7", "sharded8"])
def test_gather_dot_runs_on_every_stage2_path(cuda, case, monkeypatch):
    """Every card path that re-ranks survivors, or gathers probed rows,
    launches the gather-dot kernel (inside the fused search's graphs, the
    counts a replay adds), with two planes where the re-rank reads raw ex
    codes and one for the TOTAL plane."""
    from rabitq_tpu_torch.ops import gather_dot as gd

    run, key = _stage2_case(cuda, case, monkeypatch)
    before = dict(gd.gather_dot_kernel.launches)
    ids, _ = run()
    torch.cuda.synchronize()
    assert gd.gather_dot_kernel.launches[key] > before[key]
    assert (np.asarray(ids)[:, 0] >= 0).all()


def test_8bit_graphs_against_the_eager_plain_chain(cuda, monkeypatch):
    """The 8-bit fused8 search captured in its graphs (the kernel) against
    the eager body with the plain torch chain in the kernel's place, on the
    same queries, 11 results a query: distances of common ids within the f32
    summation tolerance carried to distances (rtol 1e-4, or 1e-2 absolute
    near 0, as the card-against-CPU tests), and the first 10 ids equal except
    where the 10th and 11th distances lie within it."""
    from rabitq_tpu_torch.index import scan
    from rabitq_tpu_torch.ops import gather_dot as gd

    data, _, card = _cpu_and_card_indexes(cuda, 8, "fused8")
    card.upload_dtype = "int8"
    params = SearchParams(top_k=11, nprobe=8)
    queries = data[:256] + 0.01
    run = lambda: card.batch_search_arrays_pipelined(  # noqa: E731
        queries, params, batch_size=64, upload_block=128)
    run()  # captures
    before = gd.gather_dot_kernel.launches["two_planes"]
    ids, d = run()
    assert gd.gather_dot_kernel.launches["two_planes"] == before + 4
    monkeypatch.setattr(scan, "gather_dot", lambda rows, *pairs, max_bytes=None:
                        gd.gather_dot_plain(rows, *pairs))
    w_ids, w_d = _eagerly(card, run)
    tol = lambda x: np.maximum(1e-4 * np.abs(x), 1e-2)  # noqa: E731
    for i in range(len(queries)):
        if abs(w_d[i, 10] - w_d[i, 9]) > tol(w_d[i, 9]):
            assert list(ids[i, :10]) == list(w_ids[i, :10])
        want = dict(zip(w_ids[i].tolist(), w_d[i].tolist()))
        for rid, dist in zip(ids[i].tolist(), d[i].tolist()):
            if rid in want:
                assert abs(dist - want[rid]) <= tol(want[rid])
