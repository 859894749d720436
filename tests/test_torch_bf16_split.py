"""The operands of the tensor-core bin scans, on the CPU.

``split_bf16x3`` must rebuild an f32 query exactly, a dot of its planes with
int8 codes must match the f32 dot, and ``query_image`` must lay the query
out so that a walk of its tiles in the kernels' fragment order (emulated
here with numpy from the layout ``csrc/mma_tile.cuh`` documents) gives the
plain dot. The bins from the planes' sum must be the bins the JAX kernel
gives (interpret mode).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rabitq_tpu.ops import pallas_fused_scan as jfs
from rabitq_tpu_torch.ops import fused_scan as tfs
from rabitq_tpu_torch.ops.packed_scan import unpack_bitplanes

from test_torch_bin_scan import CASES, N_TILES, _compare_bins, _g1, _inputs


def _sum_f32(parts: torch.Tensor) -> torch.Tensor:
    hi, mid, lo = (p.to(torch.float32) for p in parts)
    return (lo + mid) + hi


@pytest.mark.parametrize("kind", ["normal", "magnitudes", "zeros"])
def test_split_rebuilds_f32_bitwise(kind):
    rng = np.random.default_rng(3)
    if kind == "normal":
        q = rng.standard_normal((64, 256)).astype(np.float32)
    elif kind == "magnitudes":
        q = (rng.standard_normal((64, 256)) * 10.0 ** rng.uniform(-3, 4, (64, 256))).astype(np.float32)
    else:
        q = np.zeros((32, 64), np.float32)
        q[0, 0] = -0.0
    parts = tfs.split_bf16x3(torch.from_numpy(q))
    assert parts.shape == (3,) + q.shape and parts.dtype == torch.bfloat16
    back = _sum_f32(parts).numpy()
    assert np.array_equal(back.view(np.uint32) & 0x7FFFFFFF, q.view(np.uint32) & 0x7FFFFFFF)
    assert np.array_equal(back, q)


# finite f32 whose three parts all stay in the normal range: from 2**-100 (the
# lo part is 2**-16 and less of the value) up to the largest bf16
_NORMAL = st.floats(min_value=2.0 ** -100, max_value=float(torch.finfo(torch.bfloat16).max),
                    width=32)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(_NORMAL, st.booleans()), min_size=1, max_size=64))
def test_split_rebuilds_any_normal_f32(values):
    q = np.array([-v if neg else v for v, neg in values], np.float32)
    back = _sum_f32(tfs.split_bf16x3(torch.from_numpy(q))).numpy()
    assert np.array_equal(back.view(np.uint32), q.view(np.uint32))


def test_three_part_dot_matches_f32_dot():
    """Each part's products with int8 codes are exact in f32; summed
    smallest part first the dot matches the f32 dot to rtol 1e-6 (of the
    sum of magnitudes: the dot itself may cancel)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((32, 1024)).astype(np.float32)
    codes = rng.integers(-128, 128, (96, 1024)).astype(np.int8)
    parts = tfs.split_bf16x3(torch.from_numpy(q)).to(torch.float32)
    c = torch.from_numpy(codes).to(torch.float32)
    prods = parts[:, :, None, :] * c[None, None]  # [3, 32, 96, 1024]
    assert torch.equal(prods.double(), parts.double()[:, :, None, :] * c.double()[None, None])
    hi, mid, lo = (p @ c.T for p in parts)
    got = ((lo + mid) + hi).numpy()
    want = q.astype(np.float64) @ codes.astype(np.float64).T
    scale = np.abs(q).astype(np.float64) @ np.abs(codes).astype(np.float64).T
    assert np.all(np.abs(got - want) <= 1e-6 * scale)
    np.testing.assert_allclose(got, (torch.from_numpy(q) @ c.T).numpy(), rtol=1e-5, atol=2e-2)


def _walk_image(image: np.ndarray, codes: np.ndarray, mode: str, width: int) -> np.ndarray:
    """<codes rows, the 32 queries of one block> formed as the kernels form
    it: stage by stage and k-step by k-step, operand B read from the swizzled
    tiles of ``image`` and operand A taken from the code bytes in the
    fragment order of csrc/mma_tile.cuh."""
    code_bytes, tiles, planes, elem = tfs._IMAGE_MODES[mode]
    stages = width // code_bytes
    row_elems = 128 // elem
    per_unit = 16 // elem
    img = image.reshape(stages, tiles, 32, row_elems).astype(np.float64)
    n = np.arange(32)
    out = np.zeros((codes.shape[0], 32))

    def b_step(c, tile, first, count):
        """B values [32 queries, count slots] of logical row positions first.."""
        kk = first + np.arange(count)
        phys = per_unit * ((kk[None, :] // per_unit) ^ (n[:, None] % 8)) + kk[None, :] % per_unit
        return img[c, tile][n[:, None], phys]

    t = np.arange(4)
    for c in range(stages):
        chunk = codes[:, c * code_bytes : (c + 1) * code_bytes]
        if mode == "direct":
            for s in range(4):
                a = np.zeros((codes.shape[0], 16))
                words = chunk[:, 16 * s : 16 * s + 16].reshape(-1, 4, 4).astype(np.float64)
                a[:, 2 * t], a[:, 2 * t + 1] = words[:, :, 0], words[:, :, 1]
                a[:, 2 * t + 8], a[:, 2 * t + 9] = words[:, :, 2], words[:, :, 3]
                for p in range(3):
                    out += a @ b_step(c, p, 16 * s, 16).T
            continue
        for jg in range(2):
            words = chunk[:, 16 * jg : 16 * jg + 16].reshape(-1, 4, 4)
            if mode == "bits_bf16":
                for k in range(8):
                    bits = ((words >> k) & 1).astype(np.float64)
                    a = np.zeros((codes.shape[0], 16))
                    a[:, 2 * t], a[:, 2 * t + 1] = bits[:, :, 0], bits[:, :, 2]
                    a[:, 2 * t + 8], a[:, 2 * t + 9] = bits[:, :, 1], bits[:, :, 3]
                    i = 8 * jg + k
                    out += a @ b_step(c, i // 4, 16 * (i % 4), 16).T
            else:
                for kp in range(4):
                    lo = ((words >> (2 * kp)) & 1).reshape(-1, 16).astype(np.float64)
                    hi = ((words >> (2 * kp + 1)) & 1).reshape(-1, 16).astype(np.float64)
                    i = 4 * jg + kp
                    out += np.concatenate([lo, hi], 1) @ b_step(c, i // 4, 32 * (i % 4), 32).T
    return out


@pytest.mark.parametrize("d", [64, 192, 1024])
def test_query_image_direct_walk_gives_the_dot(d):
    rng = np.random.default_rng(d)
    q = rng.standard_normal((64, d)).astype(np.float32)
    codes = rng.integers(-128, 128, (40, d)).astype(np.int8)
    parts = tfs.split_bf16x3(torch.from_numpy(q))
    image = tfs.query_image(parts, "direct", d)
    assert image.shape == (2, (d // 64) * 3 * 32 * 64) and image.dtype == torch.bfloat16
    want = q.astype(np.float64) @ codes.astype(np.float64).T
    for blk in range(2):
        got = _walk_image(image[blk].to(torch.float32).numpy(), codes, "direct", d)
        np.testing.assert_allclose(got.T, want[blk * 32 : blk * 32 + 32], rtol=0, atol=1e-9)


@pytest.mark.parametrize("db", [128, 384])
@pytest.mark.parametrize("mode", ["bits_bf16", "bits_s8"])
def test_query_image_packed_walk_gives_the_dot(mode, db):
    rng = np.random.default_rng(db)
    packed = rng.integers(0, 256, (24, db)).astype(np.uint8)
    if mode == "bits_s8":
        q = torch.from_numpy(rng.integers(-127, 128, (64, 8 * db)).astype(np.int8))
    else:
        q = torch.from_numpy(rng.standard_normal((64, 8 * db)).astype(np.float32)).to(torch.bfloat16)
    image = tfs.query_image(q, mode, db)
    assert image.dtype == q.dtype and image.shape[0] == 2
    assert image.shape[1] * image.element_size() == (db // 32) * tfs._IMAGE_MODES[mode][1] * 4096
    bits = unpack_bitplanes(torch.from_numpy(packed)).to(torch.float64).numpy()
    want = q.to(torch.float64).numpy() @ bits.T
    for blk in range(2):
        got = _walk_image(image[blk].to(torch.float32).numpy(), packed, mode, db)
        np.testing.assert_array_equal(got.T, want[blk * 32 : blk * 32 + 32])


def test_query_image_is_a_permutation_of_the_block():
    for mode, width in (("direct", 128), ("bits_bf16", 128), ("bits_s8", 256)):
        idx = tfs.query_image_index(mode, width)
        planes = tfs._IMAGE_MODES[mode][2]
        k = width if mode == "direct" else 8 * width
        assert np.array_equal(np.sort(idx), np.arange(planes * 32 * k))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("compact", [False, True])
def test_bins_from_the_three_planes_match_the_jax_kernel(compact, case):
    """The plain scan fed hi + mid + lo gives the bins the JAX kernel gives
    for q (interpret mode on the CPU), as the existing parity test compares
    them."""
    x = _inputs(5, c=case[0], dup=case[1])
    g1 = _g1(x)
    tiles = tcount = None
    if compact:
        rng = np.random.default_rng(9)
        keep = np.sort(rng.choice(N_TILES, 18, replace=False)).astype(np.int32)
        tiles = np.concatenate([keep, np.full(6, keep[-1], np.int32)])[None, :]
        tcount = np.array([18], np.int32)
    j_out = jfs.fused_bin_scan(
        jnp.asarray(x["plane"]), jnp.asarray(x["q"]), jnp.asarray(x["fa_eff"]),
        jnp.asarray(x["fr"]), jnp.zeros(x["fr"].shape, jnp.float32),
        jnp.asarray(x["cluster_of"]), jnp.asarray(x["k1x"]),
        jnp.asarray(g1, jnp.bfloat16), jnp.zeros(g1.shape, jnp.bfloat16),
        jnp.asarray(x["c_blk"]),
        tiles=None if tiles is None else jnp.asarray(tiles),
        tcount=None if tcount is None else jnp.asarray(tcount),
    )
    q_back = _sum_f32(tfs.split_bf16x3(torch.from_numpy(x["q"])))
    assert torch.equal(q_back, torch.from_numpy(x["q"]))
    t_out = tfs.fused_bin_scan_plain(
        torch.from_numpy(x["plane"]), q_back, torch.from_numpy(x["fa_eff"]),
        torch.from_numpy(x["fr"]), torch.from_numpy(x["cluster_of"]),
        torch.from_numpy(x["k1x"]), torch.from_numpy(g1).to(torch.bfloat16),
        torch.from_numpy(x["c_blk"]),
        tiles=None if tiles is None else torch.from_numpy(tiles),
        tcount=None if tcount is None else torch.from_numpy(tcount),
    )
    assert _compare_bins(j_out, t_out) > 0


def test_ptxas_report_reads_registers_and_spills():
    from rabitq_tpu_torch.ops import _cuda

    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z4scanPKa' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z4scanPKa\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 233 registers, used 1 barriers, 40960 bytes smem\n"
        "ptxas info    : Compiling entry function '_Z3fhtPf' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 32 registers, used 1 barriers\n"
    )
    assert _cuda.ptxas_report(log) == [
        dict(kernel="_Z4scanPKa", registers=233, smem=40960, spill_stores=8, spill_loads=4),
        dict(kernel="_Z3fhtPf", registers=32, smem=0, spill_stores=0, spill_loads=0),
    ]
    assert _cuda.ptxas_report("") == []


def test_kernel_limits_are_checked_before_a_launch():
    """The kernels take a walk of any length (a block flushes its 16-bit
    offered counters before they can overflow) but need whole 32-query
    blocks, also per tile list."""
    assert tfs._check_cuda_batch(64, None) == 64
    with pytest.raises(ValueError):
        tfs._check_cuda_batch(48, None)
    with pytest.raises(ValueError):
        tfs._check_cuda_batch(96, torch.zeros((2, 16), dtype=torch.int32))  # 48-query lists


def test_check_cuda_batch_takes_lists_longer_than_16_bits():
    tiles = torch.zeros((2, 70000), dtype=torch.int32)
    assert tfs._check_cuda_batch(64, tiles) == 32
