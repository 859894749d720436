"""Packed lower-bound scan and the 1-bit estimator of the port (plain
versions, on the CPU) against the JAX package: ``packed_lb_scan`` against
the Pallas kernel in interpret mode on the same seeded inputs, ``est_1bit``
and ``lower_bound`` against the JAX functions.

Tolerances: the lower-bound plane is bf16, and the f32 dot sums in another
order, so a value may land on the neighbouring bf16 number: every entry
within one bf16 ulp (``|a - b| <= 2^-7 |b| + 1e-3``), and >= 99% equal. The
estimator formulas are elementwise f32: rtol 1e-6."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabitq_tpu.ops import estimator as jest
from rabitq_tpu.ops import pallas_scan as jps
from rabitq_tpu_torch.ops import estimator as t_est_ops
from rabitq_tpu_torch.ops import packed_scan as tps


def _inputs(seed, n, d, b):
    rng = np.random.default_rng(seed)
    binary = rng.integers(0, 2, (n, d)).astype(np.int8)
    q = rng.standard_normal((b, d)).astype(np.float32)
    return dict(
        binary=binary, q=q,
        f_add=rng.standard_normal(n).astype(np.float32) * 10,
        f_rescale=rng.standard_normal(n).astype(np.float32) * 0.1,
        k1x=(-0.5 * q.sum(axis=1)).astype(np.float32),
        g_comb=(rng.standard_normal((b, n)) * 20).astype(np.float32),
    )


# n = 2 * TN of the TPU kernel, d = 256, b = 8, as tests/test_pallas_scan.py;
# b = 300 is padded by both packages (to 512 there, to 320 here); d = 960
# pads the packed bytes to 128
@pytest.mark.parametrize("n,d,b", [(256, 256, 8), (384, 256, 300), (128, 960, 40)])
def test_packed_lb_scan_matches_jax(n, d, b):
    x = _inputs(n + b, n, d, b)
    j_packed = jps.pack_bitplanes(jnp.asarray(x["binary"]), d)
    j_out = jps.packed_lb_scan(
        j_packed, jps.permute_query(jnp.asarray(x["q"]), d), jnp.asarray(x["f_add"]),
        jnp.asarray(x["f_rescale"]), jnp.asarray(x["k1x"]),
        jnp.asarray(x["g_comb"]).astype(jnp.bfloat16),
    )
    t_packed = tps.pack_bitplanes(torch.from_numpy(x["binary"]), d)
    np.testing.assert_array_equal(t_packed.numpy(), np.asarray(j_packed))
    t_out = tps.packed_lb_scan(
        t_packed, tps.permute_query(torch.from_numpy(x["q"]), d), torch.from_numpy(x["f_add"]),
        torch.from_numpy(x["f_rescale"]), torch.from_numpy(x["k1x"]),
        torch.from_numpy(x["g_comb"]).to(torch.bfloat16),
    )
    assert t_out.shape == (b, n) and t_out.dtype == torch.bfloat16
    want = np.asarray(j_out).astype(np.float32)
    got = t_out.float().numpy()
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-3)
    assert np.mean(got == want) >= 0.99


def test_packed_lb_scan_row_chunks_and_checks():
    x = _inputs(3, 384, 128, 8)
    packed = tps.pack_bitplanes(torch.from_numpy(x["binary"]), 128)
    args = (
        packed, tps.permute_query(torch.from_numpy(x["q"]), 128), torch.from_numpy(x["f_add"]),
        torch.from_numpy(x["f_rescale"]), torch.from_numpy(x["k1x"]),
        torch.from_numpy(x["g_comb"]).to(torch.bfloat16),
    )
    whole = tps.packed_lb_scan_plain(*args)
    assert torch.equal(tps.packed_lb_scan_plain(*args, row_chunk=128), whole)
    # the unpacked bits are the binary plane in bit-plane order
    bits = tps.unpack_bitplanes(packed).reshape(384, 8, 128).transpose(1, 2).reshape(384, 1024)
    np.testing.assert_array_equal(bits[:, :128].numpy(), x["binary"])
    with pytest.raises(ValueError):
        tps.packed_lb_scan(args[0][:100], *args[1:])  # rows not a multiple of 128
    with pytest.raises(ValueError):
        tps.packed_lb_scan(args[0], args[1][:, :512], *args[2:])  # q not 8 * Db wide
    with pytest.raises(ValueError):
        tps.packed_lb_scan_cuda(*args)  # a CPU tensor never reaches the kernel


def test_est_1bit_and_lower_bound_match_jax():
    rng = np.random.default_rng(5)
    shape = (6, 200)
    f_add, g_add, f_rescale, bdot, g_err = (
        rng.standard_normal(shape).astype(np.float32) * s for s in (10, 30, 0.2, 50, 4)
    )
    f_err = np.abs(rng.standard_normal(shape)).astype(np.float32)
    k1x = rng.standard_normal((6, 1)).astype(np.float32)
    j_est = jest.est_1bit(*(jnp.asarray(a) for a in (f_add, g_add, f_rescale, bdot, k1x)))
    t_est = t_est_ops.est_1bit(*(torch.from_numpy(a) for a in (f_add, g_add, f_rescale, bdot, k1x)))
    np.testing.assert_allclose(t_est.numpy(), np.asarray(j_est), rtol=1e-6, atol=1e-6)
    j_lb = jest.lower_bound(j_est, jnp.asarray(f_err), jnp.asarray(g_err))
    t_lb = t_est_ops.lower_bound(t_est, torch.from_numpy(f_err), torch.from_numpy(g_err))
    np.testing.assert_allclose(t_lb.numpy(), np.asarray(j_lb), rtol=1e-6, atol=1e-5)


def _plane_inputs(seed, n, d, b, c=12):
    """Inputs of the "packed" scan's stage 1 in the permuted layout: rows of
    random clusters, some rows filtered out, some clusters not probed, and
    non-finite g terms (an inf g_add, a NaN g_error) in probed clusters."""
    x = _inputs(seed, n, d, b)
    rng = np.random.default_rng(seed + 1)
    x["cluster_of"] = rng.integers(0, c, n).astype(np.int32)
    x["row_allowed"] = rng.random(n) > 0.1
    x["probe_mask"] = rng.random((b, c)) < 0.4
    x["g_add"] = (rng.standard_normal((b, c)) * 30).astype(np.float32)
    x["g_error"] = (np.abs(rng.standard_normal((b, c))) * 4).astype(np.float32)
    x["f_error"] = (np.abs(rng.standard_normal(n)) * 0.5).astype(np.float32)
    x["g_add"][3, 5] = np.inf
    x["g_error"][b - 1, 2] = np.nan
    x["probe_mask"][3, 5] = x["probe_mask"][b - 1, 2] = True
    return x


def _plane_args(x, d):
    t = torch.from_numpy
    return (
        tps.pack_bitplanes(t(x["binary"]), d), tps.permute_query(t(x["q"]), d), t(x["f_add"]),
        t(x["f_rescale"]), t(x["k1x"]), t(x["g_add"]), t(x["g_error"]), t(x["f_error"]),
        t(x["cluster_of"]), t(x["probe_mask"]), t(x["row_allowed"]),
    )


# batches of 40 and 8 are no multiple of the kernel's 32-query block
@pytest.mark.parametrize("n,d,b", [(384, 256, 40), (256, 960, 8)])
def test_packed_lb_plane_matches_jax_caller(n, d, b):
    """The port's stage-1 plane against the JAX package's packed_lb_scan
    (interpret mode) and its caller's glue (rabitq_tpu/index/scan.py, the
    "packed" branch): the port returns -masked_lb. +-inf entries exactly
    equal, finite ones within one bf16 ulp and >= 99% equal."""
    x = _plane_inputs(n + b, n, d, b)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    g_add_rows = jnp.take(j["g_add"].astype(jnp.bfloat16), j["cluster_of"], axis=1)
    g_err_rows = jnp.take(j["g_error"].astype(jnp.bfloat16), j["cluster_of"], axis=1)
    allowed = jnp.take(j["probe_mask"], j["cluster_of"], axis=1) & j["row_allowed"][None, :]
    g_comb = (g_add_rows - j["f_error"][None, :] * g_err_rows).astype(jnp.bfloat16)
    lb16 = jps.packed_lb_scan(
        jps.pack_bitplanes(j["binary"], d), jps.permute_query(j["q"], d), j["f_add"],
        j["f_rescale"], j["k1x"], g_comb,
    )
    lb_f = lb16.astype(jnp.float32)
    lb_f = jnp.where(jnp.isfinite(lb_f), lb_f, -jnp.inf)
    want = -np.asarray(jnp.where(allowed, lb_f, jnp.inf))
    got_bf16 = tps.packed_lb_plane(*_plane_args(x, d))
    assert got_bf16.shape == (b, n) and got_bf16.dtype == torch.bfloat16
    got = got_bf16.float().numpy()
    inf = np.isinf(want)
    assert np.array_equal(np.isinf(got), inf) and np.array_equal(got[inf], want[inf])
    assert (want == np.inf).any() and (want == -np.inf).any() and (~inf).any()
    fin = ~inf
    assert np.all(np.abs(got[fin] - want[fin]) <= 2.0 ** -7 * np.abs(want[fin]) + 1e-3)
    assert np.mean(got[fin] == want[fin]) >= 0.99


def test_packed_lb_plane_plain_is_the_chain_of_ops():
    """packed_lb_plane_plain is bitwise the chain of eager ops the port's
    "packed" branch ran around packed_lb_scan, in any row chunking."""
    n, d, b = 384, 128, 40
    x = _plane_inputs(9, n, d, b)
    args = _plane_args(x, d)
    packed, q_perm, f_add, f_rescale, k1x, g_add, g_error, f_error, cl, probe, row_ok = args
    g_add_rows = g_add.to(torch.bfloat16).index_select(1, cl)
    g_err_rows = g_error.to(torch.bfloat16).index_select(1, cl)
    allowed = probe.index_select(1, cl) & row_ok[None, :]
    g_comb = (g_add_rows - f_error[None, :] * g_err_rows).to(torch.bfloat16)
    lb = tps.packed_lb_scan(packed, q_perm, f_add, f_rescale, k1x, g_comb).to(torch.float32)
    lb = torch.where(torch.isfinite(lb), lb, -float("inf"))
    chain = torch.where(allowed, -lb, -float("inf"))
    for row_chunk in (1 << 16, 128):
        plain = tps.packed_lb_plane_plain(*args, row_chunk=row_chunk)
        assert plain.dtype == torch.bfloat16
        assert torch.equal(plain.float(), chain)  # -lb of a bf16 lb is exact in bf16
    assert torch.equal(tps.packed_lb_plane(*args), tps.packed_lb_plane_plain(*args))


def test_packed_lb_plane_kernel_tables():
    """The G_TABLE kernel's operand layouts, built by the wrapper: one word
    per (query, cluster) with bf16 g_add low and bf16 g_error high, and one
    probe word per (32-query block, cluster) with bit i for query 32k + i."""
    rng = np.random.default_rng(2)
    g_add = torch.from_numpy((rng.standard_normal((64, 7)) * 50).astype(np.float32))
    g_err = torch.from_numpy(rng.random((64, 7)).astype(np.float32))
    words = tps.g_table(g_add, g_err)
    assert words.shape == (64, 7) and words.dtype == torch.int32
    w = words.numpy().view(np.uint32)
    lo = torch.from_numpy((w & 0xFFFF).astype(np.int16)).view(torch.bfloat16)
    hi = torch.from_numpy((w >> 16).astype(np.uint16).view(np.int16)).view(torch.bfloat16)
    assert torch.equal(lo, g_add.to(torch.bfloat16))
    assert torch.equal(hi, g_err.to(torch.bfloat16))
    probe = torch.from_numpy(rng.random((64, 7)) < 0.5)
    probe[31, 0] = True  # the sign bit of a word
    bits = tps.probe_words(probe)
    assert bits.shape == (2, 7) and bits.dtype == torch.int32
    u = bits.numpy().view(np.uint32).astype(np.int64)
    back = (u[:, None, :] >> np.arange(32)[None, :, None]) & 1
    assert np.array_equal(back.reshape(64, 7).astype(bool), probe.numpy())


def test_packed_lb_plane_kernel_tables_one_cluster():
    """The same tables at C = 1, the brute-force index's one cluster, and
    for a single block of 32 queries: size-1 dimensions must not break the
    words' byte view."""
    probe = torch.zeros((96, 1), dtype=torch.bool)
    probe[[0, 31, 40, 95]] = True
    bits = tps.probe_words(probe)
    assert bits.shape == (3, 1) and bits.dtype == torch.int32
    assert bits.numpy().view(np.uint32)[:, 0].tolist() == [1 | 1 << 31, 1 << 8, 1 << 31]
    words = tps.g_table(torch.full((96, 1), 2.0), torch.full((96, 1), -1.0))
    assert words.shape == (96, 1)
    assert set(words.numpy().view(np.uint32)[:, 0].tolist()) == {0xBF80_4000}
    assert torch.equal(tps.probe_words(probe.expand(96, 3)), bits.expand(3, 3))
    # one block of 32 queries, with one cluster and with many
    for c in (1, 300):
        one = torch.zeros((32, c), dtype=torch.bool)
        one[5, c - 1] = True
        got = tps.probe_words(one)
        assert got.shape == (1, c) and got[0, c - 1] == 1 << 5 and int(got.sum()) == 1 << 5
