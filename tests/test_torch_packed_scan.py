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
