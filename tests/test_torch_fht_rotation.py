"""FHT and rotators of the port against the JAX package on the CPU.

The port's plain FHT runs the same f32 butterflies as the JAX package's XLA
``fht`` and its Pallas ``fht_pallas`` (interpret mode here), so the three
agree bitwise. Rotations are compared after a round trip through the
rotator's serialized bytes, at rtol 1e-5 / atol 1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabitq_tpu.ops import rotation as jrot
from rabitq_tpu.ops.pallas_fht import fht_pallas
from rabitq_tpu_torch.ops import fht as tfht
from rabitq_tpu_torch.ops import rotation as trot
from rabitq_tpu_torch.types import RotatorType


@pytest.mark.parametrize("n", [128, 512, 1024])
def test_fht_bitwise_matches_jax(n):
    x = np.random.default_rng(n).standard_normal((33, n)).astype(np.float32)
    port = tfht.fht(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(port, np.asarray(jrot.fht(jnp.asarray(x))))
    np.testing.assert_array_equal(port, np.asarray(fht_pallas(jnp.asarray(x))))
    np.testing.assert_array_equal(tfht.fht_np(x), port)


def test_fht_sizes_and_limits():
    for n in (1, 2, 8, 8192):
        x = torch.randn((3, n), generator=torch.Generator().manual_seed(n))
        y = tfht.fht(tfht.fht(x)) / n  # self-inverse up to n
        torch.testing.assert_close(y, x, rtol=1e-4, atol=1e-4)
    assert tfht.fht_supported(8192) and tfht.fht_supported(16384)
    assert not tfht.fht_supported(96)
    with pytest.raises(ValueError):
        tfht.fht_plain(torch.zeros((2, 96)))
    with pytest.raises(ValueError):
        tfht.fht_kernel(torch.zeros((2, 128)))  # a CPU tensor never reaches the kernel


# csrc/fht.cu's geometry: rows up to 512 live in the registers of one warp
# (lane l of a row's L lanes holds elements 4Lk + 4l + i as float4s); rows up
# to 32768 in one block of W = min(n / 512, 16) warps, each warp running the
# 512 scheme on its consecutive segments, then thread c holding column c of
# the [n / 512, 512] view; longer rows take segments of 32768 and in-place
# passes for the remaining stages.
_WARP_N, _BLOCK_N = 512, 32768


def _pairs(v, axis, m):
    """One butterfly stage across index ``axis`` of v, partner index ^ m:
    the low element gets a + b, the high one a - b (a the low element's
    value), as a kernel thread computes it."""
    idx = torch.arange(v.shape[axis])
    other = v.index_select(axis, idx ^ m)
    high = ((idx & m) != 0).reshape([-1 if a == axis % v.dim() else 1 for a in range(v.dim())])
    return torch.where(high, other - v, v + other)


def _walk_warp_scheme(x, lanes, chunk_stages):
    """x [..., K * lanes * 4] in the lane order of one row's lanes: registers
    v[..., lane, k, i] = x[..., 4 * lanes * k + 4 * lane + i]; stages h = 1, 2
    in registers, then by lane (shuffles), then over the low bits of k."""
    k = x.shape[-1] // (4 * lanes)
    v = x.reshape(*x.shape[:-1], k, lanes, 4).transpose(-3, -2)  # [..., lane, k, i]
    for m in (1, 2):
        v = _pairs(v, -1, m)
    for m in (1 << s for s in range(lanes.bit_length() - 1)):
        v = _pairs(v, -3, m)
    for m in (1 << s for s in range(chunk_stages)):
        v = _pairs(v, -2, m)
    return v.transpose(-3, -2).reshape(x.shape)


def _walk_fht_kernel(x):
    """The kernel's data movement and stage order on the CPU, f32 adds and
    subtracts as on the card."""
    rows, n = x.shape
    if n == 1:
        return x.clone()
    if n == 2:
        return torch.stack([x[:, 0] + x[:, 1], x[:, 0] - x[:, 1]], dim=1)
    seg = min(n, _BLOCK_N)
    y = x.reshape(-1, seg)
    if seg <= _WARP_N:
        lanes = min(seg // 4, 32)
        y = _walk_warp_scheme(y, lanes, (seg // (4 * lanes)).bit_length() - 1)
    else:
        segs = seg // _WARP_N
        warps = min(segs, 16)
        # phase 1: each warp's span of segs / warps segments, chunks 128 apart
        span = y.reshape(-1, warps, segs // warps * _WARP_N)
        y = _walk_warp_scheme(span, 32, 2).reshape(-1, segs, _WARP_N)
        # phase 2: one column of the [segs, 512] view a thread
        for m in (1 << s for s in range(segs.bit_length() - 1)):
            y = _pairs(y, 1, m)
    y = y.reshape(rows, n)
    h = seg
    while h < n:  # in-place passes over device memory
        z = y.reshape(rows, n // (2 * h), 2, h)
        y = torch.stack([z[:, :, 0] + z[:, :, 1], z[:, :, 0] - z[:, :, 1]], dim=2).reshape(rows, n)
        h *= 2
    return y


@pytest.mark.parametrize("log_n", range(1, 17))
def test_fht_kernel_walk_is_bitwise_the_plain_fht(log_n):
    n = 1 << log_n
    x = torch.from_numpy(np.random.default_rng(log_n).standard_normal((3, n)).astype(np.float32))
    assert torch.equal(_walk_fht_kernel(x), tfht.fht_plain(x))


def _carry_rotator(jr):
    rt = trot.deserialize_rotator(
        jr.dim, jr.padded_dim, RotatorType(int(jr.rotator_type)), jr.serialize()
    )
    assert rt.serialize() == jr.serialize()
    return rt


@pytest.mark.parametrize("dim", [960, 128, 64])
def test_fhtkac_rotate_matches_jax(dim):
    jr = jrot.FhtKacRotator(dim, seed=7)
    rt = _carry_rotator(jr)
    assert (rt.padded_dim, rt.trunc_dim, rt.fac) == (jr.padded_dim, jr.trunc_dim, jr.fac)
    # the same seed draws the same flips in both packages
    assert trot.FhtKacRotator(dim, seed=7).serialize() == jr.serialize()
    x = np.random.default_rng(dim).standard_normal((17, dim)).astype(np.float32)
    y = rt.rotate(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jr.rotate(jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rt.rotate_np(x), jr.rotate_np(x), rtol=1e-5, atol=1e-5)
    back = rt.inverse_rotate(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jr.inverse_rotate(jnp.asarray(y))), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(back, x, rtol=1e-4, atol=1e-4)


def test_matrix_rotator_matches_jax():
    jr = jrot.MatrixRotator(48, seed=3)
    rt = _carry_rotator(jr)
    x = np.random.default_rng(0).standard_normal((5, 48)).astype(np.float32)
    y = rt.rotate(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jr.rotate(jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rt.inverse_rotate(torch.from_numpy(y)).numpy(), x, atol=1e-5)
    assert trot.make_rotator(48, RotatorType.MatrixRotator, 3).serialize() == jr.serialize()
