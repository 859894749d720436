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
