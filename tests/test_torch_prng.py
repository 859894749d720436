"""The port's copy of the JAX package's random draws (``ops/prng.py``)
against ``jax.random`` on the CPU: keys, folded keys, uniforms and scalar
``randint`` bit for bit (no tolerance), for the seeds the packages make
(``seed * 1_000_003 + redo``; ``(seed + r) * 1_000_003`` for MSTG split r),
seeds at and past 2**32 after the multiply, and spans of 1, a power of two
and odd sizes."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rabitq_tpu_torch.ops import prng

FOLDS = 96  # fold_in indices a seed: 12 seeds x 96 = 1152 (seed, i) pairs
SPANS = [(0, 1), (0, 2), (0, 1024), (0, 65536), (0, 4097), (0, 1_000_000), (0, 999_999),
         (3, 17), (5, 5), (9, 2), (-10, 10), (0, 2**31 - 1), (-2**31, 2**31 - 1)]
SEEDS = [
    0, 1, 42 * 1_000_003, 42 * 1_000_003 + 1, (42 + 7) * 1_000_003,  # run_kmeans, MSTG split 7
    5000 * 1_000_003,  # past 2**32 after the multiply: cut to 32 bits
    2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 7, 2**62 + 12345,
]


@jax.jit
def _jax_draws(key, i):
    folded = jax.vmap(lambda j: jax.random.fold_in(key, j))(i)
    return folded, jax.vmap(jax.random.uniform)(folded)


@pytest.mark.parametrize("seed", SEEDS)
def test_draws_match_jax_random(seed):
    jkey = jax.random.PRNGKey(seed)
    key = prng.PRNGKey(seed)
    assert key.dtype == np.uint32 and key.shape == (2,)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    idx = np.concatenate([np.arange(FOLDS - 4), [2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]])
    j_folded, j_u = (np.asarray(a) for a in _jax_draws(jkey, jnp.asarray(idx, jnp.uint32)))
    for i, want in zip(idx, j_folded):
        np.testing.assert_array_equal(prng.fold_in(key, int(i)), want)
    got_u = np.array([prng.uniform(prng.fold_in(key, int(i))) for i in idx], np.float32)
    np.testing.assert_array_equal(got_u.view(np.uint32), j_u.view(np.uint32))
    # the vector form the k-means++ init uploads: entry i = uniform(fold_in(key, i))
    vec = prng.fold_in_uniforms(key, FOLDS - 4)
    assert vec.dtype == np.float32 and vec.shape == (FOLDS - 4,)
    np.testing.assert_array_equal(vec.view(np.uint32), j_u[: FOLDS - 4].view(np.uint32))
    assert np.all((vec >= 0) & (vec < 1))
    assert prng.uniform(key).view(np.uint32) == np.asarray(jax.random.uniform(jkey)).view(np.uint32)
    for lo, hi in SPANS:
        assert prng.randint(key, lo, hi) == int(jax.random.randint(jkey, (), lo, hi)), (lo, hi)


def test_randint_over_many_keys_matches_jax():
    """1024 folded keys, each drawn at n_valid 1, 4096 and 4097 (the
    k-means++ first pick's span)."""
    base = jax.random.PRNGKey(7 * 1_000_003)
    keys = jax.vmap(lambda j: jax.random.fold_in(base, j))(jnp.arange(1024, dtype=jnp.uint32))
    for n_valid in (1, 4096, 4097):
        want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, n_valid))(keys))
        got = [prng.randint(k, 0, n_valid) for k in np.asarray(keys)]
        np.testing.assert_array_equal(got, want)
        assert n_valid > 1 or not any(got)
    assert len(set(got)) > 900  # the draws spread


def test_threefry_block_known_answer():
    """The Threefry-2x32 (20 rounds) known-answer vectors of the Random123
    suite, which JAX's own tests use."""
    cases = [
        ((0x0, 0x0), (0x0, 0x0), (0x6B200159, 0x99BA4EFE)),
        ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
        ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
    ]
    for (k1, k2), (x1, x2), want in cases:
        a, b = prng.threefry2x32(k1, k2, x1, x2)
        assert (int(a[0]), int(b[0])) == want


def test_randint_refuses_bounds_past_int32_like_jax():
    key = prng.PRNGKey(3)
    with pytest.raises(OverflowError):
        prng.randint(key, 0, 2**31)
    with pytest.raises(OverflowError):
        jax.random.randint(jax.random.PRNGKey(3), (), 0, 2**31)
    with pytest.raises(OverflowError):
        prng.PRNGKey(2**63)
