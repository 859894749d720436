"""The JAX package's random draws, bit for bit, on the host.

The JAX package draws its k-means++ seeds from ``jax.random`` keys
(``rabitq_tpu/ops/kmeans.py:_kmeanspp_init``): ``PRNGKey(seed)``,
``fold_in(key, i)``, ``randint(key, (), lo, hi)`` and ``uniform(key)``. This
module is the port's copy of those four functions for the default
``threefry2x32`` implementation with ``jax_threefry_partitionable`` on and
64-bit types off (JAX's defaults), written in numpy ``uint32`` arithmetic,
which wraps mod 2**32 as JAX's does. A key is a ``uint32[2]`` array, as a
legacy JAX key is. The draws are the same on every device because they are
made here, on the host, and uploaded where a caller needs them.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = np.uint32(0x1BD11BDA)


def threefry2x32(k1, k2, x1, x2) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block (20 rounds) of the key words ``(k1, k2)``
    over the count words ``(x1, x2)``, elementwise (arrays broadcast)."""
    with np.errstate(over="ignore"):
        k1 = np.atleast_1d(np.asarray(k1, np.uint32))
        k2 = np.atleast_1d(np.asarray(k2, np.uint32))
        ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
        a = np.atleast_1d(np.asarray(x1, np.uint32)) + ks[0]
        b = np.atleast_1d(np.asarray(x2, np.uint32)) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                a = a + b
                b = (b << np.uint32(r)) | (b >> np.uint32(32 - r))
                b = a ^ b
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802  (jax.random's name)
    """``jax.random.PRNGKey(seed)``: ``[0, seed mod 2**32]``. The seed is
    taken as an int64 (a larger one raises, as in JAX) and then cut to 32
    bits, as JAX does with 64-bit types off."""
    return np.array([0, int(np.int64(seed)) & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the block of ``key`` over the
    count ``(0, data)``."""
    a, b = threefry2x32(key[0], key[1], 0, np.uint32(data))
    return np.array([a[0], b[0]], np.uint32)


def _bits32(keys: np.ndarray) -> np.ndarray:
    """32 random bits of each key of ``keys`` [..., 2] (a draw of shape
    ``()``: the block over the count ``(0, 0)``, its words xor-ed)."""
    a, b = threefry2x32(keys[..., 0], keys[..., 1], 0, 0)
    return a ^ b


def _to_unit(bits: np.ndarray) -> np.ndarray:
    """f32 in ``[0, 1)`` from 32 random bits: the top 23 bits as the
    mantissa of a number in ``[1, 2)``, minus 1 (``jax.random.uniform``)."""
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    return np.maximum(f, np.float32(0.0))


def uniform(key: np.ndarray) -> np.float32:
    """``jax.random.uniform(key)``: one f32 in ``[0, 1)``."""
    return _to_unit(_bits32(np.asarray(key, np.uint32)))[0]


def fold_in_uniforms(key: np.ndarray, n: int) -> np.ndarray:
    """``[uniform(fold_in(key, i)) for i in range(n)]`` as one f32 array
    [n]: every draw of a k-means++ init at once."""
    a, b = threefry2x32(key[0], key[1], 0, np.arange(n, dtype=np.uint32))
    return _to_unit(_bits32(np.stack([a, b], axis=-1)))


def randint(key: np.ndarray, minval: int, maxval: int) -> int:
    """``jax.random.randint(key, (), minval, maxval)`` (int32): the key
    split in two, 32 bits from each, their value mod the span (JAX's
    two-word remainder, in wrapping ``uint32``)."""
    i32 = np.iinfo(np.int32)
    if not (i32.min <= minval <= i32.max and i32.min <= maxval <= i32.max):
        raise OverflowError(f"randint bounds ({minval}, {maxval}) exceed int32, as in JAX")
    lo, hi = int(minval), int(maxval)
    a, b = threefry2x32(key[0], key[1], 0, np.arange(2, dtype=np.uint32))
    higher, lower = _bits32(np.stack([a, b], axis=-1))
    with np.errstate(over="ignore"):
        span = np.uint32(1 if hi <= lo else (hi - lo) & 0xFFFFFFFF)  # hi <= lo: lo
        mult = np.uint32(1 << 16) % span
        mult = np.atleast_1d(mult * mult)[0] % span  # wraps, as lax.mul does
        offset = np.atleast_1d((higher % span) * mult + lower % span)[0] % span
    return lo + int(offset)
