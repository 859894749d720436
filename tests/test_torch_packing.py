"""The port's code packings against the JAX package's, byte for byte.

Every codec of ``rabitq_tpu_torch.ops.packing`` gets the same seeded numpy
codes as ``rabitq_tpu.ops.packing`` (which may run its native library; its
output is byte-identical to its numpy paths) and must give equal bytes;
each unpacking must invert its packing exactly. No tolerance: these are
integer codecs.
"""

from __future__ import annotations

import numpy as np
import pytest

from rabitq_tpu.ops import packing as jp
from rabitq_tpu_torch.ops import packing as tp


def _codes(rows, dim, bits, seed=0):
    return np.random.default_rng(seed).integers(0, 1 << bits, (rows, dim)).astype(np.uint16)


@pytest.mark.parametrize("dim", [64, 100, 960])
def test_binary_codes(dim):
    bits = _codes(37, dim, 1).astype(np.uint8)
    packed = tp.pack_binary(bits)
    np.testing.assert_array_equal(packed, jp.pack_binary(bits))
    np.testing.assert_array_equal(tp.unpack_binary(packed, dim), bits)


@pytest.mark.parametrize("ex_bits", range(1, 9))
@pytest.mark.parametrize("dim", [64, 100])
def test_ex_codes(ex_bits, dim):
    """The dispatching codec (the C++-compatible packings for ex_bits 2 and
    6 at a dim that is a multiple of 16, the generic stream otherwise) and
    the generic stream itself, at every ex_bits 1..8."""
    ex = _codes(41, dim, ex_bits, seed=ex_bits)
    for pack, jpack, unpack in (
        (tp.pack_ex, jp.pack_ex, tp.unpack_ex),
        (tp.pack_ex_generic, jp.pack_ex_generic, tp.unpack_ex_generic),
    ):
        packed = pack(ex, ex_bits)
        assert packed.shape[-1] == (dim * ex_bits + 7) // 8
        np.testing.assert_array_equal(packed, jpack(ex, ex_bits))
        np.testing.assert_array_equal(unpack(packed, dim, ex_bits), ex)
    np.testing.assert_array_equal(
        tp.unpack_ex(jp.pack_ex(ex, ex_bits), dim, ex_bits), jp.unpack_ex(jp.pack_ex(ex, ex_bits), dim, ex_bits)
    )


@pytest.mark.parametrize("ex_bits", [1, 2, 6])
def test_cpp_packings(ex_bits):
    """The C++-compatible layouts: 2 and 6 bits interleave 16 codes per
    group; the 1-bit one is the generic stream."""
    dim = 128
    ex = _codes(19, dim, ex_bits, seed=10 + ex_bits)
    if ex_bits == 1:
        got = tp.pack_ex(ex, 1)
        np.testing.assert_array_equal(got, jp.pack_ex_generic(ex, 1))
        return
    pack = {2: tp.pack_ex_2bit_cpp, 6: tp.pack_ex_6bit_cpp}[ex_bits]
    unpack = {2: tp.unpack_ex_2bit_cpp, 6: tp.unpack_ex_6bit_cpp}[ex_bits]
    jpack = {2: jp.pack_ex_2bit_cpp, 6: jp.pack_ex_6bit_cpp}[ex_bits]
    packed = pack(ex)
    assert packed.shape[-1] == dim * ex_bits // 8
    np.testing.assert_array_equal(packed, jpack(ex))
    np.testing.assert_array_equal(tp.pack_ex(ex, ex_bits), packed)
    np.testing.assert_array_equal(unpack(packed, dim), ex)


def test_zero_ex_bits():
    ex = _codes(5, 64, 1)
    assert tp.pack_ex(ex, 0).shape == (5, 0)
    np.testing.assert_array_equal(tp.unpack_ex(tp.pack_ex(ex, 0), 64, 0), np.zeros((5, 64)))


@pytest.mark.parametrize("ex_bits", [0, 6, 7])
def test_row_chunked_codecs(ex_bits):
    """``pack_ex_rows`` / ``unpack_ex_rows`` equal the whole-array codecs
    at a chunk that does not divide the rows, and on no rows."""
    ex = _codes(70, 96, max(ex_bits, 1), seed=3)
    packed = tp.pack_ex_rows(ex, ex_bits, chunk=16)
    np.testing.assert_array_equal(packed, tp.pack_ex(ex, ex_bits))
    np.testing.assert_array_equal(
        tp.unpack_ex_rows(packed, 96, ex_bits, chunk=16), tp.unpack_ex(packed, 96, ex_bits)
    )
    assert tp.pack_ex_rows(ex[:0], ex_bits).shape == (0, 96 * ex_bits // 8)


@pytest.mark.parametrize("dim_bytes", [8, 120])
def test_fastscan_batches(dim_bytes):
    rows = np.random.default_rng(dim_bytes).integers(0, 256, (3, 32, dim_bytes)).astype(np.uint8)
    packed = tp.pack_codes(rows)
    assert packed.shape == (3, dim_bytes * 32)
    np.testing.assert_array_equal(packed, jp.pack_codes(rows))
    np.testing.assert_array_equal(tp.unpack_codes(packed, dim_bytes), rows)
    np.testing.assert_array_equal(tp.KPERM0, jp.KPERM0)
