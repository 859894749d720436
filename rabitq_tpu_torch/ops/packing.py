"""Bit-packing codecs of the persisted code formats (a copy of
``rabitq_tpu/ops/packing.py``).

Host-side only (index save and load): the device keeps codes as dense int8
planes. Formats, byte-compatible with lqhl/rabitq-rs:

* binary codes: 1 bit/dim, MSB-first within each byte (``simd.rs:141-163``)
* generic ex-codes: LSB-first bitstream, ``ex_bits`` bits/dim
  (``simd.rs:166-223``)
* C++-compatible interleaved ex-code packings for ex_bits 1/2/6
  (``simd.rs:2406-2695``; the 1-bit one is the generic stream)
* FastScan 32-vector batch transpose with the KPERM0 permutation
  (``pack_codes``/``unpack_single_vector``, ``simd.rs:864-960``)

Each codec has an exact inverse. Where the native codec library is built
(``native.py``), the binary, ex-code and FastScan codecs run through it, as
in the JAX package; the bytes are the same either way.
"""

from __future__ import annotations

import numpy as np

from .. import native as _native

FASTSCAN_BATCH_SIZE = 32  # simd.rs:768
KPERM0 = np.array([0, 8, 1, 9, 2, 10, 3, 11, 4, 12, 5, 13, 6, 14, 7, 15])  # simd.rs:774


# ---------------------------------------------------------------------------
# binary codes (MSB-first)
# ---------------------------------------------------------------------------

def pack_binary(bits: np.ndarray) -> np.ndarray:
    """[..., D] {0,1} -> [..., ceil(D/8)] bytes, MSB-first (simd.rs:141-150)."""
    if _native.available():
        return _native.pack_binary(bits)
    return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="big")


def unpack_binary(packed: np.ndarray, dim: int) -> np.ndarray:
    """[..., nbytes] -> [..., dim] {0,1} (simd.rs:153-163)."""
    if _native.available():
        return _native.unpack_binary(packed, dim)
    return np.unpackbits(packed, axis=-1, bitorder="big")[..., :dim]


# ---------------------------------------------------------------------------
# generic ex-codes (LSB-first bitstream)
# ---------------------------------------------------------------------------

def pack_ex_generic(ex: np.ndarray, ex_bits: int) -> np.ndarray:
    """[..., D] codes -> [..., ceil(D*ex_bits/8)] LSB-first bitstream
    (simd.rs:166-191)."""
    assert 0 < ex_bits <= 16
    ex = ex.astype(np.uint32)
    shifts = np.arange(ex_bits, dtype=np.uint32)
    bits = (ex[..., None] >> shifts) & 1  # [..., D, ex_bits] LSB-first per code
    flat = bits.reshape(*ex.shape[:-1], ex.shape[-1] * ex_bits).astype(np.uint8)
    return np.packbits(flat, axis=-1, bitorder="little")


def unpack_ex_generic(packed: np.ndarray, dim: int, ex_bits: int) -> np.ndarray:
    """Inverse of :func:`pack_ex_generic` (simd.rs:194-223)."""
    assert 0 < ex_bits <= 16
    nbits = dim * ex_bits
    bits = np.unpackbits(packed, axis=-1, bitorder="little")[..., :nbits]
    bits = bits.reshape(*packed.shape[:-1], dim, ex_bits).astype(np.uint32)
    weights = 1 << np.arange(ex_bits, dtype=np.uint32)
    return np.sum(bits * weights, axis=-1).astype(np.uint16)


# ---------------------------------------------------------------------------
# C++-compatible interleaved ex-code packings (simd.rs:2406-2695)
#
# Both work on a group of 16 codes at a time, as little-endian words whose
# byte lanes are codes: four u32 words (codes 4i..4i+3) or two u64 words
# (codes 0..7, 8..15). Every shift below stays inside its byte lane, so one
# word operation does the work of four or eight byte operations.
# ---------------------------------------------------------------------------

_NIBBLES = np.uint64(0x0F0F0F0F0F0F0F0F)
_CRUMBS = np.uint32(0x03030303)


def _groups(x: np.ndarray, width: int) -> np.ndarray:
    """[..., D] uint8 -> contiguous [G, width] groups of one row's bytes."""
    return np.ascontiguousarray(x, np.uint8).reshape(-1, width)


def pack_ex_2bit_cpp(ex: np.ndarray) -> np.ndarray:
    """16 2-bit codes -> 4 bytes; byte j holds codes j, 4+j, 8+j, 12+j at
    bits 0, 2, 4, 6 (simd.rs:2478-2541)."""
    d = ex.shape[-1]
    assert d % 16 == 0
    quads = _groups(ex.astype(np.uint8) & 0x3, 16).view("<u4")  # [G, 4]: codes 4i..4i+3
    out = quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4) | (quads[:, 3] << 6)
    return out.astype("<u4").view(np.uint8).reshape(*ex.shape[:-1], d // 16 * 4)


def unpack_ex_2bit_cpp(packed: np.ndarray, dim: int) -> np.ndarray:
    """Inverse of :func:`pack_ex_2bit_cpp` (simd.rs:2551-2583)."""
    assert dim % 16 == 0
    word = _groups(packed, 4).view("<u4")[:, 0]
    out = np.empty((word.shape[0], 4), "<u4")
    for i in range(4):
        out[:, i] = (word >> np.uint32(2 * i)) & _CRUMBS
    return out.view(np.uint8).reshape(*packed.shape[:-1], dim).astype(np.uint16)


def pack_ex_6bit_cpp(ex: np.ndarray) -> np.ndarray:
    """16 6-bit codes -> 12 bytes: 8 bytes of low nibbles (byte j: code j,
    and code 8+j above it) + 4 bytes of the upper-2-bit plane laid out as
    the 2-bit packing (simd.rs:2601-2695)."""
    d = ex.shape[-1]
    assert d % 16 == 0
    c = _groups(ex.astype(np.uint8) & 0x3F, 16)
    halves = c.view("<u8")  # [G, 2]: codes 0..7, 8..15
    quads = (c.view("<u4") >> np.uint32(4)) & _CRUMBS  # [G, 4]: upper bits of codes 4i..4i+3
    out = np.empty((c.shape[0], 3), "<u4")
    out[:, :2] = ((halves[:, 0] & _NIBBLES) | ((halves[:, 1] & _NIBBLES) << np.uint64(4))).view(
        "<u4").reshape(-1, 2)
    out[:, 2] = quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4) | (quads[:, 3] << 6)
    return out.view(np.uint8).reshape(*ex.shape[:-1], d // 16 * 12)


def unpack_ex_6bit_cpp(packed: np.ndarray, dim: int) -> np.ndarray:
    """Inverse of :func:`pack_ex_6bit_cpp` (simd.rs:2705-2766)."""
    assert dim % 16 == 0
    g = _groups(packed, 12)
    lo = np.ascontiguousarray(g[:, :8]).view("<u8")[:, 0]
    hi = np.ascontiguousarray(g[:, 8:]).view("<u4")[:, 0]
    out = np.empty((g.shape[0], 2), "<u8")
    out[:, 0] = lo & _NIBBLES
    out[:, 1] = (lo >> np.uint64(4)) & _NIBBLES
    quads = out.view("<u4")  # [G, 4]: codes 4i..4i+3
    for i in range(4):
        quads[:, i] |= ((hi >> np.uint32(2 * i)) & _CRUMBS) << np.uint32(4)
    return out.view(np.uint8).reshape(*packed.shape[:-1], dim).astype(np.uint16)


def pack_ex(ex: np.ndarray, ex_bits: int) -> np.ndarray:
    """Dispatch matching ``quantize_with_centroid`` packing
    (``quantizer.rs:212-243``): C++-compatible formats for ex_bits 2/6 when
    dim is a multiple of 16 (the 1-bit one is bit-identical to the generic
    stream), the generic LSB-first bitstream otherwise. ex_bits == 0 packs
    to nothing (``ivf.rs:688``)."""
    dim = ex.shape[-1]
    if ex_bits == 0:
        return np.zeros((*ex.shape[:-1], 0), np.uint8)
    native = _native.available()
    if dim % 16 == 0 and ex_bits in (2, 6):
        if native:
            return _native.pack_ex_cpp(ex, ex_bits)
        return pack_ex_2bit_cpp(ex) if ex_bits == 2 else pack_ex_6bit_cpp(ex)
    if native:
        return _native.pack_ex_generic(ex, ex_bits)
    return pack_ex_generic(ex, ex_bits)


def unpack_ex(packed: np.ndarray, dim: int, ex_bits: int) -> np.ndarray:
    """Dispatch matching ``simd::unpack_ex_code`` (``simd.rs:101-134``)."""
    if ex_bits == 0:
        return np.zeros((*packed.shape[:-1], dim), np.uint16)
    native = _native.available()
    if dim % 16 == 0 and ex_bits in (2, 6):
        if native:
            return _native.unpack_ex_cpp(packed, dim, ex_bits)
        if ex_bits == 2:
            return unpack_ex_2bit_cpp(packed, dim)
        return unpack_ex_6bit_cpp(packed, dim)
    if native:
        return _native.unpack_ex_generic(packed, dim, ex_bits)
    return unpack_ex_generic(packed, dim, ex_bits)


def _by_rows(codec, x: np.ndarray, width: int, dtype, chunk: int) -> np.ndarray:
    """``codec`` over the rows of ``x`` ``chunk`` rows at a time, into one
    ``[N, width]`` array, so the codecs' intermediates stay small at
    millions of rows."""
    out = np.empty((x.shape[0], width), dtype)
    for s in range(0, x.shape[0], chunk):
        out[s : s + chunk] = codec(x[s : s + chunk])
    return out


def pack_ex_rows(ex: np.ndarray, ex_bits: int, chunk: int = 1 << 15) -> np.ndarray:
    """:func:`pack_ex` over ``[N, D]`` codes, ``chunk`` rows at a time."""
    width = pack_ex(ex[:1], ex_bits).shape[-1]
    return _by_rows(lambda x: pack_ex(x, ex_bits), ex, width, np.uint8, chunk)


def unpack_ex_rows(packed: np.ndarray, dim: int, ex_bits: int, chunk: int = 1 << 15) -> np.ndarray:
    """:func:`unpack_ex` over ``[N, nbytes]``, ``chunk`` rows at a time."""
    return _by_rows(lambda x: unpack_ex(x, dim, ex_bits), packed, dim, np.uint16, chunk)


# ---------------------------------------------------------------------------
# FastScan 32-vector batch transpose (simd.rs:864-960)
# ---------------------------------------------------------------------------

def pack_codes(packed_rows: np.ndarray) -> np.ndarray:
    """FastScan transpose of binary code bytes: ``packed_rows`` [num_batches,
    32, dim_bytes] MSB-first packed binary codes (zero-padded to full
    batches) -> [num_batches, dim_bytes * 32] bytes in the reference batch
    layout (``pack_codes``, simd.rs:864-904)."""
    nb, bs, dim_bytes = packed_rows.shape
    assert bs == FASTSCAN_BATCH_SIZE
    if _native.available():
        return _native.pack_codes(packed_rows)
    col = np.transpose(packed_rows, (0, 2, 1))  # [nb, dim_bytes, 32]
    col0 = col >> 4
    col1 = col & 15
    lo = KPERM0
    hi = KPERM0 + 16
    val0 = col0[..., lo] | (col0[..., hi] << 4)  # [nb, dim_bytes, 16]
    val1 = col1[..., lo] | (col1[..., hi] << 4)
    out = np.concatenate([val0, val1], axis=-1)  # [nb, dim_bytes, 32]
    return out.reshape(nb, dim_bytes * 32)


def unpack_codes(batch_packed: np.ndarray, dim_bytes: int) -> np.ndarray:
    """Inverse of :func:`pack_codes`: [num_batches, 32, dim_bytes] MSB-first
    packed rows (``unpack_single_vector``, simd.rs:915-960, for all 32 lanes
    at once)."""
    nb = batch_packed.shape[0]
    if _native.available():
        return _native.unpack_codes(batch_packed, dim_bytes)
    data = batch_packed.reshape(nb, dim_bytes, 32)
    val0 = data[..., :16]  # [nb, dim_bytes, 16]
    val1 = data[..., 16:]
    col0 = np.zeros((nb, dim_bytes, 32), np.uint8)
    col1 = np.zeros((nb, dim_bytes, 32), np.uint8)
    col0[..., KPERM0] = val0 & 15
    col0[..., KPERM0 + 16] = val0 >> 4
    col1[..., KPERM0] = val1 & 15
    col1[..., KPERM0 + 16] = val1 >> 4
    col = (col0 << 4) | col1  # [nb, dim_bytes, 32]
    return np.transpose(col, (0, 2, 1)).copy()  # [nb, 32, dim_bytes]
