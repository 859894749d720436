"""RBF1 v1 brute-force index files, byte-compatible with the reference (a
port of ``rabitq_tpu/io/persistence_bf.py``; lqhl/rabitq-rs
``brute_force.rs:298-523``).

Layout, little-endian:

    b"RBF1", u32 version = 1                  (not hashed)
    u32 dim, u32 padded_dim
    u8 metric, u8 rotator, u8 ex_bits, u8 total_bits
    u64 vector_count
    u64 rotator_len, rotator bytes
    per vector:
      binary_code_packed  ceil(padded_dim/8) bytes (MSB-first)
      ex_code_packed      ceil(padded_dim*ex_bits/8) bytes (cpp-compat)
      f32 x 8: delta, vl, f_add, f_rescale, f_error, residual_norm,
               f_add_ex, f_rescale_ex
    u32 crc32 of all hashed fields            (not hashed)
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..errors import InvalidConfig, InvalidPersistence
from ..ops import packing
from ..ops.rotation import deserialize_rotator
from ..types import Metric, RotatorType
from .persistence import _Cursor

MAGIC = b"RBF1"
VERSION = 1


def save_brute_force(index, path) -> None:
    from ..index.brute_force import BruteForceRabitqIndex  # imports this module

    if not isinstance(index, BruteForceRabitqIndex):
        raise TypeError("save_brute_force takes a BruteForceRabitqIndex")
    h = index.host
    n = len(index)
    padded_dim = index.padded_dim
    ex_bits = index.ex_bits

    binary_packed = packing.pack_binary(h.binary_bits)  # [n, ceil(pd/8)]
    if ex_bits > 0:
        ex_packed = packing.pack_ex_rows(h.ex_codes, ex_bits)
        if ex_packed.shape[-1] != (padded_dim * ex_bits + 7) // 8:
            raise InvalidConfig("ex-code packed length does not match the RBF1 layout")
    else:
        ex_packed = np.zeros((n, 0), np.uint8)
    meta = np.stack(
        [h.delta, h.vl, h.f_add, h.f_rescale, h.f_error, h.residual_norm,
         h.f_add_ex, h.f_rescale_ex],
        axis=1,
    ).astype("<f4")
    # one interleaved per-vector block
    per_vec = np.concatenate([binary_packed, ex_packed, meta.view(np.uint8)], axis=1)

    with open(path, "wb") as f:
        crc = 0

        def w(data: bytes, hashed: bool = True):
            nonlocal crc
            f.write(data)
            if hashed:
                crc = zlib.crc32(data, crc)

        w(MAGIC, hashed=False)
        w(struct.pack("<I", VERSION), hashed=False)
        w(struct.pack("<IIBBBBQ", index.dim, padded_dim, index.metric.to_tag(),
                      int(index.rotator.rotator_type), ex_bits, ex_bits + 1, n))
        rot = index.rotator.serialize()
        w(struct.pack("<Q", len(rot)))
        w(rot)
        w(per_vec.tobytes())
        w(struct.pack("<I", crc), hashed=False)


def load_brute_force(path, scan_dtype: str = "bf16", device=None):
    """Load an RBF1 v1 index; its device layout is built on ``device``
    (None: the card) at the first search."""
    from ..index.brute_force import BruteForceHost, BruteForceRabitqIndex

    with open(path, "rb") as f:
        data = f.read()
    cur = _Cursor(data)
    if cur.take(4) != MAGIC:
        raise InvalidPersistence("unrecognized file header")
    if cur.u32() != VERSION:
        raise InvalidPersistence("unsupported index format version")
    stored_crc = struct.unpack("<I", data[-4:])[0]
    if zlib.crc32(data[8:-4]) != stored_crc:
        raise InvalidPersistence("checksum mismatch")

    dim = cur.u32()
    if dim == 0:
        raise InvalidPersistence("dimension must be positive")
    padded_dim = cur.u32()
    if padded_dim < dim:
        raise InvalidPersistence("padded_dim must be >= dim")
    metric = Metric.from_tag(cur.u8())
    rot_tag = cur.u8()
    if rot_tag not in (0, 1):
        raise InvalidPersistence("unknown rotator type tag")
    ex_bits = cur.u8()
    if ex_bits > 16:
        raise InvalidPersistence("ex_bits out of range")
    total_bits = cur.u8()
    if total_bits == 0 or total_bits > 16 or total_bits - 1 != ex_bits:
        raise InvalidPersistence("total_bits does not match ex_bits")
    n = cur.u64()
    rot_len = cur.u64()
    rotator = deserialize_rotator(dim, padded_dim, RotatorType(rot_tag), cur.take(rot_len))

    bin_len = (padded_dim + 7) // 8
    ex_len = (padded_dim * ex_bits + 7) // 8 if ex_bits > 0 else 0
    row_len = bin_len + ex_len + 32
    block = cur.bytes_np(n * row_len).reshape(n, row_len)
    binary_bits = packing.unpack_binary(np.ascontiguousarray(block[:, :bin_len]), padded_dim)
    ex_codes = packing.unpack_ex_rows(
        np.ascontiguousarray(block[:, bin_len : bin_len + ex_len]), padded_dim, ex_bits
    )
    meta = np.ascontiguousarray(block[:, bin_len + ex_len :]).view("<f4")
    fields = ("delta", "vl", "f_add", "f_rescale", "f_error", "residual_norm", "f_add_ex",
              "f_rescale_ex")
    host = BruteForceHost(
        binary_bits=binary_bits.astype(np.uint8),
        ex_codes=ex_codes.astype(np.uint16),
        **{name: meta[:, i].astype(np.float32) for i, name in enumerate(fields)},
    )
    return BruteForceRabitqIndex(
        dim, padded_dim, metric, rotator, ex_bits, host=host, scan_dtype=scan_dtype,
        device=device,
    )
