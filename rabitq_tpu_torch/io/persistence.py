"""RBQ1 v3 IVF index files, byte-compatible with the reference (a port of
``rabitq_tpu/io/persistence.py``).

Format (lqhl/rabitq-rs ``ivf.rs:1310-1702``), all little-endian:

    b"RBQ1"                       magic        (not hashed)
    u32  version = 3                           (not hashed)
    u32  dim
    u32  padded_dim
    u8   metric tag (0 = L2, 1 = IP)
    u8   rotator tag (0 = Matrix, 1 = FhtKac)
    u8   ex_bits
    u8   total_bits (= ex_bits + 1)
    u64  vector_count
    u64  cluster_count
    u64  rotator_len, rotator bytes
    per cluster:
      f32[padded_dim]  centroid (rotated space)
      u64              num_vectors
      u64[num]         ids
      u64              batch_data_len, batch_data bytes
      per vector: u64 ex_code_len + ex bytes (cpp-compat packing)
      f32[num] f_add_ex;  f32[num] f_rescale_ex
      f32[num] delta;     f32[num] vl
    u32  crc32 over every hashed field         (not hashed)

``batch_data`` is the FastScan layout, per 32-vector batch:
[KPERM0-transposed binary codes (padded_dim*32/8 B)][f_add f32*32]
[f_rescale f32*32][f_error f32*32] (``ivf.rs:216-242, 409-522``).

The CRC is crc32fast's IEEE CRC-32 == ``zlib.crc32``; every field between
the version and the checksum is hashed in write order, so the digest is
crc32(file[8:-4]). The codes are packed for the whole index at once and
each cluster is written as a few blocks; the bytes are those the reference
writes field by field.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..errors import InvalidConfig, InvalidPersistence
from ..ops import packing
from ..ops.rotation import deserialize_rotator
from ..types import Metric, RotatorType

MAGIC = b"RBQ1"
VERSION = 3
MAX_CLUSTER_SIZE = 1_000_000  # ivf.rs:1567


def save_ivf(index, path) -> None:
    from ..index.ivf import IvfRabitqIndex  # the index module imports this one

    if not isinstance(index, IvfRabitqIndex):
        raise TypeError("save_ivf takes an IvfRabitqIndex")
    h = index.host
    padded_dim = index.padded_dim
    if padded_dim % 8 != 0:
        raise InvalidConfig("RBQ1 persistence requires padded_dim to be a multiple of 8")
    ex_bits = index.ex_bits
    n_clusters = h.cluster_offsets.shape[0] - 1
    n = h.binary_bits.shape[0]
    expected_ex_len = padded_dim * ex_bits // 8 if ex_bits > 0 else 0

    # per row: the u64 length prefix, then the packed ex code
    ex_rows = np.empty((n, 8 + expected_ex_len), np.uint8)
    ex_rows[:, :8] = np.frombuffer(struct.pack("<Q", expected_ex_len), np.uint8)
    if ex_bits > 0:
        ex_packed = packing.pack_ex_rows(h.ex_codes, ex_bits)
        if ex_packed.shape[-1] != expected_ex_len:
            raise InvalidConfig(
                "ex-code packed length does not match the RBQ1 layout "
                f"({ex_packed.shape[-1]} != {expected_ex_len}); "
                "this dim/ex_bits combination is not persistable"
            )
        ex_rows[:, 8:] = ex_packed
        del ex_packed
    bin_rows = packing.pack_binary(h.binary_bits)  # [n, padded_dim / 8]
    tail = np.stack([h.f_add_ex, h.f_rescale_ex, h.delta, h.vl]).astype("<f4")  # [4, n]

    with open(path, "wb") as f:
        crc = 0

        def w(data: bytes, hashed: bool = True):
            nonlocal crc
            f.write(data)
            if hashed:
                crc = zlib.crc32(data, crc)

        w(MAGIC, hashed=False)
        w(struct.pack("<I", VERSION), hashed=False)
        w(struct.pack("<IIBBBBQQ", index.dim, padded_dim, index.metric.to_tag(),
                      int(index.rotator.rotator_type), ex_bits, ex_bits + 1, n, n_clusters))
        rot = index.rotator.serialize()
        w(struct.pack("<Q", len(rot)))
        w(rot)

        for c in range(n_clusters):
            s, e = int(h.cluster_offsets[c]), int(h.cluster_offsets[c + 1])
            batch = _build_batch_data(bin_rows[s:e], h.f_add[s:e], h.f_rescale[s:e],
                                      h.f_error[s:e])
            w(b"".join((
                np.ascontiguousarray(h.centroids[c], "<f4").tobytes(),
                struct.pack("<Q", e - s),
                h.ids[s:e].astype("<u8").tobytes(),
                struct.pack("<Q", len(batch)),
                batch,
                ex_rows[s:e].tobytes(),
                tail[:, s:e].tobytes(),
            )))

        w(struct.pack("<I", crc), hashed=False)


def _build_batch_data(
    packed_rows: np.ndarray,  # [m, padded_dim / 8] MSB-first binary codes
    f_add: np.ndarray,
    f_rescale: np.ndarray,
    f_error: np.ndarray,
) -> bytes:
    """FastScan batch layout for one cluster (``ivf.rs:409-522``)."""
    m, dim_bytes = packed_rows.shape
    bs = packing.FASTSCAN_BATCH_SIZE
    nb = (m + bs - 1) // bs
    if nb == 0:
        return b""
    rows = np.zeros((nb * bs, dim_bytes), np.uint8)
    rows[:m] = packed_rows
    codes = packing.pack_codes(rows.reshape(nb, bs, dim_bytes))  # [nb, dim_bytes*32]

    def padf(x):
        out = np.zeros(nb * bs, np.float32)
        out[:m] = x
        return out.reshape(nb, bs).astype("<f4")

    parts = [codes, padf(f_add).view(np.uint8), padf(f_rescale).view(np.uint8),
             padf(f_error).view(np.uint8)]
    return np.concatenate(parts, axis=1).tobytes()


def _parse_batch_data(
    blob: np.ndarray, m: int, padded_dim: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Inverse of :func:`_build_batch_data`; returns
    (binary_bits [m, padded_dim], f_add [m], f_rescale [m], f_error [m])."""
    bs = packing.FASTSCAN_BATCH_SIZE
    dim_bytes = padded_dim // 8
    stride = dim_bytes * bs + 4 * bs * 3
    nb = blob.shape[0] // stride if stride else 0
    if nb == 0:
        z = np.zeros((0, padded_dim), np.uint8)
        f = np.zeros(0, np.float32)
        return z, f, f.copy(), f.copy()
    rows = blob.reshape(nb, stride)
    packed_rows = packing.unpack_codes(rows[:, : dim_bytes * bs], dim_bytes)  # [nb, 32, dim_bytes]
    bits = packing.unpack_binary(packed_rows.reshape(nb * bs, dim_bytes), padded_dim)[:m]
    fpart = rows[:, dim_bytes * bs :].copy().view("<f4").reshape(nb, 3, bs)
    f_add = fpart[:, 0, :].reshape(-1)[:m].astype(np.float32)
    f_rescale = fpart[:, 1, :].reshape(-1)[:m].astype(np.float32)
    f_error = fpart[:, 2, :].reshape(-1)[:m].astype(np.float32)
    return bits, f_add, f_rescale, f_error


class _Cursor:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise InvalidPersistence("unexpected end of file")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def f32s(self, count: int) -> np.ndarray:
        return np.frombuffer(self.take(4 * count), "<f4").astype(np.float32)

    def u64s(self, count: int) -> np.ndarray:
        return np.frombuffer(self.take(8 * count), "<u8").copy()

    def bytes_np(self, count: int) -> np.ndarray:
        return np.frombuffer(self.take(count), np.uint8)


def load_ivf(path, scan_dtype: str = "bf16", device=None):
    """Load an RBQ1 v3 index (``ivf.rs:1477-1702``): checks and messages as
    the reference's, then ``IvfRabitqIndex.from_host_arrays`` lays the codes
    out on ``device`` (None: the card)."""
    from ..index.ivf import IvfRabitqIndex

    with open(path, "rb") as f:
        data = f.read()
    cur = _Cursor(data)
    if cur.take(4) != MAGIC:
        raise InvalidPersistence("unrecognized file header")
    if cur.u32() != VERSION:
        raise InvalidPersistence(
            "unsupported index format version (expected V3 with unified memory layout)"
        )
    if len(data) < 12:
        raise InvalidPersistence("file truncated")
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
    rotator_type = RotatorType(rot_tag)
    ex_bits = cur.u8()
    if ex_bits > 16:
        raise InvalidPersistence("ex_bits out of range")
    total_bits = cur.u8()
    if total_bits == 0 or total_bits > 16:
        raise InvalidPersistence("total_bits out of range")
    if total_bits - 1 != ex_bits:
        raise InvalidPersistence("total_bits does not match ex_bits")
    expected_vectors = cur.u64()
    cluster_count = cur.u64()
    rotator_bytes = cur.take(cur.u64())
    deserialize_rotator(dim, padded_dim, rotator_type, rotator_bytes)  # validates its length

    bs = packing.FASTSCAN_BATCH_SIZE
    dim_bytes_total = padded_dim * bs // 8
    expected_ex_len = padded_dim * ex_bits // 8 if ex_bits > 0 else 0

    centroids = np.empty((cluster_count, padded_dim), np.float32)
    offsets = np.zeros(cluster_count + 1, np.int64)
    names = ("bits", "ex", "ids", "f_add", "f_rescale", "f_error", "f_add_ex", "f_rescale_ex",
             "delta", "vl")
    chunks: dict[str, list] = {k: [] for k in names}
    for c in range(cluster_count):
        centroids[c] = cur.f32s(padded_dim)
        m = cur.u64()
        if m > MAX_CLUSTER_SIZE:
            raise InvalidPersistence("cluster size exceeds reasonable limits - possible corruption")
        offsets[c + 1] = offsets[c] + m
        chunks["ids"].append(cur.u64s(m).astype(np.int64))
        batch_len = cur.u64()
        nb = (m + bs - 1) // bs
        if batch_len != nb * (dim_bytes_total + 4 * bs * 3):
            raise InvalidPersistence(
                "batch_data length mismatch - possible corruption or version incompatibility"
            )
        for key, part in zip(("bits", "f_add", "f_rescale", "f_error"),
                             _parse_batch_data(cur.bytes_np(batch_len), m, padded_dim)):
            chunks[key].append(part)
        ex_block = cur.bytes_np(m * (8 + expected_ex_len)).reshape(m, 8 + expected_ex_len)
        lens = ex_block[:, :8].copy().view("<u8")[:, 0]
        if not np.all(lens == expected_ex_len):
            raise InvalidPersistence(
                "ex_code_packed length mismatch - possible corruption or version incompatibility"
            )
        chunks["ex"].append(ex_block[:, 8:])
        for key in ("f_add_ex", "f_rescale_ex", "delta", "vl"):
            chunks[key].append(cur.f32s(m))

    n = int(offsets[-1])
    if n != expected_vectors:
        raise InvalidPersistence("vector count metadata mismatch")

    def cat(name, dtype, width=None):
        shape = (0,) if width is None else (0, width)
        if not chunks[name]:
            return np.zeros(shape, dtype)
        return np.concatenate(chunks[name]).astype(dtype, copy=False)

    ex_packed = cat("ex", np.uint8, expected_ex_len)
    return IvfRabitqIndex.from_host_arrays(
        dim=dim, padded_dim=padded_dim, metric=metric, ex_bits=ex_bits,
        rotator_type=rotator_type, rotator_bytes=rotator_bytes,
        binary_bits=cat("bits", np.uint8, padded_dim),
        ex_codes=packing.unpack_ex_rows(ex_packed, padded_dim, ex_bits),
        f_add=cat("f_add", np.float32), f_rescale=cat("f_rescale", np.float32),
        f_error=cat("f_error", np.float32), f_add_ex=cat("f_add_ex", np.float32),
        f_rescale_ex=cat("f_rescale_ex", np.float32), delta=cat("delta", np.float32),
        vl=cat("vl", np.float32), ids=cat("ids", np.int64), cluster_offsets=offsets,
        centroids=centroids, scan_dtype=scan_dtype, device=device,
    )
