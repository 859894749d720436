"""Reader and writer for the reference's multi-file MSTG persistence format
(a copy of ``rabitq_tpu/index/mstg/ref_io.py``; the loader builds this
package's ``MstgIndex`` on the given device).

The reference persists MSTG as ``{base}.mstg`` (magic ``MSTG`` version 1,
bincode bodies, CRC32) plus ``{base}.hnsw.graph``/``.hnsw.data`` dumps of
its hnsw_rs centroid graph (``mstg/io.rs:14-245``). This library's
navigation is an exact centroid matmul rebuilt from the posting-list
centroids — exactly what the reference's own loader does for the
quantized copies (``mstg/io.rs:238-243``) — so the hnsw files are
ignored; only the ``.mstg`` body is read.

bincode 1.3's legacy encoding (``bincode::serialize``): little-endian,
fixed-width integers (usize as u64), u64 sequence-length prefixes, u32
enum variant indices, 1-byte bools and Option tags. Struct field orders
follow ``mstg/config.rs:38-62``, ``mstg/posting_list.rs:6-32`` and
``quantizer.rs:60-88`` (``#[serde(skip)]`` fields absent).

Both directions are supported: :func:`load_reference_mstg` parses
reference-written files, and :func:`save_reference_mstg` emits a
byte-compatible bincode v1 body PLUS the ``{base}.hnsw.graph``/
``.hnsw.data`` centroid-graph dumps the reference's loader
hard-requires (built by :mod:`.hnsw_graph` and serialized by
:mod:`.hnswio`; the hnsw_rs byte layout is transcribed from the public
crate source and verified by an independent parser only — see the
writer's docstring for per-field confidence). The native single-file
v1003 format remains the default write format; the two formats are
versioned apart and the smart loaders on both sides reject the other's
version tag rather than misparse it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ...errors import InvalidPersistence
from ...types import Metric

_MAGIC = b"MSTG"
_REF_VERSION = 1


class _Bincode:
    """Cursor over bincode 1.3 legacy-encoded bytes."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise InvalidPersistence("unexpected end of bincode body")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def f32(self) -> float:
        return struct.unpack("<f", self.take(4))[0]

    def boolean(self) -> bool:
        v = self.u8()
        if v > 1:
            raise InvalidPersistence("invalid bincode bool")
        return bool(v)

    def enum_tag(self, n_variants: int) -> int:
        v = self.u32()
        if v >= n_variants:
            raise InvalidPersistence("invalid bincode enum variant")
        return v

    def option_f32(self) -> float | None:
        return self.f32() if self.boolean() else None

    def vec_u8(self) -> np.ndarray:
        n = self.u64()
        return np.frombuffer(self.take(n), np.uint8)

    def vec_u16(self) -> np.ndarray:
        n = self.u64()
        return np.frombuffer(self.take(2 * n), "<u2")

    def vec_f32(self) -> np.ndarray:
        n = self.u64()
        return np.frombuffer(self.take(4 * n), "<f4").astype(np.float32)

    @property
    def exhausted(self) -> bool:
        return self.pos == len(self.data)


def _parse_config(body: bytes):
    """MstgConfig field order (mstg/config.rs:38-62)."""
    from .config import MstgConfig, ScalarPrecision

    cur = _Bincode(body)
    cfg = MstgConfig(
        max_posting_size=cur.u64(),
        branching_factor=cur.u64(),
        balance_weight=cur.f32(),
        closure_epsilon=cur.f32(),
        max_replicas=cur.u64(),
        rabitq_bits=cur.u64(),
        faster_config=cur.boolean(),
        metric=Metric.from_tag(cur.enum_tag(2)),
        hnsw_m=cur.u64(),
        hnsw_ef_construction=cur.u64(),
        centroid_precision=list(ScalarPrecision)[cur.enum_tag(4)],
        default_ef_search=cur.u64(),
        pruning_epsilon=cur.f32(),
        # reference MSTG has neither survivor refinement nor a rotator
        refine_ex=False,
        use_rotator=False,
    )
    if not cur.exhausted:
        raise InvalidPersistence("trailing bytes in MSTG config body")
    return cfg


def _parse_posting_list(body: bytes, rabitq_bits: int):
    """PostingList (mstg/posting_list.rs:6-32) without #[serde(skip)] fields.

    Binary/ex codes are recovered from each vector's total-code array
    (``code = ex | binary << ex_bits``, quantizer.rs:165-168) — no need to
    re-derive them from the packed byte forms also present in the body.
    """
    cur = _Bincode(body)
    cluster_id = cur.u32()
    centroid = cur.vec_f32()
    size = cur.u32()
    # RabitqConfig { total_bits: u64, t_const: Option<f32> } (quantizer.rs:15)
    total_bits = cur.u64()
    cur.option_f32()
    if total_bits != rabitq_bits:
        raise InvalidPersistence("posting list bits disagree with config")
    n = cur.u64()
    if n != size:
        raise InvalidPersistence("posting list size mismatch")
    ex_bits = total_bits - 1
    dim = centroid.shape[0]
    ids = np.empty(n, np.int64)
    codes = np.empty((n, dim), np.uint16)
    scalars = {k: np.empty(n, np.float32) for k in (
        "delta", "vl", "f_add", "f_rescale", "f_error",
        "residual_norm", "f_add_ex", "f_rescale_ex")}
    for i in range(n):
        ids[i] = cur.u64()  # QuantizedVectorWithId.vector_id
        # QuantizedVector (quantizer.rs:63-88)
        code = cur.vec_u16()
        if code.shape[0] != dim:
            raise InvalidPersistence("quantized vector dimension mismatch")
        cur.vec_u8()  # binary_code_packed (redundant with `code`)
        cur.vec_u8()  # ex_code_packed (redundant with `code`)
        if cur.u8() != ex_bits:
            raise InvalidPersistence("vector ex_bits disagree with config")
        if cur.u64() != dim:
            raise InvalidPersistence("vector dim disagrees with centroid")
        codes[i] = code
        for k in scalars:
            scalars[k][i] = cur.f32()
    if not cur.exhausted:
        raise InvalidPersistence("trailing bytes in posting list body")
    return cluster_id, centroid, ids, codes, scalars


def load_reference_mstg(path, scan_dtype: str = "bf16", device=None):
    """Load a reference-written ``.mstg`` file (or its base path) as an index
    on ``device`` (None: the card)."""
    from .index import MstgHost, MstgIndex

    path = str(path)
    if not path.endswith(".mstg"):
        path = path + ".mstg"
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != _MAGIC:
        raise InvalidPersistence("unrecognized file header")
    version = struct.unpack("<I", data[4:8])[0]
    if version != _REF_VERSION:
        raise InvalidPersistence(
            f"not a reference MSTG v1 file (version {version})"
        )
    if len(data) < 12:
        raise InvalidPersistence("file truncated")
    stored_crc = struct.unpack("<I", data[-4:])[0]
    # every field between the version and the checksum is hashed in order
    if zlib.crc32(data[8:-4]) != stored_crc:
        raise InvalidPersistence("checksum mismatch")

    cur = _Bincode(data[8:-4])
    cfg = _parse_config(cur.take(cur.u64()))
    n_centroid_ids = cur.u64()
    centroid_ids = [cur.u32() for _ in range(n_centroid_ids)]
    n_lists = cur.u64()
    lists = [
        _parse_posting_list(cur.take(cur.u64()), cfg.rabitq_bits)
        for _ in range(n_lists)
    ]
    if not cur.exhausted:
        raise InvalidPersistence("trailing bytes after posting lists")
    if centroid_ids and len(centroid_ids) != n_lists:
        raise InvalidPersistence("centroid id count mismatch")

    if not lists:
        raise InvalidPersistence("empty MSTG index")
    dim = lists[0][1].shape[0]
    ex_bits = cfg.rabitq_bits - 1
    mask = (1 << ex_bits) - 1
    offsets = np.zeros(n_lists + 1, np.int64)
    for i, (_, _, ids, _, _) in enumerate(lists):
        offsets[i + 1] = offsets[i] + ids.shape[0]
    total = int(offsets[-1])

    def cat2(idx):
        return (
            np.concatenate([l[idx] for l in lists])
            if total
            else np.zeros((0, dim))
        )

    codes = np.concatenate([l[3] for l in lists]).astype(np.uint16)
    host = MstgHost(
        binary_bits=(codes >> ex_bits).astype(np.uint8),
        ex_codes=(codes & mask).astype(np.uint16),
        f_add=np.concatenate([l[4]["f_add"] for l in lists]),
        f_rescale=np.concatenate([l[4]["f_rescale"] for l in lists]),
        f_add_ex=np.concatenate([l[4]["f_add_ex"] for l in lists]),
        f_rescale_ex=np.concatenate([l[4]["f_rescale_ex"] for l in lists]),
        delta=np.concatenate([l[4]["delta"] for l in lists]),
        vl=np.concatenate([l[4]["vl"] for l in lists]),
        ids=np.concatenate([l[2] for l in lists]),
        list_offsets=offsets,
        centroids=np.stack([l[1] for l in lists]),
        f_error=np.concatenate([l[4]["f_error"] for l in lists]),
        residual_norm=np.concatenate([l[4]["residual_norm"] for l in lists]),
    )
    return MstgIndex(cfg, dim, host, scan_dtype=scan_dtype, device=device)


# ---------------------------------------------------------------------------
# writer (the inverse of the parser above; mstg/io.rs:82-126,129-172)
# ---------------------------------------------------------------------------


class _BincodeWriter:
    """bincode 1.3 legacy encoder (little-endian, fixed-width ints)."""

    def __init__(self):
        import io

        self.buf = io.BytesIO()

    def u8(self, v: int):
        self.buf.write(struct.pack("<B", v))

    def u32(self, v: int):
        self.buf.write(struct.pack("<I", v))

    def u64(self, v: int):
        self.buf.write(struct.pack("<Q", v))

    def f32(self, v: float):
        self.buf.write(struct.pack("<f", float(v)))

    def boolean(self, v: bool):
        self.u8(1 if v else 0)

    def option_f32(self, v: float | None):
        if v is None:
            self.u8(0)
        else:
            self.u8(1)
            self.f32(v)

    def vec_u8(self, a: np.ndarray):
        a = np.ascontiguousarray(a, np.uint8)
        self.u64(a.shape[0])
        self.buf.write(a.tobytes())

    def vec_u16(self, a: np.ndarray):
        a = np.ascontiguousarray(a).astype("<u2")
        self.u64(a.shape[0])
        self.buf.write(a.tobytes())

    def vec_f32(self, a: np.ndarray):
        a = np.ascontiguousarray(a).astype("<f4")
        self.u64(a.shape[0])
        self.buf.write(a.tobytes())

    def bytes_value(self) -> bytes:
        return self.buf.getvalue()


def _encode_config(cfg) -> bytes:
    """Inverse of ``_parse_config`` (MstgConfig field order,
    mstg/config.rs:38-62)."""
    from .config import ScalarPrecision

    w = _BincodeWriter()
    w.u64(cfg.max_posting_size)
    w.u64(cfg.branching_factor)
    w.f32(cfg.balance_weight)
    w.f32(cfg.closure_epsilon)
    w.u64(cfg.max_replicas)
    w.u64(cfg.rabitq_bits)
    w.boolean(cfg.faster_config)
    w.u32(cfg.metric.to_tag())
    w.u64(cfg.hnsw_m)
    w.u64(cfg.hnsw_ef_construction)
    w.u32(list(ScalarPrecision).index(cfg.centroid_precision))
    w.u64(cfg.default_ef_search)
    w.f32(cfg.pruning_epsilon)
    return w.bytes_value()


def _encode_posting_list(
    cluster_id: int,
    centroid: np.ndarray,
    ids: np.ndarray,
    binary: np.ndarray,  # [n, dim] {0,1}
    ex: np.ndarray,  # [n, dim] ex codes
    scalars: dict,  # per-field [n] f32 in QuantizedVector order
    rabitq_bits: int,
) -> bytes:
    """Inverse of ``_parse_posting_list`` (PostingList minus the
    #[serde(skip)] fields, mstg/posting_list.rs:6-32 +
    quantizer.rs:63-88)."""
    from ...ops import packing

    ex_bits = rabitq_bits - 1
    n, dim = binary.shape
    w = _BincodeWriter()
    w.u32(cluster_id)
    w.vec_f32(centroid)
    w.u32(n)
    # RabitqConfig { total_bits: u64, t_const: Option<f32> }; the t_const
    # value is not retained after build (only search needs the factors),
    # and the reference's loader never re-quantizes, so None is written
    w.u64(rabitq_bits)
    w.option_f32(None)
    w.u64(n)
    total = (ex.astype(np.uint16) | (binary.astype(np.uint16) << ex_bits))
    bin_packed = packing.pack_binary(binary)
    if ex_bits == 0:
        # reference allocates dim/16*2 zero bytes for consistency
        # (quantizer.rs:212-225)
        ex_packed = np.zeros((n, dim // 16 * 2), np.uint8)
    else:
        ex_packed = packing.pack_ex(ex, ex_bits)
    order = ("delta", "vl", "f_add", "f_rescale", "f_error",
             "residual_norm", "f_add_ex", "f_rescale_ex")
    for i in range(n):
        w.u64(int(ids[i]))
        w.vec_u16(total[i])
        w.vec_u8(bin_packed[i])
        w.vec_u8(ex_packed[i])
        w.u8(ex_bits)
        w.u64(dim)
        for k in order:
            w.f32(scalars[k][i])
    return w.bytes_value()


def save_reference_mstg(index, path, hnsw_seed: int = 0x45) -> None:
    """Write the index as the reference's complete on-disk set: the
    bincode v1 ``.mstg`` body (``mstg/io.rs:82-126,129-172``, the inverse
    of this module's parser) PLUS the ``{base}.hnsw.graph`` /
    ``{base}.hnsw.data`` centroid-graph dumps the reference's
    ``load_from_path`` demands (``mstg/io.rs:104-112,248-324``).

    The graph is a real host-built HNSW over the posting-list centroids
    with the reference's hardcoded construction parameters (M=32,
    ef_construction=200, max_layer=16 — ``mstg/hnsw.rs:91-97``), written
    in the hnsw_rs 0.2.x ``file_dump`` byte layout. CAVEAT (PARITY.md
    "io"): that layout is transcribed from the public crate source and
    verified by this library's independent parser (``hnswio.parse_hnsw_dump``) and
    structural tests, not against the real hnsw_rs loader.

    Raises for rotated indexes (``use_rotator``) — the reference's MSTG
    quantizes in the original space and has no rotator field to carry.
    """
    if getattr(index, "rotator", None) is not None:
        raise InvalidPersistence(
            "reference MSTG format cannot represent a rotated index "
            "(build with use_rotator=False for interop)"
        )
    h = index.host
    cfg = index.config
    n_lists = index.posting_list_count()
    zeros = np.zeros(h.ids.shape[0], np.float32)
    scal_all = {
        "delta": h.delta,
        "vl": h.vl,
        "f_add": h.f_add,
        "f_rescale": h.f_rescale,
        "f_error": zeros if h.f_error is None else h.f_error,
        "residual_norm": zeros if h.residual_norm is None else h.residual_norm,
        "f_add_ex": h.f_add_ex,
        "f_rescale_ex": h.f_rescale_ex,
    }

    body = _BincodeWriter()
    cfg_bytes = _encode_config(cfg)
    body.u64(len(cfg_bytes))
    body.buf.write(cfg_bytes)
    body.u64(n_lists)  # centroid ids for HNSW reconstruction
    for i in range(n_lists):
        body.u32(i)
    body.u64(n_lists)
    for i in range(n_lists):
        s, e = int(h.list_offsets[i]), int(h.list_offsets[i + 1])
        pl = _encode_posting_list(
            i,
            h.centroids[i],
            h.ids[s:e],
            h.binary_bits[s:e],
            h.ex_codes[s:e],
            {k: v[s:e] for k, v in scal_all.items()},
            cfg.rabitq_bits,
        )
        body.u64(len(pl))
        body.buf.write(pl)

    blob = body.bytes_value()
    path = str(path)
    if not path.endswith(".mstg"):
        path = path + ".mstg"
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", _REF_VERSION))
        f.write(blob)
        f.write(struct.pack("<I", zlib.crc32(blob)))

    # hnsw_rs side-files next to the body, over the same centroids the
    # reference would insert (ids 0..n-1, mstg/hnsw.rs:108-118)
    from .hnsw_graph import build_hnsw
    from .hnswio import dump_hnsw

    g = build_hnsw(np.ascontiguousarray(h.centroids, np.float32), seed=hnsw_seed)
    dump_hnsw(path[: -len(".mstg")], g)
