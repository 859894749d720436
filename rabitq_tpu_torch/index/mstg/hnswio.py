"""hnsw_rs ``file_dump`` side-files: writer + independent parser (a copy of
``rabitq_tpu/index/mstg/hnswio.py``).

The reference's public loader unconditionally reloads its centroid HNSW
from ``{base}.hnsw.graph`` / ``{base}.hnsw.data`` next to the ``.mstg``
body and hard-fails without them (``mstg/io.rs:104-112,248-324``). Those
files are produced by the hnsw_rs crate's ``file_dump`` (the reference pins
``hnsw_rs = "0.2"``, Cargo.toml:33) — a hand-rolled binary format, NOT
bincode.

BYTE-LAYOUT PROVENANCE — read before editing. The layout below is a
transcription of hnsw_rs 0.2.x ``src/hnswio.rs`` (public source, Jean
Pierre-Both, github.com/jean-pierreBoth/hnswlib-rs). The transcription is
from study of the crate and is not byte-verified against the real
loader (PARITY.md "io" row carries the caveat). Every constant and
field is therefore isolated in this module with a confidence note, and
`tests/test_torch_mstg_hnswio.py` round-trips the files through the
independent `parse_hnsw_dump` below plus structural invariants
(magics, counts, degree caps, navigability of the graph itself).

Layout (all integers NATIVE-endian — hnsw_rs writes ``to_ne_bytes()``;
x86/ARM hosts = little-endian). usize = u64.

``{base}.hnsw.graph``:
    u32   MAGICDESCR            [high confidence]
    u8    dumpmode (1 = Full)   [high]
    u8    max_nb_connection     [high]
    u8    nb_layer (= 16; hnsw_rs only serializes NB_LAYER_MAX-layer
          indexes — the reference pins max_layer=16 for exactly this
          reason, mstg/hnsw.rs:93-95)                     [high]
    u64   ef_construction       [high]
    u64   nb_point              [high]
    u64   data dimension        [high]
    u64   len + utf8 bytes      distance type name        [medium]
    u64   len + utf8 bytes      T type name ("f32")       [medium]
    then, for layer in 0..nb_layer (ascending, empty layers included):
        u32   MAGICLAYER                                  [medium]
        u8    layer index                                 [medium]
        u64   number of points in this layer              [medium]
        per point (insertion order = p_id rank order):
            u32   MAGICPOINT                              [high]
            u64   origin_id (DataId)                      [high]
            u8    p_id.0 (the point's top layer)          [medium]
            i32   p_id.1 (rank within that layer)         [medium]
            u8    number of neighbour layers (= p_id.0+1) [medium]
            per neighbour layer l in 0..=p_id.0:
                u64   neighbour count                     [medium]
                per neighbour:
                    u64  origin_id                        [medium]
                    u8   p_id.0                           [medium]
                    i32  p_id.1                           [medium]
                    f32  distance (DistL2: true Euclidean,
                         sqrt included)                   [medium]

``{base}.hnsw.data``:
    u32   MAGICDATAP            [high]
    u64   nb_point              [medium]
    u64   dimension             [medium]
    per point (same order as the graph traversal):
        u32   MAGICDATAP        [high]
        u64   origin_id         [high]
        dim * 4 raw bytes       f32 vector, native-endian [high]
"""

from __future__ import annotations

import struct

import numpy as np

from .hnsw_graph import HnswGraph, NB_LAYER_MAX

# --- hnsw_rs 0.2.x hnswio.rs magic constants (transcribed) ---
MAGICDESCR = 0x002A677F  # start of the Description header
MAGICLAYER = 0x000A677F  # start of each layer block
MAGICPOINT = 0x000A678F  # start of each graph point record
MAGICDATAP = 0xA67F0000  # data-file header and each data point record

#: std::any::type_name::<DistL2>() / ::<f32>() as the crate writes them
DIST_L2_NAME = "hnsw_rs::dist::DistL2"
T_NAME_F32 = "f32"

_END = "<"  # native-endian in practice: every supported host is LE


class HnswDumpError(ValueError):
    pass


def dump_hnsw(base_path: str, g: HnswGraph, origin_ids=None) -> tuple[str, str]:
    """Write ``{base}.hnsw.graph`` / ``{base}.hnsw.data`` for ``g``.

    ``origin_ids`` maps point index -> DataId (default: identity, which
    matches the reference's centroid insertion ``mstg/hnsw.rs:108-118``:
    centroids are inserted with ids 0..n-1).

    Returns the two paths written.
    """
    n, dim = g.vectors.shape
    if origin_ids is None:
        origin_ids = np.arange(n, dtype=np.int64)
    origin_ids = np.asarray(origin_ids, np.int64)
    if g.max_layer != NB_LAYER_MAX:
        raise HnswDumpError(
            f"hnsw_rs only serializes max_layer == {NB_LAYER_MAX} indexes "
            f"(got {g.max_layer}); the reference pins 16 for this reason"
        )
    by_layer = g.rank_in_layer()
    # rank of each point within its TOP layer — hnsw_rs PointId.1
    rank_in_top: dict[int, int] = {}
    for l, pts in enumerate(by_layer):
        for r, p in enumerate(pts):
            if int(g.levels[p]) == l:
                rank_in_top[int(p)] = r

    graph_path = f"{base_path}.hnsw.graph"
    data_path = f"{base_path}.hnsw.data"
    gw = open(graph_path, "wb")
    dw = open(data_path, "wb")
    try:
        # --- description ---
        gw.write(struct.pack(_END + "I", MAGICDESCR))
        gw.write(struct.pack(_END + "BBB", 1, g.m, NB_LAYER_MAX))
        gw.write(struct.pack(_END + "QQQ", g.ef_construction, n, dim))
        for name in (DIST_L2_NAME, T_NAME_F32):
            b = name.encode()
            gw.write(struct.pack(_END + "Q", len(b)))
            gw.write(b)
        # --- data header ---
        dw.write(struct.pack(_END + "I", MAGICDATAP))
        dw.write(struct.pack(_END + "QQ", n, dim))

        def p_id(p: int) -> bytes:
            return struct.pack(
                _END + "Bi", int(g.levels[p]), rank_in_top[int(p)]
            )

        vecs = np.ascontiguousarray(g.vectors, "<f4")
        for l in range(NB_LAYER_MAX):
            pts = by_layer[l] if l < len(by_layer) else np.empty(0, np.int64)
            # a layer block holds the points whose TOP layer is l — each
            # point is dumped exactly once, from its home layer
            home = [int(p) for p in pts if int(g.levels[p]) == l]
            gw.write(struct.pack(_END + "I", MAGICLAYER))
            gw.write(struct.pack(_END + "B", l))
            gw.write(struct.pack(_END + "Q", len(home)))
            for p in home:
                gw.write(struct.pack(_END + "I", MAGICPOINT))
                gw.write(struct.pack(_END + "Q", int(origin_ids[p])))
                gw.write(p_id(p))
                lvl = int(g.levels[p])
                gw.write(struct.pack(_END + "B", lvl + 1))
                q = g.vectors[p]
                for nl in range(lvl + 1):
                    nbrs = g.neighbors[p][nl]
                    gw.write(struct.pack(_END + "Q", len(nbrs)))
                    if not nbrs:
                        continue
                    nb = np.asarray(nbrs, np.int64)
                    d = g.vectors[nb] - q[None, :]
                    dist = np.sqrt(
                        np.maximum(np.einsum("nd,nd->n", d, d), 0.0)
                    ).astype(np.float32)
                    for i, dd in zip(nbrs, dist):
                        gw.write(
                            struct.pack(_END + "Q", int(origin_ids[int(i)]))
                        )
                        gw.write(p_id(int(i)))
                        gw.write(struct.pack(_END + "f", float(dd)))
                # interleaved data record (Point::dump writes both files)
                dw.write(struct.pack(_END + "I", MAGICDATAP))
                dw.write(struct.pack(_END + "Q", int(origin_ids[p])))
                dw.write(vecs[p].tobytes())
    finally:
        gw.close()
        dw.close()
    return graph_path, data_path


class _Reader:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.buf = f.read()
        self.pos = 0
        self.path = path

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise HnswDumpError(f"{self.path}: truncated at offset {self.pos}")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        fmt = _END + fmt
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))

    def expect_magic(self, magic: int, what: str):
        (got,) = self.unpack("I")
        if got != magic:
            raise HnswDumpError(
                f"{self.path}: bad {what} magic {got:#x} (want {magic:#x}) "
                f"at offset {self.pos - 4}"
            )

    @property
    def exhausted(self) -> bool:
        return self.pos == len(self.buf)


def parse_hnsw_dump(base_path: str):
    """Independent parser for the files `dump_hnsw` writes (and, layout
    permitting, real hnsw_rs 0.2.x dumps). Returns a dict with the
    description, per-point levels/neighbour lists keyed by origin_id,
    and the data vectors.

    This is the round-trip check the tests rely on: it shares only the
    layout constants with the writer, not its code paths.
    """
    gr = _Reader(f"{base_path}.hnsw.graph")
    dr = _Reader(f"{base_path}.hnsw.data")

    gr.expect_magic(MAGICDESCR, "description")
    dumpmode, m, nb_layer = gr.unpack("BBB")
    ef_construction, nb_point, dim = gr.unpack("QQQ")
    (dlen,) = gr.unpack("Q")
    distname = gr.take(dlen).decode()
    (tlen,) = gr.unpack("Q")
    t_name = gr.take(tlen).decode()

    dr.expect_magic(MAGICDATAP, "data header")
    d_nb_point, d_dim = dr.unpack("QQ")
    if (d_nb_point, d_dim) != (nb_point, dim):
        raise HnswDumpError(
            f"graph/data disagree: {nb_point}x{dim} vs {d_nb_point}x{d_dim}"
        )

    levels: dict[int, int] = {}
    ranks: dict[int, int] = {}
    neighbors: dict[int, list[list[tuple[int, float]]]] = {}
    vectors: dict[int, np.ndarray] = {}
    seen = 0
    for l in range(nb_layer):
        gr.expect_magic(MAGICLAYER, "layer")
        (layer_idx,) = gr.unpack("B")
        if layer_idx != l:
            raise HnswDumpError(f"layer index {layer_idx} out of order (want {l})")
        (cnt,) = gr.unpack("Q")
        for _ in range(cnt):
            gr.expect_magic(MAGICPOINT, "point")
            (origin,) = gr.unpack("Q")
            top, rank = gr.unpack("Bi")
            (nlayers,) = gr.unpack("B")
            if top != l:
                raise HnswDumpError(
                    f"point {origin} dumped from layer {l} but p_id.0={top}"
                )
            levels[origin] = top
            ranks[origin] = rank
            nbl = []
            for _nl in range(nlayers):
                (ncnt,) = gr.unpack("Q")
                lst = []
                for _ in range(ncnt):
                    (n_origin,) = gr.unpack("Q")
                    _n_top, _n_rank = gr.unpack("Bi")
                    (ndist,) = gr.unpack("f")
                    lst.append((n_origin, ndist))
                nbl.append(lst)
            neighbors[origin] = nbl
            dr.expect_magic(MAGICDATAP, "data point")
            (d_origin,) = dr.unpack("Q")
            if d_origin != origin:
                raise HnswDumpError(
                    f"data point order diverged: {d_origin} != {origin}"
                )
            vectors[origin] = np.frombuffer(
                dr.take(dim * 4), dtype="<f4"
            ).copy()
            seen += 1
    if seen != nb_point:
        raise HnswDumpError(f"dumped {seen} points, description says {nb_point}")
    if not gr.exhausted:
        raise HnswDumpError(f"graph file has {len(gr.buf)-gr.pos} trailing bytes")
    if not dr.exhausted:
        raise HnswDumpError(f"data file has {len(dr.buf)-dr.pos} trailing bytes")
    return {
        "dumpmode": dumpmode,
        "max_nb_connection": m,
        "nb_layer": nb_layer,
        "ef_construction": ef_construction,
        "nb_point": nb_point,
        "dimension": dim,
        "distname": distname,
        "t_name": t_name,
        "levels": levels,
        "ranks": ranks,
        "neighbors": neighbors,
        "vectors": vectors,
    }
