"""Streamed serving for IVF indexes larger than device memory (port of
``rabitq_tpu/index/streaming.py``).

The code planes stay in host RAM as chunk slabs
(``layout.assemble_host_chunks``) and stream through device memory for each
query batch, so index capacity is bounded by host memory. Each chunk runs
the full ``scan_kernel`` (the fused scans go two-stage: 1-bit lower bounds
from the packed planes into bins, then the exact re-rank) and keeps its own
top-k on the device; the per-chunk results are fetched once and merged on
the host. The tier is bounded by the host-to-device link: it is for
batch-heavy offline serving or capacity overflow, not latency.

On the card the slabs live in pinned host memory, made once, and the
uploads are double-buffered by hand: chunk i+1 is copied on a side stream
while chunk i is scanned. The compute stream waits for the copy's event
before the scan, and every uploaded tensor is marked with ``record_stream``
so that the caching allocator does not hand its memory to a later upload
while a scan still reads it. Before staging chunk i+1 the host waits for
chunk i-1's scan, so at most two slabs are resident at once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fused_scan import TN
from ..types import Metric, SearchParams, SearchResult
from ..utils.device import resolve_device
from .ivf import IvfRabitqIndex, allowed_id_table
from .layout import assemble_host_chunks
from .scan import _pad_pow2, is_fused, probe_k_bucket, scan_kernel


class StreamedIvfIndex:
    """Chunk-streaming wrapper over a trained ``IvfRabitqIndex``.

    ``chunk_rows`` sets the device working set (rows per uploaded slab).
    Wrapping releases the index's device layout; the index lays itself out
    again from its host copy at its next in-memory search."""

    def __init__(self, index: IvfRabitqIndex, chunk_rows: int = 1 << 20):
        self.index = index
        # fused chunks stream packed 1-bit planes; the "packed" scan has no
        # chunked variant and takes the dense bf16 scan
        index.scan_dtype = index._plan.fit(index.scan_dtype)
        self._scan_dtype = "bf16" if index.scan_dtype == "packed" else index.scan_dtype
        self._fused = is_fused(self._scan_dtype)
        h = index.host  # downloads the host copy of a trained index once
        n = len(index)
        unit = TN if self._fused else 128
        chunk_rows = max(2 * unit, (chunk_rows // unit) * unit)
        self.chunk_rows = chunk_rows
        self.device = resolve_device(index.device)  # raises where the card is missing

        chunks = assemble_host_chunks(
            n=n, ex_bits=index.ex_bits, binary=h.binary_bits, ex=h.ex_codes, f_add=h.f_add,
            f_rescale=h.f_rescale, f_error=h.f_error, f_add_ex=h.f_add_ex,
            f_rescale_ex=h.f_rescale_ex, cluster_sizes=np.diff(h.cluster_offsets), ids=h.ids,
            chunk_rows=chunk_rows, fused=self._fused,
        )
        pin = self.device.type == "cuda"
        self._chunks = []
        while chunks:  # one slab's numpy arrays at a time become (pinned) tensors
            c = chunks.pop(0)
            self._chunks.append(
                {k: torch.from_numpy(v).pin_memory() if pin else torch.from_numpy(v)
                 for k, v in c.items()}
            )
        self._centroids = torch.tensor(h.centroids, dtype=torch.float32, device=self.device)
        # the compaction budget, valid for every chunk's own slice of the rows
        self._plan = index._plan.sliced(
            [(s, min(s + chunk_rows, n)) for s in range(0, n, chunk_rows)])
        self._copy_stream = None
        # release the wrapped index's device planes: the point of this tier
        # is that they do not fit. The host copy stays (save, fetch, and the
        # index's own re-layout)
        index._layout = None
        index._plan.reset()

    @property
    def n_chunks(self) -> int:
        return len(self._chunks)

    def _uploads(self):
        """Yield each chunk's tensors on the device, in order. On the card:
        copies on a side stream from pinned memory, chunk i+1's issued once
        chunk i's scan is queued (the caller queues it between two steps of
        this generator) and chunk i-1's has finished."""
        if self.device.type != "cuda":
            yield from self._chunks
            return
        compute = torch.cuda.current_stream(self.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        copy = self._copy_stream

        def stage(chunk):
            with torch.cuda.stream(copy):
                dev = {k: v.to(self.device, non_blocking=True) for k, v in chunk.items()}
                ready = torch.cuda.Event()
                ready.record(copy)
            return dev, ready

        staged = stage(self._chunks[0])
        prev_done = None
        for i in range(len(self._chunks)):
            cur, ready = staged
            staged = None
            compute.wait_event(ready)
            for t in cur.values():
                t.record_stream(compute)
            yield cur
            del cur  # freed once the scan queued behind it has run
            done = torch.cuda.Event()
            done.record(compute)
            if i + 1 < len(self._chunks):
                if prev_done is not None:
                    prev_done.synchronize()  # chunk i-1's slab is free again
                staged = stage(self._chunks[i + 1])
            prev_done = done

    def _scan_chunk(self, cur: dict, q_rot, params: SearchParams, allowed, max_tiles, probe_k):
        """Queue one chunk's scan; returns its device (ids, dists)
        ``[B_pad, top_k]``."""
        index = self.index
        row_allowed = cur["valid"]
        if allowed is not None:
            row_allowed = row_allowed & _allowed_rows(cur["ids"], allowed)
        ex = cur["ex"]
        if self._fused and ex.shape[1] % 128:
            # width-pad as the in-memory layout does: zero columns change no
            # dot, and the re-rank's product gets the in-memory shape
            ex = torch.nn.functional.pad(ex, (0, (-ex.shape[1]) % 128))
        return scan_kernel(
            q_rot, self._centroids, cur.get("binary"), ex, cur["f_add"], cur["f_rescale"],
            cur["f_error"], cur["f_add_ex"], cur["f_rescale_ex"], cur["cluster_of"],
            row_allowed, cur["ids"],
            nprobe=params.nprobe,
            packed=cur.get("packed"),
            fused_cblk=cur.get("cblk"),
            top_k=params.top_k, rerank=params.resolved_rerank(), metric=index.metric,
            ex_bits=index.ex_bits, scan_dtype=self._scan_dtype,
            approx_topk=index.approx_topk, max_tiles=max_tiles, probe_k=probe_k,
        )

    def _rotate(self, queries: np.ndarray):
        """(b, rotated queries ``[_pad_pow2(b), Dpad]`` on the device): f32
        up, zero-padded, the rotation (the FHT kernel on the card)."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        b = queries.shape[0]
        q = np.zeros((_pad_pow2(b), self.index.dim), np.float32)
        q[:b] = queries
        return b, self.index.rotator.rotate(torch.from_numpy(q).to(self.device))

    def batch_search_arrays(
        self,
        queries: np.ndarray,
        params: SearchParams,
        filter_ids: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(ids [B, k] int32 with -1 padding, dist [B, k] f32 internal
        distances). ``filter_ids`` restricts results to the given vector ids
        (an id array or a bool mask over the id domain, ``ivf.rs:1723-1730``):
        each chunk's rows are masked by their own ids."""
        b, q_rot = self._rotate(queries)
        allowed = None
        if filter_ids is not None:
            table = allowed_id_table(filter_ids, int(self.index.host.ids.max(initial=0)))
            allowed = torch.from_numpy(table).to(self.device)
        max_tiles = self._plan.max_tiles(self._scan_dtype, params.nprobe)
        probe_k = probe_k_bucket(params.nprobe, self.index.cluster_count(), self.index.scan_dtype)
        pending = [
            self._scan_chunk(cur, q_rot, params, allowed, max_tiles, probe_k)
            for cur in self._uploads()
        ]
        # one fetch for all chunks, then the host merge (the JAX package's
        # argsort on the same arrays, so that ties fall alike)
        merged_ids = torch.cat([p[0] for p in pending], dim=1).cpu().numpy()[:b]
        merged_d = torch.cat([p[1] for p in pending], dim=1).cpu().numpy()[:b]
        order = np.argsort(merged_d, axis=1)[:, : params.top_k]
        return (
            np.take_along_axis(merged_ids, order, axis=1),
            np.take_along_axis(merged_d, order, axis=1),
        )

    def batch_search(
        self,
        queries: np.ndarray,
        params: SearchParams,
        filter_ids: np.ndarray | None = None,
    ) -> list[list[SearchResult]]:
        ids, dists = self.batch_search_arrays(queries, params, filter_ids)
        out = []
        for row_ids, row_d in zip(ids, dists):
            hits = []
            for i, dd in zip(row_ids, row_d):
                if i < 0 or not np.isfinite(dd):
                    continue
                score = float(dd) if self.index.metric is Metric.L2 else float(-dd)
                hits.append(SearchResult(id=int(i), score=score))
            out.append(hits)
        return out


def _allowed_rows(ids: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """Per row, whether its id is in the allowed-id table (padding rows, id
    -1, and ids past the table's end are not)."""
    idx = ids.to(torch.int64)
    in_range = (idx >= 0) & (idx < allowed.shape[0])
    if allowed.shape[0] == 0:
        return in_range
    return in_range & allowed[idx.clamp(0, allowed.shape[0] - 1)]
