"""The choice of scan for an index's query blocks, in one place.

``IvfRabitqIndex``, ``MstgIndex``, the streamed tier and the sharded one each
own a :class:`ScanPlan`. From the index's list sizes, plane width and code
width it decides whether a fused ``scan_dtype`` can serve the lists at all
(:meth:`~ScanPlan.fit`), whether the fused scan runs in EXACT mode, the
compacted walk's tile budget (valid for every row slice the owner's kernels
see: the whole index, the streamed chunks or the shards), the gather scan's
row budget and the locality-sort depth. It holds what a layout derives for
the fused scans and drops it, with the graphs that read it, in one
:meth:`~ScanPlan.reset`.

:func:`switches` alone reads the JAX package's experiment switches, at
each call and with its defaults: ``RABITQ_FUSED_EXACT=0`` (the two-stage
scan instead of the EXACT one), ``RABITQ_FUSED_COMPACT`` ("0": the dense
walk, "force": every tile listed), ``RABITQ_GATHER=1`` with
``RABITQ_GATHER_MAX`` (the gather scan, opt-in, declined above that many
rows a query; 16384) and ``RABITQ_LOCALITY`` (the locality-sort depth).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.fused_scan import (
    EXACT_MAX_WIDTH,
    TN,
    TWO_STAGE_MAX_WIDTH,
    TWO_STAGE_MAX_WIDTH_INT8,
    fused_geometry_ok,
    sliced_max_tiles,
    tile_cluster_blocks,
)
from ..ops.packed_scan import pack_bitplanes
from ..utils.logging import get_logger
from .layout import cluster_of_rows
from .scan import ex_plane_is_total, gather_budget_bucket, integer_grid, is_fused

_log = get_logger("scan_plan")


def switches() -> tuple[bool, str, int | None, int]:
    """The environment's scan switches, read now: (EXACT allowed, the
    compaction switch, the gather scan's row limit or None where it is off,
    the locality-sort depth)."""
    env = os.environ
    gather_max = None
    if env.get("RABITQ_GATHER", "0") == "1":
        gather_max = int(env.get("RABITQ_GATHER_MAX", "16384"))
    return (
        env.get("RABITQ_FUSED_EXACT", "1") != "0",
        env.get("RABITQ_FUSED_COMPACT", "1"),
        gather_max,
        int(env.get("RABITQ_LOCALITY", "1")),
    )


class ScanPlan:
    """The scan choice of one index. ``dim`` is the code plane's width
    before its 128-column padding; the EXACT and gather scans read TOTAL
    codes (``ex_bits`` 1..6 with ``refine_ex``); ``rotated``: queries reach
    the scan rotated (f32); ``offsets`` the lists' ``[C+1]`` row ranges;
    ``slices`` the ``(start, stop)`` row slices the owner's kernels each see
    (None: the whole index); ``graphs`` the owner's fused search, whose
    graphs :meth:`reset` drops."""

    def __init__(self, dim: int, ex_bits: int, *, refine_ex: bool = True, rotated: bool = True,
                 offsets=None, slices=None, graphs=None, device=None):
        self.dim = dim
        self.width = dim + (-dim) % 128
        self.ex_bits = ex_bits
        self.refine_ex = refine_ex
        self.total = refine_ex and ex_plane_is_total(ex_bits)
        self.rotated = rotated
        self.device = device
        self._slices = slices
        self._graphs = graphs
        self.offsets = None
        self.reset(offsets)

    def sliced(self, slices) -> "ScanPlan":
        """This plan over the same lists for kernels that each see one of
        ``slices`` (the streamed tier's chunks, the sharded tier's shards)."""
        return ScanPlan(self.dim, self.ex_bits, refine_ex=self.refine_ex, rotated=self.rotated,
                        offsets=self.offsets, slices=slices)

    def reset(self, offsets=None) -> None:
        """Drop the tensors derived from a layout and the graphs that read
        them; with ``offsets`` (new lists), also what the list sizes
        decided."""
        if offsets is not None:
            self.offsets = offsets
            self.sizes = np.diff(offsets)
            self.rows = int(self.sizes.sum())
            self.plane_tiles = -(-max(self.rows, 1) // TN)
            self._geometry_ok: bool | None = None
            self._max_tiles: dict = {}
        self.plane_rows: int | None = None  # the layout's padded rows (prepare)
        self.packed: torch.Tensor | None = None  # bit planes ("packed" and fused)
        self.c_blk: torch.Tensor | None = None  # the tiles' cluster windows (fused)
        self._cl_ranges: tuple[torch.Tensor, torch.Tensor] | None = None
        if self._graphs is not None:
            self._graphs.clear()  # the graphs read the old layout's tensors

    def fit(self, scan_dtype: str) -> str:
        """``scan_dtype``, or "bf16" with a warning where the fused kernels
        cannot serve these lists: a row tile would span more than 128 lists,
        or the plane is wider than the two-stage fused scan serves."""
        if not is_fused(scan_dtype):
            return scan_dtype
        if self._geometry_ok is None:
            self._geometry_ok = fused_geometry_ok(self.sizes)
        limit = TWO_STAGE_MAX_WIDTH_INT8 if scan_dtype == "fused8" else TWO_STAGE_MAX_WIDTH
        if self._geometry_ok and self.width <= limit:
            return scan_dtype
        _log.warning(
            "list geometry unsuited for scan_dtype=%r (a row tile would span >128 lists, "
            "or the plane is wider than the two-stage fused scan serves); falling back to bf16",
            scan_dtype,
        )
        return "bf16"

    def fused_exact(self, scan_dtype: str, sw=None) -> bool:
        """Whether the fused scan runs in EXACT mode: the TOTAL refine plane
        within ``EXACT_MAX_WIDTH``, unless ``RABITQ_FUSED_EXACT=0``."""
        exact_on = (sw or switches())[0]
        return exact_on and is_fused(scan_dtype) and self.total and self.width <= EXACT_MAX_WIDTH

    def max_tiles(self, scan_dtype: str, nprobe, sw=None) -> int | None:
        """Probed-tile budget of the bin kernel's compacted walk, or None for
        the dense walk: the safe bound of a block's probed tiles, bucketed
        to a power of two, where the expected count is under 0.6 of a
        slice's tiles (``sliced_max_tiles``; cached per nprobe).
        ``RABITQ_FUSED_COMPACT=0`` turns compaction off, ``=force`` lists
        every tile of a slice."""
        compact = (sw or switches())[1]
        if compact == "0" or not is_fused(scan_dtype) or not isinstance(nprobe, (int, np.integer)):
            return None
        slices = self._slices or [(0, self.rows)]
        if compact == "force":
            return max(-(-(e - s) // TN) for s, e in slices)
        nprobe = int(nprobe)
        if nprobe not in self._max_tiles:
            self._max_tiles[nprobe] = sliced_max_tiles(self.sizes, nprobe, slices)
        return self._max_tiles[nprobe]

    def gather_rows(self, scan_dtype: str, nprobe, sw=None) -> int | None:
        """Per-query row budget of the gather scan, or None for the bin
        scans. Opt-in by ``RABITQ_GATHER=1``: the gather scan scores every
        probed row exactly, and needs the cluster-sorted layout and the
        TOTAL refine plane. The budget is the sum of the ``nprobe`` largest
        lists rounded up to a power of two (pruning only shrinks the probed
        set); it is declined above ``RABITQ_GATHER_MAX`` or at half the
        rows."""
        limit = (sw or switches())[2]
        if limit is None or not (is_fused(scan_dtype) and self.total):
            return None
        bucket = gather_budget_bucket(self.sizes, nprobe)
        if bucket is None or bucket > limit or 2 * bucket >= self.rows:
            return None
        return bucket

    def prepare(self, lay, scan_dtype: str) -> None:
        """Bring the packed plane and the tiles' cluster windows of layout
        ``lay`` up to date for ``scan_dtype``."""
        self.plane_rows = int(lay.ids.shape[0])
        fused = is_fused(scan_dtype)
        if (fused or scan_dtype == "packed") and self.packed is None:
            self.packed = lay.packed if lay.packed is not None else pack_bitplanes(
                lay.binary, self.dim)  # fused layouts pre-pack
        if fused and self.c_blk is None:
            n_pad = int(lay.ids.shape[0])
            c_blk = tile_cluster_blocks(
                cluster_of_rows(self.sizes, n_pad), np.arange(n_pad) < self.rows)
            self.c_blk = torch.from_numpy(c_blk).to(self.device)

    def scan_kw(self, scan_dtype: str, nprobe, q, qscale, *, rerank: int, block=None,
                exact=True, gather=True):
        """The fused search's keywords for one query block (``q`` with its
        ``qscale``, as uploaded; ``block`` its padded rows where the scan
        covers a window of ``q``) and the counts of its ``search.dispatch``
        span: ``k1_int8``, whether its bin scan takes the query as int8
        codes (an un-rotated ``scan.integer_grid`` on the EXACT bin scan);
        on the dense scans also ``lb_pairs``, the padded queries times the
        plane rows stage 1 scores, and ``survivors``, the padded queries
        times the ``rerank`` rows the survivor cut keeps. The counts come
        from shapes the host holds. ``exact`` / ``gather`` False keep the
        block off the EXACT and gather scans (diagnostics measure the
        two-stage scan)."""
        sw = switches()
        fused = is_fused(scan_dtype)
        fused_exact = exact and self.fused_exact(scan_dtype, sw)
        gather_rows = self.gather_rows(scan_dtype, nprobe, sw) if gather else None
        kw = {
            "fused_exact": fused_exact, "gather_rows": gather_rows, "locality_depth": sw[3],
            "packed": self.packed if (fused or scan_dtype == "packed") else None,
            "fused_cblk": self.c_blk if fused else None,
        }
        if gather_rows is None:
            kw["max_tiles"] = self.max_tiles(scan_dtype, nprobe, sw)
        else:
            if self._cl_ranges is None:
                offsets = torch.from_numpy(self.offsets).to(self.device)
                self._cl_ranges = (offsets[:-1], offsets[1:] - offsets[:-1])
            kw["cl_starts"], kw["cl_sizes"] = self._cl_ranges
        k1_int8 = (gather_rows is None and fused_exact and not self.rotated
                   and integer_grid(q, qscale))
        counts = {"k1_int8": int(k1_int8)}
        if not fused:
            b = int(q.shape[0] if block is None else block)
            counts["lb_pairs"] = b * self.plane_rows
            counts["survivors"] = b * min(rerank, self.plane_rows)
        return kw, counts
