"""IVF + RaBitQ index on the card (port of ``rabitq_tpu/index/ivf.py``).

Build: k-means on the device (``ops/kmeans.py``), FhtKac rotation (the FHT
kernel), residual quantization in row chunks (``index/build.py``) and the
device layout (``index/layout.py``): cluster-sorted for the fused scans,
pseudorandomly permuted for the dense and packed ones. Search: the index's
fused search (``index/scan.make_fused_search``: decode, rotation and
``scan_kernel`` of a query block, one CUDA graph replay on the card), routed
as the reference routes it.

``scan_dtype`` "fused"/"fused8" takes the EXACT scan for ``total_bits`` 2..7
(``ex_bits`` 1..6, the TOTAL int8 plane) and planes up to 2560 columns, the
two-stage fused scan otherwise (through 3072 columns with bf16 queries,
7168 with int8 ones), and drops to "bf16" with a warning beyond that or
where a row tile would span more than 128 clusters. "f32", "bf16", "int8"
and "packed" are the dense scans. Assigning ``scan_dtype`` after
construction re-lays the index on the device at the next search.

The index's ``scan_plan.ScanPlan`` makes that choice, the compaction and
gather budgets among it, and reads the JAX package's experiment switches
from the environment at each call.

Persistence is the byte-compatible RBQ1 v3 format (``io/persistence.py``).

Spans (``utils/profiling.py``): a public search is the root ``ivf.search``
or ``ivf.batch``, with ``serve.encode`` (on the card with ``serve.copy_in``
inside; ``scan.QueryStage``), ``serve.copy_in`` (on the CPU),
``search.dispatch`` (with ``graph.replay``), ``serve.fetch`` and
``serve.results`` inside; ``train`` is ``ivf.train``, with ``build.upload``,
``kmeans`` (``kmeans.init``, ``kmeans.lloyd``, ``kmeans.assign``) and
``build.quantize``, whose durations are the build report's seconds.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..errors import DimensionMismatch, EmptyIndex, InvalidConfig
from ..ops import kmeans as kmeans_ops
from ..ops.fused_scan import TN
from ..ops.quantize import compute_const_scaling_factor
from ..ops.rotation import Rotator, deserialize_rotator, make_rotator
from ..types import Metric, RotatorType, SearchDiagnostics, SearchParams, SearchResult
from ..utils.device import resolve_device, synchronize
from ..utils.profiling import Span, span
from ..utils.transfer import upload_dataset
from .build import build_codes_device, exact_t_rows
from .layout import DeviceLayout, assemble_device_layout, host_order_planes
from .scan import (
    QueryStage,
    _fetch,
    _pad_pow2,
    is_fused,
    make_fused_search,
    probe_k_bucket,
    serve_pipelined,
)
from .scan_plan import ScanPlan


def allowed_id_table(filter_ids: np.ndarray, max_id: int) -> np.ndarray:
    """Allowed-id set (id array or bool mask over the id domain) -> bool
    lookup over [0, max_id] (``ivf.rs:1723-1730``)."""
    filter_ids = np.asarray(filter_ids)
    if filter_ids.dtype == bool:
        return filter_ids
    table = np.zeros(max_id + 1, bool)
    in_range = filter_ids[(filter_ids >= 0) & (filter_ids <= max_id)]
    table[in_range.astype(np.int64)] = True
    return table


@dataclass
class HostCodes:
    """Host copy of an index's codes, in cluster-sorted row order."""

    binary_bits: np.ndarray  # [N, Dpad] uint8 {0,1}
    ex_codes: np.ndarray  # [N, Dpad] uint16
    f_add: np.ndarray  # [N] f32
    f_rescale: np.ndarray
    f_error: np.ndarray
    f_add_ex: np.ndarray
    f_rescale_ex: np.ndarray
    delta: np.ndarray
    vl: np.ndarray
    ids: np.ndarray  # [N] int64 original vector ids
    cluster_offsets: np.ndarray  # [C+1] int64 row ranges per cluster
    centroids: np.ndarray  # [C, Dpad] f32 (rotated space)


class IvfRabitqIndex:
    def __init__(
        self,
        dim: int,
        padded_dim: int,
        metric: Metric,
        rotator: Rotator,
        ex_bits: int,
        host: HostCodes | None = None,
        scan_dtype: str = "bf16",
        approx_topk: bool | None = None,
        *,
        device: "str | torch.device | None" = None,
    ):
        """An index over ``host`` codes (laid out on ``device`` at first use;
        ``None``: the card), or an empty one that ``train`` / ``_build``
        fills."""
        self.dim = dim
        self.padded_dim = padded_dim
        self.metric = metric
        self.rotator = rotator
        self.ex_bits = ex_bits
        self.device = resolve_device(device)
        self.scan_dtype = scan_dtype
        # survivors of the dense scans come from the bf16 plane unless this
        # is off; the f32 oracle configuration defaults to f32 selection
        self.approx_topk = approx_topk if approx_topk is not None else scan_dtype != "f32"
        # query upload encoding, the query precision the scan decodes: "f32",
        # "bf16", "int8" (per-query scale) or "int4" (nibble pairs). On the CPU
        # numpy encodes on the host (int8 a quarter of the bytes, int4 an
        # eighth); on the card the raw f32 rows cross the link and a kernel
        # gives the same codes (scan.QueryStage)
        self.upload_dtype: str = "f32"
        self.build_report: dict | None = None
        # [N] original ids, cluster-sorted; [C+1] cluster row ranges
        self._ids: np.ndarray | None = host.ids if host is not None else None
        self._offsets: np.ndarray | None = host.cluster_offsets if host is not None else None
        self._layout: DeviceLayout | None = None
        self._layout_mode_built: str | None = None  # see _layout_mode
        self._host: HostCodes | None = host  # see host
        self._stage = QueryStage(self.device)  # the query blocks' way onto the device
        # decode + rotation + scan of a query block: one CUDA graph replay a
        # dispatch on the card (scan.make_fused_search)
        self._fused_scan = make_fused_search(self.rotator.rotate, dim=self.dim)
        # which scan serves a block, its budgets, and what the layout derives for it
        self._plan = ScanPlan(padded_dim, ex_bits, offsets=self._offsets,
                              graphs=self._fused_scan, device=self.device)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def train(
        cls,
        data: "np.ndarray | torch.Tensor",
        nlist: int,
        total_bits: int,
        metric: Metric = Metric.L2,
        rotator_type: RotatorType = RotatorType.FhtKacRotator,
        seed: int = 42,
        use_faster_config: bool = False,
        kmeans_iters: int = 30,
        scan_dtype: str = "bf16",
        data_upload: str = "auto",
        kmeans_dtype: str = "auto",
        kmeans_tol: float = 1e-3,
        device: "str | torch.device | None" = None,
    ) -> "IvfRabitqIndex":
        """Train from scratch (``ivf.rs:950-1021``): k-means on the raw
        rows, rotate, quantize residuals per cluster. ``data`` is a host
        array or a tensor (a tensor already on ``device`` is used as is).
        ``data_upload`` is the host rows' upload encoding
        (``utils/transfer.upload_dataset``: "auto" sends more than 512 MB as
        bf16). ``device=None`` means the card."""
        dev = resolve_device(device)
        n, dim = data.shape
        cls._validate_train_args(data, nlist, total_bits)
        with Span("ivf.train", rows=n, nlist=nlist) as total:
            with Span("build.upload") as upload:
                data_dev, upload_report = upload_dataset(data, data_upload, device=dev)
            if kmeans_dtype == "auto":
                kmeans_dtype = kmeans_ops.auto_assign_dtype(n, dim)
            with Span("kmeans", n=n, k=nlist) as kmeans:
                km = kmeans_ops.run_kmeans(
                    data_dev, nlist, niter=kmeans_iters, seed=seed,
                    assign_dtype=kmeans_dtype, tol=kmeans_tol, with_report=True,
                )
            with Span("build.quantize") as quantize:
                index = cls._build(
                    data, data_dev, km.centroids, km.assignments, total_bits, metric,
                    rotator_type, seed, use_faster_config, scan_dtype, dev,
                )
                synchronize(dev)
        index.build_report = {
            "upload": upload_report,
            "upload_s": upload.seconds,
            "kmeans_s": kmeans.seconds,
            "kmeans": {**km.report, "iters": km.iters},
            "quantize_s": quantize.seconds,
            "total_s": total.seconds,
        }
        return index

    @staticmethod
    def _validate_train_args(data, nlist: int, total_bits: int) -> None:
        """The checks of ``train`` (a host array or a tensor), shared with
        the sharded tier's ``ShardedIvfIndex.train``."""
        if math.prod(data.shape) == 0:
            raise InvalidConfig("training data must be non-empty")
        if nlist <= 0:
            raise InvalidConfig("nlist must be positive")
        if not (1 <= total_bits <= 16):
            raise InvalidConfig("total_bits must be between 1 and 16")
        if nlist > data.shape[0]:
            raise InvalidConfig("nlist cannot exceed number of vectors")

    @classmethod
    def train_with_clusters(
        cls,
        data: np.ndarray,
        centroids: np.ndarray,
        assignments: np.ndarray,
        total_bits: int,
        metric: Metric = Metric.L2,
        rotator_type: RotatorType = RotatorType.FhtKacRotator,
        seed: int = 42,
        use_faster_config: bool = False,
        scan_dtype: str = "bf16",
        device: "str | torch.device | None" = None,
    ) -> "IvfRabitqIndex":
        """Build with an external clustering (``ivf.rs:1025-1103``)."""
        dev = resolve_device(device)
        data = np.ascontiguousarray(data, np.float32)
        centroids = np.ascontiguousarray(centroids, np.float32)
        assignments = np.asarray(assignments, np.int64)
        if data.size == 0:
            raise InvalidConfig("training data must be non-empty")
        if centroids.size == 0:
            raise InvalidConfig("centroids must be non-empty")
        if assignments.shape[0] != data.shape[0]:
            raise InvalidConfig("assignments length must match data length")
        if not (1 <= total_bits <= 16):
            raise InvalidConfig("total_bits must be between 1 and 16")
        if centroids.shape[1] != data.shape[1]:
            raise InvalidConfig("centroids must match the data dimensionality")
        if centroids.shape[0] > data.shape[0]:
            raise InvalidConfig("nlist cannot exceed number of vectors")
        if assignments.min(initial=0) < 0 or assignments.max(initial=0) >= centroids.shape[0]:
            raise InvalidConfig("assignments reference invalid cluster ids")
        return cls._build(
            data, torch.from_numpy(data).to(dev), torch.from_numpy(centroids).to(dev),
            assignments, total_bits, metric, rotator_type, seed, use_faster_config,
            scan_dtype, dev,
        )

    @classmethod
    def _build(
        cls, data, data_dev, centroids, assignments, total_bits, metric,
        rotator_type, seed, use_faster_config, scan_dtype, dev,
    ) -> "IvfRabitqIndex":
        n, dim = data_dev.shape
        nlist = centroids.shape[0]
        ex_bits = total_bits - 1
        rotator = make_rotator(dim, rotator_type, seed)
        padded_dim = rotator.padded_dim
        with Span("build.rotate_centroids"):
            rotated_centroids = rotator.rotate(centroids)

        # cluster-sorted row order, ascending original id within a cluster
        assignments = np.asarray(assignments, np.int64)
        order = np.argsort(assignments, kind="stable")
        sizes = np.bincount(assignments, minlength=nlist)
        offsets = np.zeros(nlist + 1, np.int64)
        np.cumsum(sizes, out=offsets[1:])

        t_const = 0.0
        t_rows = None
        if ex_bits > 0:
            if use_faster_config:
                t_const = compute_const_scaling_factor(padded_dim, ex_bits, seed, device=dev)
            else:
                # reference default: exact per-vector t sweep on the host
                host = data if isinstance(data, np.ndarray) else data_dev.cpu().numpy()
                with Span("build.exact_t"):
                    t_rows = exact_t_rows(
                        host, centroids.cpu().numpy(), assignments[order], order,
                        rotator, ex_bits,
                    )
        with Span("build.codes", rows=n):
            codes = build_codes_device(
                data_dev, rotated_centroids, assignments[order],
                rotator=rotator, ex_bits=ex_bits, metric=metric,
                use_t_const=use_faster_config, t_const=t_const, t_rows=t_rows,
                order=order,
            )
        index = cls(dim, padded_dim, metric, rotator, ex_bits, None, scan_dtype, device=dev)
        index._set_layout(
            ids=order.astype(np.int64), offsets=offsets, centroids=rotated_centroids,
            binary=codes["binary"], ex=codes["ex"], f_add=codes["f_add"],
            f_rescale=codes["f_rescale"], f_error=codes["f_error"],
            f_add_ex=codes["f_add_ex"], f_rescale_ex=codes["f_rescale_ex"],
            delta=codes["delta"], vl=codes["vl"],
        )
        return index

    @classmethod
    def from_host_arrays(
        cls,
        *,
        dim: int,
        padded_dim: int,
        metric: Metric,
        ex_bits: int,
        rotator_type: RotatorType,
        rotator_bytes: bytes,
        binary_bits: np.ndarray,  # [N, Dpad] uint8 {0,1}, cluster-sorted
        ex_codes: np.ndarray,  # [N, Dpad] raw ex codes
        f_add: np.ndarray,
        f_rescale: np.ndarray,
        f_error: np.ndarray,
        f_add_ex: np.ndarray,
        f_rescale_ex: np.ndarray,
        delta: np.ndarray,
        vl: np.ndarray,
        ids: np.ndarray,  # [N] original ids
        cluster_offsets: np.ndarray,  # [C+1] row ranges per cluster
        centroids: np.ndarray,  # [C, Dpad] rotated centroids
        scan_dtype: str = "bf16",
        approx_topk: bool | None = None,
        device: "str | torch.device | None" = None,
    ) -> "IvfRabitqIndex":
        """An index over existing codes: the JAX package's index state
        (``HostCodes`` plus the rotator's serialized bytes) as host arrays,
        carried across so both packages search the same codes, in the same
        device row order (the permuted layouts share the permutation)."""
        rotator = deserialize_rotator(dim, padded_dim, rotator_type, rotator_bytes)
        host = HostCodes(
            binary_bits=np.asarray(binary_bits, np.uint8), ex_codes=np.asarray(ex_codes, np.uint16),
            f_add=np.asarray(f_add, np.float32), f_rescale=np.asarray(f_rescale, np.float32),
            f_error=np.asarray(f_error, np.float32), f_add_ex=np.asarray(f_add_ex, np.float32),
            f_rescale_ex=np.asarray(f_rescale_ex, np.float32),
            delta=np.asarray(delta, np.float32), vl=np.asarray(vl, np.float32),
            ids=np.asarray(ids, np.int64), cluster_offsets=np.asarray(cluster_offsets, np.int64),
            centroids=np.asarray(centroids, np.float32),
        )
        index = cls(
            dim, padded_dim, metric, rotator, ex_bits, host, scan_dtype, approx_topk,
            device=device,
        )
        index._rematerialize()
        return index

    def _set_layout(self, *, ids, offsets, centroids, **planes) -> None:
        """Assemble the device layout of the current ``scan_dtype`` from
        cluster-sorted planes (host arrays or tensors)."""
        self._ids = ids
        self._offsets = offsets
        self._plan.reset(offsets)  # and the graphs: they read the old layout's tensors
        self.scan_dtype = self._plan.fit(self.scan_dtype)
        self._layout = assemble_device_layout(
            n=int(ids.shape[0]), ex_bits=self.ex_bits, cluster_sizes=np.diff(offsets),
            ids=ids, centroids=centroids, device=self.device, **planes,
            **self._layout_kwargs(),
        )
        self._layout_mode_built = self._layout_mode()

    def _layout_mode(self) -> str:
        """'sorted' (cluster-contiguous, TN-padded: the fused scans) or
        'perm' (pseudorandom scatter, 128-padded: the dense and packed
        scans)."""
        return "sorted" if is_fused(self.scan_dtype) else "perm"

    def _layout_kwargs(self) -> dict:
        if self._layout_mode() == "sorted":
            return {"permute": False, "row_pad": TN}
        return {}

    def _relayout(self) -> None:
        """Rebuild the device layout for the other layout mode, on the
        device, from the raw planes of the current one."""
        planes = host_order_planes(self._layout, len(self), self.padded_dim, self.ex_bits)
        centroids = self._layout.centroids
        self._layout = None
        self._set_layout(ids=self._ids, offsets=self._offsets, centroids=centroids, **planes)

    def _rematerialize(self) -> None:
        """Lay the index out on the device again from its host copy, in the
        current ``scan_dtype``'s layout mode."""
        h = self._host
        self._set_layout(
            ids=self._ids, offsets=self._offsets, centroids=h.centroids,
            binary=h.binary_bits, ex=h.ex_codes, f_add=h.f_add, f_rescale=h.f_rescale,
            f_error=h.f_error, f_add_ex=h.f_add_ex, f_rescale_ex=h.f_rescale_ex,
            delta=h.delta, vl=h.vl,
        )

    @property
    def host(self) -> HostCodes:
        """The codes as host arrays in cluster-sorted order: those the index
        was made from (``from_host_arrays``, a loaded file), or downloaded
        from the device layout once, at first use."""
        if self._host is None:
            if self._layout is None:
                raise EmptyIndex()
            with Span("ivf.download_host", n=len(self)):
                planes = host_order_planes(self._layout, len(self), self.padded_dim, self.ex_bits)
                self._host = HostCodes(
                    binary_bits=planes.pop("binary").cpu().numpy().astype(np.uint8),
                    ex_codes=planes.pop("ex").cpu().numpy().astype(np.uint16),
                    ids=self._ids, cluster_offsets=self._offsets,
                    centroids=self._layout.centroids.cpu().numpy(),
                    **{name: x.cpu().numpy() for name, x in planes.items()},
                )
        return self._host

    # ------------------------------------------------------------------
    # accessors
    # ------------------------------------------------------------------

    @property
    def layout(self) -> DeviceLayout:
        if self._layout is None:
            if self._host is None:
                raise EmptyIndex()
            self._rematerialize()  # the layout was released (the streamed tier)
        if self._layout_mode_built != self._layout_mode():
            self._relayout()  # scan_dtype was assigned since the layout was built
        return self._layout

    def __len__(self) -> int:
        return 0 if self._ids is None else int(self._ids.shape[0])

    @property
    def is_empty(self) -> bool:
        return len(self) == 0

    def cluster_count(self) -> int:
        return int(self._offsets.shape[0] - 1)

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    def search(self, query: np.ndarray, params: SearchParams) -> list[SearchResult]:
        """Single-query search (``ivf.rs:1705-1711``)."""
        with span("ivf.search", queries=1):
            queries = self._check_queries(np.asarray(query, np.float32)[None, :])
            return self._results(queries, params)[0]

    def search_filtered(
        self, query: np.ndarray, params: SearchParams, filter_ids: np.ndarray
    ) -> list[SearchResult]:
        """Filtered search (``ivf.rs:1723-1730``): only ids in ``filter_ids``
        (an id array or a bool mask over the id domain) may be returned."""
        with span("ivf.search", queries=1):
            queries = self._check_queries(np.asarray(query, np.float32)[None, :])
            return self._results(queries, params, filter_ids)[0]

    def batch_search(
        self,
        queries: np.ndarray,
        params: SearchParams,
        filter_ids: np.ndarray | None = None,
    ) -> list[list[SearchResult]]:
        with span("ivf.batch") as sp:
            queries = self._check_queries(queries)
            sp.add(queries=queries.shape[0])
            return self._results(queries, params, filter_ids)

    def _results(self, queries, params: SearchParams, filter_ids=None) -> list[list[SearchResult]]:
        """Result lists of checked queries."""
        ids, dists = self._search_arrays(queries, params, filter_ids)
        with span("serve.results"):
            out: list[list[SearchResult]] = []
            for row_ids, row_d in zip(ids, dists):
                hits = []
                for i, dd in zip(row_ids, row_d):
                    if i < 0 or not np.isfinite(dd):
                        continue
                    score = float(dd) if self.metric is Metric.L2 else float(-dd)
                    hits.append(SearchResult(id=int(i), score=score))
                out.append(hits)
        return out

    def _check_queries(self, queries) -> np.ndarray:
        if self.is_empty:
            raise EmptyIndex()
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, queries.shape[1])
        return queries

    def batch_search_arrays(
        self,
        queries: np.ndarray,
        params: SearchParams,
        filter_ids: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Array in, arrays out: (ids [B, k] int32 with -1 padding,
        dist [B, k] f32 internal distances)."""
        with span("ivf.batch") as sp:
            queries = self._check_queries(queries)
            sp.add(queries=queries.shape[0])
            return self._search_arrays(queries, params, filter_ids)

    def _search_arrays(self, queries, params: SearchParams, filter_ids=None):
        """``batch_search_arrays`` of checked queries."""
        b = queries.shape[0]
        if params.top_k <= 0:
            return np.full((b, 0), -1, np.int32), np.full((b, 0), np.inf, np.float32)
        row_allowed = self._scan_inputs(filter_ids)
        q, qscale = self._pad_queries(queries, _pad_pow2(b))
        ids, dists = self._dispatch_scan(q, qscale, params, row_allowed)
        with span("serve.fetch"):
            return ids.cpu().numpy()[:b], dists.cpu().numpy()[:b]

    def batch_search_arrays_pipelined(
        self,
        queries: np.ndarray,
        params: SearchParams,
        batch_size: int = 1024,
        filter_ids: np.ndarray | None = None,
        upload_block: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Search over many fixed-size blocks: each upload block is put on
        the device (on the card its raw rows are copied from the index's
        pinned staging block without blocking and encoded there) and its
        scans are queued behind it; the results are fetched once at the end.
        ``upload_block`` (>= batch_size) sets the copy granularity,
        ``batch_size`` the scan granularity. Results equal
        ``batch_search_arrays``."""
        with span("ivf.batch") as sp:
            queries = self._check_queries(queries)
            b_total = queries.shape[0]
            sp.add(queries=b_total)
            if params.top_k <= 0:
                return (
                    np.full((b_total, 0), -1, np.int32),
                    np.full((b_total, 0), np.inf, np.float32),
                )
            row_allowed = self._scan_inputs(filter_ids)
            return serve_pipelined(
                queries, batch_size, upload_block, self._pad_queries,
                lambda q, qscale, off, bs: self._dispatch_scan(
                    q, qscale, params, row_allowed, offset=off, sub_block=bs),
            )

    def upload_queries(self, queries: np.ndarray):
        """Encode the queries once with the current ``upload_dtype`` and keep
        them on the device: ``batch_search_resident`` then searches them
        again (a parameter sweep, say) with no query byte crossing the host
        link. Returns an opaque handle. Like the reference, this checks the
        queries' width only; an empty index refuses at the search."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, queries.shape[1])
        q, qscale = self._pad_queries(queries, _pad_pow2(queries.shape[0]))
        return q, qscale, queries.shape[0]

    def batch_search_resident(
        self,
        qcache,
        params: SearchParams,
        batch_size: int = 256,
        filter_ids: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """``batch_search_arrays`` over an ``upload_queries`` handle: each
        dispatch scans the ``batch_size``-row window of the resident block at
        its offset (``sub_block``). Results equal the upload paths' on the
        same ``upload_dtype``."""
        if self.is_empty:
            raise EmptyIndex()
        q, qscale, b_total = qcache
        if params.top_k <= 0:
            return (
                np.full((b_total, 0), -1, np.int32),
                np.full((b_total, 0), np.inf, np.float32),
            )
        with span("ivf.batch", queries=b_total):
            row_allowed = self._scan_inputs(filter_ids)
            bs = _pad_pow2(min(batch_size, q.shape[0]))
            pending = [
                self._dispatch_scan(q, qscale, params, row_allowed, offset=off, sub_block=bs)
                for off in range(0, b_total, bs)
            ]
            return _fetch(pending, b_total)

    def _scan_inputs(self, filter_ids: np.ndarray | None) -> torch.Tensor:
        """Bring the layout, the packed plane and the tile windows up to
        date for the current ``scan_dtype``; returns the row mask of the
        scan: valid rows, narrowed by the user filter."""
        self.scan_dtype = self._plan.fit(self.scan_dtype)
        lay = self.layout
        self._plan.prepare(lay, self.scan_dtype)
        row_allowed = lay.valid
        if filter_ids is not None:
            mask = torch.from_numpy(self._row_filter(filter_ids)).to(self.device)
            row_allowed = row_allowed & mask
        return row_allowed

    def _row_filter(self, filter_ids: np.ndarray) -> np.ndarray:
        """Allowed-id set -> per-row bool mask in the device row layout."""
        ids = self._ids
        n = ids.shape[0]
        allowed_of_id = allowed_id_table(filter_ids, int(ids.max(initial=0)))
        mask = np.zeros(self.layout.ids.shape[0], bool)
        idx = ids.astype(np.int64)
        safe = idx < allowed_of_id.shape[0]
        mask[:n][safe] = allowed_of_id[idx[safe]]
        return mask[self.layout.perm]

    def _pad_queries(self, queries: np.ndarray, b_pad: int):
        """(q, qscale | None) of ``queries`` padded to ``b_pad`` rows, on the
        index's device in the upload encoding (``scan.QueryStage``)."""
        return self._stage(queries, b_pad, self.dim, self.upload_dtype)

    def _dispatch_scan(
        self, q, qscale, params: SearchParams, row_allowed, offset=None, sub_block=None,
        diagnostics: bool = False,
    ):
        """Queue decode + rotation + scan of one padded query block through
        the index's fused search (one graph replay on the card); returns
        device tensors (callers fetch). With ``sub_block``, ``q`` is a
        resident upload block and the scan covers the window at ``offset``.
        The scan is the plan's choice (``ScanPlan.scan_kw``); ``diagnostics``
        takes the two-stage scan with its counters. The span
        ``search.dispatch`` covers it, down to the graph's input copies and
        output clones, with the plan's counts: ``k1_int8`` (never 1, since
        the rotation makes the query f32) and on the dense scans
        ``lb_pairs`` and ``survivors``."""
        with span("search.dispatch") as sp:
            lay = self.layout
            rerank = params.resolved_rerank()
            kw, counts = self._plan.scan_kw(
                self.scan_dtype, params.nprobe, q, qscale, rerank=rerank, block=sub_block,
                exact=not diagnostics, gather=not diagnostics)
            sp.add(**counts)
            return self._fused_scan(
                q, lay.centroids, lay.binary, lay.ex, lay.f_add, lay.f_rescale,
                lay.f_error, lay.f_add_ex, lay.f_rescale_ex, lay.cluster_of, row_allowed,
                lay.ids, qscale=qscale, offset=offset, sub_block=sub_block,
                nprobe=params.nprobe, top_k=params.top_k, rerank=rerank,
                metric=self.metric, ex_bits=self.ex_bits, scan_dtype=self.scan_dtype,
                approx_topk=self.approx_topk, with_diagnostics=diagnostics,
                probe_k=probe_k_bucket(params.nprobe, self.cluster_count(), self.scan_dtype),
                **kw,
            )

    def search_with_diagnostics(
        self, query: np.ndarray, params: SearchParams
    ) -> tuple[list[SearchResult], SearchDiagnostics]:
        """Search plus scan counters measured from the scan's own masks; on
        the fused paths, the bin kernel's offered-row counters (reference
        test accessor ``ivf.rs:2131-2140``). As in the reference, a fused
        index is measured through its two-stage scan, whose lower-bound cut
        is what ``skipped_by_lower_bound`` counts."""
        query = self._check_queries(query)[:1]
        row_allowed = self._scan_inputs(None)
        ids, dists, diag = self._dispatch_scan(
            torch.from_numpy(query).to(self.device), None, params, row_allowed, diagnostics=True)
        results = []
        for i, dd in zip(ids[0].tolist(), dists[0].tolist()):
            if i < 0 or not np.isfinite(dd):
                continue
            results.append(SearchResult(id=i, score=dd if self.metric is Metric.L2 else -dd))
        d = diag[0].tolist()
        return results, SearchDiagnostics(
            estimated=d[0], skipped_by_lower_bound=d[1], extended_evaluations=d[2]
        )

    # ------------------------------------------------------------------
    # embedding reconstruction (ivf.rs:1247-1307) and persistence
    # ------------------------------------------------------------------

    def fetch_embedding(self, vector_id: int) -> np.ndarray | None:
        """The stored vector ``vector_id`` rebuilt from its codes,
        ``centroid + delta * total_code + vl`` rotated back (the FHT kernel
        on the card); None for an unknown id."""
        h = self.host
        rows = np.flatnonzero(h.ids == vector_id)
        if rows.size == 0:
            return None
        row = int(rows[0])
        cluster = int(np.searchsorted(h.cluster_offsets, row, side="right") - 1)
        total_code = h.ex_codes[row].astype(np.float32) + h.binary_bits[row].astype(
            np.float32
        ) * float(1 << self.ex_bits)
        rec = h.centroids[cluster] + h.delta[row] * total_code + h.vl[row]
        out = self.rotator.inverse_rotate(torch.from_numpy(rec[None, :]).to(self.device))
        return out[0].cpu().numpy()

    def save_to_path(self, path) -> None:
        """Write the index as an RBQ1 v3 file (``io/persistence.py``)."""
        from ..io import persistence

        persistence.save_ivf(self, path)

    @classmethod
    def load_from_path(
        cls, path, scan_dtype: str = "bf16", device: "str | torch.device | None" = None
    ) -> "IvfRabitqIndex":
        """Read an RBQ1 v3 file; the index lays itself out on ``device``
        (None: the card) as a trained one does."""
        from ..io import persistence

        return persistence.load_ivf(path, scan_dtype=scan_dtype, device=device)
