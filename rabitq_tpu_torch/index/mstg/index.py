"""MSTG (Multi-Scale Tree Graph) index on the card (port of
``rabitq_tpu/index/mstg/index.py``).

SPANN-style, after the reference ``MstgIndex`` (lqhl/rabitq-rs
``src/mstg/``): hierarchical balanced clustering (``clustering.py``) ->
closure multi-assignment (``closure.py``) -> per-posting-list RaBitQ
quantization (``index/build.py``; in the original space, or rotated by an
FhtKac rotator with ``config.use_rotator``) -> centroid navigation -> dynamic
pruning -> the scan of the selected posting lists.

As in the JAX package:

* navigation is an exact top-``ef_search`` centroid ranking by L2 (an HNSW
  graph is built only for the reference-format files, ``ref_io.py``);
* posting lists are one flat row space served by ``index/scan.scan_kernel``
  through the index's fused search (``index/scan.make_fused_search``:
  decode, rotation and scan, one CUDA graph replay on the card), with
  ``use_prune_epsilon``, ``clamp_l2`` and ``centroid_select_l2`` and a
  layout whose ``f_error`` is zero, as the reference's scan zeroes it
  (``mstg/index.rs:285-299``). ``scan_dtype`` picks the scan and the layout
  as for ``IvfRabitqIndex``; the fused scans reach the bin-scan kernels, the
  rotator the FHT kernel;
* closure replication puts a vector in several lists, so a scan returns a
  replication-sized candidate set and the device keeps the first (best)
  occurrence of each id (``_dedup_topk_device``); an index without replicas
  skips both;
* with ``config.refine_ex`` (default) survivors are re-scored with the
  extended codes.

``len(index)`` is the largest id + 1; ``total_rows`` counts the replicas,
and the scans' tile and gather budgets count rows. The host copy of a built
index is downloaded from the device layout at first use
(``layout.host_order_planes``). Files: the native single-file format v1003
(v1001/v1002 read), byte-identical to the JAX package's, and the reference's
bincode v1 set (``ref_io.py``).

Spans (``utils/profiling.py``), with the IVF index's names where the step is
the same: a public search is the root ``mstg.search`` or ``mstg.batch``
(``queries``, ``ef``, ``lists``), with ``serve.encode``, ``search.dispatch``
(``tiles``, ``plane_tiles``, ``dense``, ``rerank``, ``dedup``; ``mstg.dedup``
and ``graph.replay`` inside), ``serve.fetch`` and ``serve.results`` inside;
``build`` is ``mstg.build``, with ``build.upload``, ``mstg.clustering``,
``mstg.closure`` and ``mstg.quantize``, whose durations are the build
report's seconds.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from ...errors import DimensionMismatch, EmptyIndex, InvalidConfig, InvalidPersistence
from ...ops import packing
from ...ops.fused_scan import TN
from ...ops.kmeans import auto_assign_dtype
from ...ops.quantize import compute_const_scaling_factor
from ...ops.rotation import FhtKacRotator, make_rotator
from ...types import Metric, RotatorType, SearchDiagnostics, SearchResult
from ...utils.device import resolve_device, synchronize
from ...utils.profiling import Span, span
from ...utils.transfer import upload_dataset
from ..build import build_codes_device, exact_t_rows
from ..layout import assemble_device_layout, host_order_planes
from ..scan import (
    QueryStage,
    _fetch,
    _pad_pow2,
    is_fused,
    make_fused_search,
    probe_k_bucket,
    serve_pipelined,
    sort_result_rows,
)
from ..scan_plan import ScanPlan
from .clustering import hierarchical_cluster
from .closure import closure_assign
from .config import MstgConfig, MstgSearchParams, ScalarPrecision
from .metadata import PostingListDirectory
from .scalar_quant import apply_centroid_precision, dequantize_centroids, quantize_centroids

_MAGIC = b"MSTG"
# native single-file format (distinct from the reference's bincode-v1
# multi-file format); v1003 stores centroids in their configured scalar
# precision (bf16 bits / fp16 halves / int8+scale) instead of always f32
_VERSION = 1003
_HEADER = "<IBBBBffIIfIB"
_PLANE_FIELDS = ("binary", "ex", "f_add", "f_rescale", "f_add_ex", "f_rescale_ex")
_SMALL_FIELDS = (
    "f_add", "f_rescale", "f_error", "f_add_ex", "f_rescale_ex", "delta", "vl", "residual_norm",
)


@dataclass
class MstgHost:
    binary_bits: np.ndarray  # [R, dim] uint8 (R = total rows incl. replicas)
    ex_codes: np.ndarray  # [R, dim] uint16
    f_add: np.ndarray
    f_rescale: np.ndarray
    f_add_ex: np.ndarray
    f_rescale_ex: np.ndarray
    delta: np.ndarray
    vl: np.ndarray
    ids: np.ndarray  # [R] int64 original vector id per row
    list_offsets: np.ndarray  # [C+1] row ranges per posting list
    centroids: np.ndarray  # [C, dim] f32
    # MSTG's own scan zeroes f_error (mstg/index.rs:285), but the reference
    # serializes both per vector (quantizer.rs:82-86) — kept for the
    # reference-format writer (None on v1001/v1002 loads -> written as zeros)
    f_error: np.ndarray | None = None
    residual_norm: np.ndarray | None = None


class MstgIndex:
    def __init__(
        self,
        config: MstgConfig,
        dim: int,
        host: MstgHost | None,
        scan_dtype: str = "bf16",
        approx_topk: bool | None = None,
        rotator: FhtKacRotator | None = None,
        *,
        device: "str | torch.device | None" = None,
        _meta: dict | None = None,
        _codes_dev: dict | None = None,
    ):
        self.config = config
        self.dim = dim  # original (query) dimension
        self.rotator = rotator  # optional FhtKac (config.use_rotator)
        # quantization-space dimension: padded when rotating
        self.quant_dim = rotator.padded_dim if rotator is not None else dim
        self.device = resolve_device(device)
        # A built index keeps its code planes on the device (``_codes_dev``,
        # then the layout); the host copy is downloaded at first use
        self._host = host
        if host is not None:
            self._ids = host.ids
            self._offsets = host.list_offsets
            self._centroids_np = host.centroids
            self._small = None
        else:
            if _meta is None or _codes_dev is None:
                raise ValueError("an index without host arrays needs _meta and _codes_dev")
            self._ids = _meta["ids"]
            self._offsets = _meta["list_offsets"]
            self._centroids_np = _meta["centroids"]
            self._small = _meta["small"]  # [R] per-row fields for MstgHost
        self._codes_dev = _codes_dev
        self._derive_from_lists()
        self.scan_dtype = scan_dtype
        self.approx_topk = approx_topk if approx_topk is not None else scan_dtype != "f32"
        # query upload encoding for serving, as IvfRabitqIndex.upload_dtype
        self.upload_dtype: str = "f32"
        self.build_report: dict | None = None
        self._layout = None
        self._layout_mode_built: str | None = None
        # decode + optional rotation + scan of a query block: one CUDA graph
        # replay a dispatch on the card (scan.make_fused_search)
        self._fused_scan = make_fused_search(
            rotator.rotate if rotator is not None else None, dim=self.dim
        )
        # which scan serves a block, its budgets, and what the layout derives
        # for it; the budgets count rows, replicas included
        self._plan = ScanPlan(
            self.quant_dim, config.rabitq_bits - 1, refine_ex=config.refine_ex,
            rotated=rotator is not None, offsets=self._offsets, graphs=self._fused_scan,
            device=self.device,
        )
        self._stage = QueryStage(self.device)  # the query blocks' way onto the device

    def _derive_from_lists(self) -> None:
        """What the index derives from its ids and list offsets."""
        # distinct vectors: the largest id + 1 (read at every dispatch)
        self._n_vectors = int(self._ids.max()) + 1 if self._ids.size else 0
        self._has_repl: bool | None = None  # see _has_replicas
        # disk-tier scaffolding (mstg/metadata.rs parity); all lists resident
        row_bytes = self.quant_dim * 2 if self._ids.size else 0
        self.directory = PostingListDirectory.from_offsets(self._offsets, row_bytes)

    @property
    def host(self) -> MstgHost:
        """Host code arrays; a built index downloads them from its device
        layout on first access."""
        if self._host is None:
            self._host = self._download_host()
        return self._host

    @host.setter
    def host(self, value: MstgHost) -> None:
        """Replace the host arrays and what is derived from them; a device
        layout already built stays as it is (as in the JAX package)."""
        self._host = value
        self._ids = value.ids
        self._offsets = value.list_offsets
        self._centroids_np = value.centroids
        self._derive_from_lists()

    def _download_host(self) -> MstgHost:
        """MstgHost from the device layout: the big code planes through the
        layout's inverse, the [R] per-row fields kept on the host at build."""
        with Span("mstg.download_host", rows=self.total_rows):
            planes = host_order_planes(
                self.layout, self.total_rows, self.quant_dim, self.config.rabitq_bits - 1
            )
            s = self._small
            return MstgHost(
                binary_bits=planes["binary"].cpu().numpy().astype(np.uint8),
                ex_codes=planes["ex"].cpu().numpy().astype(np.uint16),
                f_add=s["f_add"], f_rescale=s["f_rescale"], f_add_ex=s["f_add_ex"],
                f_rescale_ex=s["f_rescale_ex"], delta=s["delta"], vl=s["vl"],
                ids=self._ids, list_offsets=self._offsets, centroids=self._centroids_np,
                f_error=s["f_error"], residual_norm=s["residual_norm"],
            )

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def build(
        cls,
        data,
        config: MstgConfig | None = None,
        seed: int = 42,
        scan_dtype: str = "bf16",
        device: "str | torch.device | None" = None,
    ) -> "MstgIndex":
        """Build from rows (``mstg/index.rs:16-140``): ``data`` is a host
        array or a tensor (one already on ``device`` is used as is; host rows
        cross with ``config.data_upload``). ``device=None`` means the card.
        ``build_report`` holds the seconds of each phase."""
        config = config or MstgConfig()
        dev = resolve_device(device)
        if len(data.shape) != 2 or data.shape[0] == 0 or data.shape[1] == 0:
            raise InvalidConfig("cannot build index from empty data")
        n, orig_dim = data.shape
        with Span("mstg.build", rows=n) as total:
            with Span("build.upload") as upload:
                data_dev, upload_report = upload_dataset(data, config.data_upload, device=dev)
            rotator = None
            if config.use_rotator:
                # clustering and closure run on the original rows (the rotation
                # is an isometry); the codes and the stored centroids are rotated
                rotator = make_rotator(orig_dim, RotatorType.FhtKacRotator, seed)
            dim = rotator.padded_dim if rotator is not None else orig_dim

            # step 1: hierarchical balanced clustering
            with Span("mstg.clustering", n=n) as clustering:
                clusters = hierarchical_cluster(
                    data, max_cluster_size=config.max_posting_size,
                    branching_factor=config.branching_factor,
                    balance_weight=config.balance_weight, seed=seed, data_dev=data_dev,
                    refine_iters=config.refine_iters, assign_dtype=auto_assign_dtype(n, orig_dim),
                )

            # step 2: closure assignment with the RNG rule
            with Span("mstg.closure", C=len(clusters.centroids)) as closure:
                members = closure_assign(
                    data, clusters.centroids, config.closure_epsilon, config.max_replicas,
                    data_dev=data_dev,
                )

            # step 3: per-posting-list residual quantization, from the STORED
            # centroids rounded through the configured precision: the residual
            # base, the centroid scoring operands and the file bytes
            with Span("mstg.quantize") as quantize:
                centroids = clusters.centroids
                if rotator is not None:
                    centroids = rotator.rotate(torch.from_numpy(centroids).to(dev)).cpu().numpy()
                centroids = apply_centroid_precision(centroids, config.centroid_precision)
                ex_bits = config.rabitq_bits - 1
                t_const = 0.0
                t_rows = None
                if ex_bits > 0 and config.faster_config:
                    t_const = compute_const_scaling_factor(dim, ex_bits, seed, device=dev)
                sizes = [m.size for m in members]
                offsets = np.zeros(len(members) + 1, np.int64)
                np.cumsum(sizes, out=offsets[1:])
                ids = np.concatenate(members) if members else np.zeros(0, np.int64)
                row_list = np.repeat(np.arange(len(members), dtype=np.int32), sizes)
                quantize.add(rows=ids.shape[0])
                if ex_bits > 0 and not config.faster_config:
                    # reference default: exact per-vector t sweep on the host
                    host = data if isinstance(data, np.ndarray) else data_dev.cpu().numpy()
                    if rotator is None:
                        t_rows = exact_t_rows(host, centroids, row_list, ids, None, ex_bits)
                    else:
                        t_rows = exact_t_rows(
                            host, None, row_list, ids, rotator, ex_bits,
                            centroids_rotated=centroids,
                        )
                codes = build_codes_device(
                    data_dev, torch.from_numpy(centroids).to(dev), row_list, rotator=rotator,
                    ex_bits=ex_bits, metric=config.metric, use_t_const=config.faster_config,
                    t_const=t_const, t_rows=t_rows, order=ids,
                )
                # the [R] per-row fields come to the host now; the code planes
                # stay on the device and feed the layout
                small = {k: codes[k].cpu().numpy() for k in _SMALL_FIELDS}
                synchronize(dev)
            total.add(lists=len(members), replication=ids.shape[0] / max(n, 1))
        meta = {"ids": ids, "list_offsets": offsets, "centroids": centroids, "small": small}
        index = cls(
            config, orig_dim, None, scan_dtype, rotator=rotator, device=dev,
            _meta=meta, _codes_dev=codes,
        )
        index.build_report = {
            "upload": upload_report,
            "upload_s": upload.seconds,
            "clustering_s": clustering.seconds,
            "clustering": clusters.report,
            "closure_s": closure.seconds,
            "quantize_s": quantize.seconds,
            "total_s": total.seconds,
        }
        return index

    @classmethod
    def from_host_arrays(
        cls,
        *,
        config: MstgConfig,
        dim: int,
        binary_bits: np.ndarray,  # [R, quant_dim] {0,1}, list-sorted
        ex_codes: np.ndarray,  # [R, quant_dim] raw ex codes
        f_add: np.ndarray,
        f_rescale: np.ndarray,
        f_add_ex: np.ndarray,
        f_rescale_ex: np.ndarray,
        delta: np.ndarray,
        vl: np.ndarray,
        ids: np.ndarray,  # [R] original ids
        list_offsets: np.ndarray,  # [C+1] row ranges per posting list
        centroids: np.ndarray,  # [C, quant_dim] stored centroids
        f_error: np.ndarray | None = None,
        residual_norm: np.ndarray | None = None,
        rotator_bytes: bytes = b"",
        scan_dtype: str = "bf16",
        approx_topk: bool | None = None,
        device: "str | torch.device | None" = None,
    ) -> "MstgIndex":
        """An index over existing codes: the JAX package's ``MstgIndex``
        state (its ``host`` fields as host arrays, its config's values, and
        ``rotator.serialize()``, empty for no rotator) carried across, so
        both packages search the same codes in the same device row order."""
        centroids = np.asarray(centroids, np.float32)
        rotator = None
        if rotator_bytes:
            rotator = FhtKacRotator.deserialize(dim, centroids.shape[1], rotator_bytes)

        def f32(x):
            return None if x is None else np.asarray(x, np.float32)

        host = MstgHost(
            binary_bits=np.asarray(binary_bits, np.uint8), ex_codes=np.asarray(ex_codes, np.uint16),
            f_add=f32(f_add), f_rescale=f32(f_rescale), f_add_ex=f32(f_add_ex),
            f_rescale_ex=f32(f_rescale_ex), delta=f32(delta), vl=f32(vl),
            ids=np.asarray(ids, np.int64), list_offsets=np.asarray(list_offsets, np.int64),
            centroids=centroids, f_error=f32(f_error), residual_norm=f32(residual_norm),
        )
        return cls(config, dim, host, scan_dtype, approx_topk, rotator, device=device)

    # ------------------------------------------------------------------
    # accessors
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        """Number of distinct indexed vectors: the largest id + 1."""
        return self._n_vectors

    @property
    def total_rows(self) -> int:
        """Rows in the posting lists, replicas included."""
        return int(self._ids.shape[0])

    def posting_list_count(self) -> int:
        return int(self._offsets.shape[0] - 1)

    def replication_factor(self) -> float:
        return self.total_rows / max(len(self), 1)

    def memory_usage(self) -> int:
        """Rough device-resident bytes (``mstg/index.rs:143-147``), from
        shapes only (never forces the host download)."""
        r = int(self._ids.shape[0])
        code_bytes = 2 * r * self.quant_dim  # binary + ex int8 planes
        factor_bytes = 6 * 4 * r
        cent_bytes = int(
            self._centroids_np.shape[0]
            * self._centroids_np.shape[1]
            * self.config.centroid_precision.bytes_per_dim
        )
        return code_bytes + factor_bytes + cent_bytes

    # ------------------------------------------------------------------
    # device layout and the scan gates
    # ------------------------------------------------------------------

    def _layout_mode(self) -> str:
        """'sorted' (list-contiguous, TN-padded: the fused scans) or 'perm'
        (pseudorandom scatter: the dense and packed scans)."""
        return "sorted" if is_fused(self.scan_dtype) else "perm"

    @property
    def layout(self):
        """The device layout for the current ``scan_dtype`` (the JAX
        package's ``device`` property). Built at first use from the build's
        device planes or the host arrays; assigning ``scan_dtype`` to another
        layout mode re-lays it on the device from the current layout."""
        mode = self._layout_mode()
        if self._layout is None or self._layout_mode_built != mode:
            ex_bits = self.config.rabitq_bits - 1
            if self._layout is not None:
                src = host_order_planes(self._layout, self.total_rows, self.quant_dim, ex_bits)
                self._layout = None
            elif self._codes_dev is not None:
                src = self._codes_dev
                self._codes_dev = None  # the layout holds the data from here on
            else:
                h = self.host
                src = {"binary": h.binary_bits, "ex": h.ex_codes, "f_add": h.f_add,
                       "f_rescale": h.f_rescale, "f_add_ex": h.f_add_ex,
                       "f_rescale_ex": h.f_rescale_ex}
            kwargs = {}
            if mode == "sorted":
                # refinement off -> stage 2 re-scores with the 1-bit
                # estimator, which reads the dense binary plane
                kwargs = {"permute": False, "row_pad": TN, "keep_binary": not self.config.refine_ex}
            self._layout = assemble_device_layout(
                n=self.total_rows, ex_bits=ex_bits, cluster_sizes=np.diff(self._offsets),
                ids=self._ids, centroids=self._centroids_np,
                # the reference MSTG zeroes f_error in its scan (mstg/index.rs:285)
                zero_f_error=True, device=self.device,
                **{k: src[k] for k in _PLANE_FIELDS}, **kwargs,
            )
            self._layout_mode_built = mode
            self._plan.reset(self._offsets)  # and the graphs: they read the old layout
        return self._layout

    def _has_replicas(self) -> bool:
        """Whether closure assignment replicated any vector. Without
        replicas the dispatch extracts top_k directly and skips the dedup."""
        if self._has_repl is None:
            self._has_repl = len(np.unique(self._ids)) != len(self._ids)
        return self._has_repl

    def _scan_planes(self):
        """Bring the layout, the packed plane and the tile windows up to date
        for the current ``scan_dtype``; returns the layout."""
        self.scan_dtype = self._plan.fit(self.scan_dtype)
        lay = self.layout
        self._plan.prepare(lay, self.scan_dtype)
        return lay

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    def _encode_queries(self, queries: np.ndarray, b_pad: int):
        """(q, qscale | None) of ``queries`` padded to ``b_pad`` rows, on the
        index's device in the ``upload_dtype`` encoding (``scan.QueryStage``)."""
        return self._stage(queries, b_pad, self.dim, self.upload_dtype)

    def _scan(self, q, qscale, params: MstgSearchParams, offset=None, sub_block=None, **scan_kw):
        """Queue the decode, rotation and scan of one encoded query block
        (the ``sub_block``-row window at ``offset`` where given) through the
        fused search with MSTG's fixed options; ``scan_kw`` holds the
        per-call ones."""
        lay = self.layout
        return self._fused_scan(
            q, lay.centroids, *lay.scan_args(), qscale=qscale, offset=offset,
            sub_block=sub_block, nprobe=params.ef_search, prune_epsilon=params.pruning_epsilon,
            metric=self.config.metric, ex_bits=self.config.rabitq_bits - 1,
            scan_dtype=self.scan_dtype, use_prune_epsilon=True, refine_ex=self.config.refine_ex,
            clamp_l2=True, centroid_select_l2=True, approx_topk=self.approx_topk,
            probe_k=probe_k_bucket(params.ef_search, self.posting_list_count(), self.scan_dtype),
            **scan_kw,
        )

    def _dispatch_scan(self, q, qscale, params: MstgSearchParams, offset=None, sub_block=None):
        """Queue the MSTG scan of one encoded query block (the window at
        ``offset`` with ``sub_block``); returns device (ids [B, top_k],
        dists). With replicas the scan returns the whole re-ranked candidate
        set (``rerank``, at least top_k times the replication factor + 16,
        so that top_k distinct ids survive) and the device dedup cuts it to
        top_k after the scan; without, the scan extracts top_k. The span
        ``search.dispatch`` covers it, with the tiles the bin scan walks
        (``tiles`` of the plane's ``plane_tiles``; ``dense`` where it walks
        them all, 0 for both on the gather scan), ``rerank``, ``dedup`` and
        the plan's counts (``ScanPlan.scan_kw``: ``k1_int8``, and on the
        dense scans ``lb_pairs`` and ``survivors``)."""
        with span("search.dispatch") as sp:
            rerank = max(
                params.resolved_rerank(),
                int(np.ceil(params.top_k * self.replication_factor())) + 16,
            )
            kw, counts = self._plan.scan_kw(self.scan_dtype, params.ef_search, q, qscale,
                                            rerank=rerank, block=sub_block)
            plane_tiles = self._plan.plane_tiles
            gathered = kw["gather_rows"] is not None
            max_tiles = kw.get("max_tiles")
            tiles = 0 if gathered else plane_tiles if max_tiles is None else max_tiles
            dedup = self._has_replicas()
            sp.add(tiles=tiles, plane_tiles=plane_tiles,
                   dense=int(not gathered and max_tiles is None), rerank=rerank,
                   dedup=int(dedup), **counts)
            ids, dists = self._scan(
                q, qscale, params, offset=offset, sub_block=sub_block,
                top_k=rerank if dedup else params.top_k, rerank=rerank,
                # dedup path: keep the kernel's best-first candidate order
                # through the dedup, which sorts the rows it keeps
                fused_exact_sort=not dedup, **kw,
            )
            if not dedup:
                return ids, dists
            with span("mstg.dedup"):
                return self._dedup_topk_device(ids, dists, top_k=params.top_k)

    @staticmethod
    def _dedup_topk_device(ids: torch.Tensor, dists: torch.Tensor, *, top_k: int):
        """Closure dedup on the device: results arrive best-first along the
        candidate axis, so in a stable id sort the first occurrence of an id
        is its best replica. Kept entries are compacted to the front in
        their order, cut to ``top_k`` (padded with -1 / +inf), and each row
        sorted by distance (``sort_result_rows``)."""
        b, r = ids.shape
        valid = (ids >= 0) & torch.isfinite(dists)
        ids_safe = torch.where(valid, ids, torch.full_like(ids, -1))
        sorted_ids, order = torch.sort(ids_safe, dim=1, stable=True)
        first = torch.ones_like(valid)
        first[:, 1:] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
        keep = torch.zeros_like(valid).scatter(1, order, first) & valid
        # compact kept entries to the front, preserving best-first order
        rank = torch.arange(r, device=ids.device).expand(b, r)
        comp = torch.argsort(torch.where(keep, rank, r + rank), dim=1)[:, : min(top_k, r)]
        ok = torch.gather(keep, 1, comp)
        out_ids = torch.where(ok, torch.gather(ids, 1, comp), -1)
        out_d = torch.where(ok, torch.gather(dists, 1, comp), float("inf"))
        if top_k > r:  # tiny indexes: pad out to the requested k
            out_ids = torch.nn.functional.pad(out_ids, (0, top_k - r), value=-1)
            out_d = torch.nn.functional.pad(out_d, (0, top_k - r), value=float("inf"))
        return sort_result_rows(out_ids, out_d)

    def _dedup_results(
        self, ids: np.ndarray, dists: np.ndarray, top_k: int
    ) -> list[list[SearchResult]]:
        """SearchResult lists of host result rows, first (= best)
        occurrence of each id only (the span ``serve.results``)."""
        with span("serve.results"):
            valid = (ids >= 0) & np.isfinite(dists)
            ids_safe = np.where(valid, ids, np.int64(-1))
            sort_keys = np.argsort(ids_safe, axis=1, kind="stable")
            sorted_ids = np.take_along_axis(ids_safe, sort_keys, axis=1)
            first = np.ones_like(sorted_ids, bool)
            first[:, 1:] = sorted_ids[:, 1:] != sorted_ids[:, :-1]
            keep = np.zeros_like(valid)
            np.put_along_axis(keep, sort_keys, first, axis=1)
            keep &= valid
            sign = 1.0 if self.config.metric is Metric.L2 else -1.0
            out: list[list[SearchResult]] = []
            for row_ids, row_d, row_keep in zip(ids, dists, keep):
                sel = np.nonzero(row_keep)[0][:top_k]
                out.append(
                    [SearchResult(id=int(row_ids[j]), score=sign * float(row_d[j])) for j in sel]
                )
            return out

    def _check_queries(self, queries) -> np.ndarray:
        if self.total_rows == 0:
            raise EmptyIndex()
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, queries.shape[1])
        return queries

    def _root(self, params: MstgSearchParams):
        """The root span of a public batch call (its caller adds ``queries``)."""
        return span("mstg.batch", ef=params.ef_search, lists=self.posting_list_count())

    def search(self, query: np.ndarray, params: MstgSearchParams) -> list[SearchResult]:
        with span("mstg.search", queries=1):
            queries = self._check_queries(np.asarray(query, np.float32)[None, :])
            return self._search(queries, params)[0]

    def batch_search(
        self, queries: np.ndarray, params: MstgSearchParams
    ) -> list[list[SearchResult]]:
        """(``mstg/index.rs:150-213``, batched as at 340) One dispatch for
        the batch, padded to a power of two."""
        with self._root(params) as sp:
            queries = self._check_queries(queries)
            sp.add(queries=queries.shape[0])
            return self._search(queries, params)

    def _search(self, queries: np.ndarray, params: MstgSearchParams) -> list[list[SearchResult]]:
        """``batch_search`` of checked queries, inside the caller's root span."""
        b = queries.shape[0]
        if params.top_k <= 0:
            return [[] for _ in range(b)]
        self._scan_planes()
        q, qscale = self._encode_queries(queries, _pad_pow2(b))
        ids, dists = self._dispatch_scan(q, qscale, params)
        with span("serve.fetch"):
            ids, dists = ids.cpu().numpy()[:b], dists.cpu().numpy()[:b]
        return self._dedup_results(ids, dists, params.top_k)

    def upload_queries(self, queries: np.ndarray):
        """Encode the queries once with the current ``upload_dtype`` and keep
        them on the device: ``batch_search_resident`` then reruns ef / epsilon
        sweeps over them with no query byte crossing the host link. Checks the
        queries' width only. Returns an opaque handle."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, queries.shape[1])
        q, qscale = self._encode_queries(queries, _pad_pow2(queries.shape[0]))
        return q, qscale, queries.shape[0]

    def batch_search_resident(
        self, qcache, params: MstgSearchParams, batch_size: int = 256
    ) -> list[list[SearchResult]]:
        """``batch_search`` over an ``upload_queries`` handle: each dispatch
        scans the ``batch_size``-row window of the resident block at its
        offset."""
        if self.total_rows == 0:
            raise EmptyIndex()
        q, qscale, b_total = qcache
        if params.top_k <= 0:
            return [[] for _ in range(b_total)]
        with self._root(params) as sp:
            sp.add(queries=b_total)
            self._scan_planes()
            bs = _pad_pow2(min(batch_size, q.shape[0]))
            pending = [
                self._dispatch_scan(q, qscale, params, offset=off, sub_block=bs)
                for off in range(0, b_total, bs)
            ]
            ids, dists = _fetch(pending, b_total)
            return self._dedup_results(ids, dists, params.top_k)

    def _pipelined(self, queries, params, batch_size, upload_block):
        self._scan_planes()
        return serve_pipelined(
            queries, batch_size, upload_block, self._encode_queries,
            lambda q, qscale, off, bs: self._dispatch_scan(
                q, qscale, params, offset=off, sub_block=bs),
        )

    def batch_search_pipelined(
        self,
        queries: np.ndarray,
        params: MstgSearchParams,
        batch_size: int = 256,
        upload_block: int | None = None,
    ) -> list[list[SearchResult]]:
        """``batch_search`` over many fixed-size blocks, each upload block
        copied from pinned memory without blocking and its scans queued
        behind it (``scan.serve_pipelined``); ``upload_block`` (>=
        batch_size) sets the copy granularity. Results equal
        ``batch_search``'s."""
        with self._root(params) as sp:
            queries = self._check_queries(queries)
            sp.add(queries=queries.shape[0])
            if params.top_k <= 0:
                return [[] for _ in range(queries.shape[0])]
            ids, dists = self._pipelined(queries, params, batch_size, upload_block)
            return self._dedup_results(ids, dists, params.top_k)

    def batch_search_arrays_pipelined(
        self,
        queries: np.ndarray,
        params: MstgSearchParams,
        batch_size: int = 256,
        upload_block: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """``batch_search_pipelined`` returning arrays (ids [B, top_k] int32
        with -1 padding, internal distances f32) instead of SearchResult
        lists; the dedup already ran on the device."""
        with self._root(params) as sp:
            queries = self._check_queries(queries)
            b_total = queries.shape[0]
            sp.add(queries=b_total)
            if params.top_k <= 0:
                return (
                    np.full((b_total, 0), -1, np.int32),
                    np.full((b_total, 0), np.inf, np.float32),
                )
            return self._pipelined(queries, params, batch_size, upload_block)

    def search_with_diagnostics(
        self, query: np.ndarray, params: MstgSearchParams
    ) -> tuple[list[SearchResult], SearchDiagnostics]:
        """Search plus counters measured inside the scan (fused: the bin
        kernel's offered rows, through the two-stage scan; dense: mask sums).
        ``estimated + skipped_by_lower_bound`` is the rows offered: below the
        sum of the top-ef list sizes where epsilon-pruning binds
        (``mstg/index.rs:349-362``)."""
        self._scan_planes()
        q = torch.from_numpy(np.asarray(query, np.float32).reshape(1, self.dim)).to(self.device)
        rerank = params.resolved_rerank()
        kw, _ = self._plan.scan_kw(self.scan_dtype, params.ef_search, q, None, rerank=rerank,
                                   exact=False, gather=False)
        ids, dists, diag = self._scan(
            q, None, params, top_k=params.top_k, rerank=rerank,
            with_diagnostics=True, **kw,
        )
        sign = 1.0 if self.config.metric is Metric.L2 else -1.0
        results = [
            SearchResult(id=i, score=sign * dd)
            for i, dd in zip(ids[0].tolist(), dists[0].tolist())
            if i >= 0 and np.isfinite(dd)
        ][: params.top_k]
        d = diag[0].tolist()
        return results, SearchDiagnostics(
            estimated=d[0], skipped_by_lower_bound=d[1], extended_evaluations=d[2]
        )

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def save_to_path(self, path, format: str = "native") -> None:
        """Write the index: ``format="native"`` the single-file v1003 format,
        ``format="reference"`` the reference's bincode v1 ``.mstg`` body and
        its hnsw side files (``ref_io.save_reference_mstg``)."""
        if format == "reference":
            from .ref_io import save_reference_mstg

            save_reference_mstg(self, path)
            return
        if format != "native":
            raise InvalidConfig(f"unknown MSTG save format {format!r}")
        h = self.host
        cfg = self.config
        r = self.total_rows
        ex_bits = cfg.rabitq_bits - 1

        with open(path, "wb") as f:
            crc = 0

            def w(data: bytes, hashed: bool = True):
                nonlocal crc
                f.write(data)
                if hashed:
                    crc = zlib.crc32(data, crc)

            w(_MAGIC, hashed=False)
            w(struct.pack("<I", _VERSION), hashed=False)
            w(struct.pack(
                _HEADER, self.dim, cfg.metric.to_tag(), cfg.rabitq_bits,
                list(ScalarPrecision).index(cfg.centroid_precision), 1 if cfg.refine_ex else 0,
                cfg.closure_epsilon, cfg.balance_weight, cfg.max_posting_size,
                cfg.branching_factor, cfg.pruning_epsilon, cfg.default_ef_search,
                1 if cfg.faster_config else 0,
            ))
            w(struct.pack("<I", self.quant_dim))
            rot_blob = self.rotator.serialize() if self.rotator is not None else b""
            w(struct.pack("<Q", len(rot_blob)))
            w(rot_blob)
            w(struct.pack("<QQ", self.posting_list_count(), r))
            # the centroid block in the configured precision; the stored
            # centroids are exactly representable in it, so this is lossless
            stored, _ = quantize_centroids(h.centroids, cfg.centroid_precision)
            if cfg.centroid_precision is ScalarPrecision.INT8:
                w(stored["scale"].astype("<f4").tobytes())
                w(stored["data"].astype("<i1").tobytes())
            elif cfg.centroid_precision is ScalarPrecision.BF16:
                w(stored["data"].astype("<u2").tobytes())
            elif cfg.centroid_precision is ScalarPrecision.FP16:
                w(stored["data"].astype("<f2").tobytes())
            else:
                w(stored["data"].astype("<f4").tobytes())
            w(h.list_offsets.astype("<u8").tobytes())
            w(h.ids.astype("<u8").tobytes())
            w(packing.pack_binary(h.binary_bits).tobytes())
            if ex_bits > 0:
                w(packing.pack_ex_generic(h.ex_codes, ex_bits).tobytes())
            for name in ("f_add", "f_rescale", "f_add_ex", "f_rescale_ex", "delta", "vl"):
                w(getattr(h, name).astype("<f4").tobytes())
            # v1003: f_error + residual_norm (the scan zeroes f_error, but
            # the reference-format writer needs the real ones)
            for name in ("f_error", "residual_norm"):
                v = getattr(h, name)
                v = np.zeros(r, np.float32) if v is None else v
                w(v.astype("<f4").tobytes())
            w(struct.pack("<I", crc), hashed=False)

    @classmethod
    def load_from_path(
        cls, path, scan_dtype: str = "bf16", device: "str | torch.device | None" = None
    ) -> "MstgIndex":
        """Read a native v1001-v1003 file, or a reference v1 ``.mstg`` set;
        the index lays itself out on ``device`` (None: the card)."""
        from ...io.persistence import _Cursor

        with open(path, "rb") as f:
            data = f.read()
        cur = _Cursor(data)
        if cur.take(4) != _MAGIC:
            raise InvalidPersistence("unrecognized file header")
        version = cur.u32()
        if version == 1:
            # the reference's bincode multi-file format (mstg/io.rs:14-245)
            from .ref_io import load_reference_mstg

            return load_reference_mstg(path, scan_dtype=scan_dtype, device=device)
        if version not in (1001, 1002, _VERSION):
            raise InvalidPersistence(
                f"unsupported MSTG format version {version} (supported: the "
                "native v1001/v1002/v1003 single-file formats and the "
                "reference's bincode v1 multi-file format)"
            )
        stored_crc = struct.unpack("<I", data[-4:])[0]
        if zlib.crc32(data[8:-4]) != stored_crc:
            raise InvalidPersistence("checksum mismatch")

        (
            dim, metric_tag, rabitq_bits, prec_tag, refine_ex, closure_eps, balance_w,
            max_posting, branching, pruning_eps, default_ef, faster,
        ) = struct.unpack(_HEADER, cur.take(struct.calcsize(_HEADER)))
        if version >= 1002:
            quant_dim = cur.u32()
            rot_len = cur.u64()
            rot_blob = cur.take(rot_len)
        else:  # v1001 predates the rotator extension
            quant_dim, rot_len, rot_blob = dim, 0, b""
        n_lists = cur.u64()
        r = cur.u64()
        cfg = MstgConfig(
            max_posting_size=max_posting, branching_factor=branching, balance_weight=balance_w,
            closure_epsilon=closure_eps, rabitq_bits=rabitq_bits, faster_config=bool(faster),
            metric=Metric.from_tag(metric_tag), centroid_precision=list(ScalarPrecision)[prec_tag],
            default_ef_search=default_ef, pruning_epsilon=pruning_eps,
            refine_ex=bool(refine_ex), use_rotator=rot_len > 0,
        )
        rotator = FhtKacRotator.deserialize(dim, quant_dim, rot_blob) if rot_len > 0 else None
        ex_bits = rabitq_bits - 1
        prec = cfg.centroid_precision
        if version >= 1003 and prec is not ScalarPrecision.FP32:
            stored = {}
            if prec is ScalarPrecision.INT8:
                stored["scale"] = cur.f32s(n_lists)
                stored["data"] = cur.bytes_np(n_lists * quant_dim).view(np.int8).reshape(
                    n_lists, quant_dim)
            else:  # BF16 bits / FP16 halves: 2 bytes per dim
                raw = cur.bytes_np(2 * n_lists * quant_dim)
                dt = "<u2" if prec is ScalarPrecision.BF16 else "<f2"
                stored["data"] = np.frombuffer(raw.tobytes(), dt).reshape(n_lists, quant_dim)
            centroids = dequantize_centroids(stored, prec)
        else:
            centroids = cur.f32s(n_lists * quant_dim).reshape(n_lists, quant_dim)
        offsets = cur.u64s(n_lists + 1).astype(np.int64)
        ids = cur.u64s(r).astype(np.int64)
        bin_len = (quant_dim + 7) // 8
        binary = packing.unpack_binary(
            cur.bytes_np(r * bin_len).reshape(r, bin_len), quant_dim
        ).astype(np.uint8)
        if ex_bits > 0:
            ex_len = (quant_dim * ex_bits + 7) // 8
            ex = packing.unpack_ex_generic(
                cur.bytes_np(r * ex_len).reshape(r, ex_len), quant_dim, ex_bits
            ).astype(np.uint16)
        else:
            ex = np.zeros((r, quant_dim), np.uint16)
        fields = {}
        for name in ("f_add", "f_rescale", "f_add_ex", "f_rescale_ex", "delta", "vl"):
            fields[name] = cur.f32s(r)
        if version >= 1003:
            for name in ("f_error", "residual_norm"):
                fields[name] = cur.f32s(r)
        host = MstgHost(
            binary_bits=binary, ex_codes=ex, ids=ids, list_offsets=offsets,
            centroids=centroids.astype(np.float32), **fields,
        )
        return cls(cfg, dim, host, scan_dtype, rotator=rotator, device=device)
