"""Brute-force RaBitQ index on the card (port of
``rabitq_tpu/index/brute_force.py``; reference ``brute_force.rs``).

The whole dataset is quantized against one zero centroid
(``brute_force.rs:252-275``) and every query scans every code: the IVF scan
(``index/scan.scan_kernel``) with a single cluster and nprobe = 1, through
the index's fused search (``index/scan.make_fused_search``: rotation and scan
as one CUDA graph replay on the card). For ``scan_dtype="packed"`` that is
the packed lower-bound kernel over all rows with a one-column g table. The
reference hardcodes ``g_add = 0`` instead of ``||q - 0||^2``
(``brute_force.rs:571``), so its reported L2 "distance" is ``||v - q||^2 -
||q||^2``, a per-query shift that never changes the ranking; the same scores
are reported here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..errors import DimensionMismatch, EmptyIndex, InvalidConfig
from ..ops.packed_scan import pack_bitplanes
from ..ops.quantize import compute_const_scaling_factor
from ..ops.rotation import Rotator, make_rotator
from ..types import Metric, RotatorType, SearchResult
from ..utils.device import resolve_device
from .build import build_codes_device, exact_t_rows
from .layout import DeviceLayout, assemble_device_layout, host_order_planes
from .scan import _pad_pow2, make_fused_search


@dataclass(frozen=True)
class BruteForceSearchParams:
    """(``brute_force.rs:21-30``) plus the re-rank budget of the scan."""

    top_k: int
    rerank: int | None = None

    def resolved_rerank(self) -> int:
        if self.rerank is not None:
            return max(self.rerank, self.top_k)
        return max(4 * self.top_k, 400)


@dataclass
class BruteForceHost:
    binary_bits: np.ndarray  # [N, Dpad] uint8
    ex_codes: np.ndarray  # [N, Dpad] uint16
    delta: np.ndarray
    vl: np.ndarray
    f_add: np.ndarray
    f_rescale: np.ndarray
    f_error: np.ndarray
    residual_norm: np.ndarray
    f_add_ex: np.ndarray
    f_rescale_ex: np.ndarray


class BruteForceRabitqIndex:
    def __init__(
        self,
        dim: int,
        padded_dim: int,
        metric: Metric,
        rotator: Rotator,
        ex_bits: int,
        host: BruteForceHost | None,
        scan_dtype: str = "bf16",
        approx_topk: bool | None = None,
        device: "str | torch.device | None" = None,
    ):
        self.dim = dim
        self.padded_dim = padded_dim
        self.metric = metric
        self.rotator = rotator
        self.ex_bits = ex_bits
        self.scan_dtype = scan_dtype
        self.approx_topk = approx_topk if approx_topk is not None else scan_dtype != "f32"
        self.device = resolve_device(device)
        self._host = host
        self._n = 0 if host is None else int(host.binary_bits.shape[0])
        self._layout: DeviceLayout | None = None
        self._residual_norm: torch.Tensor | None = None  # until the host copy is made
        self._packed: torch.Tensor | None = None
        # rotation + scan of a query block: one graph replay on the card
        self._fused_scan = make_fused_search(self.rotator.rotate)

    @classmethod
    def train(
        cls,
        data: "np.ndarray | torch.Tensor",
        total_bits: int,
        metric: Metric = Metric.L2,
        rotator_type: RotatorType = RotatorType.FhtKacRotator,
        seed: int = 42,
        use_faster_config: bool = False,
        scan_dtype: str = "bf16",
        device: "str | torch.device | None" = None,
    ) -> "BruteForceRabitqIndex":
        """(``brute_force.rs:214-285``) ``data`` is a host array or a tensor
        (already on ``device`` saves the upload); ``device=None`` means the
        card. The codes stay on the device; the host copy is made when
        ``host`` is first read."""
        dev = resolve_device(device)
        n, dim = data.shape
        if n == 0 or dim == 0:
            raise InvalidConfig("training data must be non-empty")
        if not (1 <= total_bits <= 16):
            raise InvalidConfig("total_bits must be between 1 and 16")
        ex_bits = total_bits - 1
        rotator = make_rotator(dim, rotator_type, seed)
        padded_dim = rotator.padded_dim

        t_const = 0.0
        t_rows = None
        if ex_bits > 0:
            if use_faster_config:
                t_const = compute_const_scaling_factor(padded_dim, ex_bits, seed, device=dev)
            else:
                # the reference default: exact per-vector t; the residual
                # against the zero centroid is the rotated row itself
                host = data if isinstance(data, np.ndarray) else data.cpu().numpy()
                t_rows = exact_t_rows(host, None, np.zeros(n, np.int64), None, rotator, ex_bits)
        data_dev = torch.as_tensor(data, dtype=torch.float32).to(dev)
        codes = build_codes_device(
            data_dev, torch.zeros((1, padded_dim), device=dev), np.zeros(n, np.int64),
            rotator=rotator, ex_bits=ex_bits, metric=metric,
            use_t_const=use_faster_config, t_const=t_const, t_rows=t_rows,
        )
        index = cls(dim, padded_dim, metric, rotator, ex_bits, None, scan_dtype, device=dev)
        index._n = n
        index._residual_norm = codes.pop("residual_norm")
        index._layout = index._assemble(codes)
        return index

    def _assemble(self, planes) -> DeviceLayout:
        """One cluster (the zero centroid) with every row in it, rows
        permuted as the dense scans take them."""
        n = self._n
        self._fused_scan.clear()  # the graphs read the old layout's tensors
        return assemble_device_layout(
            n=n, ex_bits=self.ex_bits, binary=planes["binary"], ex=planes["ex"],
            f_add=planes["f_add"], f_rescale=planes["f_rescale"], f_error=planes["f_error"],
            f_add_ex=planes["f_add_ex"], f_rescale_ex=planes["f_rescale_ex"],
            delta=planes["delta"], vl=planes["vl"], cluster_sizes=np.array([n], np.int64),
            ids=np.arange(n, dtype=np.int64),
            centroids=np.zeros((1, self.padded_dim), np.float32), device=self.device,
        )

    @property
    def layout(self) -> DeviceLayout:
        if self._layout is None:
            h = self.host
            self._layout = self._assemble(
                {"binary": h.binary_bits, "ex": h.ex_codes, "f_add": h.f_add,
                 "f_rescale": h.f_rescale, "f_error": h.f_error, "f_add_ex": h.f_add_ex,
                 "f_rescale_ex": h.f_rescale_ex, "delta": h.delta, "vl": h.vl}
            )
        return self._layout

    @property
    def host(self) -> BruteForceHost:
        """The codes as host arrays: those the index was loaded from, or
        downloaded from the device layout once, at first use."""
        if self._host is None:
            if self._layout is None:
                raise EmptyIndex()
            planes = host_order_planes(self._layout, self._n, self.padded_dim, self.ex_bits)
            self._host = BruteForceHost(
                binary_bits=planes.pop("binary").cpu().numpy().astype(np.uint8),
                ex_codes=planes.pop("ex").cpu().numpy().astype(np.uint16),
                residual_norm=self._residual_norm.cpu().numpy(),
                **{name: planes[name].cpu().numpy() for name in (
                    "delta", "vl", "f_add", "f_rescale", "f_error", "f_add_ex", "f_rescale_ex")},
            )
            self._residual_norm = None
        return self._host

    @host.setter
    def host(self, value: BruteForceHost) -> None:
        """Replace the codes. An index not laid out yet lays itself out
        from them at its first search; a layout already built stays as it
        is (the JAX package's ``host`` is a plain attribute)."""
        self._host = value
        self._n = int(value.binary_bits.shape[0])

    def __len__(self) -> int:
        return self._n

    @property
    def is_empty(self) -> bool:
        return len(self) == 0

    # ------------------------------------------------------------------

    def search(self, query: np.ndarray, params: BruteForceSearchParams) -> list[SearchResult]:
        return self.batch_search(np.asarray(query, np.float32)[None, :], params)[0]

    def search_filtered(
        self, query: np.ndarray, params: BruteForceSearchParams, filter_ids: np.ndarray
    ) -> list[SearchResult]:
        """Only ids in ``filter_ids`` (an id array, or a bool mask over the
        ids) may be returned."""
        return self.batch_search(
            np.asarray(query, np.float32)[None, :], params, filter_ids=filter_ids
        )[0]

    def batch_search(
        self,
        queries: np.ndarray,
        params: BruteForceSearchParams,
        filter_ids: np.ndarray | None = None,
    ) -> list[list[SearchResult]]:
        """One dispatch for the whole batch (padded to a power of two)."""
        if self.is_empty:
            raise EmptyIndex()
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if queries.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, queries.shape[1])
        b = queries.shape[0]
        if params.top_k <= 0:
            return [[] for _ in range(b)]

        lay = self.layout
        if self.scan_dtype in ("fused", "fused8"):
            # every row is scanned anyway: there is no cluster pruning for
            # the fused bin scans to fold, and the dense bf16 scan is the
            # equivalent configuration (as in the reference package)
            self.scan_dtype = "bf16"
        packed = None
        if self.scan_dtype == "packed":
            if self._packed is None:
                self._packed = pack_bitplanes(lay.binary, self.padded_dim)
                self._fused_scan.clear()
            packed = self._packed
        row_allowed = lay.valid
        if filter_ids is not None:
            filter_ids = np.asarray(filter_ids)
            n = len(self)
            mask = np.zeros(lay.binary.shape[0], bool)
            if filter_ids.dtype == bool:
                mask[: min(n, filter_ids.shape[0])] = filter_ids[:n]
            else:
                ok = filter_ids[(filter_ids >= 0) & (filter_ids < n)]
                mask[ok.astype(np.int64)] = True
            row_allowed = row_allowed & torch.from_numpy(mask[lay.perm]).to(self.device)

        q = np.zeros((_pad_pow2(b), self.dim), np.float32)
        q[:b] = queries
        ids, dists = self._fused_scan(
            torch.from_numpy(q).to(self.device), lay.centroids, lay.binary, lay.ex, lay.f_add,
            lay.f_rescale, lay.f_error, lay.f_add_ex, lay.f_rescale_ex, lay.cluster_of,
            row_allowed, lay.ids,
            nprobe=1, packed=packed, top_k=params.top_k, rerank=params.resolved_rerank(),
            metric=self.metric, ex_bits=self.ex_bits, scan_dtype=self.scan_dtype,
            approx_topk=self.approx_topk,
        )
        ids = ids.cpu().numpy()[:b]
        dists = dists.cpu().numpy()[:b]
        if self.metric is Metric.L2:
            # the scan used g_add = ||rot(q)||^2 = ||q||^2 (the rotation is
            # orthonormal); the reference reports without it
            dists = dists - np.sum(q[:b] ** 2, axis=-1, keepdims=True)

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

    # ------------------------------------------------------------------

    def save_to_path(self, path) -> None:
        """Write the index as an RBF1 v1 file (``io/persistence_bf.py``)."""
        from ..io import persistence_bf

        persistence_bf.save_brute_force(self, path)

    @classmethod
    def load_from_path(
        cls, path, scan_dtype: str = "bf16", device: "str | torch.device | None" = None
    ) -> "BruteForceRabitqIndex":
        """Read an RBF1 v1 file; the codes go to ``device`` (None: the card)
        at the first search."""
        from ..io import persistence_bf

        return persistence_bf.load_brute_force(path, scan_dtype=scan_dtype, device=device)
