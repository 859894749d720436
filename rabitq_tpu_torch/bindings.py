"""Drop-in Python API matching the reference's PyO3 bindings (port of
``rabitq_tpu/bindings.py``).

Signature-for-signature parity with lqhl/rabitq-rs
``src/python_bindings.rs``:

* ``MstgIndex(dimension, metric="euclidean", ...)`` with
  fit / query / batch_query / set_query_arguments / get_memory_usage /
  save / load / __len__ (``python_bindings.rs:27-331``)
* ``IvfRabitqIndex(dimension, metric="euclidean")`` with
  fit / fit_with_clusters / query(query, k, nprobe) / batch_query /
  save / load / __len__ / cluster_count (``python_bindings.rs:339-720``)

The one addition is a keyword-only ``device`` on each constructor (and on
``MstgIndex.load``): the card unless ``"cpu"`` is asked for; every entry
point runs there. Result arrays are float32 ``(n, 2)`` of ``[id, distance]``
rows, as in the bindings.
"""

from __future__ import annotations

import numpy as np

from .index.ivf import IvfRabitqIndex as _NativeIvf
from .index.mstg import MstgConfig, MstgIndex as _NativeMstg, MstgSearchParams, ScalarPrecision
from .types import Metric, RotatorType, SearchParams
from .utils.device import resolve_device


def _parse_metric(metric: str) -> Metric:
    m = metric.lower()
    if m in ("euclidean", "l2"):
        return Metric.L2
    if m in ("angular", "ip", "inner_product"):
        return Metric.InnerProduct
    raise ValueError(f"Invalid metric: {metric}. Use 'euclidean' or 'angular'")


def _parse_rotator(rotator_type: str) -> RotatorType:
    """(``python_bindings.rs:398-407``)"""
    r = rotator_type.lower()
    if r in ("fht", "random"):
        return RotatorType.FhtKacRotator
    if r in ("matrix", "identity"):
        return RotatorType.MatrixRotator
    raise ValueError(
        f"Invalid rotator_type: {rotator_type}. Use 'fht', 'random', 'matrix', or 'identity'"
    )


def _parse_precision(precision: str) -> ScalarPrecision:
    try:
        return ScalarPrecision(precision.lower())
    except ValueError:
        raise ValueError(
            f"Invalid precision: {precision}. Use 'fp32', 'bf16', 'fp16', or 'int8'"
        ) from None


def _result_array(hits) -> np.ndarray:
    out = np.empty((len(hits), 2), np.float32)
    for i, h in enumerate(hits):
        out[i, 0] = float(h.id)
        out[i, 1] = h.score
    return out


class MstgIndex:
    """Binding-compatible MSTG wrapper (``python_bindings.rs:14-331``)."""

    def __init__(
        self,
        dimension: int,
        metric: str = "euclidean",
        max_posting_size: int = 16,
        branching_factor: int = 10,
        balance_weight: float = 1.0,
        closure_epsilon: float = 0.15,
        max_replicas: int = 8,
        rabitq_bits: int = 7,
        faster_config: bool = True,
        hnsw_m: int = 32,
        hnsw_ef_construction: int = 400,
        centroid_precision: str = "bf16",
        default_ef_search: int = 150,
        pruning_epsilon: float = 0.6,
        use_rotator: bool = False,  # an extension of the JAX package (not in the reference)
        *,
        device=None,
    ):
        self.dimension = dimension
        self.config = MstgConfig(
            max_posting_size=max_posting_size,
            branching_factor=branching_factor,
            balance_weight=balance_weight,
            closure_epsilon=closure_epsilon,
            max_replicas=max_replicas,
            rabitq_bits=rabitq_bits,
            faster_config=faster_config,
            metric=_parse_metric(metric),
            hnsw_m=hnsw_m,
            hnsw_ef_construction=hnsw_ef_construction,
            centroid_precision=_parse_precision(centroid_precision),
            default_ef_search=default_ef_search,
            pruning_epsilon=pruning_epsilon,
            use_rotator=use_rotator,
        )
        self.device = resolve_device(device)
        self.index: _NativeMstg | None = None

    def fit(self, data: np.ndarray) -> None:
        data = np.asarray(data, np.float32)
        if data.ndim != 2:
            raise ValueError("Data must be 2D array (N x D)")
        if data.shape[1] != self.dimension:
            raise ValueError(
                f"Data dimension {data.shape[1]} does not match expected {self.dimension}"
            )
        self.index = _NativeMstg.build(data, self.config, device=self.device)

    def set_query_arguments(
        self, ef_search: int | None = None, pruning_epsilon: float | None = None
    ) -> None:
        if ef_search is not None:
            self.config.default_ef_search = ef_search
        if pruning_epsilon is not None:
            self.config.pruning_epsilon = pruning_epsilon
        if self.index is not None:
            self.index.config.default_ef_search = self.config.default_ef_search
            self.index.config.pruning_epsilon = self.config.pruning_epsilon

    def _params(self, k: int) -> MstgSearchParams:
        return MstgSearchParams(
            ef_search=self.config.default_ef_search,
            pruning_epsilon=self.config.pruning_epsilon,
            top_k=k,
        )

    def _require(self) -> _NativeMstg:
        if self.index is None:
            raise RuntimeError("Index not built yet. Call fit() first.")
        return self.index

    def query(self, query: np.ndarray, k: int) -> np.ndarray:
        index = self._require()
        query = np.asarray(query, np.float32)
        if query.shape != (self.dimension,):
            raise ValueError(
                f"Query dimension {query.shape[-1]} does not match expected {self.dimension}"
            )
        return _result_array(index.search(query, self._params(k)))

    def batch_query(self, queries: np.ndarray, k: int) -> list[np.ndarray]:
        index = self._require()
        queries = np.asarray(queries, np.float32)
        if queries.ndim != 2:
            raise ValueError("Queries must be 2D array (N x D)")
        if queries.shape[1] != self.dimension:
            raise ValueError(
                f"Query dimension {queries.shape[1]} does not match expected {self.dimension}"
            )
        # large batches take the pipelined serving loop (the same results;
        # block i+1's upload overlaps block i's scan)
        if queries.shape[0] > 256:
            hits = index.batch_search_pipelined(queries, self._params(k), batch_size=256)
        else:
            hits = index.batch_search(queries, self._params(k))
        return [_result_array(h) for h in hits]

    def get_memory_usage(self) -> int:
        return self._require().memory_usage()

    def save(self, path: str) -> None:
        self._require().save_to_path(path)

    @staticmethod
    def load(path: str, *, device=None) -> "MstgIndex":
        native = _NativeMstg.load_from_path(path, device=device)
        wrapper = MstgIndex(native.dim, device=native.device)
        wrapper.config = native.config
        wrapper.index = native
        return wrapper

    def __len__(self) -> int:
        return len(self.index) if self.index is not None else 0

    def __repr__(self) -> str:
        built = f"{len(self)} vectors" if self.index is not None else "not fitted"
        return f"MstgIndex(dim={self.dimension}, {built})"


class IvfRabitqIndex:
    """Binding-compatible IVF wrapper (``python_bindings.rs:339-720``)."""

    def __init__(self, dimension: int, metric: str = "euclidean", *, device=None):
        self.dimension = dimension
        self.metric = _parse_metric(metric)
        self.device = resolve_device(device)
        self.index: _NativeIvf | None = None

    def fit(
        self,
        data: np.ndarray,
        nlist: int,
        total_bits: int = 7,
        rotator_type: str = "random",
        seed: int = 42,
        faster_config: bool = True,
        scan_dtype: str = "bf16",  # an extension: "fused"/"fused8" take the bin-kernel scans
    ) -> None:
        data = self._check_2d(data)
        self.index = _NativeIvf.train(
            data,
            nlist,
            total_bits,
            self.metric,
            _parse_rotator(rotator_type),
            seed,
            faster_config,
            scan_dtype=scan_dtype,
            device=self.device,
        )

    def fit_with_clusters(
        self,
        data: np.ndarray,
        centroids: np.ndarray,
        assignments: np.ndarray,
        total_bits: int = 7,
        rotator_type: str = "random",
        seed: int = 42,
        faster_config: bool = True,
    ) -> None:
        data = self._check_2d(data)
        self.index = _NativeIvf.train_with_clusters(
            data,
            np.asarray(centroids, np.float32),
            np.asarray(assignments, np.int64),
            total_bits,
            self.metric,
            _parse_rotator(rotator_type),
            seed,
            faster_config,
            device=self.device,
        )

    def _check_2d(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, np.float32)
        if data.ndim != 2:
            raise ValueError("Data must be 2D array (N x D)")
        if data.shape[1] != self.dimension:
            raise ValueError(
                f"Data dimension {data.shape[1]} does not match expected {self.dimension}"
            )
        return data

    def _require(self) -> _NativeIvf:
        if self.index is None:
            raise RuntimeError("Index not built yet. Call fit() first.")
        return self.index

    def query(self, query: np.ndarray, k: int, nprobe: int = 1) -> np.ndarray:
        index = self._require()
        query = np.asarray(query, np.float32)
        hits = index.search(query, SearchParams(top_k=k, nprobe=nprobe))
        return _result_array(hits)

    def batch_query(self, queries: np.ndarray, k: int, nprobe: int = 1) -> list[np.ndarray]:
        index = self._require()
        queries = np.asarray(queries, np.float32)
        params = SearchParams(top_k=k, nprobe=nprobe)
        if queries.ndim == 2 and queries.shape[0] > 256:
            # the pipelined serving loop (the same results, overlapped
            # uploads) and a vectorized result-array conversion
            ids, dists = index.batch_search_arrays_pipelined(queries, params, batch_size=256)
            sign = 1.0 if index.metric is Metric.L2 else -1.0
            out = []
            for row_ids, row_d in zip(ids, dists):
                m = (row_ids >= 0) & np.isfinite(row_d)
                arr = np.empty((int(m.sum()), 2), np.float32)
                arr[:, 0] = row_ids[m]
                arr[:, 1] = sign * row_d[m]
                out.append(arr)
            return out
        res = index.batch_search(queries, params)
        return [_result_array(h) for h in res]

    def save(self, path: str) -> None:
        self._require().save_to_path(path)

    def load(self, path: str) -> None:
        """In-place load, like the binding (``python_bindings.rs:679-687``)."""
        self.index = _NativeIvf.load_from_path(path, device=self.device)
        self.dimension = self.index.dim
        self.metric = self.index.metric

    def __len__(self) -> int:
        return len(self.index) if self.index is not None else 0

    def cluster_count(self) -> int:
        return self._require().cluster_count()

    def __repr__(self) -> str:
        built = f"{len(self)} vectors" if self.index is not None else "not fitted"
        return f"IvfRabitqIndex(dim={self.dimension}, {built})"
