"""fvecs / ivecs dataset files (a copy of ``rabitq_tpu/io/vecio.py``).

Format (lqhl/rabitq-rs ``src/io.rs``): each row is a little-endian i32
dimension followed by ``dim`` little-endian payload elements (f32 for
fvecs, i32 for ivecs). All rows share the same dimension. The whole file
is parsed with one vectorized reinterpret.
"""

from __future__ import annotations

import numpy as np

from ..errors import InvalidPersistence


def _read_vecs(path, payload_dtype, limit: int | None = None) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size == 0:
        return np.zeros((0, 0), payload_dtype)
    if raw.size < 4:
        raise InvalidPersistence(f"{path}: truncated vecs file")
    dim = int(raw[:4].view("<i4")[0])
    if dim <= 0:
        raise InvalidPersistence(f"{path}: non-positive dimension {dim}")
    row_bytes = 4 + 4 * dim
    n = raw.size // row_bytes
    if n * row_bytes != raw.size:
        raise InvalidPersistence(f"{path}: file size is not a multiple of row size")
    if limit is not None:
        n = min(n, limit)
    rows = raw[: n * row_bytes].reshape(n, row_bytes)
    dims = rows[:, :4].copy().view("<i4")[:, 0]
    if not np.all(dims == dim):
        raise InvalidPersistence(f"{path}: inconsistent row dimensions")
    payload = np.ascontiguousarray(rows[:, 4:]).view(np.dtype(payload_dtype).newbyteorder("<"))
    return payload.astype(payload_dtype)


def read_fvecs(path, limit: int | None = None) -> np.ndarray:
    """[N, dim] float32 (``io.rs:77-80``)."""
    return _read_vecs(path, np.float32, limit)


def read_ivecs(path, limit: int | None = None) -> np.ndarray:
    """[N, dim] int32 (``io.rs:82-90``)."""
    return _read_vecs(path, np.int32, limit)


def read_ids(path, limit: int | None = None) -> np.ndarray:
    """Cluster-id column: single-column ivecs flattened with validation
    (``io.rs:92-103``)."""
    arr = read_ivecs(path, limit)
    if arr.ndim != 2 or arr.shape[1] != 1:
        raise InvalidPersistence(f"{path}: expected single-column ivecs for ids")
    if np.any(arr < 0):
        raise InvalidPersistence(f"{path}: negative id")
    return arr[:, 0].astype(np.int64)


def read_groundtruth(path, limit: int | None = None) -> np.ndarray:
    """Ground-truth neighbour lists: [N, k] int32 (``io.rs:105-161``)."""
    arr = read_ivecs(path, limit)
    if np.any(arr < 0):
        raise InvalidPersistence(f"{path}: negative groundtruth id")
    return arr


def write_fvecs(path, data: np.ndarray) -> None:
    """Write [N, dim] rows as fvecs (reference-format files for tests and
    benchmarks)."""
    data = np.ascontiguousarray(data, np.float32)
    n, dim = data.shape
    out = np.empty((n, dim + 1), np.float32)
    out[:, 0] = np.frombuffer(np.full(n, dim, "<i4").tobytes(), "<f4")
    out[:, 1:] = data
    out.astype("<f4").tofile(path)


def write_ivecs(path, data: np.ndarray) -> None:
    """Write [N, dim] int32 rows as ivecs."""
    data = np.ascontiguousarray(data, np.int32)
    n, dim = data.shape
    out = np.empty((n, dim + 1), np.int32)
    out[:, 0] = dim
    out[:, 1:] = data
    out.astype("<i4").tofile(path)
