"""rabitq_tpu_torch -- the PyTorch/CUDA port of rabitq_tpu for NVIDIA Hopper.

A second package beside the JAX one, held against it by the tests. It
trains an IVF-RaBitQ index and serves batched searches through the fused
EXACT scan, the two-stage fused scan and the dense scans; the FHT inside
every rotation, the two bin scans and the packed lower-bound scan are
hand-written CUDA kernels (``csrc/``), built with ``nvcc`` at first use.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .errors import (
    DimensionMismatch,
    EmptyIndex,
    InvalidConfig,
    InvalidPersistence,
    IoError,
    RabitqError,
)
from .types import Metric, RotatorType, SearchDiagnostics, SearchParams, SearchResult
from .index.ivf import IvfRabitqIndex

__version__ = "0.1.0"

__all__ = [
    "Metric",
    "RotatorType",
    "SearchParams",
    "SearchResult",
    "SearchDiagnostics",
    "IvfRabitqIndex",
    "RabitqError",
    "DimensionMismatch",
    "InvalidConfig",
    "EmptyIndex",
    "IoError",
    "InvalidPersistence",
]
