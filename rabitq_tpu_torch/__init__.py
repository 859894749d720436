"""rabitq_tpu_torch -- the PyTorch/CUDA port of rabitq_tpu for NVIDIA Hopper.

A second package beside the JAX one, held against it by the tests. It
trains IVF-RaBitQ and brute-force indexes and builds MSTG ones, saves and
loads them in the reference's RBQ1/RBF1 files and the MSTG native and
reference formats, and serves batched searches through the fused
EXACT scan, the two-stage fused scan, the gather scan and the dense scans,
in memory or streamed from host RAM (``StreamedIvfIndex``);
the FHT inside every rotation, the two bin scans and the packed lower-bound
scan are hand-written CUDA kernels (``csrc/``), built with ``nvcc`` at first
use. Entry points run on the card unless the caller passes
``device="cpu"``.
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
from .index.brute_force import BruteForceRabitqIndex, BruteForceSearchParams
from .index.ivf import IvfRabitqIndex
from .index.loader import RabitqIndex, load_index
from .index.mstg import MstgConfig, MstgIndex, MstgSearchParams, ScalarPrecision
from .index.streaming import StreamedIvfIndex

__version__ = "0.1.0"

__all__ = [
    "Metric",
    "RotatorType",
    "SearchParams",
    "SearchResult",
    "SearchDiagnostics",
    "IvfRabitqIndex",
    "StreamedIvfIndex",
    "BruteForceRabitqIndex",
    "BruteForceSearchParams",
    "MstgConfig",
    "MstgIndex",
    "MstgSearchParams",
    "ScalarPrecision",
    "RabitqIndex",
    "load_index",
    "RabitqError",
    "DimensionMismatch",
    "InvalidConfig",
    "EmptyIndex",
    "IoError",
    "InvalidPersistence",
]
