"""Common public types (a copy of ``rabitq_tpu/types.py``).

Mirrors the reference API surface: ``Metric`` (``src/lib.rs:32-37``),
``RotatorType`` (``src/rotation.rs:10-15``), ``SearchParams``
(``src/ivf.rs:22-26``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class Metric(enum.Enum):
    """Distance metric. L2 = squared Euclidean; InnerProduct = max similarity."""

    L2 = "l2"
    InnerProduct = "ip"

    @staticmethod
    def from_str(s: "str | Metric") -> "Metric":
        if isinstance(s, Metric):
            return s
        s = s.lower().replace("-", "_")
        if s in ("l2", "euclidean", "angular_l2"):
            return Metric.L2
        if s in ("ip", "innerproduct", "inner_product", "dot", "angular"):
            return Metric.InnerProduct
        raise ValueError(f"unknown metric: {s}")

    def to_tag(self) -> int:
        """Persistence tag (reference ``ivf.rs:122-127``)."""
        return 0 if self is Metric.L2 else 1

    @staticmethod
    def from_tag(tag: int) -> "Metric":
        if tag == 0:
            return Metric.L2
        if tag == 1:
            return Metric.InnerProduct
        raise ValueError(f"unknown metric tag: {tag}")


class RotatorType(enum.IntEnum):
    """Rotator selection; values match the persistence tags
    (reference ``rotation.rs:10-15``)."""

    MatrixRotator = 0
    FhtKacRotator = 1

    def padding_requirement(self, dim: int) -> int:
        """Padded dimension required by this rotator
        (reference ``rotation.rs:27-33``)."""
        if self is RotatorType.MatrixRotator:
            return dim
        return ((dim + 63) // 64) * 64


@dataclass(frozen=True)
class SearchParams:
    """IVF search parameters (reference ``ivf.rs:22-26``), plus TPU-specific
    re-rank budget.

    ``rerank`` is the fixed-size survivor set that replaces the reference's
    data-dependent heap pruning (``ivf.rs:2045-2057``): the scan estimates a
    1-bit lower bound for every probed candidate, keeps the best ``rerank``
    of them, and re-scores those exactly with the extended codes. ``None``
    picks ``max(4 * top_k, 400)`` — the CPU reference effectively
    re-ranks every candidate that beats the evolving heap bound, and recall
    is insensitive to the budget beyond a few hundred survivors.

    NOTE: under the fused EXACT scan (the default on fused layouts with
    total_bits <= 7, env ``RABITQ_FUSED_EXACT``) every probed row is
    already scored at full precision in-kernel and there is no survivor
    cut, so ``rerank`` is a no-op there — tuning it for recall only
    affects the two-stage paths (``scan_dtype`` in f32/bf16/int8/packed,
    or ``RABITQ_FUSED_EXACT=0``). The exact scan's residual loss channel
    is a bin collision between two true top-k rows instead
    (~top_k^2/2L odds with L=8192 bins — below measurement noise at the
    bench operating points).
    """

    top_k: int
    nprobe: int
    rerank: int | None = None

    def resolved_rerank(self) -> int:
        if self.rerank is not None:
            return max(self.rerank, self.top_k)
        return max(4 * self.top_k, 400)


@dataclass(frozen=True)
class SearchResult:
    """One search hit (reference ``ivf.rs:144-148``)."""

    id: int
    score: float


@dataclass
class SearchDiagnostics:
    """Scan observability counters (reference ``ivf.rs:150-155``).

    * ``estimated`` — candidates that reached final scoring
    * ``skipped_by_lower_bound`` — probed candidates dropped by the 1-bit
      lower-bound selection (the heap prune in the reference; the fixed
      survivor cut here)
    * ``extended_evaluations`` — candidates re-scored with extended codes
    """

    estimated: int = 0
    skipped_by_lower_bound: int = 0
    extended_evaluations: int = 0
