"""MSTG configuration (a copy of ``rabitq_tpu/index/mstg/config.py``; parity
with lqhl/rabitq-rs ``src/mstg/config.rs``)."""

from __future__ import annotations

from dataclasses import dataclass
import enum

from ...types import Metric


class ScalarPrecision(enum.Enum):
    """Centroid storage precision (``mstg/config.rs:6-35``).

    The reference only implements FP32/BF16 and panics on FP16/INT8
    (``mstg/hnsw.rs:40-52``); all four are REAL here: centroids are
    rounded through the precision at build time and the rounded values
    drive the residual base, centroid scoring and the persisted bytes
    (``index/mstg/scalar_quant.py``).
    """

    FP32 = "fp32"
    BF16 = "bf16"
    FP16 = "fp16"
    INT8 = "int8"

    @property
    def bytes_per_dim(self) -> float:
        return {"fp32": 4, "bf16": 2, "fp16": 2, "int8": 1}[self.value]


@dataclass
class MstgConfig:
    """(``mstg/config.rs:38-91``; defaults at 64-91)."""

    # clustering
    max_posting_size: int = 5000
    branching_factor: int = 10
    balance_weight: float = 1.0
    # closure assignment
    closure_epsilon: float = 0.15
    max_replicas: int = 8
    # RaBitQ
    rabitq_bits: int = 7
    faster_config: bool = False
    metric: Metric = Metric.L2
    # centroid navigation (the reference's HNSW params are kept for config
    # parity; navigation here is an exact centroid product, so they are
    # accepted and ignored, like hnsw_m/ef_construction already are in the
    # reference itself, mstg/hnsw.rs:91-97)
    hnsw_m: int = 32
    hnsw_ef_construction: int = 200
    centroid_precision: ScalarPrecision = ScalarPrecision.BF16
    # search defaults
    default_ef_search: int = 150
    pruning_epsilon: float = 0.6
    # extension: refine survivors with extended codes (the reference's
    # MSTG scan is 1-bit-estimate only, mstg/index.rs:216-331; refinement
    # improves recall at equal ef — disable for exact reference parity)
    refine_ex: bool = True
    # extension, build-time knob (not persisted): global Lloyd polish
    # iterations applied to the hierarchical leaf partition — the subtree-
    # restricted recursion strands split-boundary rows in far lists, and
    # the polish roughly doubles low-ef recall. 0 restores strict reference
    # clustering behavior.
    refine_iters: int = 12
    # extension: apply an FhtKac rotation before quantization.
    # The reference quantizes MSTG posting lists in the original space
    # (mstg/index.rs:49-88), which caps recall on coordinate-correlated
    # data — the rotation is what makes the RaBitQ error bound
    # dimension-independent. Off by default for reference parity.
    use_rotator: bool = False
    # build-time knob (not persisted): dataset host->device upload encoding
    # ("auto" | "f32" | "bf16" | "int8", utils/transfer.py) — "auto" sends
    # >512 MB datasets bf16, halving the bytes over the host link.
    data_upload: str = "auto"


@dataclass(frozen=True)
class MstgSearchParams:
    """(``mstg/config.rs:95-136``)."""

    ef_search: int = 150
    pruning_epsilon: float = 0.6
    top_k: int = 100
    rerank: int | None = None

    @staticmethod
    def high_recall(top_k: int) -> "MstgSearchParams":
        return MstgSearchParams(ef_search=300, pruning_epsilon=0.8, top_k=top_k)

    @staticmethod
    def balanced(top_k: int) -> "MstgSearchParams":
        return MstgSearchParams(ef_search=150, pruning_epsilon=0.6, top_k=top_k)

    @staticmethod
    def low_latency(top_k: int) -> "MstgSearchParams":
        return MstgSearchParams(ef_search=50, pruning_epsilon=0.4, top_k=top_k)

    def resolved_rerank(self) -> int:
        if self.rerank is not None:
            return max(self.rerank, self.top_k)
        return max(4 * self.top_k, 400)
