"""MSTG hierarchical index (SPANN-style) on the card: the port of
``rabitq_tpu.index.mstg``."""

from .config import MstgConfig, MstgSearchParams, ScalarPrecision
from .index import MstgIndex

__all__ = ["MstgConfig", "MstgSearchParams", "ScalarPrecision", "MstgIndex"]
