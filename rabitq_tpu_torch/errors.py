"""Error taxonomy for rabitq_tpu_torch (a copy of ``rabitq_tpu/errors.py``).

Mirrors the reference error surface (lqhl/rabitq-rs ``src/lib.rs:41-57``):
DimensionMismatch, InvalidConfig, EmptyIndex, Io, InvalidPersistence.
"""

from __future__ import annotations


class RabitqError(Exception):
    """Base class for all rabitq_tpu_torch errors."""


class DimensionMismatch(RabitqError):
    def __init__(self, expected: int, got: int):
        super().__init__(f"dimension mismatch: expected {expected}, got {got}")
        self.expected = expected
        self.got = got


class InvalidConfig(RabitqError):
    def __init__(self, msg: str):
        super().__init__(f"invalid configuration: {msg}")


class EmptyIndex(RabitqError):
    def __init__(self, msg: str = "index is empty; call `train` first"):
        super().__init__(msg)


class IoError(RabitqError):
    def __init__(self, msg: str):
        super().__init__(f"i/o error while reading or writing an index: {msg}")


class InvalidPersistence(RabitqError):
    def __init__(self, msg: str):
        super().__init__(f"invalid persisted index: {msg}")
