"""Index loader by magic (port of ``rabitq_tpu/index/loader.py``).

Mirrors the reference ``RabitqIndex`` enum (lqhl/rabitq-rs
``src/index.rs:36-198``): peek the 4-byte magic, dispatch ``RBQ1`` to the
IVF loader and ``RBF1`` to the brute-force loader, reject anything else.
"""

from __future__ import annotations

import torch

from ..errors import InvalidPersistence
from .brute_force import BruteForceRabitqIndex
from .ivf import IvfRabitqIndex


class RabitqIndex:
    """Either index kind behind one type (``index.rs:36-69``)."""

    def __init__(self, inner):
        self.inner = inner

    @property
    def kind(self) -> str:
        return "ivf" if isinstance(self.inner, IvfRabitqIndex) else "brute_force"

    @property
    def is_ivf(self) -> bool:
        return self.kind == "ivf"

    @property
    def is_brute_force(self) -> bool:
        return self.kind == "brute_force"

    def as_ivf(self) -> IvfRabitqIndex:
        if not self.is_ivf:
            raise TypeError("index is not an IVF index")
        return self.inner

    def as_brute_force(self) -> BruteForceRabitqIndex:
        if not self.is_brute_force:
            raise TypeError("index is not a brute-force index")
        return self.inner

    def __len__(self) -> int:
        return len(self.inner)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    @classmethod
    def load_from_path(
        cls, path, scan_dtype: str = "bf16", device: "str | torch.device | None" = None
    ) -> "RabitqIndex":
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic == b"RBQ1":
            return cls(IvfRabitqIndex.load_from_path(path, scan_dtype=scan_dtype, device=device))
        if magic == b"RBF1":
            return cls(
                BruteForceRabitqIndex.load_from_path(path, scan_dtype=scan_dtype, device=device)
            )
        raise InvalidPersistence("unrecognized file header")


def load_index(
    path, scan_dtype: str = "bf16", device: "str | torch.device | None" = None
) -> RabitqIndex:
    """``RabitqIndex::load_from_path``: the index kind by the file's magic,
    laid out on ``device`` (None: the card)."""
    return RabitqIndex.load_from_path(path, scan_dtype=scan_dtype, device=device)
