"""Posting-list directory — scaffolding for a future disk tier (a copy of
``rabitq_tpu/index/mstg/metadata.py``).

Parity with the reference's placeholder (lqhl/rabitq-rs
``mstg/metadata.rs:5-59``; constructed empty at ``mstg/index.rs:126-127``):
the MSTG spec (``docs/MSTG_SPEC.md:44-75``) reserves a billion-scale tier
where cold posting lists live on disk/remote storage and are paged in on
demand. On the card the analogous design streams cold posting-list code
planes from host memory into device memory with async copies; the directory
records where each list's rows live.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PostingListEntry:
    """Location/metadata of one posting list (``mstg/metadata.rs``)."""

    cluster_id: int
    disk_offset: int = 0
    size_bytes: int = 0
    num_vectors: int = 0
    resident: bool = True  # True: rows are in the device code planes


@dataclass
class PostingListDirectory:
    """Directory over posting lists; currently all lists are resident."""

    entries: list[PostingListEntry] = field(default_factory=list)

    @classmethod
    def from_offsets(cls, list_offsets, row_bytes: int) -> "PostingListDirectory":
        entries = []
        for c in range(len(list_offsets) - 1):
            n = int(list_offsets[c + 1] - list_offsets[c])
            entries.append(
                PostingListEntry(
                    cluster_id=c,
                    disk_offset=int(list_offsets[c]) * row_bytes,
                    size_bytes=n * row_bytes,
                    num_vectors=n,
                )
            )
        return cls(entries)

    def total_vectors(self) -> int:
        return sum(e.num_vectors for e in self.entries)
