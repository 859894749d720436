"""I/O: fvecs/ivecs dataset files, and the reference-compatible index files
RBQ1 v3 (IVF) and RBF1 v1 (brute force)."""

from .vecio import read_fvecs, read_groundtruth, read_ids, read_ivecs, write_fvecs, write_ivecs

__all__ = [
    "read_fvecs",
    "read_ivecs",
    "read_ids",
    "read_groundtruth",
    "write_fvecs",
    "write_ivecs",
]
