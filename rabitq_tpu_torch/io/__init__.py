"""Reference-compatible index files: RBQ1 v3 (IVF) and RBF1 v1 (brute force)."""
