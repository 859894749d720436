"""The query encoding of an index on the card, on the CPU: the plain version
of the encode kernel (``ops/encode.encode_rows_plain``, the kernel's twin)
against the host's numpy encoding (``index/scan._encode``), bitwise. The
kernel itself is held against the twin on the card (``test_torch_cuda.py``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rabitq_tpu_torch.index.scan import _encode
from rabitq_tpu_torch.ops.encode import BITS, encode_rows, encode_rows_plain

SIZES = [(1, 1), (70, 128), (1000, 1024)]  # (queries, rows padded to)


def _row(kind: str, dim: int, rng, top: float) -> np.ndarray:
    x = rng.standard_normal(dim).astype(np.float32)
    if kind == "zeros":
        return np.zeros(dim, np.float32)
    if kind == "halves":
        # |x| max ``top`` (127 for int8, 7 for int4) makes the scale 1.0: every
        # other value lands on k + 0.5 after scaling (round half to even)
        x = np.resize(np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 6.5, -6.5], np.float32), dim)
        x[0] = top
        return x
    if kind == "one_large":
        x[:] = 0
        x[dim // 3] = -3.0e38
        return x
    if kind == "tiny":
        return x * np.float32(1e-40)  # subnormal f32, under the 1e-30 floor
    if kind == "nan":
        x[1] = np.nan
        return x
    if kind == "inf":
        x[2], x[5] = np.inf, -np.inf
        return x
    return x * 3


def _queries(kind: str, n: int, dim: int, upload: str = "int8", seed: int = 0) -> np.ndarray:
    """``n`` rows, the first of the ``kind`` asked for, the rest random with a
    row of each special kind among them where ``n`` allows."""
    rng = np.random.default_rng(seed)
    top = (1 << (BITS.get(upload, 8) - 1)) - 1.0
    kinds = [kind] + ["random", "zeros", "halves", "one_large", "tiny", "nan", "inf"] * n
    return np.stack([_row(k, dim, rng, top) for k in kinds[:n]])


def _assert_bitwise(got, want) -> None:
    """Codes bitwise equal, padding rows included; scales bitwise equal, and
    NaN where numpy's is NaN (a NaN's bits are the platform's)."""
    (got_q, got_s), (want_q, want_s) = got, want
    assert got_q.dtype == want_q.dtype and got_q.shape == want_q.shape
    assert torch.equal(got_q.view(torch.uint8), want_q.view(torch.uint8))
    nan = torch.isnan(want_s)
    assert torch.equal(torch.isnan(got_s), nan)
    assert torch.equal(got_s[~nan].view(torch.int32), want_s[~nan].view(torch.int32))


@pytest.mark.parametrize("dim", [960, 33])
@pytest.mark.parametrize("n,b_pad", SIZES)
@pytest.mark.parametrize("kind", ["random", "zeros", "halves", "one_large", "tiny", "nan", "inf"])
@pytest.mark.parametrize("upload", ["int8", "int4"])
def test_plain_encode_is_the_host_encode_bitwise(upload, kind, n, b_pad, dim):
    q = _queries(kind, n, dim, upload)
    with np.errstate(invalid="ignore"):
        want = _encode(q, b_pad, dim, upload)
    _assert_bitwise(encode_rows_plain(torch.from_numpy(q), b_pad, BITS[upload]), want)


def test_encode_rows_refuses_other_code_widths():
    with pytest.raises(ValueError, match="8 or 4 bits"):
        encode_rows_plain(torch.zeros((2, 4)), 2, 2)


@pytest.mark.parametrize("upload", ["f32", "bf16", "int8", "int4"])
def test_encode_rows_refuses_rows_on_the_cpu(upload):
    """The card's entry takes rows on the card only: an index on the CPU
    encodes with numpy (``index/scan.encode_queries``)."""
    with pytest.raises(ValueError, match="on the card"):
        encode_rows(torch.zeros((2, 4)), 2, upload)
