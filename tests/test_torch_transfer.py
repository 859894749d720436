"""The port's dataset upload (``rabitq_tpu_torch/utils/transfer.py``) against
the JAX package's (``rabitq_tpu/utils/transfer.py``): the same host rows
decode to bitwise the same f32 device values under every encoding, with the
same report keys, and ``IvfRabitqIndex.train(data_upload=...)`` builds from
those values."""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

import rabitq_tpu as jr
import rabitq_tpu_torch as tr
from rabitq_tpu.utils import transfer as jt
from rabitq_tpu_torch.utils import transfer as tt


def _rows(n=1500, dim=48, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, dim)) * rng.uniform(0.01, 30.0, (n, 1))).astype(np.float32)


@pytest.mark.parametrize("encoding", ["auto", "f32", "bf16", "int8"])
def test_upload_decodes_as_jax(encoding):
    data = _rows()
    j_dev, j_rep = jt.upload_dataset(data, encoding, chunk_rows=512)
    t_dev, t_rep = tt.upload_dataset(data, encoding, chunk_rows=512, device="cpu")
    assert t_dev.dtype == torch.float32 and t_dev.shape == data.shape
    np.testing.assert_array_equal(t_dev.numpy(), np.asarray(j_dev))
    assert set(t_rep) == set(j_rep)
    assert t_rep["encoding"] == j_rep["encoding"] and t_rep["bytes"] == j_rep["bytes"]
    if encoding in ("auto", "f32"):
        np.testing.assert_array_equal(t_dev.numpy(), data)


def test_upload_in_the_jax_shape():
    """``upload_dataset(data, encoding, chunk_rows)``, positionally as the
    JAX package takes it: the chunk size lands in ``chunk_rows``, the rows
    decode as the JAX package's, on the device asked for (the card where
    none is named)."""
    data = _rows(700, 16)
    j_dev, j_rep = jt.upload_dataset(data, "int8", 256)
    t_dev, t_rep = tt.upload_dataset(data, "int8", 256, device="cpu")
    assert t_dev.device == torch.device("cpu")
    np.testing.assert_array_equal(t_dev.numpy(), np.asarray(j_dev))
    assert t_rep["bytes"] == j_rep["bytes"] == 700 * 16
    params = inspect.signature(tt.upload_dataset).parameters
    assert list(params)[:3] == list(inspect.signature(jt.upload_dataset).parameters)
    assert params["device"].kind is inspect.Parameter.KEYWORD_ONLY
    assert params["device"].default is None


def test_resolve_encoding_matches_jax():
    big = np.broadcast_to(np.float32(0.0), (140_000_000,))  # 560 MB, no memory
    small = _rows(10)
    for data in (big, small):
        for enc in ("auto", "f32", "bf16", "int8"):
            assert tt.resolve_encoding(data, enc) == jt.resolve_encoding(data, enc)
    assert tt.resolve_encoding(big) == "bf16" and tt.resolve_encoding(small) == "f32"
    for mod in (jt, tt):
        with pytest.raises(ValueError, match="fp8"):
            mod.resolve_encoding(small, "fp8")


def test_resident_tensor_is_used_as_is():
    t = torch.from_numpy(_rows(64))
    out, rep = tt.upload_dataset(t, "int8", device="cpu")
    assert out.data_ptr() == t.data_ptr() and rep["bytes"] == 0 and rep["encoding"] == "resident"
    empty, rep = tt.upload_dataset(np.zeros((0, 8), np.float32), "bf16", device="cpu")
    assert empty.shape == (0, 8) and rep["bytes"] == 0


def test_ivf_train_builds_from_the_decoded_rows():
    """``data_upload="int8"`` trains on the values the upload decodes to: the
    same index as training on those values sent exact; the report names the
    encoding and the JAX package's byte count."""
    data = _rows(1200, 64)
    kw = dict(nlist=8, total_bits=7, seed=3, use_faster_config=True, device="cpu")
    lossy = tr.IvfRabitqIndex.train(data, data_upload="int8", **kw)
    decoded = np.asarray(jt.upload_dataset(data, "int8")[0])
    exact = tr.IvfRabitqIndex.train(decoded, data_upload="f32", **kw)
    assert lossy.build_report["upload"]["encoding"] == "int8"
    j_idx = jr.IvfRabitqIndex.train(data, nlist=8, total_bits=7, seed=3, use_faster_config=True,
                                    data_upload="int8")
    assert lossy.build_report["upload"]["bytes"] == j_idx.build_report["upload"]["bytes"]
    a, b = lossy.host, exact.host
    for name in ("binary_bits", "ex_codes", "f_add", "f_rescale", "delta", "vl", "ids",
                 "cluster_offsets", "centroids"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
