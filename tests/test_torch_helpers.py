"""Small public functions of the port against the JAX package's:
``ops/quantize.reconstruct``, ``ops/estimator.scores_from_distances``, and
the profiling helpers (``utils/profiling.py``: a Chrome trace written on
the CPU). Tolerance: reconstruct rtol 1e-6 (one f32
multiply-add in another order), scores exact."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import rabitq_tpu as jr
import rabitq_tpu_torch as tr
from rabitq_tpu.ops import estimator as jest
from rabitq_tpu.ops import quantize as jq
from rabitq_tpu_torch.ops import estimator as t_est
from rabitq_tpu_torch.ops import quantize as tq
from rabitq_tpu_torch.utils.profiling import device_trace


def test_reconstruct_matches_jax():
    rng = np.random.default_rng(0)
    centroid = rng.standard_normal((5, 64)).astype(np.float32)
    code = rng.integers(0, 128, (5, 64)).astype(np.uint16)
    delta = rng.random(5).astype(np.float32)
    vl = -rng.random(5).astype(np.float32)
    want = np.asarray(jq.reconstruct(jnp.asarray(centroid), jnp.asarray(code),
                                     jnp.asarray(delta), jnp.asarray(vl)))
    got = tq.reconstruct(torch.from_numpy(centroid), torch.from_numpy(code.astype(np.int32)),
                         torch.from_numpy(delta), torch.from_numpy(vl))
    assert got.dtype == torch.float32 and got.shape == (5, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_reconstruct_rebuilds_an_indexed_row():
    """The stored row, rebuilt in rotated space from its codes, rotated back
    (``fetch_embedding`` does the same on the host copy)."""
    data = np.random.default_rng(1).standard_normal((300, 32)).astype(np.float32)
    index = tr.IvfRabitqIndex.train(data, nlist=4, total_bits=7, device="cpu")
    h = index.host
    row = 7
    cluster = int(np.searchsorted(h.cluster_offsets, row, side="right") - 1)
    total = h.ex_codes[row].astype(np.int32) + (h.binary_bits[row].astype(np.int32) << 6)
    rec = tq.reconstruct(torch.from_numpy(h.centroids[cluster]),
                         torch.from_numpy(total), torch.tensor(h.delta[row]),
                         torch.tensor(h.vl[row]))
    back = index.rotator.inverse_rotate(rec[None, :])[0].numpy()
    np.testing.assert_allclose(back, index.fetch_embedding(int(h.ids[row])), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_scores_from_distances_matches_jax(metric):
    dist = np.array([[0.5, -1.25, np.inf]], np.float32)
    want = np.asarray(jest.scores_from_distances(jnp.asarray(dist), jr.Metric.from_str(metric)))
    got = t_est.scores_from_distances(torch.from_numpy(dist), tr.Metric.from_str(metric))
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with device_trace(str(logdir)) as prof:
        torch.mm(torch.ones(64, 64), torch.ones(64, 64))
    path = logdir / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
    # a block that raises still leaves its trace
    with pytest.raises(ValueError):
        with device_trace(str(tmp_path / "raised")):
            raise ValueError("stop")
    assert os.path.exists(tmp_path / "raised" / "trace.json")

