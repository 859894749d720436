"""``ops/select.top_k``, the port's one selection, against ``jax.lax.top_k``
on the CPU, and the selection sites that tie: the k-means reseed, the MSTG
closure and the shard merge.

Every comparison is exact: values bit for bit (a NaN's payload, a zero's
sign) and indices equal. The inputs tie heavily on purpose: integer-valued
floats, values rounded to bf16, a constant row, signed zeros, infinities and
NaNs of both signs with several payloads.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabitq_tpu.index.mstg import closure as jcl
from rabitq_tpu.ops import kmeans as jk
from rabitq_tpu_torch.index.mstg import closure as tcl
from rabitq_tpu_torch.ops import kmeans as tk
from rabitq_tpu_torch.ops import select
from rabitq_tpu_torch.parallel import sharding as tsh

# f32 bit patterns the order must place: NaNs of both signs and three
# payloads, infinities, signed zeros, +-1
SPECIAL_F32 = np.array(
    [0x7FC00000, 0x7FC00001, 0x7FC00002, 0xFFC00000, 0xFFC00001, 0x7F800000, 0xFF800000,
     0x00000000, 0x80000000, 0x3F800000, 0xBF800000], dtype=np.uint32,
)


def _bits(kind: str, shape, rng) -> np.ndarray:
    """Bits of a float32 input (uint32) or, for the "bf16_*" kinds, a bf16
    input (uint16)."""
    n = int(np.prod(shape))
    if kind == "integers":
        x = rng.integers(-3, 4, n).astype(np.float32)
    elif kind == "rounded_to_bf16":  # f32 values that carry bf16's precision
        x = rng.standard_normal(n).astype(np.float32)
        x = (x.view(np.uint32) & 0xFFFF0000).view(np.float32)
    elif kind == "constant":
        x = np.full(n, 1.5, np.float32)
    elif kind == "special":
        return rng.choice(SPECIAL_F32, n).reshape(shape)
    elif kind == "signed_zeros":
        return rng.choice(SPECIAL_F32[7:9], n).reshape(shape)
    elif kind == "bf16_normal":
        x = rng.standard_normal(n).astype(np.float32)
        return (x.view(np.uint32) >> 16).astype(np.uint16).reshape(shape)
    elif kind == "bf16_special":
        return (rng.choice(SPECIAL_F32, n) >> 16).astype(np.uint16).reshape(shape)
    else:
        raise ValueError(kind)
    return x.view(np.uint32).reshape(shape)


def _pair(bits: np.ndarray):
    """The same bits as a JAX array and a torch tensor."""
    if bits.dtype == np.uint16:
        return jnp.asarray(bits.view(jnp.bfloat16)), torch.from_numpy(bits.view(np.int16)).view(
            torch.bfloat16)
    return jnp.asarray(bits.view(np.float32)), torch.from_numpy(bits.view(np.float32).copy())


def _as_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


KINDS = ("integers", "rounded_to_bf16", "constant", "special", "signed_zeros", "bf16_normal",
         "bf16_special")


@pytest.mark.parametrize("k_of", ["1", "mid", "n"])
@pytest.mark.parametrize("shape", [(37,), (5, 64)])
@pytest.mark.parametrize("kind", KINDS)
def test_top_k_equals_lax_top_k(kind, shape, k_of):
    rng = np.random.default_rng(len(kind) * 100 + len(shape))
    bits = _bits(kind, shape, rng)
    n = shape[-1]
    k = {"1": 1, "mid": n // 3, "n": n}[k_of]
    jx, tx = _pair(bits)
    j_val, j_idx = jax.lax.top_k(jx, k)
    t_val, t_idx = select.top_k(tx, k)
    assert t_val.dtype == tx.dtype and t_idx.dtype == torch.int32
    assert t_val.shape == t_idx.shape == (*shape[:-1], k)
    np.testing.assert_array_equal(_as_bits(t_val), np.asarray(j_val).view(bits.dtype))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_ordered_key_is_lax_top_k_total_order(dtype):
    """Every bf16 bit pattern, and those patterns widened to f32 with a low
    payload, all in one row: the full order equals ``lax.top_k``'s. The bf16
    row leaves out the subnormals and the NaNs other than 0x7FC0 and 0xFFC0:
    XLA's bf16 top_k on the CPU compares through f32 with subnormals flushed
    to zero and signalling NaNs quieted, and returns every NaN as one of
    those two, where the port orders and keeps each pattern's bits (held
    for those patterns against the f32 row, which XLA orders by its bits)."""
    bits = np.arange(1 << 16, dtype=np.uint32)
    if dtype == "bf16":
        exponent, mantissa = bits & 0x7F80, bits & 0x7F
        odd = ((exponent == 0) & (mantissa != 0)) | ((exponent == 0x7F80) & (mantissa != 0)
                                                     & ((bits & 0x7FFF) != 0x7FC0))
        bits = bits[~odd].astype(np.uint16)
    else:
        bits = (bits << 16) | np.random.default_rng(0).integers(0, 3, bits.size, dtype=np.uint32)
    bits = np.random.default_rng(1).permutation(bits)
    jx, tx = _pair(bits)
    j_val, j_idx = jax.lax.top_k(jx, bits.size)
    t_val, t_idx = select.top_k_plain(tx, bits.size)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(_as_bits(t_val), np.asarray(j_val).view(bits.dtype))


def test_top_k_dispatch_and_limits():
    x = torch.tensor([[1.0, 3.0, 2.0], [0.0, -0.0, 5.0]])
    before = dict(select.top_k_cuda.launches)
    v, i = select.top_k(x, 2)  # a CPU tensor: the plain version, no launch
    assert select.top_k_cuda.launches == before
    assert v.tolist() == [[3.0, 2.0], [5.0, 0.0]] and i.tolist() == [[1, 2], [2, 0]]
    v, i = select.top_k(x, 0)
    assert v.shape == i.shape == (2, 0)
    for bad in (x.to(torch.float64), x.to(torch.int32), x[None], torch.tensor(1.0)):
        with pytest.raises(ValueError):
            select.top_k(bad, 1)
    with pytest.raises(ValueError):
        select.top_k(x, 4)
    with pytest.raises(ValueError):
        select.top_k(x.to("meta"), 1)  # neither the CPU nor a CUDA device
    with pytest.raises(ValueError):
        select.top_k_cuda(x, 1, site="nowhere")


@pytest.mark.parametrize("n,k,want", [
    (4096, 4096, "sort"),      # centroid ranking at k = n (dense scans)
    (4096, 16, "select"),      # centroid ranking, a probe bucket
    (8192, 400, "select"),     # best bins
    (400, 10, "warp"),         # final top-k
    (40, 10, "warp"),          # shard merge, 4 shards x 10
    (2363, 4, "select"),       # MSTG closure over ~2,363 lists
    (8193, 400, "cluster"),    # past the short rows
    (1024, 32, "warp"), (1024, 33, "select"), (1025, 32, "select"),
    (8192, 4096, "select"), (8192, 4097, "sort"), (1001, 1001, "sort"),
    (1_000_064, 400, "cluster"),  # survivors [256, ~1M]
    (1_000_000, 8, "cluster"),    # the k-means reseed, one row of 1M
    (50_000, 8, "cluster"),       # rows of an MSTG split's reseed's length
    (1_000_000, 8192, "cluster"), (1_000_000, 8193, "spill"),  # the on-chip capacity
    (1_000_448, 10_000, "spill"),
])
def test_kernel_path_at_each_site(n, k, want):
    """The card's variant for each selection site's shape, and on both
    sides of each limit: the short rows (at most 8192 entries) in shared
    memory or a warp, the survivors on the long-row kernel, which orders
    k <= CAND winners on chip and spills larger k; one long row with k <= 32
    (the k-means reseed, a 1-D tensor) on the whole card. A function of (n,
    k) and, for one row, the rows: both types keep 64-bit composites."""
    assert select.kernel_path(n, k) == want
    one_row = "grid" if want == "cluster" and k <= select.WARP_K else want
    assert select.kernel_path(n, k, 1) == one_row


# cudaOccupancyMaxActiveClusters for the long-row kernel on an H100 SXM
# (132 multiprocessors, one block of 512 threads each), as the card reports it
H100_SMS = 132
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


@pytest.mark.parametrize("rows,n,k,elem,want", [
    (256, 1_000_064, 400, 2, ("cluster", 16, 7)),  # survivors bf16 (8 bits packed, brute force)
    (256, 1_000_064, 400, 4, ("cluster", 16, 6)),  # the same plane in f32: 4 MB rows, six fit
    (1, 1_000_000, 8, 4, ("grid", 1, 123)),        # the k-means reseed: one row over the card
    (1, 4_000, 8, 4, None),                        # an MSTG split's reseed, short: no plan
    (1, 50_000, 8, 4, ("grid", 1, 7)),             # an MSTG split's reseed, long
    (256, 8_193, 400, 4, ("cluster", 1, 132)),     # the closure at n = 8,193: a block a row
    (256, 1_000_448, 10_000, 2, ("spill", 16, 7)),  # k = 10,000: every row spills
    (4, 1_000_448, 400, 2, ("cluster", 16, 4)),    # few long rows
    (1, 1_000_000, 33, 4, ("cluster", 16, 1)),     # one row, k past the grid variant's 32
])
def test_long_row_plan_at_the_main_path_shapes(rows, n, k, elem, want):
    """The long-row kernel's grid is a pure function of the shape, the card's
    multiprocessors and its cluster occupancy: one launch whatever the rows
    (the reseed's one row on the whole card), rows in flight x row bytes
    within the L2 budget, at most one block a multiprocessor in a cluster
    grid (two in the one-row grid), every block of a cluster larger than
    one a slice of at least MIN_SLICE entries; the variant as kernel_path
    names it. A card that holds fewer clusters of 16 gets fewer rows in
    flight, never more bytes."""
    if want is None:
        assert select.kernel_path(n, k, rows) in ("warp", "sort", "select")
        return
    plan = select.long_row_plan(rows, n, k, elem, H100_SMS, H100_CLUSTERS)
    assert (plan.variant, plan.cluster, plan.clusters) == want
    assert plan.variant == select.kernel_path(n, k, rows)
    assert plan.in_flight_bytes <= select.L2_BUDGET
    if plan.variant == "grid":
        assert plan.rows_in_flight == 1 and plan.blocks <= 2 * H100_SMS
        assert plan.clusters == -(-n * elem // select.GRID_BLOCK_BYTES)
        return
    assert plan.blocks <= H100_SMS and plan.clusters <= min(rows, H100_CLUSTERS[plan.cluster])
    assert plan.cluster == 1 or n >= plan.cluster * select.MIN_SLICE
    small = select.long_row_plan(rows, n, k, elem, H100_SMS, {**H100_CLUSTERS, 16: 2})
    assert small.in_flight_bytes <= select.L2_BUDGET and small.blocks <= H100_SMS


@pytest.mark.parametrize("kind", ["ties_beyond_the_capacity", "one_value", "masked_94"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_top_k_equals_lax_top_k_on_the_long_rows_branches(kind, dtype):
    """The inputs the long-row kernel branches on, against ``lax.top_k``:
    rows whose k-th key is tied by more than CAND entries (the spill), rows
    of one value, and rows 94% -inf as a survivor plane at nprobe 256."""
    rng = np.random.default_rng(len(kind))
    n, k = 20_000, 400
    x = rng.integers(-200, 200, (2, n)).astype(np.float32) / 4
    if kind == "ties_beyond_the_capacity":
        x[:, rng.permutation(n)[: select.CAND + 800]] = 60.0  # above every other entry
    elif kind == "one_value":
        x[:] = 2.5
    else:
        x[rng.random((2, n)) < 0.94] = -np.inf
    bits = x.view(np.uint32)
    if dtype == "bf16":
        bits = (bits >> 16).astype(np.uint16)
    jx, tx = _pair(bits)
    j_val, j_idx = jax.lax.top_k(jx, k)
    t_val, t_idx = select.top_k(tx, k)
    np.testing.assert_array_equal(_as_bits(t_val), np.asarray(j_val).view(bits.dtype))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))


def test_no_other_selection_in_the_port():
    """``torch.topk`` orders ties as it likes: the port selects with
    ``ops/select.top_k`` only."""
    root = Path(select.__file__).resolve().parent.parent
    found = [str(p.relative_to(root)) for p in root.rglob("*.py")
             if re.search(r"torch\.topk|\.topk\(", p.read_text())]
    assert found == []


def test_reseed_picks_the_jax_rows_among_tied_distances():
    """One Lloyd step with three empty clusters on integer rows: twelve far
    rows at the same distance from their centroid (+-10 along six axes)
    compete for the reseeds; both packages take the same rows, and the
    centroids come out bitwise equal."""
    rng = np.random.default_rng(5)
    dim = 8
    near = rng.integers(-1, 2, (244, dim)).astype(np.float32)
    far = np.zeros((12, dim), np.float32)
    for j in range(12):
        far[j, j % 6] = 10.0 if j < 6 else -10.0
    data = np.concatenate([near[:100], far, near[100:]])
    init = np.zeros((6, dim), np.float32)
    init[1, 0], init[2, 1] = 40.0, -40.0
    init[3:] = 1000.0 + np.arange(3, dtype=np.float32)[:, None]  # empty clusters
    jc, _ = jk._lloyd_step(jnp.asarray(data), jnp.asarray(init), 6, 64, len(data), False)
    tc, _ = tk._lloyd_step(torch.from_numpy(data), torch.from_numpy(init), 6, 64, len(data), False)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert {tuple(r) for r in tc.numpy()[3:]} <= {tuple(r) for r in far}


def test_closure_candidates_equal_jax_among_tied_centroids():
    """Rows equidistant from several centroids: the candidate order (ties to
    the lower centroid) and the RNG rule's picks equal the JAX package's."""
    cents = np.array([[2, 0], [0, 2], [-2, 0], [0, -2], [4, 4], [-4, 4]], np.float32)
    rows = np.array([[0, 0], [1, 1], [-1, 1], [0, 3], [2, 2], [0, 0]], np.float32)
    j_cand, j_sel = jcl._closure_chunk(jnp.asarray(rows), jnp.asarray(cents), 0.5, 4)
    t_cand, t_sel = tcl._closure_chunk(torch.from_numpy(rows), torch.from_numpy(cents), 0.5, 4)
    np.testing.assert_array_equal(t_cand.numpy(), np.asarray(j_cand))
    np.testing.assert_array_equal(t_sel.numpy(), np.asarray(j_sel))


def test_shard_merge_equals_jax_on_signed_zeros_and_ties():
    """Four shards' candidates with tied distances, +0.0 beside -0.0 and
    +inf padding: ids and distances (bits) equal ``lax.top_k(-d, k)``'s,
    the JAX package's merge (``rabitq_tpu/parallel/sharding.py:167``)."""
    rng = np.random.default_rng(2)
    dists = rng.choice(np.array([0.0, -0.0, 1.0, 2.0, np.inf], np.float32), (6, 4 * 5))
    ids = rng.integers(0, 1000, dists.shape).astype(np.int32)
    g_ids, g_d = tsh._merge_topk(
        list(torch.from_numpy(ids).split(5, dim=1)), list(torch.from_numpy(dists).split(5, dim=1)),
        7, torch.device("cpu"),
    )
    neg, pos = jax.lax.top_k(-jnp.asarray(dists), 7)
    np.testing.assert_array_equal(g_ids.numpy(), np.take_along_axis(ids, np.asarray(pos), 1))
    np.testing.assert_array_equal(g_d.numpy().view(np.uint32),
                                  (-np.asarray(neg)).view(np.uint32))
