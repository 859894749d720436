"""Device layout and fused-scan geometry of the port against the JAX
package: every plane of ``assemble_device_layout`` and every host geometry
helper must be equal."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabitq_tpu.index import layout as jl
from rabitq_tpu.ops import pallas_fused_scan as jfs
from rabitq_tpu.ops import pallas_scan as jps
from rabitq_tpu_torch.index import layout as tl
from rabitq_tpu_torch.ops import fused_scan as tfs
from rabitq_tpu_torch.ops import packed_scan as tps


def _codes(seed, n=1500, dpad=192, c=20):
    rng = np.random.default_rng(seed)
    sizes = rng.multinomial(n, np.ones(c) / c)
    return dict(
        binary=rng.integers(0, 2, (n, dpad)).astype(np.uint8),
        ex=rng.integers(0, 64, (n, dpad)).astype(np.uint16),
        **{k: rng.standard_normal(n).astype(np.float32)
           for k in ("f_add", "f_rescale", "f_error", "f_add_ex", "f_rescale_ex", "delta", "vl")},
        cluster_sizes=sizes,
        ids=rng.permutation(n).astype(np.int64),
        centroids=rng.standard_normal((c, dpad)).astype(np.float32),
    )


@pytest.mark.parametrize("mode", [
    dict(permute=False, row_pad=512), dict(),
    # MSTG's layout: the binary plane kept for the 1-bit re-score, f_error zeroed
    dict(permute=False, row_pad=512, keep_binary=True, zero_f_error=True),
])
def test_layout_planes_match_jax(mode):
    x = _codes(0)
    n = len(x["ids"])
    j = jl.assemble_device_layout(n=n, ex_bits=6, **x, **mode)
    t = tl.assemble_device_layout(n=n, ex_bits=6, device="cpu", **x, **mode)
    np.testing.assert_array_equal(t.perm, j.perm)
    for name in ("binary", "ex", "packed", "f_add", "f_rescale", "f_error", "f_add_ex",
                 "f_rescale_ex", "cluster_of", "valid", "ids", "centroids", "delta", "vl"):
        jv, tv = getattr(j, name), getattr(t, name)
        assert (jv is None) == (tv is None), name
        if jv is not None:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=name)
    if not mode:
        assert t.binary.dtype == torch.int8 and t.packed is None
    else:
        assert (t.binary is None) == ("keep_binary" not in mode)
        assert bool(t.f_error.any()) == ("zero_f_error" not in mode)
        assert t.ex.shape[1] == 256  # width-padded to 128


def test_host_helpers_match_jax():
    sizes = np.random.default_rng(1).multinomial(3000, np.ones(30) / 30)
    assert tl.pad_rows(3000, 512) == jl.pad_rows(3000, 512)
    np.testing.assert_array_equal(tl.cluster_of_rows(sizes, 3072), jl.cluster_of_rows(sizes, 3072))
    b = np.random.default_rng(2).integers(0, 2, (40, 200)).astype(np.int8)
    np.testing.assert_array_equal(tps.pack_bitplanes_np(b, 200), jps.pack_bitplanes_np(b, 200))
    np.testing.assert_array_equal(
        tps.pack_bitplanes(torch.from_numpy(b), 200).numpy(),
        np.asarray(jps.pack_bitplanes(jnp.asarray(b), 200)),
    )
    q = np.random.default_rng(3).standard_normal((5, 200)).astype(np.float32)
    np.testing.assert_array_equal(
        tps.permute_query(torch.from_numpy(q), 200).float().numpy(),
        np.asarray(jps.permute_query(jnp.asarray(q), 200)).astype(np.float32),
    )
    assert tps.packed_bytes(960) == jps.packed_bytes(960)


@pytest.mark.parametrize("c", [40, 900, 4096])
def test_fused_geometry_matches_jax(c):
    rng = np.random.default_rng(c)
    n = 200 * c
    sizes = rng.multinomial(n, rng.dirichlet(np.ones(c) * 2))
    n_pad = jl.pad_rows(n, 512)
    cl = jl.cluster_of_rows(sizes, n_pad)
    valid = np.arange(n_pad) < n
    np.testing.assert_array_equal(
        tfs.tile_cluster_blocks(cl, valid), jfs.tile_cluster_blocks(cl, valid)
    )
    assert tfs.fused_geometry_ok(sizes) == jfs.fused_geometry_ok(sizes)
    for nprobe in (1, 4, 16, 64):
        for bt in (32, 128):
            assert tfs.probed_tile_bound(sizes, nprobe, bt) == jfs.probed_tile_bound(
                sizes, nprobe, bt
            )
            assert tfs.expected_tile_cost(sizes, nprobe, bt) == pytest.approx(
                jfs.expected_tile_cost(sizes, nprobe, bt), rel=1e-12
            )
        slices = [(0, n_pad // 2), (n_pad // 2, n_pad)]
        assert tfs.sliced_max_tiles(sizes, nprobe, slices, 32) == jfs.sliced_max_tiles(
            sizes, nprobe, slices, 32
        )
    assert tfs.n_bins() == jfs.n_bins() and tfs.BIG == jfs.BIG


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_budget_is_the_jax_inline_formula(seed):
    """One formula serves every owner of a scan plan: over a whole index
    (one slice) the plan's budget, ``sliced_max_tiles``, equals the JAX
    IVF index's inline formula at the port's 32-query block, on random list
    sizes with empty lists."""
    from rabitq_tpu_torch.index.scan_plan import ScanPlan

    rng = np.random.default_rng(seed)
    for _ in range(60):
        c = int(rng.integers(1, 3001))
        sizes = rng.multinomial(int(rng.integers(1, 400)) * c, rng.dirichlet(np.ones(c) * 0.7))
        sizes[rng.random(c) < 0.1] = 0
        if not sizes.any():
            sizes[0] = 1
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        plan = ScanPlan(128, 6, offsets=offsets)
        n_tiles = jl.pad_rows(int(sizes.sum()), jfs.TN) // jfs.TN
        for nprobe in map(int, rng.integers(1, 65, 4)):
            want = None
            if jfs.expected_tile_cost(sizes, nprobe, batch_tile=32) < 0.6 * n_tiles:
                bound = jfs.probed_tile_bound(sizes, nprobe, batch_tile=32)
                want = min(1 << (bound - 1).bit_length(), n_tiles)
            assert plan.max_tiles("fused8", nprobe) == want, (c, nprobe)


def test_degenerate_geometry_and_exact_width():
    tiny = np.full(400, 2)  # 2-row clusters: a 512-row tile spans 256
    assert not tfs.fused_geometry_ok(tiny) and not jfs.fused_geometry_ok(tiny)
    with pytest.raises(ValueError):
        tfs.tile_cluster_blocks(tl.cluster_of_rows(tiny, 1024), np.arange(1024) < 800)
    # the port's EXACT width limit is where the JAX package's budget ends
    for w in range(128, 4097, 128):
        assert (w <= tfs.EXACT_MAX_WIDTH) == jfs.fused_fits_vmem(w, direct=True), w
