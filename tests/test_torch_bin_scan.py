"""Bin scan of the port (plain version, on the CPU) against the JAX
package's Pallas ``fused_bin_scan`` in interpret mode and its
``fused_select``: dense walk and compacted tile lists, rows wrapping the
8192 bins, duplicate rows forcing ties, masked rows and unprobed clusters.

Tolerances: ``offered`` equal; bin values rtol 1e-5 (the f32 dot sums in
another order); ``bins_idx`` equal on >= 99.5% of bins (a reordered sum can
flip a near-tie inside a bin). The same holds for an int8 query with its
per-query scale (an integer grid: the exact integer dot, rounded once)
against the JAX package's f32 scan of ``codes * scale``, and against the
port's own f32 mode; its integer dot is bitwise an int64 product's.

Packed mode (stage 1 of the two-stage scan: bit planes, a bf16 or int8
query in bit-plane order, the ``- f_error * g_error`` term): ``offered``
and the filled bins equal, values rtol 1e-5 with a bf16 query and 1e-6 with
an int8 one (its dot is exact), ``bins_idx`` >= 99.9% equal, and
``fused_select`` returns the same candidate rows."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabitq_tpu.ops import pallas_fused_scan as jfs
from rabitq_tpu.ops import pallas_scan as jps
from rabitq_tpu_torch.ops import fused_scan as tfs
from rabitq_tpu_torch.ops import packed_scan as tps

N_TILES, D = 24, 128
# (clusters, duplicate rows): 96 clusters share one window and rows 8192
# apart are duplicated (same bin, same value: the first row must win);
# 300 clusters move the windows
CASES = [(96, True), (300, False)]


def _inputs(seed, bq=64, c=96, dup=True):
    rng = np.random.default_rng(seed)
    n = N_TILES * tfs.TN
    plane = rng.integers(0, 128, (n, D)).astype(np.int8)
    sizes = rng.multinomial(n - 300, np.ones(c) / c)
    cluster_of = np.zeros(n, np.int32)
    cluster_of[: n - 300] = np.repeat(np.arange(c, dtype=np.int32), sizes)
    valid = np.arange(n) < n - 300
    fa = rng.normal(size=n).astype(np.float32) * 10
    fr = rng.normal(size=n).astype(np.float32) * 0.05
    if dup:
        for a in (plane, fa, fr, cluster_of):
            a[8192:8192 + 700] = a[:700]
    allowed = valid & (rng.random(n) > 0.05)
    fa_eff = np.where(allowed, fa, tfs.BIG).astype(np.float32)
    q = rng.normal(size=(bq, D)).astype(np.float32)
    k1x = (-63.5 * q.sum(1)).astype(np.float32)
    g_add = (rng.random((bq, c)) * 50).astype(np.float32)
    probe = rng.random((bq, c)) < 0.3
    c_blk = tfs.tile_cluster_blocks(cluster_of, allowed)
    return dict(plane=plane, fa_eff=fa_eff, fr=fr, cluster_of=cluster_of, q=q, k1x=k1x,
                g_add=g_add, probe=probe, c_blk=c_blk)


def _as_int8(q):
    """(codes int8, scale f32) of an f32 ``[B, D]`` query, as the int8
    upload makes them, and ``codes * scale`` in f32: the same query."""
    scale = np.maximum(np.abs(q).max(axis=1), 1e-30).astype(np.float32) / np.float32(127.0)
    codes = np.clip(np.rint(q / scale[:, None]), -127, 127).astype(np.int8)
    return codes, scale, codes.astype(np.float32) * scale[:, None]


def _g1(x):
    c = x["g_add"].shape[1]
    g1 = np.full((x["q"].shape[0], tfs._pad_clusters(c)), tfs.BIG, np.float32)
    g1[:, :c] = np.where(x["probe"], x["g_add"], tfs.BIG)
    return g1


def _compare_bins(j_out, t_out):
    jv, ji, jo = (np.asarray(a) for a in j_out)
    tv, ti, to = (a.numpy() for a in t_out)
    np.testing.assert_array_equal(to, jo)
    filled = jv < tfs.BIG / 2
    np.testing.assert_array_equal(tv < tfs.BIG / 2, filled)
    np.testing.assert_allclose(tv[filled], jv[filled], rtol=1e-5, atol=1e-4)
    assert np.mean(ti == ji) >= 0.995
    return jo.sum()


@pytest.mark.parametrize("int8_q", [False, True])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("compact", [False, True])
def test_bin_scan_matches_jax(compact, case, int8_q):
    x = _inputs(5, c=case[0], dup=case[1])
    t_q, q_scale = torch.from_numpy(x["q"]), None
    if int8_q:
        codes, scale, x["q"] = _as_int8(x["q"])  # JAX scans codes * scale in f32
        t_q, q_scale = torch.from_numpy(codes), torch.from_numpy(scale)
    g1 = _g1(x)
    bq = x["q"].shape[0]
    tiles = tcount = None
    if compact:
        # one ascending list per 64-query block, skipping a few tiles and
        # padding with the last valid one, as fused_select builds them
        rng = np.random.default_rng(9)
        keep = np.sort(rng.choice(N_TILES, 18, replace=False)).astype(np.int32)
        tiles = np.concatenate([keep, np.full(6, keep[-1], np.int32)])[None, :]
        tcount = np.array([18], np.int32)
    j_out = jfs.fused_bin_scan(
        jnp.asarray(x["plane"]), jnp.asarray(x["q"]), jnp.asarray(x["fa_eff"]),
        jnp.asarray(x["fr"]), jnp.zeros(x["fr"].shape, jnp.float32),
        jnp.asarray(x["cluster_of"]), jnp.asarray(x["k1x"]),
        jnp.asarray(g1, jnp.bfloat16), jnp.zeros(g1.shape, jnp.bfloat16),
        jnp.asarray(x["c_blk"]),
        tiles=None if tiles is None else jnp.asarray(tiles),
        tcount=None if tcount is None else jnp.asarray(tcount),
    )
    t_out = tfs.fused_bin_scan(
        torch.from_numpy(x["plane"]), t_q, torch.from_numpy(x["fa_eff"]),
        torch.from_numpy(x["fr"]), torch.from_numpy(x["cluster_of"]),
        torch.from_numpy(x["k1x"]), torch.from_numpy(g1).to(torch.bfloat16),
        torch.from_numpy(x["c_blk"]),
        tiles=None if tiles is None else torch.from_numpy(tiles),
        tcount=None if tcount is None else torch.from_numpy(tcount), q_scale=q_scale,
    )
    assert t_out[0].shape == (bq, tfs.n_bins())
    assert _compare_bins(j_out, t_out) > 0


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("max_tiles", [None, 32])
def test_fused_select_matches_jax(max_tiles, case):
    x = _inputs(7, bq=40, c=case[0], dup=case[1])  # pads to the query tiles of each package
    top_k = 10
    j = jfs.fused_select(
        jnp.asarray(x["q"]), jnp.asarray(x["plane"]), jnp.asarray(x["fa_eff"]),
        jnp.asarray(x["fr"]), jnp.zeros(x["fr"].shape, jnp.float32),
        jnp.asarray(x["cluster_of"]), jnp.asarray(x["k1x"]), jnp.asarray(x["g_add"]),
        jnp.zeros(x["g_add"].shape, jnp.float32), jnp.asarray(x["probe"]),
        jnp.asarray(x["c_blk"]), top_k, D, max_tiles=max_tiles,
        direct_plane=True, with_values=True,
    )
    j_idx, j_ok, j_val, j_probed = (np.asarray(a) for a in j)
    t = tfs.fused_select(
        torch.from_numpy(x["q"]), torch.from_numpy(x["plane"]),
        torch.from_numpy(x["fa_eff"]), torch.from_numpy(x["fr"]),
        torch.from_numpy(x["cluster_of"]), torch.from_numpy(x["k1x"]),
        torch.from_numpy(x["g_add"]), torch.from_numpy(x["probe"]),
        torch.from_numpy(x["c_blk"]), top_k, max_tiles=max_tiles,
    )
    t_idx, t_ok, t_val, t_probed = (a.numpy() for a in t)
    np.testing.assert_array_equal(t_probed, j_probed)
    np.testing.assert_array_equal(t_ok, j_ok)
    np.testing.assert_allclose(t_val[j_ok], j_val[j_ok], rtol=1e-5, atol=1e-4)
    assert np.mean(t_idx == j_idx) >= 0.995


def _direct_args(x, q, g1, tiles=None, tcount=None):
    return (torch.from_numpy(x["plane"]), q, torch.from_numpy(x["fa_eff"]),
            torch.from_numpy(x["fr"]), torch.from_numpy(x["cluster_of"]),
            torch.from_numpy(x["k1x"]), torch.from_numpy(g1).to(torch.bfloat16),
            torch.from_numpy(x["c_blk"]), tiles, tcount)


@pytest.mark.parametrize("width", [128, 1024, 2560])
@pytest.mark.parametrize("compact", [False, True])
def test_int8_direct_mode_is_the_f32_mode_on_codes_times_scale(compact, width):
    """The plain version's int8 direct mode against its f32 mode on ``s * c``
    (the same query to f32 rounding), over both walks and the widths the
    EXACT scan serves: a plane of 960 live columns padded to 1024, and the
    widest, 2560, whose dots pass 2**24."""
    rng = np.random.default_rng(width)
    n_tiles, bq = 18, 64
    x = _inputs(11, bq=bq, c=300, dup=False)
    n = n_tiles * tfs.TN
    for key in ("fa_eff", "fr", "cluster_of"):
        x[key] = x[key][:n]
    x["plane"] = rng.integers(0, 128, (n, width)).astype(np.int8)
    q = rng.normal(size=(bq, width)).astype(np.float32)
    if width == 1024:
        q[:, 960:] = 0.0
        x["plane"][:, 960:] = 0
    codes, scale, q32 = _as_int8(q)
    x["k1x"] = (-63.5 * q32.sum(1)).astype(np.float32)
    x["c_blk"] = tfs.tile_cluster_blocks(x["cluster_of"], x["fa_eff"] < tfs.BIG / 2)
    g1 = _g1(x)
    tiles = tcount = None
    if compact:
        tiles, tcount = tfs.compaction_lists(
            torch.from_numpy(x["fa_eff"]), torch.from_numpy(x["cluster_of"]),
            torch.from_numpy(x["probe"]), 32, n_tiles)
    got = tfs.fused_bin_scan(*_direct_args(x, torch.from_numpy(codes), g1, tiles, tcount),
                             q_scale=torch.from_numpy(scale))
    want = tfs.fused_bin_scan_plain(*_direct_args(x, torch.from_numpy(q32), g1, tiles, tcount))
    # the f32 mode rounds at every add of its width-long sum (dots ~1e3 to 4e3
    # here, cancelled by k1x): atol as tests/test_torch_cuda.py's kernel-vs-
    # plain comparison of two f32 sums at these widths
    (wv, wi, wo), (gv, gi, go) = want, got
    assert torch.equal(go, wo) and int(go.sum()) > 0
    filled = wv < tfs.BIG / 2
    assert torch.equal(gv < tfs.BIG / 2, filled)
    atol = {128: 1e-4, 1024: 1e-3, 2560: 4e-3}[width]
    torch.testing.assert_close(gv[filled], wv[filled], rtol=1e-5, atol=atol)
    assert float((gi == wi).float().mean()) >= 0.995


def test_int8_direct_dot_is_the_int64_dot():
    """With fa = 0, fr = 1, k1x = 0 and g = 0 over 16 tiles, bin n holds row
    n's dot: f32(the integer dot) * scale, bitwise, on a plane 2560 wide
    whose extreme rows (127 against +-127) reach 4.1e7, past f32's 2**24."""
    rng = np.random.default_rng(3)
    n, d, bq = 16 * tfs.TN, 2560, 32
    plane = rng.integers(-128, 128, (n, d)).astype(np.int8)
    plane[:64] = 127
    codes = rng.integers(-127, 128, (bq, d)).astype(np.int8)
    codes[:4] = 127
    codes[4:8] = -127
    scale = (rng.random(bq) * 0.1 + 0.01).astype(np.float32)
    dot64 = codes.astype(np.int64) @ plane.astype(np.int64).T
    assert np.abs(dot64).max() > 2**24
    want = dot64.astype(np.float32) * scale[:, None]
    zero = torch.zeros(n)
    val, idx, offered = tfs.fused_bin_scan_plain(
        torch.from_numpy(plane), torch.from_numpy(codes), zero, torch.ones(n),
        torch.zeros(n, dtype=torch.int32), torch.zeros(bq),
        torch.zeros((bq, 256), dtype=torch.bfloat16), torch.zeros(16, dtype=torch.int32),
        q_scale=torch.from_numpy(scale))
    np.testing.assert_array_equal(val.numpy().view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(idx.numpy(), np.broadcast_to(np.arange(n), (bq, n)))
    assert int(offered.sum()) == bq * n


def test_direct_mode_argument_checks():
    x = _inputs(1, bq=32)
    codes, scale, q32 = _as_int8(x["q"])
    g1 = _g1(x)
    with pytest.raises(ValueError, match="q_scale"):
        tfs.fused_bin_scan(*_direct_args(x, torch.from_numpy(codes), g1))  # no q_scale
    with pytest.raises(ValueError, match="q_scale"):
        tfs.fused_bin_scan(*_direct_args(x, torch.from_numpy(q32), g1),
                           q_scale=torch.from_numpy(scale))  # f32 query
    with pytest.raises(ValueError, match="q_scale"):
        tfs.fused_bin_scan(*_direct_args(x, torch.from_numpy(codes), g1),
                           q_scale=torch.from_numpy(scale[:16]))  # not [Bp]
    with pytest.raises(ValueError):
        tfs.fused_bin_scan_cuda(*_direct_args(x, torch.from_numpy(codes), g1),
                                q_scale=torch.from_numpy(scale))  # CPU tensors


def test_compaction_lists_cover_probed_tiles():
    x = _inputs(3, bq=64, c=300, dup=False)
    probe = torch.from_numpy(x["probe"])
    tiles, tcount = tfs.compaction_lists(
        torch.from_numpy(x["fa_eff"]), torch.from_numpy(x["cluster_of"]), probe, 32, N_TILES
    )
    assert tiles.shape == (2, N_TILES) and tcount.shape == (2,)
    cl = x["cluster_of"].reshape(N_TILES, tfs.TN)
    ok = (x["fa_eff"] < tfs.BIG / 2).reshape(N_TILES, tfs.TN)
    for j in range(2):
        union = x["probe"][32 * j : 32 * (j + 1)].any(0)
        needed = [t for t in range(N_TILES) if union[cl[t][ok[t]]].any()]
        got = tiles[j, : tcount[j]].tolist()
        assert got == needed  # ascending, exactly the needed tiles
        assert (tiles[j, tcount[j]:] == got[-1]).all()


def test_cuda_wrapper_refuses_cpu_tensors():
    x = _inputs(1, bq=32)
    args = (
        torch.from_numpy(x["plane"]), torch.from_numpy(x["q"]), torch.from_numpy(x["fa_eff"]),
        torch.from_numpy(x["fr"]), torch.from_numpy(x["cluster_of"]),
        torch.from_numpy(x["k1x"]), torch.from_numpy(_g1(x)).to(torch.bfloat16),
        torch.from_numpy(x["c_blk"]),
    )
    with pytest.raises(ValueError):
        tfs.fused_bin_scan_cuda(*args)


# ----------------------------------------------------------------------
# packed mode
# ----------------------------------------------------------------------


def _packed_inputs(seed, bq=64, c=300):
    """The geometry of ``_inputs`` with bit planes, f_error and g_error, as
    ``tests/test_pallas_fused_scan.py`` builds them. Almost no f_error is a
    bf16 number, so a scan that skips the bf16 rounding of f_error gives
    other values."""
    x = _inputs(seed, bq=bq, c=c, dup=False)
    rng = np.random.default_rng(seed + 50)
    n = N_TILES * tfs.TN
    x["binary"] = rng.integers(0, 2, (n, D)).astype(np.int8)
    x["k1x"] = (-0.5 * x["q"].sum(1)).astype(np.float32)
    fe = np.abs(rng.normal(size=n)).astype(np.float32) + 0.01
    assert np.mean(torch.from_numpy(fe).to(torch.bfloat16).float().numpy() == fe) < 0.01
    x["fe"] = fe
    x["g_err"] = (rng.random(x["g_add"].shape) * 7).astype(np.float32)
    return x


def _q_operand(x, int8_q):
    """(q_perm, q_scale | None) as numpy, quantized as fused_select does."""
    q_perm = tps.permute_query(torch.from_numpy(x["q"]), D)
    if not int8_q:
        return q_perm, None
    qf = q_perm.float()
    scale = torch.clamp_min(qf.abs().amax(1), 1e-30) / 127.0
    return torch.clamp(torch.round(qf / scale[:, None]), -127, 127).to(torch.int8), scale


def _run_packed(x, int8_q, tiles=None, tcount=None, t_fe=None):
    g1 = _g1(x)
    g2 = np.zeros_like(g1)
    g2[:, : x["g_err"].shape[1]] = x["g_err"]
    q_perm, q_scale = _q_operand(x, int8_q)
    j_q = jnp.asarray(q_perm.float().numpy()).astype(jnp.int8 if int8_q else jnp.bfloat16)
    j_out = jfs.fused_bin_scan(
        jps.pack_bitplanes(jnp.asarray(x["binary"]), D), j_q, jnp.asarray(x["fa_eff"]),
        jnp.asarray(x["fr"]), jnp.asarray(x["fe"]), jnp.asarray(x["cluster_of"]),
        jnp.asarray(x["k1x"]), jnp.asarray(g1, jnp.bfloat16), jnp.asarray(g2, jnp.bfloat16),
        jnp.asarray(x["c_blk"]),
        q_scale=None if q_scale is None else jnp.asarray(q_scale.numpy()),
        tiles=None if tiles is None else jnp.asarray(tiles),
        tcount=None if tcount is None else jnp.asarray(tcount),
    )
    t_out = tfs.fused_bin_scan(
        tps.pack_bitplanes(torch.from_numpy(x["binary"]), D), q_perm,
        torch.from_numpy(x["fa_eff"]), torch.from_numpy(x["fr"]),
        torch.from_numpy(x["cluster_of"]), torch.from_numpy(x["k1x"]),
        torch.from_numpy(g1).to(torch.bfloat16), torch.from_numpy(x["c_blk"]),
        tiles=None if tiles is None else torch.from_numpy(tiles),
        tcount=None if tcount is None else torch.from_numpy(tcount),
        f_error=torch.from_numpy(x["fe"] if t_fe is None else t_fe),
        g2=torch.from_numpy(g2).to(torch.bfloat16), q_scale=q_scale,
    )
    return j_out, t_out


def _compare_packed(j_out, t_out, rtol):
    jv, ji, jo = (np.asarray(a) for a in j_out)
    tv, ti, to = (a.numpy() for a in t_out)
    np.testing.assert_array_equal(to, jo)
    filled = jv < tfs.BIG / 2
    np.testing.assert_array_equal(tv < tfs.BIG / 2, filled)
    np.testing.assert_allclose(tv[filled], jv[filled], rtol=rtol, atol=rtol * 10)
    assert np.mean(ti == ji) >= 0.999
    return jo.sum()


@pytest.mark.parametrize("int8_q", [False, True])
@pytest.mark.parametrize("compact", [False, True])
def test_packed_bin_scan_matches_jax(compact, int8_q):
    x = _packed_inputs(5)
    tiles = tcount = None
    if compact:
        rng = np.random.default_rng(9)
        keep = np.sort(rng.choice(N_TILES, 18, replace=False)).astype(np.int32)
        tiles = np.concatenate([keep, np.full(6, keep[-1], np.int32)])[None, :]
        tcount = np.array([18], np.int32)
    j_out, t_out = _run_packed(x, int8_q, tiles, tcount)
    assert _compare_packed(j_out, t_out, 1e-6 if int8_q else 1e-5) > 0


def test_packed_bin_scan_rounds_f_error_to_bf16():
    """With f_error values bf16 cannot hold, the scan still matches the
    reference; handing the port the pre-rounded values changes nothing,
    and the unrounded product would: the rounding is really there."""
    x = _packed_inputs(11)
    j_out, t_out = _run_packed(x, int8_q=True)
    _compare_packed(j_out, t_out, 1e-6)
    fe_bf16 = torch.from_numpy(x["fe"]).to(torch.bfloat16).float().numpy()
    _, t_rounded = _run_packed(x, int8_q=True, t_fe=fe_bf16)
    assert torch.equal(t_rounded[0], t_out[0])
    # the same scan with f32 f_error in the product, from the dense formula
    filled = t_out[0] < tfs.BIG / 2
    rows = t_out[1][filled].long()
    b_of = torch.nonzero(filled)[:, 0]
    g2 = torch.from_numpy(x["g_err"]).to(torch.bfloat16).float()
    cl = torch.from_numpy(x["cluster_of"]).long()[rows]
    shift = (torch.from_numpy(fe_bf16)[rows] - torch.from_numpy(x["fe"])[rows]) * g2[b_of, cl]
    assert float(shift.abs().max()) > 1e-3  # skipping the rounding would move values


@pytest.mark.parametrize("int8_q", [False, True])
@pytest.mark.parametrize("max_tiles", [None, 32])
def test_packed_fused_select_matches_jax(max_tiles, int8_q):
    x = _packed_inputs(7, bq=40)
    rerank = 400
    j_idx, j_ok, j_probed = (np.asarray(a) for a in jfs.fused_select(
        jnp.asarray(x["q"]), jps.pack_bitplanes(jnp.asarray(x["binary"]), D),
        jnp.asarray(x["fa_eff"]), jnp.asarray(x["fr"]), jnp.asarray(x["fe"]),
        jnp.asarray(x["cluster_of"]), jnp.asarray(x["k1x"]), jnp.asarray(x["g_add"]),
        jnp.asarray(x["g_err"]), jnp.asarray(x["probe"]), jnp.asarray(x["c_blk"]),
        rerank, D, int8_stage1=int8_q, max_tiles=max_tiles,
    ))
    t_idx, t_ok, t_probed = (a.numpy() for a in tfs.fused_select(
        torch.from_numpy(x["q"]), tps.pack_bitplanes(torch.from_numpy(x["binary"]), D),
        torch.from_numpy(x["fa_eff"]), torch.from_numpy(x["fr"]),
        torch.from_numpy(x["cluster_of"]), torch.from_numpy(x["k1x"]),
        torch.from_numpy(x["g_add"]), torch.from_numpy(x["probe"]),
        torch.from_numpy(x["c_blk"]), rerank, max_tiles=max_tiles,
        f_error=torch.from_numpy(x["fe"]), g_err=torch.from_numpy(x["g_err"]),
        int8_stage1=int8_q, direct_plane=False, with_values=False,
    ))
    assert t_idx.shape == (40, rerank)
    np.testing.assert_array_equal(t_probed, j_probed)
    np.testing.assert_array_equal(t_ok, j_ok)
    for row in range(40):
        j_rows, t_rows = set(j_idx[row][j_ok[row]]), set(t_idx[row][t_ok[row]])
        assert len(j_rows & t_rows) >= 0.995 * len(j_rows), row


def test_packed_mode_argument_checks():
    x = _packed_inputs(1, bq=32)
    q_perm, _ = _q_operand(x, False)
    args = (
        tps.pack_bitplanes(torch.from_numpy(x["binary"]), D), q_perm,
        torch.from_numpy(x["fa_eff"]), torch.from_numpy(x["fr"]),
        torch.from_numpy(x["cluster_of"]), torch.from_numpy(x["k1x"]),
        torch.from_numpy(_g1(x)).to(torch.bfloat16), torch.from_numpy(x["c_blk"]),
    )
    g2 = torch.zeros_like(args[6])
    fe = torch.from_numpy(x["fe"])
    with pytest.raises(ValueError, match="f_error and g2"):
        tfs.fused_bin_scan(*args)
    with pytest.raises(ValueError, match="q_scale"):
        tfs.fused_bin_scan(*args, f_error=fe, g2=g2, q_scale=torch.ones(32))
    with pytest.raises(ValueError):
        tfs.fused_bin_scan_packed_cuda(*args, f_error=fe, g2=g2)  # CPU tensors
