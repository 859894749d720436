"""Row sharding of the index over several devices (port of
``rabitq_tpu/parallel/sharding.py``).

The row axis of the code planes is cut into one contiguous slice a shard:

* every shard holds an equal slice of the code planes and per-row factors
  (rows stay grouped by cluster; a cluster's rows may span shards, since
  the scan only needs the row -> cluster map, which is sliced with the
  rows);
* centroids and queries are replicated: one copy on each distinct device;
* each shard runs the single-device ``scan_kernel`` on its slice and keeps
  its own top-k; the shards' candidates (``B * top_k`` each, not O(N)) are
  moved to the first shard's device and merged there.

One Python process drives every shard (a single controller, as the JAX
package's ``shard_map`` inside one ``jit`` is). A :class:`Mesh` is an ordered
list of ``torch.device``s in which a device may repeat: several shards on
one card run one after another in its stream, and ``[cpu] * 8`` is the
counterpart of the JAX package's virtual CPU mesh. On distinct cards every
shard's work is queued before the first host sync, so the cards overlap.
The JAX package's ``all_gather`` becomes the copy of each shard's
candidates to the first device and ``psum`` a sum of the partials there.

Every entry point defaults to the visible CUDA devices and raises where
there is none; ``make_mesh(devices=["cpu"] * n)`` runs on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..index.build import build_codes_device, exact_t_rows
from ..index.ivf import IvfRabitqIndex
from ..index.scan import _pad_pow2, is_fused, probe_k_bucket, scan_kernel
from ..ops.fused_scan import TB, TN, sliced_max_tiles, tile_cluster_blocks
from ..ops.kmeans import KMeansResult, _assign_blocks, _kmeanspp_init, segment_sum_counts
from ..ops.packed_scan import _KERNEL_RU, pack_bitplanes
from ..ops.prng import PRNGKey
from ..ops.quantize import compute_const_scaling_factor
from ..ops.rotation import make_rotator
from ..types import Metric, RotatorType, SearchParams
from ..utils.device import resolve_device

SHARD_AXIS = "shard"
# the code planes of an IVF layout, as build_codes_device names them
_PLANES = (
    "binary", "ex", "f_add", "f_rescale", "f_error", "f_add_ex", "f_rescale_ex", "delta", "vl",
)


@dataclass(frozen=True)
class Mesh:
    """The devices of the shards, in shard order; a device may repeat."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def shape(self) -> dict[str, int]:
        return {SHARD_AXIS: len(self.devices)}


def _canonical(device: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so that one card has one name."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_devices: int | None = None, *, devices=None) -> Mesh:
    """A mesh over ``devices`` (any list; entries may repeat) or, by
    default, over the visible CUDA devices; the first ``n_devices`` of them
    (asking for more than there are gives those there are). Without a card
    and without ``devices`` it raises, as every entry point of the port
    does."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [_canonical(resolve_device(d)) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(tuple(devices))


def _on(device: torch.device):
    """Make ``device`` current while a shard's work is queued (a kernel
    must be launched from the device that owns its stream)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def shard_rows(mesh: Mesh, *arrays):
    """Each array (``[N, ...]``, host or device, ``N`` a multiple of the
    shard count) as a list of one contiguous row slice a shard, on that
    shard's device; a slice of a tensor already there is a view."""
    n_dev = mesh.shape[SHARD_AXIS]
    out = []
    for a in arrays:
        t = _tensor(a)
        if t.shape[0] % n_dev:
            raise ValueError(f"{t.shape[0]} rows do not split into {n_dev} equal shards")
        rows = t.shape[0] // n_dev
        out.append([t[i * rows : (i + 1) * rows].to(dev) for i, dev in enumerate(mesh.devices)])
    return tuple(out)


def replicate(mesh: Mesh, *arrays):
    """Each array as a list with one entry a shard: one copy on each
    distinct device, shared by the shards on it."""
    out = []
    for a in arrays:
        t = _tensor(a)
        copies: dict[torch.device, torch.Tensor] = {}
        out.append([copies.setdefault(dev, t.to(dev)) for dev in mesh.devices])
    return tuple(out)


def _merge_topk(ids, dists, top_k: int, device: torch.device):
    """The final top-k of the shards' ``[B, k]`` candidates on ``device``:
    their shard-major concatenation sorted ascending by distance with a
    stable sort, so that ties keep the lower column, as ``lax.top_k``
    breaks them. One shard's candidates are the result as they are."""
    nb = device.type == "cuda"
    if len(ids) == 1:
        return ids[0].to(device, non_blocking=nb), dists[0].to(device, non_blocking=nb)
    all_ids = torch.cat([t.to(device, non_blocking=nb) for t in ids], dim=1)
    all_d = torch.cat([t.to(device, non_blocking=nb) for t in dists], dim=1)
    d, pos = torch.sort(all_d, dim=1, stable=True)
    pos = pos[:, :top_k]
    return torch.gather(all_ids, 1, pos), d[:, :top_k]


def sharded_scan(
    q_rot,  # replicated [B, Dpad] f32 rotated queries
    centroids,  # replicated [C, Dpad] f32
    binary,  # the rest sharded by rows, as shard_rows gives them
    ex,
    f_add,
    f_rescale,
    f_error,
    f_add_ex,
    f_rescale_ex,
    cluster_of,
    row_allowed,
    ids,
    prune_epsilon: float = 0.0,
    packed=None,  # [Np, Db] bit planes ("packed" and fused paths)
    fused_cblk=None,  # [N_tiles] cluster windows, sharded by tiles (fused path)
    *,
    mesh: Mesh,
    top_k: int,
    nprobe: int,
    rerank: int,
    metric: Metric,
    ex_bits: int,
    scan_dtype: str,
    use_prune_epsilon: bool = False,
    refine_ex: bool = True,
    clamp_l2: bool = False,
    centroid_select_l2: bool = False,
    approx_topk: bool = True,
    max_tiles: int | None = None,
    probe_k: int | None = None,
    fused_exact: bool = False,
    fused_exact_sort: bool = True,
):
    """Row-sharded batched search: ``scan_kernel``'s contract (the MSTG
    pruning and refinement flags included) with the row arrays sharded
    over ``mesh``. Each shard keeps its own top ``top_k`` (the union of
    the shards' top-k sets holds the global top-k); they are merged on the
    first device. Returns device (ids [B, top_k] int32, dists [B, top_k])."""
    fused = is_fused(scan_dtype)
    needs_packed = fused or scan_dtype == "packed"
    local = []
    for i, dev in enumerate(mesh.devices):
        with _on(dev):
            local.append(scan_kernel(
                q_rot[i], centroids[i], binary[i], ex[i], f_add[i], f_rescale[i], f_error[i],
                f_add_ex[i], f_rescale_ex[i], cluster_of[i], row_allowed[i], ids[i],
                prune_epsilon=float(prune_epsilon),
                packed=packed[i] if needs_packed else None,
                fused_cblk=fused_cblk[i] if fused else None,
                top_k=top_k, nprobe=nprobe, rerank=rerank, metric=metric, ex_bits=ex_bits,
                scan_dtype=scan_dtype, use_prune_epsilon=use_prune_epsilon,
                refine_ex=refine_ex, clamp_l2=clamp_l2, centroid_select_l2=centroid_select_l2,
                approx_topk=approx_topk,
                # the per-shard budget (sliced_max_tiles) fits every shard's
                # own tile count; fused_select clamps it as a backstop
                max_tiles=max_tiles, probe_k=probe_k, fused_exact=fused_exact,
                fused_exact_sort=fused_exact_sort,
            ))
    dst = mesh.devices[0]
    with _on(dst):
        return _merge_topk([r[0] for r in local], [r[1] for r in local], top_k, dst)


def _pad_to(x: torch.Tensor, n_pad: int, fill=0) -> torch.Tensor:
    if x.shape[0] == n_pad:
        return x
    out = torch.full((n_pad, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    out[: x.shape[0]] = x
    return out


class _ShardedLayout:
    """An index's device layout cut into the mesh's row slices: rows padded
    (``ids`` -1, ``valid`` False) to a multiple of the shard count, times
    the kernels' row tile where the scan takes one (fused: ``TN``; packed:
    the lower-bound kernel's ``_KERNEL_RU``), so that each slice is whole
    tiles. A fused layout with a TOTAL refine plane has no dense binary
    plane, which no shard reads: a 1-wide placeholder is sharded instead."""

    def __init__(self, index, mesh: Mesh | None, devices, plane_dim: int):
        self.index = index
        self.mesh = mesh or make_mesh(devices=devices)
        index._maybe_downgrade_fused()  # degenerate geometry -> dense path
        lay = index.layout
        n_dev = self.mesh.shape[SHARD_AXIS]
        rows = int(lay.ids.shape[0])
        self._fused = is_fused(index.scan_dtype)
        self._packed_mode = index.scan_dtype == "packed"
        unit = n_dev * (TN if self._fused else _KERNEL_RU if self._packed_mode else 1)
        pad_to = -(-rows // unit) * unit
        self._slab_rows = pad_to // n_dev  # rows a shard
        binary = (
            _pad_to(lay.binary, pad_to)
            if lay.binary is not None
            else torch.zeros((pad_to, 1), dtype=torch.int8, device=lay.ex.device)
        )
        valid = _pad_to(lay.valid, pad_to, False)
        cluster = _pad_to(lay.cluster_of, pad_to)
        self._rows = shard_rows(
            self.mesh, binary, _pad_to(lay.ex, pad_to), _pad_to(lay.f_add, pad_to),
            _pad_to(lay.f_rescale, pad_to), _pad_to(lay.f_error, pad_to),
            _pad_to(lay.f_add_ex, pad_to), _pad_to(lay.f_rescale_ex, pad_to), cluster, valid,
            _pad_to(lay.ids, pad_to, -1),
        )
        self._valid_pad = valid.cpu().numpy()  # host copy: a filtered search re-shards it
        self._packed = self._cblk = None
        if self._fused:
            packed = (
                _pad_to(lay.packed, pad_to)
                if lay.packed is not None
                else pack_bitplanes(binary, plane_dim)
            )
            cblk = tile_cluster_blocks(cluster.cpu().numpy(), self._valid_pad)
            self._packed, self._cblk = shard_rows(self.mesh, packed, cblk)
        elif self._packed_mode:
            (self._packed,) = shard_rows(self.mesh, pack_bitplanes(binary, plane_dim))
        (self._centroids,) = replicate(self.mesh, lay.centroids)
        self._max_tiles_cache: dict = {}

    def _fused_max_tiles(self, nprobe, batch):
        """Per-SHARD probed-tile budget: each shard's kernel sees only its
        own slice (``_slab_rows`` rows of the cluster-sorted rows), so the
        budget is the max of the per-slice bounds (``sliced_max_tiles``),
        not the whole index's, which routinely exceeds a slice's tile count
        and would leave compaction off. Cached per (nprobe, batch tile);
        ``RABITQ_FUSED_COMPACT=0`` (the dense walk) is read at each call."""
        if not self._fused or not isinstance(nprobe, (int, np.integer)):
            return None
        if os.environ.get("RABITQ_FUSED_COMPACT", "1") == "0":
            return None
        bt = min(TB, ((int(batch) + 31) // 32) * 32)
        key = (int(nprobe), bt)
        if key not in self._max_tiles_cache:
            rows = self._slab_rows
            slices = [(i * rows, (i + 1) * rows) for i in range(self.mesh.shape[SHARD_AXIS])]
            self._max_tiles_cache[key] = sliced_max_tiles(
                np.diff(self.index._offsets), int(nprobe), slices, bt
            )
        return self._max_tiles_cache[key]


class ShardedIvfIndex(_ShardedLayout):
    """Row-sharded serving wrapper around a trained ``IvfRabitqIndex``.

    Shards the code planes and per-row factors over a mesh and serves
    batched queries with one candidate merge. Build the index once, then
    wrap::

        mesh = sharding.make_mesh()
        sharded = sharding.ShardedIvfIndex(index, mesh)
        ids, dists = sharded.batch_search_arrays(queries, params)

    ``mesh=None`` takes ``make_mesh(devices=devices)``: every visible card
    by default."""

    @classmethod
    def train(
        cls,
        data: "np.ndarray | torch.Tensor",
        nlist: int,
        total_bits: int,
        metric: Metric = Metric.L2,
        mesh: Mesh | None = None,
        seed: int = 42,
        use_faster_config: bool = False,
        kmeans_iters: int = 25,
        scan_dtype: str = "bf16",
        *,
        devices=None,
    ) -> "ShardedIvfIndex":
        """End-to-end sharded build: data-parallel k-means (partials summed
        on the first device), row-sharded rotation and quantization, then
        the row-sharded wrapper. ``data`` is a host array or a tensor. The
        index lives on the mesh's first device; its ``build_report`` gives
        the seconds of each phase."""
        mesh = mesh or make_mesh(devices=devices)
        src = _tensor(data).to(torch.float32)
        IvfRabitqIndex._validate_train_args(src, nlist, total_bits)
        dev = mesh.devices[0]
        t0 = time.perf_counter()
        km = sharded_kmeans(src, nlist, mesh=mesh, niter=kmeans_iters, seed=seed)
        t_kmeans = time.perf_counter()

        n, dim = src.shape
        ex_bits = total_bits - 1
        rotator = make_rotator(dim, RotatorType.FhtKacRotator, seed)
        with _on(dev):
            rotated_cents = rotator.rotate(km.centroids.to(dev))
        order = np.argsort(km.assignments, kind="stable")
        sizes = np.bincount(km.assignments, minlength=nlist)
        offsets = np.zeros(nlist + 1, np.int64)
        np.cumsum(sizes, out=offsets[1:])
        assign_sorted = km.assignments[order]

        t_const, t_rows = 0.0, None
        if ex_bits > 0:
            if use_faster_config:
                t_const = compute_const_scaling_factor(rotator.padded_dim, ex_bits, seed, device=dev)
            else:
                t_rows = exact_t_rows(
                    src.cpu().numpy(), km.centroids.cpu().numpy(), assign_sorted, order, rotator,
                    ex_bits,
                )
        parts = _build_code_shards(
            src.index_select(0, torch.from_numpy(order).to(src.device)), rotated_cents,
            assign_sorted, mesh=mesh, rotator=rotator, ex_bits=ex_bits, metric=metric,
            use_t_const=use_faster_config, t_const=t_const, t_rows=t_rows,
        )
        with _on(dev):  # the shards' code planes joined on the first device
            codes = {name: torch.cat([p[name].to(dev) for p in parts]) for name in _PLANES}
        del parts
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # codes_s counts the device work, not its queueing
        t_codes = time.perf_counter()
        index = IvfRabitqIndex(
            dim, rotator.padded_dim, metric, rotator, ex_bits, device=dev, scan_dtype=scan_dtype
        )
        # the host copy (index.host) is downloaded at first use, as after train
        index._set_layout(
            ids=order.astype(np.int64), offsets=offsets, centroids=rotated_cents, **codes
        )
        sharded = cls(index, mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_end = time.perf_counter()
        index.build_report = {
            "kmeans_s": round(t_kmeans - t0, 2),
            "kmeans": {"objective": km.objective, "iters": km.iters},
            "codes_s": round(t_codes - t_kmeans, 2),
            "layout_s": round(t_end - t_codes, 2),
            "total_s": round(t_end - t0, 2),
        }
        return sharded

    def __init__(self, index: IvfRabitqIndex, mesh: Mesh | None = None, *, devices=None):
        super().__init__(index, mesh, devices, index.padded_dim)

    def batch_search_arrays(
        self, queries: np.ndarray, params: SearchParams, filter_ids: np.ndarray | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Row-sharded batched search: (ids [B, k] int32 with -1 padding,
        dist [B, k] f32 internal distances). ``filter_ids`` restricts the
        results to the given vector ids (``ivf.rs:1723-1730``): the row mask
        is sharded with the rows. Queries are rotated once, on the first
        device, from f32."""
        index = self.index
        queries = index._check_queries(queries)
        b = queries.shape[0]
        if params.top_k <= 0:
            return np.full((b, 0), -1, np.int32), np.full((b, 0), np.inf, np.float32)
        rows = self._rows
        if filter_ids is not None:
            mask = index._row_filter(filter_ids)  # device-layout order
            mask_pad = np.zeros(self._valid_pad.shape[0], bool)
            mask_pad[: mask.shape[0]] = mask
            (allowed,) = shard_rows(self.mesh, self._valid_pad & mask_pad)
            rows = (*rows[:8], allowed, rows[9])
        dev = self.mesh.devices[0]
        q = np.zeros((_pad_pow2(b), index.dim), np.float32)
        q[:b] = queries
        with _on(dev):
            q_rot = index.rotator.rotate(torch.from_numpy(q).to(dev))
        ids, dists = sharded_scan(
            replicate(self.mesh, q_rot)[0], self._centroids, *rows,
            packed=self._packed, fused_cblk=self._cblk, mesh=self.mesh,
            top_k=params.top_k, nprobe=params.nprobe, rerank=params.resolved_rerank(),
            metric=index.metric, ex_bits=index.ex_bits, scan_dtype=index.scan_dtype,
            approx_topk=index.approx_topk,
            max_tiles=self._fused_max_tiles(params.nprobe, q.shape[0]),
            probe_k=probe_k_bucket(params.nprobe, index.cluster_count(), index.scan_dtype),
            fused_exact=index._fused_exact_ok(),
        )
        return ids.cpu().numpy()[:b], dists.cpu().numpy()[:b]


class ShardedMstgIndex(_ShardedLayout):
    """Row-sharded serving wrapper around a built ``MstgIndex``: posting-list
    rows are sharded, centroids and queries replicated, and each shard's
    scan keeps the MSTG semantics (ef_search probe count, dynamic epsilon
    pruning, f_error = 0, the L2 clamp, optional ex refinement) before the
    candidate merge. Where closure replicated rows, each shard returns its
    whole re-ranked candidate set (``rerank``, at least top_k times the
    replication factor + 16) and the merged set is deduplicated on the
    device, as ``MstgIndex`` serves it, so that one shard returns the
    index's results. Queries are rotated once, on the first device, from
    f32 (the FHT kernel on the card), and replicated."""

    def __init__(self, index, mesh: Mesh | None = None, *, devices=None):
        super().__init__(index, mesh, devices, index.quant_dim)

    def batch_search(self, queries: np.ndarray, params) -> list:
        index = self.index
        queries = index._check_queries(queries)
        b = queries.shape[0]
        if params.top_k <= 0:
            return [[] for _ in range(b)]
        q = np.zeros((_pad_pow2(b), index.dim), np.float32)
        q[:b] = queries
        dev = self.mesh.devices[0]
        with _on(dev):  # rotated once, on the first device, from f32
            q_rot = torch.from_numpy(q).to(dev)
            if index.rotator is not None:
                q_rot = index.rotator.rotate(q_rot)
        (q_rep,) = replicate(self.mesh, q_rot)
        dedup = index._has_replicas()
        rerank = max(
            params.resolved_rerank(),
            int(np.ceil(params.top_k * index.replication_factor())) + 16,
        )
        ids, dists = sharded_scan(
            q_rep, self._centroids, *self._rows, prune_epsilon=params.pruning_epsilon,
            packed=self._packed, fused_cblk=self._cblk, mesh=self.mesh,
            top_k=rerank if dedup else params.top_k, nprobe=params.ef_search, rerank=rerank,
            metric=index.config.metric, ex_bits=index.config.rabitq_bits - 1,
            scan_dtype=index.scan_dtype, use_prune_epsilon=True,
            refine_ex=index.config.refine_ex, clamp_l2=True, centroid_select_l2=True,
            approx_topk=index.approx_topk,
            max_tiles=self._fused_max_tiles(params.ef_search, q_rep[0].shape[0]),
            fused_exact=index._fused_exact_ok(),
            # dedup: each shard's candidates stay in the kernel's best-first
            # order, as MstgIndex keeps them through its dedup
            fused_exact_sort=not dedup,
            probe_k=probe_k_bucket(params.ef_search, index.posting_list_count(), index.scan_dtype),
        )
        if dedup:  # on the device: [B, top_k], not [B, rerank], crosses to the host
            with _on(self.mesh.devices[0]):
                ids, dists = type(index)._dedup_topk_device(ids, dists, top_k=params.top_k)
        return index._dedup_results(ids.cpu().numpy()[:b], dists.cpu().numpy()[:b], params.top_k)


def sharded_kmeans_step(data, centroids, valid=None, *, mesh: Mesh, k: int, block: int):
    """One data-parallel Lloyd iteration: on each shard the blockwise
    nearest-centroid assignment (``ops/kmeans._assign_blocks``) and segment
    sums into ``k + 1`` segments (``ops/kmeans.segment_sum``: ascending row
    order, no float atomics; ``valid`` False routes a padding row to the
    scratch one), then the partials summed on the first device in shard
    order. ``data`` and ``valid`` are sharded, ``centroids`` replicated. Returns (sums [k, D], counts [k] f32, both on the first
    device; the shards' assignments, int64)."""
    sums, counts, assigns = [], [], []
    for i, dev in enumerate(mesh.devices):
        x = data[i]
        with _on(dev):
            assign, _ = _assign_blocks(x, centroids[i], block)
            seg = assign if valid is None else torch.where(valid[i], assign, k)
            s, c = segment_sum_counts(x.to(torch.float32), seg, k + 1)
        sums.append(s[:k])
        counts.append(c[:k])
        assigns.append(assign)
    dst = mesh.devices[0]
    with _on(dst):
        return sum(s.to(dst) for s in sums), sum(c.to(dst) for c in counts), assigns


def _shard_padded(mesh: Mesh, x: torch.Tensor, per: int):
    """``x`` as ``per`` rows a shard on each shard's device, the tail padded
    with zero rows, and each shard's mask of real rows."""
    n = x.shape[0]
    rows, valid = [], []
    for i, dev in enumerate(mesh.devices):
        s = min(i * per, n)
        e = min(s + per, n)
        rows.append(_pad_to(x[s:e].to(dev), per))
        valid.append(torch.arange(per, device=dev) < e - s)
    return rows, valid


def sharded_kmeans(
    data: "np.ndarray | torch.Tensor",
    k: int,
    *,
    mesh: Mesh,
    niter: int = 25,
    seed: int = 42,
    max_points_per_centroid: int = 256,
) -> KMeansResult:
    """Full data-parallel k-means: rows sharded (each shard padded to whole
    assignment blocks), one :func:`sharded_kmeans_step` an iteration.

    The subsample for the init (``rng.permutation``) and the empty-cluster
    reseed (``rng.integers``) are the JAX package's host draws from
    ``np.random.default_rng(seed)``. The k-means++ init on the subsample
    (``ops/kmeans._kmeanspp_init``, on the first device) draws from the
    JAX package's key ``PRNGKey(seed * 1_000_003)`` (``ops/prng.py``), so it
    picks the JAX package's rows wherever its sums are exact, and one seed
    gives one result on every run. Returns ``ops.kmeans.KMeansResult`` (centroids on
    the first device, the objective of the final centroids against the
    last assignment)."""
    src = _tensor(data).to(torch.float32)
    n, dim = src.shape
    n_dev = mesh.shape[SHARD_AXIS]
    dev = mesh.devices[0]
    rng = np.random.default_rng(seed)

    block = int(max(256, min(8192, (1 << 22) // max(k, 1))))
    per_dev = (-(-n // n_dev) + block - 1) // block * block
    data_sh, valid_sh = _shard_padded(mesh, src, per_dev)

    # k-means++ on a subsample, on the first device
    target = int(min(n, max(k * max_points_per_centroid // 8, k)))
    pick = torch.from_numpy(rng.permutation(n)[:target]).to(src.device)
    with _on(dev):
        sub_pad = _pad_to(src.index_select(0, pick).to(dev), -(-target // 256) * 256)
        centroids = _kmeanspp_init(sub_pad, PRNGKey(seed * 1_000_003), k, target)

    assign_sh = None
    for _ in range(niter):
        (cents_rep,) = replicate(mesh, centroids)
        sums, counts, assign_sh = sharded_kmeans_step(
            data_sh, cents_rep, valid_sh, mesh=mesh, k=k, block=block
        )
        with _on(dev):
            centroids = sums / torch.clamp_min(counts, 1.0)[:, None]
            empty = np.flatnonzero((counts == 0).cpu().numpy())
            if empty.size:  # reseed empties from random rows
                rows = torch.from_numpy(rng.integers(0, n, empty.size)).to(src.device)
                centroids[torch.from_numpy(empty).to(dev)] = src.index_select(0, rows).to(dev)

    # the objective: each shard's sum of squared distances, in f64
    (cents_rep,) = replicate(mesh, centroids)
    totals = []
    for x, a, c, v in zip(data_sh, assign_sh, cents_rep, valid_sh):
        with _on(x.device):
            total = torch.zeros((), dtype=torch.float64, device=x.device)
            for s in range(0, x.shape[0], block):
                diff = x[s : s + block] - c[a[s : s + block]]
                sq = torch.where(v[s : s + block], torch.sum(diff * diff, dim=1), 0.0)
                total += torch.sum(sq, dtype=torch.float64)
            totals.append(total)
    objective = sum(float(t) for t in totals)
    assignments = torch.cat([a.cpu() for a in assign_sh])
    valid_all = torch.cat([v.cpu() for v in valid_sh])
    return KMeansResult(
        centroids=centroids,
        assignments=assignments[valid_all].numpy().astype(np.int32),
        objective=objective,
        iters=niter,
    )


def sharded_build_codes(
    data_sorted,  # [M, dim] rows in storage order (host array or tensor)
    rotated_centroids,  # [C, Dpad] (host array or tensor)
    assign_sorted: np.ndarray,  # [M] cluster of each row
    *,
    mesh: Mesh,
    rotator,
    ex_bits: int,
    metric: Metric,
    use_t_const: bool,
    t_const: float = 0.0,
    t_rows: np.ndarray | None = None,
) -> dict:
    """Row-sharded rotation and quantization (the sharded build's compute
    stage): each shard rotates its row slice (the FHT kernel on the card)
    and quantizes it against its rows' centroids
    (``index/build.build_codes_device``). Rotation is per row, so nothing
    crosses between shards. Returns host arrays in row order: ``binary``
    uint8, ``ex`` uint16, the factors f32."""
    parts = _build_code_shards(
        data_sorted, rotated_centroids, assign_sorted, mesh=mesh, rotator=rotator,
        ex_bits=ex_bits, metric=metric, use_t_const=use_t_const, t_const=t_const, t_rows=t_rows,
    )
    dtypes = {"binary": np.uint8, "ex": np.uint16}
    return {
        name: np.concatenate([p[name].cpu().numpy() for p in parts]).astype(
            dtypes.get(name, np.float32)
        )
        for name in parts[0]
    }


def _build_code_shards(
    data_sorted, rotated_centroids, assign_sorted, *, mesh: Mesh, rotator, ex_bits, metric,
    use_t_const, t_const, t_rows,
) -> list[dict[str, torch.Tensor]]:
    """:func:`sharded_build_codes`' device step: the codes of each shard's
    row slice, left on that shard's device (``build_codes_device``'s
    dtypes), in shard order."""
    src = _tensor(data_sorted)
    m = src.shape[0]
    per = -(-m // mesh.shape[SHARD_AXIS])
    (cents,) = replicate(mesh, _tensor(rotated_centroids).to(torch.float32))
    parts = []
    for i, dev in enumerate(mesh.devices):
        s, e = min(i * per, m), min((i + 1) * per, m)
        if s == e:
            continue
        with _on(dev):
            parts.append(build_codes_device(
                src[s:e].to(dev), cents[i], assign_sorted[s:e], rotator=rotator,
                ex_bits=ex_bits, metric=metric, use_t_const=use_t_const, t_const=t_const,
                t_rows=None if t_rows is None else t_rows[s:e],
            ))
    return parts
