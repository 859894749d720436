#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``rabitq_tpu_torch``) on one NVIDIA GPU.

Phases, one line each:
  1. device: the card's name, and nvidia-smi's name and power limit;
  2. build: compile every kernel from ``rabitq_tpu_torch/csrc`` with nvcc
     (one process per source, all at once), with each kernel's registers,
     shared memory and spills as ptxas reports them and the dynamic shared
     memory of the tensor-core kernels and the FHT as their libraries say;
     a spill in any kernel fails the phase;
  3. fht: the FHT kernel against its plain version on [256, 512],
     [8192, 512] and [64, 16384] f32 (must be bitwise equal), with device
     times from a cold L2 and bound, and beside it the one library call
     that computes the same function ([8192, 512] times the 512 x 512
     Sylvester matrix, torch.mm);
  4. main path at full size: a seeded 1M x 960 dataset (the recipe of
     bench.py's make_workload, drawn on the card), IvfRabitqIndex.train
     (nlist 4096, 7 bits, FhtKac, faster config, fused8), then 2048 queries
     served through batch_search_arrays_pipelined (int8 uploads, batch 256,
     upload block 1024) and batch_search_arrays at nprobe 16, 64 and 256,
     with recall@10 against an exact brute force on the card and QPS. The
     kernels' launch counters are zeroed just before and read just after;
     every kernel must have run;
  5. bin scan: the kernel against its plain version on the inputs the main
     path gives it for one 256-query block, dense walk and compacted walk,
     with times and bound, and the host and device time of the query image
     the wrapper makes before each launch;
  6. profile: device time by kernel and the device's busy share over one
     pipelined serving run at nprobe 16 and 256 (torch.profiler);
  7. two-stage and dense paths at full size: a second index on the same
     data with total_bits=8 (raw ex codes: no EXACT scan), served through
     scan_dtype fused8 and fused (the packed bin kernel, int8 and bf16
     query, compacted walk at nprobe 16 and dense walk at 256), packed (the
     packed lower-bound kernel; the index is re-laid on the card to the
     permuted layout) and bf16 (a plain matrix product: the reference
     point), with recall@10 and QPS; launch counters zeroed before and read
     after; then each kernel against its plain version on the main path's
     inputs for one 256-query block (the packed lower-bound kernel in both
     epilogues: the masked plane the packed scan takes, and the TPU
     contract on a g_comb built from the same inputs, with a bf16 torch.mm
     of the unpacked planes beside it as the library time of the dot alone;
     the packed bin kernel with an int8 query and with a bf16 query, both
     walks), and a profile of a packed run at nprobe 256, a fused8 run at
     nprobe 16 and a fused run at nprobe 256.
Between 6 and 7, on the 7-bit index and the same data:
  persistence: save to RBQ1 (twice; the two files byte-identical), load_index
     with scan_dtype fused8, serve nprobe 64 with ids and distances equal to
     the index's before the save, fetch_embedding of four ids against their
     raw rows (files in a temporary directory of the checkout, deleted);
  resident queries: upload_queries + batch_search_resident at nprobe 64,
     ids equal to batch_search_arrays', QPS beside the pipelined path's;
  gather scan: RABITQ_GATHER=1 in this process at nprobe 16, with
     RABITQ_GATHER_MAX raised to its budget (both unset after), the budget, the device time of one 256-query dispatch, QPS and recall@10
     beside the EXACT scan's (no more than 0.005 below it);
  brute force: BruteForceRabitqIndex.train (7 bits, faster config) on the
     1M rows, served through "packed" (the packed lower-bound kernel at one
     cluster) and "bf16" with recall@10 (floor 0.90) and QPS, the kernel
     against its plain version on the packed path's inputs, a profile of a
     packed run, and an RBF1 round trip with equal ids;
  streamed tier: StreamedIvfIndex over the same 7-bit index (fused8, so the
     two-stage scan: the packed bin kernel with an int8 query, and the FHT):
     the in-memory index's own results first (RABITQ_FUSED_EXACT=0 set in
     this process and unset after, f32 query uploads, nprobe 16 and 256),
     then a one-chunk tier whose ids must equal them and distances within
     1e-5 relative, then the tier in 4 chunks of 262144 rows from pinned
     memory: chunk count, upload bytes a batch, the bare pinned
     host-to-device rate of one chunk (the tier's bound: bytes a batch over
     it), the 2048 queries served as one batch at nprobe 16 (compacted walk)
     and 256 (dense walk) with recall@10 (floor 0.90 at 256) and QPS (median
     [min, max] of 3) beside the transfer bound and the same scans on
     resident chunks, the 4-chunk results against the one-chunk ones (top-10
     overlap >= 0.98, recall no more than 0.005 below), a profile of one
     batch (copy time, kernel time, copying hidden under kernels), a
     filtered batch (a seeded half of the ids), the packed bin kernel
     against its plain version on chunk 0's inputs for one 256-query block
     (both walks), and last the wrapped index serving nprobe 64 in memory
     again with the ids it gave before;
  MSTG: MstgIndex.build on the 1M rows with bench.py's configuration
     (max_posting_size rows/500, faster config, FhtKac rotator, 7 bits,
     fused8, seed 42), its phases, list sizes and replication, then 2048
     queries served through batch_search_arrays_pipelined (int8 uploads,
     batch 256, upload block 1024) at ef_search 8 and 64, epsilon 0.6, with
     the fused EXACT gate's walk, QPS and recall@10 (floor 0.90 at ef 64),
     after each ef's serving the direct bin kernel against its plain
     version on that path's inputs, and a profile of one run at ef 8; then
     bench.py's replicated variant (10% of the rows and half the queries at
     midpoints of pairs of blob centres, closure_epsilon 0.9; at 262144
     rows if the first build took over 60 s), served and checked the same
     way, replication above 1 and no id twice in a result row, and at each
     ef the device dedup against the host dedup on the same candidates and
     recall beside the gather scan's (no bins) on the same index; the
     headline index is saved to a native file for the next phase;
  front ends: the IVF binding fit on the 1M rows (nlist 4096, 7 bits,
     fused8) and its batch_query of the 2048 queries at nprobe 64 (the
     pipelined branch; ids and distances equal to its index's
     batch_search_arrays), the MSTG binding's load of the headline file and
     batch_query at ef 64 (ids equal to the index's own serving loop), the
     ann-benchmarks IVF module (ann_benchmarks/rabitq-tpu-torch-ivf) at its
     nlist_4096 group and nprobe 64, and the CLI (python -m
     rabitq_tpu_torch build, info, query --groundtruth, sweep --method ivf
     --nprobes 16 64) in subprocesses on a 100,000-row fvecs slice with 256
     queries (files in a temporary directory of the checkout, deleted), each
     of which must exit 0, with recall and the CSV header checked.
The sharded tier (rabitq_tpu_torch.parallel.sharding), with its 4 shards
all on the one card, runs on each index while that index is alive, so that
no phase before or after it serves with less memory than it would alone:
  sharded IVF (after the streamed tier, on the 7-bit index): a one-shard
     mesh first (ids and distances equal to the index's at nprobe 16 and
     256), then 4 shards serving the 2048 queries in blocks of 256 at
     nprobe 16, 64 and 256 (recall@10, floor 0.90 at 256; top-10 overlap
     with the index; QPS, median of 5, beside the index's one-batch QPS;
     rows and tile budget a shard), the direct bin kernel against its plain
     version on shard 0's inputs (compacted at 16, dense at 256), and a
     profile at nprobe 16 with the merge's device time;
  sharded MSTG (in the MSTG phase, on the headline index before the
     replicated variant is built): ef 8 and 64 (recall, floor 0.90 at 64;
     QPS; queries rotated on the card) and a one-shard wrapper at ef 64
     returning the index's ids;
  sharded train (after the front ends, before the 8-bit index is trained): ShardedIvfIndex.train on the 1M rows (nlist 4096, 7 bits,
     faster config, fused8, 25 k-means iterations) with seconds by phase,
     its k-means objective beside the 7-bit index's, and recall@10 at
     nprobe 64 (floor 0.90);
  sharded 8-bit (after 7): the 8-bit index through fused8 at nprobe 16 and
     packed at 256 (recall, QPS; the packed bin kernel with an int8 query
     and the packed lower-bound kernel checked on shard 0's inputs).
Each of these paths zeroes the launch counters just before it and reads
them just after; every kernel it runs must have launched.
The JAX-shaped calls: the JAX package's call shapes, none naming a device
(the card is the default), on each index while it is alive, each path's
launch counters zeroed before it and read after, any mismatch failing the
run (``phase seconds: JAX-shaped calls``):
  IVF (after the sharded IVF check, the 7-bit index's last phase):
     IvfRabitqIndex(dim, padded_dim, metric, rotator, ex_bits, index.host,
     "fused8") laid out from the host copy (seconds beside load_index's),
     served at nprobe 16 and 64 with ids and distances equal to the index's
     on all queries, QPS beside the index's, and the direct bin kernel
     against its plain version at nprobe 64 (dense); run_kmeans(data_np,
     4096, ..., data_dev=data) with centroids and assignments equal to
     run_kmeans(data, 4096, ...) at the same seed; upload_dataset(rows,
     "f32", 262_144) on cuda:0 equal to the rows; assemble_host_chunks with
     zero_f_error and row_pad given, its slabs equal to the streamed tier's;
  brute force (after the RBF1 round trip): a BruteForceRabitqIndex made
     without codes and given the trained index's host, its packed serving
     (the FHT and the packed lower-bound kernel) returning the trained
     index's ids;
  MSTG (on the headline index, after its sharded check):
     hierarchical_cluster and closure_assign given the rows as a host array,
     their lists equal to those of the device-tensor calls MstgIndex.build
     makes; then index.host = index.host, len unchanged and ef 8 ids equal.
  The k-means and clustering pairs agree without any deterministic switch:
  every segment sum adds in one fixed order.
The reproducible builds: one seed gives one index, each build run a second
time while its first index is alive and freed before the next phase
(``phase seconds: reproducible builds``):
  IVF (after the RBQ1 round trip): the segment-sum kernel at the k-means
     shape (the 1M rows into 4097 segments by the 7-bit index's lists)
     against its plain version (CPU index_add_, ascending row order),
     bitwise, timed beside index_add_ on the card and the bound; the
     running-sum kernel at the k-means++ init's shape (262,144 weights)
     against its plain version, bitwise, beside a 1-D torch.cumsum on the
     card (and how often that one's bits vary) and the bound; then the
     7-bit headline train again: every host array bitwise equal, its RBQ1
     file byte-identical to the persistence phase's, nprobe 16 ids and
     distances equal, both trains' seconds by phase;
  picks: a k-means++ init on the card and on the CPU from one key on
     integer-valued rows (4096 x 32 in [-4, 4], k 64): the same rows;
  MSTG (on the headline index, after its JAX-shaped calls): the segment sum
     at the polish shape, then the headline build again: the same list
     count, every list's members and every host array bitwise equal, both
     builds' seconds by phase;
  sharded train (after the first one): ShardedIvfIndex.train again,
     centroids and row ids bitwise equal.
Every search of the IVF, brute-force and MSTG indexes goes through the
index's fused search (rabitq_tpu_torch.index.scan.make_fused_search): on the
card one CUDA graph replay a dispatch, captured at a key's first call, with
the launch counters advanced at each replay by what the capture recorded.
The checks that need a kernel's arguments from inside a search (the bin
scan and packed lower-bound checks) run that search through the index's
eager body, and every profile runs its search once before it, so that no
graph is captured inside the profiler. The fused-search phase, on each
index while it is alive: 7 bits fused8 at nprobe 16, 64 and 256, the gather
scan, a filtered search, resident queries and f32, bf16 and int4 uploads
(after the gather scan); brute force packed and bf16 (after its serving);
MSTG headline and replicated at each ef (after each ef's checks); 8 bits
fused8, fused, packed and bf16 (after the 8-bit serving). For each: the
graphs' results against the eager body on the same blocks (ids and
distances equal; where a torch.topk cut over bf16 lower bounds may break
ties otherwise, the overlap is measured, floor 0.99), no kernel launched
outside a graph and one replay a block, eager and graph QPS paired (medians
of 5), one profile of each (device busy share, CUDA API kernel and graph
launches a dispatch, the port's kernels inside the replays), the seconds of
each capture, and the graph pool's bytes, and after each index its pool's
peak.
Then one JSON line of kernel numbers, nvidia-smi's line again, and last
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.

Usage: python3 chip_smoke.py (no arguments; one card).
"""

from __future__ import annotations

import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
L2_BYTES = 50e6  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, CUDA cores (the FHT's adds)
BF16_TENSOR_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores (the bin scan's dot)
INT8_TENSOR_OPS = 1979e12  # H100 SXM, dense int8 tensor cores (the int8 bit-plane dot)
ROWS, DIM, N_QUERIES, NLIST = 1_000_000, 960, 2048, 4096  # bench.py's headline
RECALL_FLOOR = 0.90  # recall@10 at nprobe=256
QPS_RUNS = 5  # timed serving runs per nprobe (after one warm-up)
QPS_RUNS_8BIT = 3  # the same on the total_bits=8 index
MSTG_EFS = (8, 64)  # ef_search served on the MSTG indexes (bench.py's sweep starts at 8)
MSTG_EPS = 0.6  # pruning epsilon (bench.py's)
MSTG_BUILD_CUT_S = 60.0  # a slower headline MSTG build cuts the replicated variant ...
MSTG_CUT_ROWS = 262_144  # ... to this many rows
STREAM_CHUNK_ROWS = 262_144  # rows a slab of the streamed tier: 4 chunks at 1M rows
STREAM_QPS_RUNS = 3  # timed streamed batches a nprobe
CLI_ROWS, CLI_QUERIES = 100_000, 256  # the CLI's fvecs slice (1M x 960 would be 3.8 GB)
CLI_RECALL_FLOOR = 0.80  # recall@10 of the CLI's query (nlist 1024, nprobe 64, bf16 scan)
SHARDS = 4  # shards of the sharded phase, all on the one card
SHARD_BLOCK = 256  # queries a sharded dispatch


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Median host time (microseconds) to call ``fn`` without waiting for
    the device: what a call costs the thread that dispatches it. Called in
    rounds of 10 from an idle device, so that no launch queue fills up and
    makes the host wait."""
    import statistics

    import torch

    fn()
    rounds = []
    for _ in range(max(reps // 10, 1)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        rounds.append((time.perf_counter() - t0) / 10 * 1e6)
    torch.cuda.synchronize()
    return statistics.median(rounds)


def queued_us(fn, reps: int) -> float:
    """Mean device time (microseconds) of ``fn`` over ``reps`` calls made
    while the device is still busy with a long product, so that the calls
    wait in the stream and run back to back: for work so short that the
    host calls it more slowly than the device runs it."""
    import torch

    fn()
    a = torch.ones((8192, 8192), device="cuda")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.mm(a, a)
    torch.mm(a, a)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def make_workload(rows, n_queries, dim, n_centers, seed, device):
    """bench.py's make_workload drawn on the card: overlapping Gaussian
    blobs, queries from the same mixture, sigma = 1.5 * (dim / 128)^0.25.
    Returns (data, queries, the blob centres)."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    sigma = 1.5 * (dim / 128.0) ** 0.25
    centers = torch.randn((n_centers, dim), generator=g, device=device)

    def draw(n):
        out = torch.empty((n, dim), device=device)
        for s in range(0, n, 1 << 17):
            e = min(s + (1 << 17), n)
            a = torch.randint(0, n_centers, (e - s,), generator=g, device=device)
            out[s:e] = centers[a] + sigma * torch.randn((e - s, dim), generator=g, device=device)
        return out

    return draw(rows), draw(n_queries), centers


def ground_truth(data, queries, k):
    import torch

    d_sq = torch.sum(data * data, dim=1)
    out = []
    for s in range(0, queries.shape[0], 256):
        q = queries[s : s + 256]
        dist = d_sq[None, :] - 2.0 * (q @ data.T)
        out.append(torch.topk(dist, k, dim=1, largest=False).indices)
    return torch.cat(out).cpu().numpy()


def recall_at(ids, gt, k):
    hits = sum(len(set(ids[i, :k].tolist()) & set(gt[i, :k].tolist())) for i in range(len(gt)))
    return hits / (len(gt) * k)


def check_fht():
    import torch
    from rabitq_tpu_torch.ops.fht import fht_kernel, fht_plain

    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    rows_out = {}
    for rows, n in ((256, 512), (8192, 512), (64, 16384)):
        x = torch.randn((rows, n), generator=g, device="cuda")
        k_out = fht_kernel(x)
        p_out = fht_plain(x)
        torch.cuda.synchronize()
        err = float((k_out - p_out).abs().max())
        if not torch.equal(k_out, p_out):
            raise AssertionError(f"fht [{rows}, {n}]: kernel != plain (max |err| {err})")
        # device times of calls queued behind a long product (a call takes
        # longer on the host than on the device), each call on another copy
        # of the input from a pool four times the L2's size, so that every
        # call reads its input from device memory, as the bound counts it
        pool = [x.clone() for _ in range(math.ceil(4 * L2_BYTES / (rows * n * 4)))]
        turn = itertools.count()

        def cold():
            return pool[next(turn) % len(pool)]

        ms = queued_us(lambda: fht_kernel(cold()), 50) / 1e3
        plain_ms = queued_us(lambda: fht_plain(cold()), 20) / 1e3
        n_bytes = 2 * rows * n * 4
        ops = rows * n * (n.bit_length() - 1)
        bound = max(n_bytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
        library = ""
        library_ms = None
        if (rows, n) == (8192, 512):
            # the one library call for this function: a product with the
            # Sylvester matrix (f32, no TF32); timed here, used nowhere
            h = fht_plain(torch.eye(n, device="cuda"))
            lib_out = torch.mm(x, h)
            torch.cuda.synchronize()
            if not torch.allclose(lib_out, p_out, rtol=1e-4, atol=1e-3):
                raise AssertionError("fht: torch.mm with the Sylvester matrix disagrees")
            library_ms = queued_us(lambda: torch.mm(cold(), h), 50) / 1e3
            library = f", library (torch.mm, f32) {library_ms:.4f} ms"
        log(f"fht [{rows}, {n}]: bitwise equal; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms (bytes){library}")
        rows_out[(rows, n)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, err=err,
                                   library_ms=library_ms)
        del pool
    return rows_out


def bin_scan_bound(args, kw):
    """Least time for the bin scan on these inputs: the plane rows it must
    read (listed tiles, or all), the other inputs and outputs once, and
    2 flops per plane column and (query, row) pair it must score. Direct
    mode: D columns at the bf16 tensor rate (the int8 codes are exact in
    bf16; the kernel's three products a column, for the three bf16 parts of
    the f32 query, are its own cost, not the function's). Packed mode: 8 * Db
    columns at the int8 tensor rate for an int8 query, the bf16 rate for a
    bf16 one, against an eighth of the plane bytes."""
    from rabitq_tpu_torch.ops.fused_scan import TN, n_bins

    plane, q, _, _, _, _, g1, c_blk, tiles, tcount = args
    n, d = plane.shape
    bq = q.shape[0]
    packed = kw.get("f_error") is not None
    if tiles is None:
        pair_tiles = bq * (n // TN)
        read_tiles = n // TN
    else:
        tb = bq // tiles.shape[0]
        cnt = tcount.clamp(max=tiles.shape[1]).cpu()
        pair_tiles = tb * int(cnt.sum())
        listed = set()
        for j, c in enumerate(cnt.tolist()):
            listed.update(tiles[j, :c].cpu().tolist())
        read_tiles = len(listed)
    rows = read_tiles * TN
    n_bytes = (
        rows * d + rows * (16 if packed else 12) + q.numel() * q.element_size() + bq * 4
        + g1.numel() * 2 * (2 if packed else 1) + c_blk.numel() * 4
        + 2 * bq * n_bins() * 4 + bq * 128 * 4
    )
    if kw.get("q_scale") is not None:
        n_bytes += bq * 4
    ops = 2 * pair_tiles * TN * q.shape[1]
    rate = INT8_TENSOR_OPS if kw.get("q_scale") is not None else BF16_TENSOR_FLOPS
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_bin_scan(index, queries_np, nprobe, walk):
    """Kernel vs plain on the exact inputs the main path hands the bin
    kernel for one 256-query block at this nprobe, in the mode the index's
    scan_dtype takes (direct, or packed with a bf16 or int8 query)."""
    from rabitq_tpu_torch import SearchParams

    return check_bin_scan_run(
        lambda: index.batch_search_arrays(queries_np[:256], SearchParams(top_k=10, nprobe=nprobe)),
        f"nprobe={nprobe}", walk, index=index)


class EagerBody:
    """An index's fused search run as its eager body (``FusedSearch.eager``,
    no graph): the witness the graphs are held against, and the way to see
    the arguments a kernel gets inside a search (a replay runs no Python)."""

    def __init__(self, fused):
        self.fused = fused

    def __call__(self, *a, **kw):
        return self.fused.eager(*a, **kw)

    def clear(self):
        self.fused.clear()


def eagerly(index, run):
    """``run()`` with ``index``'s searches served by the eager body."""
    fused = index._fused_scan
    index._fused_scan = EagerBody(fused)
    try:
        return run()
    finally:
        index._fused_scan = fused


def check_bin_scan_run(run, label, walk=None, index=None):
    """:func:`check_bin_scan` on the first bin-kernel call that ``run()``
    makes (one 256-query block of a path's search; through ``index``'s
    eager body where an index is given, so that the wrapper is called).
    Where ``walk`` is given ("compacted" or "dense"), fails unless that call
    took that walk, so a result filed under a walk's name holds that walk's
    numbers."""
    import torch
    from rabitq_tpu_torch.ops import fused_scan

    captured = []
    real = fused_scan.fused_bin_scan

    def spy(*a, tiles=None, tcount=None, **kw):
        captured.append((a + (tiles, tcount), kw))
        return real(*a, tiles=tiles, tcount=tcount, **kw)

    fused_scan.fused_bin_scan = spy
    try:
        eagerly(index, run) if index is not None else run()
    finally:
        fused_scan.fused_bin_scan = real
    args, kw = captured[0]
    seen = "dense" if args[8] is None else "compacted"
    if walk is not None and seen != walk:
        raise AssertionError(f"bin scan ({label}): took the {seen} walk, expected {walk}")
    walk = seen
    if kw.get("f_error") is None:
        mode, kernel = "direct", fused_scan.fused_bin_scan_cuda
    else:
        mode = "packed int8 q" if kw.get("q_scale") is not None else "packed bf16 q"
        kernel = fused_scan.fused_bin_scan_packed_cuda
    what = f"bin scan ({mode}, {walk})" if mode != "direct" else f"bin scan ({walk})"
    kv, ki, ko = kernel(*args, **kw)
    pv, pi, po = fused_scan.fused_bin_scan_plain(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(ko, po):
        raise AssertionError(f"{what}: offered counts differ")
    finite = pv < fused_scan.BIG / 2
    if not torch.equal(finite, kv < fused_scan.BIG / 2):
        raise AssertionError(f"{what}: different bins filled")
    err = float((kv - pv)[finite].abs().max()) if bool(finite.any()) else 0.0
    # an int8 dot is exact; f32 sums of a bf16 or f32 dot run in another order
    tol = dict(rtol=1e-6, atol=1e-6) if kw.get("q_scale") is not None else dict(rtol=1e-5, atol=1e-3)
    if not torch.allclose(kv[finite], pv[finite], **tol):
        raise AssertionError(f"{what}: values differ, max |err| {err}")
    agree = float((ki == pi).float().mean())
    if agree < 0.999:
        raise AssertionError(f"{what}: bins_idx agree on {agree:.5f} < 0.999")
    ms = cuda_ms(lambda: kernel(*args, **kw), 10)
    plain_ms = cuda_ms(lambda: fused_scan.fused_bin_scan_plain(*args, **kw), 2)
    bound, bound_by = bin_scan_bound(args, kw)
    # what the wrapper does to the query before each launch (the split into
    # bf16 planes and the layout as the kernel's image), on the host and on
    # the device, beside the whole wrapper's host time
    if mode == "direct":
        image = lambda: fused_scan.query_image(  # noqa: E731
            fused_scan.split_bf16x3(args[1]), "direct", args[0].shape[1])
    else:
        image_mode = "bits_s8" if kw.get("q_scale") is not None else "bits_bf16"
        image = lambda: fused_scan.query_image(args[1], image_mode, args[0].shape[1])  # noqa: E731
    image_host, image_dev = host_us(image, 100), queued_us(image, 20)
    wrapper_host = host_us(lambda: kernel(*args, **kw), 50)
    extra = ""
    if args[8] is not None:
        cnt = args[9].clamp(max=args[8].shape[1])
        extra = (f", lists of {args[8].shape[1]} slots, {int(cnt.sum())} tiles listed over "
                 f"{cnt.numel()} blocks of {args[1].shape[0] // cnt.numel()} queries")
    log(f"{what} ({label}, q {tuple(args[1].shape)}, plane "
        f"{tuple(args[0].shape)}{extra}): offered equal, max |err| {err:.3g}, idx agree "
        f"{agree:.5f}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.3f} ms "
        f"({bound_by}); query image {image_host:.0f} us on the host, {image_dev:.1f} us on "
        f"the device, of {wrapper_host:.0f} us the wrapper takes on the host")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, err=err)


def plane_agreement(got, want, what):
    """+-inf entries of a bf16 lower-bound plane equal, finite ones within one
    bf16 ulp (a reordered f32 sum can cross a rounding boundary), >= 99%
    bitwise equal. Returns (max |err| of the finite entries, share equal)."""
    import torch

    got, want = got.float(), want.float()
    inf = torch.isinf(want)
    if not (torch.equal(torch.isinf(got), inf) and torch.equal(got[inf], want[inf])):
        raise AssertionError(f"{what}: the infinite entries differ")
    fin = ~inf
    diff = (got[fin] - want[fin]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if not bool((diff <= 2.0 ** -7 * want[fin].abs() + 1e-3).all()):
        raise AssertionError(f"{what}: an entry is off by more than a bf16 ulp ({err})")
    same = float((got == want).float().mean())
    if same < 0.99:
        raise AssertionError(f"{what}: only {same:.5f} of entries bitwise equal")
    return err, same


def packed_lb_bound(n_bytes, bq, n, db):
    """Least time for a packed lower-bound plane: ``n_bytes`` moved, or
    2 * 8 * Db bf16 tensor operations per (query, row) pair."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, 2 * bq * n * 8 * db / BF16_TENSOR_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def capture_packed_lb_plane(run, index=None):
    """The arguments of the first ``packed_lb_plane`` call that ``run()``
    makes (the dense "packed" scan's stage 1; through ``index``'s eager body
    where an index is given)."""
    from rabitq_tpu_torch.index import scan

    captured = []
    real = scan.packed_lb_plane

    def spy(*a):
        captured.append(a)
        return real(*a)

    scan.packed_lb_plane = spy
    try:
        eagerly(index, run) if index is not None else run()
    finally:
        scan.packed_lb_plane = real
    return captured[0]


def check_lb_plane(args, what):
    """The packed lower-bound kernel's G_TABLE epilogue (the masked plane the
    "packed" scan takes) vs its plain version on a main path's own inputs,
    with times and bound, and beside them the library time of the dot alone:
    a bf16 torch.mm of the query and the bit planes unpacked ahead of time,
    with f32 output."""
    import torch
    from rabitq_tpu_torch.ops import packed_scan

    packed, q_perm = args[:2]
    n, db = packed.shape
    bq, c = args[5].shape
    err, same = plane_agreement(packed_scan.packed_lb_plane_cuda(*args),
                                packed_scan.packed_lb_plane_plain(*args), what)
    # inputs as the function takes them, each once, and the plane it writes
    table_bytes = sum(t.numel() * t.element_size() for t in args[1:])
    b, by = packed_lb_bound(n * db + table_bytes + bq * n * 2, bq, n, db)
    out = dict(err=err, same=same, bound_ms=b, bound_by=by,
               ms=cuda_ms(lambda: packed_scan.packed_lb_plane_cuda(*args), 5),
               plain_ms=cuda_ms(lambda: packed_scan.packed_lb_plane_plain(*args), 2))
    bits = packed_scan.unpack_bitplanes(packed).to(torch.bfloat16)
    out["library_ms"] = cuda_ms(lambda: torch.mm(q_perm, bits.T, out_dtype=torch.float32), 5)
    del bits
    torch.cuda.empty_cache()
    log(f"{what} (q {tuple(q_perm.shape)}, packed {tuple(packed.shape)}, {c} clusters): max "
        f"|err| {err:.3g}, {same:.5f} bitwise equal, infinities equal; kernel {out['ms']:.3f} ms, "
        f"plain {out['plain_ms']:.3f} ms, bound {b:.3f} ms ({by}), library (torch.mm bf16 -> "
        f"f32 of the unpacked planes, the dot alone) {out['library_ms']:.3f} ms")
    return out


def check_packed_lb_scan(index, queries_np, nprobe):
    """The packed lower-bound kernel vs its plain versions on the inputs the
    main path (scan_dtype "packed") hands it for one 256-query block: the
    G_TABLE epilogue, then the G_PLANE epilogue (the TPU contract) on a
    g_comb built from the same inputs."""
    import torch
    from rabitq_tpu_torch import SearchParams
    from rabitq_tpu_torch.ops import packed_scan

    args = capture_packed_lb_plane(lambda: index.batch_search_arrays(
        queries_np[:256], SearchParams(top_k=10, nprobe=nprobe)), index)
    packed, q_perm, f_add, f_rescale, k1x, g_add, g_error, f_error, cluster_of = args[:9]
    n, db = packed.shape
    bq = g_add.shape[0]
    out = {"plane": check_lb_plane(args, f"packed lb plane (G_TABLE, nprobe={nprobe})")}
    cl = cluster_of
    g_comb = (g_add.to(torch.bfloat16)[:, cl] - f_error[None, :] * g_error.to(torch.bfloat16)[:, cl])
    g_comb = g_comb.to(torch.bfloat16)
    scan_args = (packed, q_perm, f_add, f_rescale, k1x, g_comb)
    err, same = plane_agreement(packed_scan.packed_lb_scan_cuda(*scan_args),
                                packed_scan.packed_lb_scan_plain(*scan_args), "packed lb scan")
    b, by = packed_lb_bound(n * db + n * 8 + q_perm.numel() * 2 + bq * 4 + 2 * bq * n * 2,
                            bq, n, db)
    r = out["scan"] = dict(
        err=err, same=same, bound_ms=b, bound_by=by,
        library_ms=out["plane"]["library_ms"],
        ms=cuda_ms(lambda: packed_scan.packed_lb_scan_cuda(*scan_args), 5),
        plain_ms=cuda_ms(lambda: packed_scan.packed_lb_scan_plain(*scan_args), 2))
    log(f"packed lb scan (G_PLANE, nprobe={nprobe}): max |err| {r['err']:.3g}, {r['same']:.5f} "
        f"bitwise equal, infinities equal; kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
        f"ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
    return out


def profile_serving(index, queries_np, nprobe, label=""):
    """:func:`profile_run` over one pipelined serving run of the queries."""
    from rabitq_tpu_torch import SearchParams

    params = SearchParams(top_k=10, nprobe=nprobe)
    profile_run(lambda: index.batch_search_arrays_pipelined(
        queries_np, params, batch_size=256, upload_block=1024), f"{label}nprobe={nprobe}")


def profile_run(run, label):
    """Device time by kernel over one ``run()``, and the share of its wall
    time the device was busy (torch.profiler); returns the device's busy
    milliseconds. ``run()`` runs once before the profiled one, so that no
    graph is captured inside the profiler."""
    run()
    p = profile_dispatches(run, 1)
    log(f"profile {label}: wall {p['wall']:.1f} ms, device busy {p['busy']:.1f} ms "
        f"({100 * p['busy'] / p['wall']:.0f}%); top: {top_rows(p['rows'])}")
    return p["busy"]


def device_rows(prof):
    """(device ms, name, count) of every kernel and copy a profile recorded,
    largest first; fails if the device ran nothing."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        # device rows only: an operator's row repeats its kernels' device time
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.key, ev.count))
    if not rows:
        raise AssertionError("the profiler recorded no kernel on the device")
    return sorted(rows, reverse=True)


def top_rows(rows, n=8):
    return "; ".join(f"{name[:48]} x{k} {ms:.2f} ms" for ms, name, k in rows[:n])


KERNEL_NAMES = ("fht_", "bin_scan_kernel", "packed_lb_kernel")  # the port's kernels by name


def profile_dispatches(run, dispatches):
    """One profiled ``run()`` whose graphs are captured already: wall and
    device busy ms, the kernel launches and graph launches the CUDA API made
    a dispatch (the profiler's CPU events), the device's kernels and copies
    a dispatch, and the device rows (:func:`device_rows`), all and the
    port's kernels' alone."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    launches = graphs = 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CPU:
            continue
        if "GraphLaunch" in ev.key:
            graphs += ev.count
        elif "LaunchKernel" in ev.key:
            launches += ev.count
    ours = [r for r in rows if any(k in r[1] for k in KERNEL_NAMES)]
    return dict(wall=wall, busy=busy, launches=launches / dispatches, graphs=graphs / dispatches,
                device_ops=sum(r[2] for r in rows) / dispatches, rows=rows, ours=ours)


def check_fused(name, index, run, dispatches, ties=False):
    """The fused-search phase for one serving configuration. ``run()`` serves
    the queries (``dispatches`` blocks) and returns host (ids, distances).
    After one run that captures every key the configuration needs (the
    seconds of each capture printed), a run must launch no kernel outside a
    graph (no wrapper looks its kernel up) and replay once a block, and its
    results must equal the eager body's on the same blocks, ids and
    distances; with ``ties`` (a torch.topk survivor cut over bf16 lower
    bounds) a difference is measured and allowed down to a top-10 overlap
    of 0.99. Then eager and graph QPS paired (medians of 5, in turns), one
    profile of each (device busy share, the CUDA API's kernel and graph
    launches a dispatch, the port's kernels inside the replays), and the
    graphs' memory pool."""
    import numpy as np
    from rabitq_tpu_torch.ops import _cuda

    st = index._fused_scan.stats
    seen = len(st["capture_s"])
    run()
    capture_s = st["capture_s"][seen:]
    replays = st["replays"]
    entries = []
    real = _cuda.entry
    _cuda.entry = lambda k: entries.append(k) or real(k)
    try:
        got = run()
    finally:
        _cuda.entry = real
    replayed = st["replays"] - replays
    if entries or replayed != dispatches:
        raise AssertionError(f"fused {name}: {len(entries)} kernel launches outside a graph, "
                             f"{replayed} replays for {dispatches} blocks")
    want = eagerly(index, run)
    ids_equal = float(np.mean(got[0] == want[0]))
    overlap = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / len(a)
                             for a, b in zip(got[0], want[0])]))
    same = ids_equal == 1.0 and np.array_equal(got[1], want[1])
    d_err = float(np.nanmax(np.abs(got[1] - want[1]))) if got[1].size else 0.0
    if not same and (not ties or overlap < 0.99):
        raise AssertionError(f"fused {name}: graph results differ from the eager body's (ids "
                             f"equal {ids_equal:.5f}, overlap {overlap:.5f}, max |d| {d_err:.3g})")
    n = len(got[0])
    qps = {"eager": [], "graph": []}
    for i in range(QPS_RUNS):
        for mode in (("eager", "graph") if i % 2 == 0 else ("graph", "eager")):
            t0 = time.perf_counter()
            eagerly(index, run) if mode == "eager" else run()
            qps[mode].append(n / (time.perf_counter() - t0))
    prof = {"eager": profile_dispatches(lambda: eagerly(index, run), dispatches),
            "graph": profile_dispatches(run, dispatches)}
    med = {k: float(np.median(v)) for k, v in qps.items()}
    agree = ("ids and distances equal" if same else
             f"ids equal {ids_equal:.5f}, top-10 overlap {overlap:.5f}, max |d| {d_err:.3g}")
    log(f"fused {name}: graph vs eager body on the same {dispatches} blocks: {agree}; QPS "
        f"paired, medians of {QPS_RUNS} [min, max]: eager {med['eager']:.0f} "
        f"[{min(qps['eager']):.0f}, {max(qps['eager']):.0f}], graph {med['graph']:.0f} "
        f"[{min(qps['graph']):.0f}, {max(qps['graph']):.0f}] ({med['graph'] / med['eager']:.2f}x)"
        + "".join(
            f"; {k}: device busy {p['busy']:.1f} of {p['wall']:.1f} ms "
            f"({100 * p['busy'] / p['wall']:.0f}%), a dispatch {p['launches']:.1f} kernel "
            f"launches + {p['graphs']:.1f} graph launches (CUDA API), {p['device_ops']:.1f} "
            f"device kernels and copies" for k, p in prof.items())
        + f"; captures {len(capture_s)} ("
        + ", ".join(f"{c:.3f}" for c in capture_s) + " s); graph pool now "
        f"{st['pool_bytes'] / 1e6:.1f} MB, peak {st['pool_peak'] / 1e6:.1f} MB; the port's "
        f"kernels inside the replays: " + (top_rows(prof["graph"]["ours"], 4) or "none listed"))
    return med


def file_digest(path) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def serve(index, queries_np, nprobe):
    """The serving call of every IVF phase: pipelined, batch 256, upload
    block 1024."""
    from rabitq_tpu_torch import SearchParams

    return index.batch_search_arrays_pipelined(
        queries_np, SearchParams(top_k=10, nprobe=nprobe), batch_size=256, upload_block=1024)


def zero_launches():
    """Set every kernel's launch counter to 0."""
    from rabitq_tpu_torch.ops.fht import fht_kernel
    from rabitq_tpu_torch.ops.fused_scan import fused_bin_scan_cuda, fused_bin_scan_packed_cuda
    from rabitq_tpu_torch.ops.kmeans import running_sum_kernel, segment_sum_kernel
    from rabitq_tpu_torch.ops.packed_scan import packed_lb_plane_cuda, packed_lb_scan_cuda

    fht_kernel.launches = 0
    fused_bin_scan_cuda.dense_launches = fused_bin_scan_cuda.compact_launches = 0
    for key in fused_bin_scan_packed_cuda.launches:
        fused_bin_scan_packed_cuda.launches[key] = 0
    packed_lb_scan_cuda.launches = packed_lb_plane_cuda.launches = 0
    segment_sum_kernel.launches = running_sum_kernel.launches = 0


def read_launches(path, needed):
    """The launch counters after a path's run; fails if a kernel in
    ``needed`` never ran on it."""
    from rabitq_tpu_torch.ops.fht import fht_kernel
    from rabitq_tpu_torch.ops.fused_scan import fused_bin_scan_cuda, fused_bin_scan_packed_cuda
    from rabitq_tpu_torch.ops.kmeans import running_sum_kernel, segment_sum_kernel
    from rabitq_tpu_torch.ops.packed_scan import packed_lb_plane_cuda

    counts = {"fht": fht_kernel.launches, "segment_sum": segment_sum_kernel.launches,
              "running_sum": running_sum_kernel.launches,
              "fused_bin_scan_dense": fused_bin_scan_cuda.dense_launches,
              "fused_bin_scan_compact": fused_bin_scan_cuda.compact_launches,
              "fused_bin_scan": fused_bin_scan_cuda.dense_launches
              + fused_bin_scan_cuda.compact_launches,
              "packed_lb_plane": packed_lb_plane_cuda.launches}
    counts.update({f"fused_bin_scan_packed_{k}": v
                   for k, v in fused_bin_scan_packed_cuda.launches.items()})
    counts = {k: counts[k] for k in needed}
    log(f"launches on the {path} path: {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the {path} path never ran: {counts}")
    return counts


def check_persistence(index, queries_np, data):
    """RBQ1 round trip of the 7-bit index: save (twice, byte-identical),
    load_index with scan_dtype fused8, serve at nprobe 64 through the EXACT
    scan with ids and distances equal to the index's before the save, and
    fetch_embedding of a few ids against the raw rows. The files go to a
    temporary directory inside the checkout and are deleted. Returns (the
    reload's launches, load_index's seconds, the file's sha256)."""
    import tempfile

    import numpy as np
    import torch
    from rabitq_tpu_torch import load_index

    want_ids, want_d = serve(index, queries_np, 64)
    t0 = time.perf_counter()
    index.host  # noqa: B018  (the host copy, downloaded from the card once)
    host_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path, again = os.path.join(tmp, "index.rbq"), os.path.join(tmp, "again.rbq")
        t0 = time.perf_counter()
        index.save_to_path(path)
        save_s = time.perf_counter() - t0
        index.save_to_path(again)
        digest = file_digest(path)
        identical = digest == file_digest(again)
        size = os.path.getsize(path)
        os.remove(again)
        t0 = time.perf_counter()
        loaded = load_index(path, scan_dtype="fused8", device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    if not (loaded.is_ivf and identical):
        raise AssertionError(f"RBQ1: loaded as {loaded.kind}, second save identical {identical}")
    loaded = loaded.as_ivf()
    loaded.upload_dtype = index.upload_dtype
    zero_launches()
    ids, dists = serve(loaded, queries_np, 64)
    launches = read_launches("RBQ1 reload", ("fht", "fused_bin_scan_dense"))
    if not (np.array_equal(ids, want_ids) and np.array_equal(dists, want_d)):
        raise AssertionError(
            f"RBQ1 reload: ids equal {np.mean(ids == want_ids):.5f}, dists equal "
            f"{np.mean(dists == want_d):.5f} of entries")
    rows = [0, 1, ROWS // 2, ROWS - 1]
    errs = []
    for i in rows:
        x = data[i].cpu().numpy()
        errs.append(float(np.linalg.norm(loaded.fetch_embedding(i) - x) / np.linalg.norm(x)))
    log(f"RBQ1: {size} bytes; host copy {host_s:.2f} s, save {save_s:.2f} s, second save "
        f"byte-identical (sha256), load_index {load_s:.2f} s; reload serves nprobe=64 with ids "
        f"and distances equal; fetch_embedding of ids {rows}: L2 error / row norm "
        f"{', '.join(f'{e:.4f}' for e in errs)}")
    if max(errs) > 0.05:
        raise AssertionError(f"fetch_embedding off by {max(errs):.4f} of the row's norm")
    return launches, load_s, digest


def check_resident(index, queries_np):
    """upload_queries + batch_search_resident at nprobe 64: ids equal to
    batch_search_arrays on the same uploads, QPS beside the pipelined
    path's."""
    import numpy as np
    from rabitq_tpu_torch import SearchParams

    params = SearchParams(top_k=10, nprobe=64)
    want_ids, _ = index.batch_search_arrays(queries_np, params)
    zero_launches()
    handle = index.upload_queries(queries_np)
    ids, _ = index.batch_search_resident(handle, params, batch_size=256)
    launches = read_launches("resident", ("fht", "fused_bin_scan_dense"))
    if not np.array_equal(ids, want_ids):
        raise AssertionError(f"resident ids equal on {np.mean(ids == want_ids):.5f} of entries")
    qps = {"resident": [], "pipelined": []}
    for _ in range(QPS_RUNS):
        t0 = time.perf_counter()
        index.batch_search_resident(handle, params, batch_size=256)
        qps["resident"].append(len(queries_np) / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        serve(index, queries_np, 64)
        qps["pipelined"].append(len(queries_np) / (time.perf_counter() - t0))
    log(f"resident queries ({index.upload_dtype} uploads, nprobe=64): ids equal to "
        f"batch_search_arrays; QPS over {QPS_RUNS} runs (median [min, max]): " + ", ".join(
            f"{k} {np.median(v):.0f} [{min(v):.0f}, {max(v):.0f}]" for k, v in qps.items()))
    return launches


def check_gather(index, queries_np, gt):
    """The gather scan (RABITQ_GATHER=1, set in this process and unset after)
    at nprobe 16 beside the EXACT scan: budget, device ms of one 256-query
    dispatch, QPS and recall@10; fails more than 0.005 below the EXACT
    scan's recall. The 16 largest clusters of this k-means hold more than
    the default RABITQ_GATHER_MAX (16384) rows, so the limit is raised to
    the budget for the run (and unset after)."""
    import numpy as np
    from rabitq_tpu_torch import SearchParams
    from rabitq_tpu_torch.index.scan import gather_budget_bucket

    nprobe = 16
    params = SearchParams(top_k=10, nprobe=nprobe)
    handle = index.upload_queries(queries_np[:256])
    row_allowed = index._scan_inputs(None)

    def one_dispatch():
        return index._dispatch_scan(handle[0], handle[1], params, row_allowed)

    def measure(name):
        qps = []
        for _ in range(QPS_RUNS):
            t0 = time.perf_counter()
            ids, _ = serve(index, queries_np, nprobe)
            qps.append(len(queries_np) / (time.perf_counter() - t0))
        one_dispatch()
        ms = profile_run(one_dispatch, f"one 256-query dispatch, {name} scan nprobe={nprobe}")
        return recall_at(ids, gt, 10), qps, ms

    exact = measure("EXACT")
    os.environ["RABITQ_GATHER"] = "1"
    os.environ["RABITQ_GATHER_MAX"] = str(gather_budget_bucket(np.diff(index._offsets), nprobe))
    try:
        budget = index._gather_budget(nprobe)
        if budget is None:
            raise AssertionError("the gather scan's gate declined at nprobe 16")
        zero_launches()
        serve(index, queries_np, nprobe)
        launches = read_launches("gather", ("fht",))
        gather = measure("gather")
    finally:
        del os.environ["RABITQ_GATHER"], os.environ["RABITQ_GATHER_MAX"]
    for name, (recall, qps, ms) in (("EXACT", exact), ("gather", gather)):
        log(f"{name} scan nprobe={nprobe}: recall@10 {recall:.4f}; device busy {ms:.3f} ms "
            f"a 256-query dispatch; pipelined QPS over {QPS_RUNS} runs (median [min, max]) "
            f"{np.median(qps):.0f} [{min(qps):.0f}, {max(qps):.0f}]")
    log(f"gather scan: budget R = {budget} rows a query (a [256, {budget}, "
        f"{index.layout.ex.shape[1]}] code gather a dispatch)")
    if gather[0] < exact[0] - 0.005:
        raise AssertionError(f"gather recall {gather[0]:.4f} < EXACT {exact[0]:.4f} - 0.005")
    return launches


def check_fused_ivf(index, queries_np):
    """The fused-search phase on the 7-bit index (:func:`check_fused` for each
    configuration): fused8 at nprobe 16, 64 and 256, the gather scan at 16
    (RABITQ_GATHER=1 and its row limit raised to the budget, unset after), a
    filtered search (a seeded half of the ids), resident queries (the
    superblock scanned in windows), and f32, bf16 and int4 uploads at nprobe
    64 (int8 is the nprobe 64 line)."""
    import numpy as np
    from rabitq_tpu_torch import SearchParams
    from rabitq_tpu_torch.index.scan import gather_budget_bucket

    blocks = len(queries_np) // 256
    for nprobe in (16, 64, 256):
        check_fused(f"7 bits fused8 nprobe={nprobe}", index,
                    lambda: serve(index, queries_np, nprobe), blocks)
    os.environ["RABITQ_GATHER"] = "1"
    os.environ["RABITQ_GATHER_MAX"] = str(gather_budget_bucket(np.diff(index._offsets), 16))
    try:
        check_fused("7 bits gather scan nprobe=16", index, lambda: serve(index, queries_np, 16),
                    blocks)
    finally:
        del os.environ["RABITQ_GATHER"], os.environ["RABITQ_GATHER_MAX"]
    params = SearchParams(top_k=10, nprobe=64)
    allowed = np.random.default_rng(5).permutation(len(index))[: len(index) // 2]
    check_fused("7 bits filtered (a half of the ids) nprobe=64", index,
                lambda: index.batch_search_arrays_pipelined(
                    queries_np, params, batch_size=256, upload_block=1024, filter_ids=allowed),
                blocks)
    handle = index.upload_queries(queries_np)
    check_fused("7 bits resident superblock nprobe=64", index,
                lambda: index.batch_search_resident(handle, params, batch_size=256), blocks)
    for upload in ("f32", "bf16", "int4"):
        index.upload_dtype = upload
        try:
            check_fused(f"7 bits {upload} uploads nprobe=64", index,
                        lambda: serve(index, queries_np, 64), blocks)
        finally:
            index.upload_dtype = "int8"
    log_pool("7-bit", index)


def log_pool(label, index):
    """The graphs' memory pool of an index at its peak, and every capture it
    made (seconds each, warm-up included)."""
    st = index._fused_scan.stats
    log(f"graph pool of the {label} index: peak {st['pool_peak'] / 1e6:.1f} MB; "
        f"{len(st['capture_s'])} captures ({', '.join(f'{c:.3f}' for c in st['capture_s'])} s), "
        f"{st['replays']} replays")


def require_equal(what, got, want):
    """Fails unless the arrays are equal, naming how many entries differ
    and the largest difference."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape}, expected {want.shape}")
    if np.array_equal(got, want):
        return
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    raise AssertionError(f"{what}: {int((got != want).sum())} of {want.size} entries differ, "
                         f"largest difference {np.nanmax(diff):.6g}")


def require_bitwise(what, got, want):
    """Fails unless the arrays have one dtype and shape and the same bytes
    (so -0.0 is not 0.0), naming how many entries differ."""
    import numpy as np

    got, want = np.ascontiguousarray(got), np.ascontiguousarray(want)
    if got.dtype != want.dtype:
        raise AssertionError(f"{what}: dtype {got.dtype}, expected {want.dtype}")
    require_equal(what, got, want)
    if got.tobytes() != want.tobytes():
        raise AssertionError(f"{what}: equal values with other bits (signed zeros)")


# seconds of each part of the reproducible-builds phase, which runs on each
# index while it is alive
REPRO_S: dict = {}


def segment_ids_of_lists(ids, offsets, n_rows):
    """[n_rows] int64: the list of each row, from an index's row ids in list
    order and its list offsets (-1 for a row in no list)."""
    import numpy as np

    seg = np.full(n_rows, -1, np.int64)
    seg[np.asarray(ids)] = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    return seg


def check_segment_sum(data, seg_np, segments, label):
    """The segment-sum kernel at one of the build's shapes: the rows
    ``data`` [N, D] f32 on the card into ``segments`` segments by
    ``seg_np``. Its sums against the plain version (CPU ``index_add_``,
    ascending row order) on the same inputs, bitwise; device times (CUDA
    events, mean of 5 after a warm-up) of the wrapper (stable sort of the
    ids, segment offsets, kernel) and of its sort alone, beside
    ``index_add_`` on the card (the library yardstick: float atomics, which
    the port never calls) and the bound (rows and ids read once, sums
    written once, over HBM); the plain version's host time. The check's
    launches count on no path. Returns the kernel-line numbers."""
    import numpy as np
    import torch
    from rabitq_tpu_torch.ops.kmeans import segment_sum_kernel, segment_sum_plain

    n, d = data.shape
    ids = torch.from_numpy(seg_np).to(data.device)
    before = segment_sum_kernel.launches
    got, counts = segment_sum_kernel(data, ids, segments)
    ms = cuda_ms(lambda: segment_sum_kernel(data, ids, segments), 5)
    sort_ms = cuda_ms(lambda: torch.sort(ids, stable=True), 5)

    def library():
        return torch.zeros((segments, d), device=data.device).index_add_(0, ids, data)

    lib = library().cpu()
    library_ms = cuda_ms(library, 5)
    segment_sum_kernel.launches = before
    rows_cpu, ids_cpu = data.cpu(), ids.cpu()
    t0 = time.perf_counter()
    want = segment_sum_plain(rows_cpu, ids_cpu, segments)
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = got.cpu()
    err = float((got.double() - want.double()).abs().max())
    lib_diff = int((lib != want).sum())
    counts = counts.cpu().numpy()
    bound_ms = (n * d * 4 + n * 8 + segments * d * 4) / HBM_BYTES_PER_S * 1e3
    log(f"segment sum, {label}: [{n}, {d}] f32 rows into {segments} segments (rows a segment "
        f"max {counts.max()}, median {np.median(counts):.0f}, {int((counts == 0).sum())} empty): "
        f"the card's sums equal the CPU form's bitwise {torch.equal(got, want)} (max |diff| "
        f"{err:.3g}); wrapper {ms:.3f} ms (its stable sort of the ids {sort_ms:.3f} ms), "
        f"index_add_ on the card {library_ms:.3f} ms ({lib_diff} of {want.numel()} sums differ "
        f"from the fixed order's), bound {bound_ms:.3f} ms (bytes); the plain version (CPU "
        f"index_add_, host clock) {plain_ms:.1f} ms")
    require_bitwise(f"segment sum, {label}", got.numpy(), want.numpy())
    del rows_cpu, ids_cpu
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": library_ms}


def check_running_sum(data):
    """The running-sum kernel at the k-means++ init's shape on the main
    path: the weights of one init step (the squared distances of the
    init's 262,144 rows to row 0). Its sums against the plain version (CPU,
    the same chunks and order), bitwise; device time (CUDA events, mean of
    20 after a warm-up) beside a 1-D ``torch.cumsum`` on the card (the
    library yardstick, which the port never calls: how many of 20 of its
    runs differ from its first is printed) and the bound (weights read
    once, sums written once, over HBM); the plain version's host time. The
    check's launches count on no path. Returns the kernel-line numbers."""
    import torch
    from rabitq_tpu_torch.ops.kmeans import (
        _init_rows_cap,
        running_sum_kernel,
        running_sum_plain,
    )

    n = _init_rows_cap(NLIST, data.shape[0])
    w = torch.sum((data[:n] - data[0]) ** 2, dim=1)
    before = running_sum_kernel.launches
    got = running_sum_kernel(w)
    ms = cuda_ms(lambda: running_sum_kernel(w), 20)
    running_sum_kernel.launches = before
    library_ms = cuda_ms(lambda: torch.cumsum(w, 0), 20)
    first = torch.cumsum(w, 0)
    varies = sum(not torch.equal(torch.cumsum(w, 0), first) for _ in range(20))
    w_cpu = w.cpu()
    t0 = time.perf_counter()
    want = running_sum_plain(w_cpu)
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = got.cpu()
    err = float((got.double() - want.double()).abs().max())
    bound_ms = 2 * n * 4 / HBM_BYTES_PER_S * 1e3
    log(f"running sum, the k-means++ init's shape: {n} f32 weights: the card's sums equal the "
        f"CPU form's bitwise {torch.equal(got, want)} (max |diff| {err:.3g}); kernel {ms:.4f} "
        f"ms, 1-D torch.cumsum on the card {library_ms:.4f} ms ({varies} of 20 of its runs "
        f"differ from its first), bound {bound_ms:.5f} ms (bytes); the plain version (CPU, "
        f"host clock) {plain_ms:.2f} ms")
    require_bitwise("running sum", got.numpy(), want.numpy())
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": library_ms}


def check_kmeanspp_picks():
    """A k-means++ init on the card and on the CPU from one key, on
    integer-valued rows that keep every distance and running sum exact in
    f32 (4096 x 32, coordinates in [-4, 4], k = 64, TF32 off as by
    default): the picked rows must be equal. Two seeds."""
    import numpy as np
    import torch
    from rabitq_tpu_torch.ops.kmeans import _kmeanspp_init
    from rabitq_tpu_torch.ops.prng import PRNGKey

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 products are on: the picks' sums would not be exact")
    t0 = time.perf_counter()
    for seed in (0, 42):
        rows = np.random.default_rng(seed).integers(-4, 5, (4096, 32)).astype(np.float32)
        key = PRNGKey(seed * 1_000_003)
        on_card = _kmeanspp_init(torch.from_numpy(rows).cuda(), key, 64, 4096).cpu().numpy()
        on_cpu = _kmeanspp_init(torch.from_numpy(rows), key, 64, 4096).numpy()
        require_bitwise(f"k-means++ picks, seed {seed}: card against CPU", on_card, on_cpu)
    REPRO_S["picks"] = time.perf_counter() - t0
    log("reproducible picks: a k-means++ init (4096 x 32 integer rows in [-4, 4], k 64) from "
        "PRNGKey(seed * 1_000_003), seeds 0 and 42: the card picks the CPU's 64 rows")


def check_reproducible_ivf(index, data, queries_np, digest, first):
    """The 7-bit headline train a second time from the same rows and seed:
    the segment-sum kernel first at the k-means shape (the rows into
    NLIST + 1 segments by the index's assignments) and the running-sum
    kernel at the k-means++ init's, then the train (its
    path: launch counters zeroed before, read after), every host array
    bitwise equal to the index's (the centroids among them), its RBQ1 file
    byte-identical to the persistence phase's (``digest``), and ids and
    distances at nprobe 16 equal. ``first``: (seconds, build report) of the
    first train. Returns (launches, segment-sum check, running-sum check)."""
    import dataclasses
    import tempfile

    import torch
    from rabitq_tpu_torch import IvfRabitqIndex, Metric, RotatorType

    t_all = time.perf_counter()
    h = index.host
    seg = segment_ids_of_lists(h.ids, h.cluster_offsets, data.shape[0])
    kernel = check_segment_sum(data, seg, NLIST + 1, "k-means shape (the 7-bit index's lists)")
    scan = check_running_sum(data)
    zero_launches()
    t0 = time.perf_counter()
    again = IvfRabitqIndex.train(
        data, nlist=NLIST, total_bits=7, metric=Metric.L2,
        rotator_type=RotatorType.FhtKacRotator, seed=42, use_faster_config=True,
        scan_dtype="fused8", device=data.device,
    )
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    launches = read_launches("7-bit train, second run", ("fht", "segment_sum", "running_sum"))
    h2 = again.host
    # the k-means result first, so that a failure names the earliest stage
    names = ["centroids", "cluster_offsets", "ids"]
    names += [f.name for f in dataclasses.fields(h) if f.name not in names]
    for name in names:
        require_bitwise(f"second 7-bit train: host.{name}", getattr(h2, name), getattr(h, name))
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = os.path.join(tmp, "again.rbq")
        again.save_to_path(path)
        if file_digest(path) != digest:
            raise AssertionError("second 7-bit train: its RBQ1 file differs from the first's")
    again.upload_dtype = index.upload_dtype
    want_ids, want_d = serve(index, queries_np, 16)
    ids, dists = serve(again, queries_np, 16)
    require_equal("second 7-bit train: nprobe 16 ids", ids, want_ids)
    require_equal("second 7-bit train: nprobe 16 distances", dists, want_d)
    again_report = again.build_report
    del again, h2
    torch.cuda.empty_cache()
    log(f"reproducible IVF: the 7-bit headline train run again: {again_s:.2f} s (report "
        f"{json.dumps(again_report)}) against the first's {first[0]:.2f} s (report "
        f"{json.dumps(first[1])}); "
        f"every host array bitwise equal (centroids, codes, factors, ids, offsets), RBQ1 file "
        f"byte-identical to the first save (sha256), nprobe 16 ids and distances equal on all "
        f"{len(queries_np)} queries; launches {launches}")
    REPRO_S["IVF"] = time.perf_counter() - t_all
    return launches, kernel, scan


def check_reproducible_mstg(index, data, build_s):
    """The MSTG headline build a second time from the same rows and seed:
    the segment-sum kernel first at the polish shape (the rows into the
    padded list count + 1 segments by the headline's lists), then the build
    (its path: launch counters zeroed before, read after), with the same
    list count and every host array bitwise equal (each list's members
    after closure, codes, factors, centroids). Seconds by phase of both
    builds. Returns (launches, segment-sum check)."""
    import dataclasses

    import torch
    from rabitq_tpu_torch import MstgIndex
    from rabitq_tpu_torch.index.scan import _pad_pow2

    t_all = time.perf_counter()
    h = index.host
    seg = segment_ids_of_lists(h.ids, h.list_offsets, data.shape[0])
    c_pad = _pad_pow2(index.posting_list_count(), floor=8)
    kernel = check_segment_sum(data, seg, c_pad + 1, "MSTG polish shape (the headline's lists)")
    zero_launches()
    t0 = time.perf_counter()
    again = MstgIndex.build(data, index.config, seed=42, scan_dtype="fused8", device="cuda")
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    launches = read_launches("MSTG headline build, second run", ("fht", "segment_sum", "running_sum"))
    if again.posting_list_count() != index.posting_list_count():
        raise AssertionError(f"second MSTG build: {again.posting_list_count()} lists, the first "
                             f"{index.posting_list_count()}")
    h2 = again.host
    names = ["list_offsets", "ids", "centroids"]  # the clustering first
    names += [f.name for f in dataclasses.fields(h) if f.name not in names]
    for name in names:
        a, b = getattr(h2, name), getattr(h, name)
        if a is None or b is None:
            if (a is None) != (b is None):
                raise AssertionError(f"second MSTG build: host.{name} is None on one side")
            continue
        require_bitwise(f"second MSTG build: host.{name}", a, b)
    reports = [index.build_report, again.build_report]
    del again, h2
    torch.cuda.empty_cache()
    phases = [f"clustering {r['clustering_s']} s (levels {r['clustering']['levels_s']}, polish "
              f"and means {r['clustering']['polish_s']} s), closure {r['closure_s']} s, quantize "
              f"{r['quantize_s']} s, upload {r['upload_s']} s" for r in reports]
    log(f"reproducible MSTG: the headline build run again: {again_s:.2f} s ({phases[1]}) against "
        f"the first's {build_s:.2f} s ({phases[0]}); {index.posting_list_count()} lists in both, "
        f"every list's members and every host array bitwise equal; launches {launches}")
    REPRO_S["MSTG"] = time.perf_counter() - t_all
    return launches, kernel


def check_jax_shaped_ivf(index, data, data_np, queries_np, load_s):
    """The JAX package's call shapes on the 7-bit index, its last phase,
    each naming no device (the card is the default). The index made as the
    JAX package makes one over codes it holds, ``IvfRabitqIndex(dim,
    padded_dim, metric, rotator, ex_bits, host, "fused8")``: laid out from
    the host copy (seconds beside load_index's), served at nprobe 16 and 64
    (its path: launch counters zeroed before, read after) with ids and
    distances equal to the index's on every query, QPS beside the index's
    (median of 3, in turns), and K1 against its plain version at nprobe 64
    (dense). Then ``run_kmeans(data_np, NLIST, ..., data_dev=data)`` against
    ``run_kmeans(data, NLIST, ...)`` at the same seed (centroids and
    assignments equal: the segment sums add in one fixed order);
    ``upload_dataset(rows, "f32", 262_144)`` (on cuda:0, equal to the rows);
    and ``assemble_host_chunks`` with ``zero_f_error`` and ``row_pad`` given
    (the slabs equal to the streamed tier's, which releases the index's
    layout). Returns (launches, K1 check)."""
    import numpy as np
    import torch
    from rabitq_tpu_torch import IvfRabitqIndex, StreamedIvfIndex
    from rabitq_tpu_torch.index.layout import assemble_host_chunks
    from rabitq_tpu_torch.ops.kmeans import run_kmeans
    from rabitq_tpu_torch.utils.transfer import upload_dataset

    host = index.host
    made = IvfRabitqIndex(index.dim, index.padded_dim, index.metric, index.rotator,
                          index.ex_bits, host, "fused8")
    made.upload_dtype = index.upload_dtype
    t0 = time.perf_counter()
    made.layout  # noqa: B018  (laid out from the host copy)
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    want = {nprobe: serve(index, queries_np, nprobe) for nprobe in (16, 64)}
    zero_launches()
    got = {nprobe: serve(made, queries_np, nprobe) for nprobe in (16, 64)}
    launches = read_launches("JAX-shaped IVF", (
        "fht", "fused_bin_scan_compact", "fused_bin_scan_dense"))
    qps = {}
    for nprobe in (16, 64):
        require_equal(f"JAX-shaped IVF nprobe={nprobe} ids", got[nprobe][0], want[nprobe][0])
        require_equal(f"JAX-shaped IVF nprobe={nprobe} distances", got[nprobe][1],
                      want[nprobe][1])
        runs = {"made": [], "index": []}
        for _ in range(3):
            for name, idx in (("made", made), ("index", index)):
                t1 = time.perf_counter()
                serve(idx, queries_np, nprobe)
                runs[name].append(len(queries_np) / (time.perf_counter() - t1))
        qps[nprobe] = {k: float(np.median(v)) for k, v in runs.items()}
    log(f"JAX-shaped IVF (IvfRabitqIndex(..., index.host, \"fused8\"), no device): laid out "
        f"from the host copy in {layout_s:.2f} s (load_index {load_s:.2f} s); ids and distances "
        f"equal to the index's on all {len(queries_np)} queries at nprobe 16 and 64; pipelined "
        f"int8 QPS (median of 3, in turns) nprobe 16 {qps[16]['made']:.0f} (index "
        f"{qps[16]['index']:.0f}), nprobe 64 {qps[64]['made']:.0f} (index "
        f"{qps[64]['index']:.0f}); K1 and K2 launches {launches}")
    k1 = check_bin_scan(made, queries_np, 64, "dense")
    del made
    torch.cuda.empty_cache()

    km, km_s = {}, {}
    for name, call in (
        ("host rows, data_dev", lambda: run_kmeans(data_np, NLIST, 25, 42, data_dev=data,
                                                   assign_dtype="bf16", tol=1e-3)),
        ("device rows", lambda: run_kmeans(data, NLIST, 25, 42, assign_dtype="bf16", tol=1e-3)),
    ):
        t0 = time.perf_counter()
        km[name] = call()
        torch.cuda.synchronize()
        km_s[name] = time.perf_counter() - t0
    a, b = km.values()
    require_equal("run_kmeans(data_np, data_dev=data) centroids", a.centroids.cpu(),
                  b.centroids.cpu())
    require_equal("run_kmeans(data_np, data_dev=data) assignments", a.assignments, b.assignments)

    t0 = time.perf_counter()
    rows, report = upload_dataset(data_np, "f32", 262_144)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    if rows.device != torch.device("cuda", 0) or not torch.equal(rows, data):
        raise AssertionError(f"upload_dataset(rows, 'f32', 262_144): on {rows.device}, equal to "
                             f"the rows {torch.equal(rows, data) if rows.is_cuda else False}")
    del rows

    t0 = time.perf_counter()
    tier = StreamedIvfIndex(index, chunk_rows=STREAM_CHUNK_ROWS)
    tier_s = time.perf_counter() - t0
    h = index.host
    t0 = time.perf_counter()
    slabs = assemble_host_chunks(
        n=len(index), ex_bits=index.ex_bits, binary=h.binary_bits, ex=h.ex_codes,
        f_add=h.f_add, f_rescale=h.f_rescale, f_error=h.f_error, f_add_ex=h.f_add_ex,
        f_rescale_ex=h.f_rescale_ex, cluster_sizes=np.diff(h.cluster_offsets), ids=h.ids,
        chunk_rows=tier.chunk_rows, zero_f_error=False, row_pad=128, fused=tier._fused)
    chunks_s = time.perf_counter() - t0
    if len(slabs) != tier.n_chunks:
        raise AssertionError(f"assemble_host_chunks: {len(slabs)} slabs, tier {tier.n_chunks}")
    for i, (slab, chunk) in enumerate(zip(slabs, tier._chunks)):
        if sorted(slab) != sorted(chunk):
            raise AssertionError(f"slab {i}: keys {sorted(slab)} != {sorted(chunk)}")
        for key, arr in slab.items():
            require_equal(f"assemble_host_chunks slab {i} {key}", arr, chunk[key].numpy())
    n_slabs = len(slabs)
    del tier, slabs
    log(f"JAX-shaped k-means (run_kmeans(data_np, {NLIST}, 25, 42, data_dev=data) against "
        f"run_kmeans(data, ...)): centroids and assignments equal "
        f"({a.iters} iterations; {' s / '.join(f'{v:.2f}' for v in km_s.values())} s); "
        f"upload_dataset(rows, "
        f"'f32', 262_144): cuda:0, equal to the rows, {report['bytes']} bytes in "
        f"{upload_s:.2f} s; assemble_host_chunks(zero_f_error=False, row_pad=128): {n_slabs} "
        f"slabs equal to the streamed tier's ({chunks_s:.2f} s on the host; the tier "
        f"{tier_s:.2f} s)")
    return launches, k1


def check_jax_shaped_brute_force(index, queries_np, params, want_ids):
    """A brute-force index made in the JAX package's shape with no codes
    and no device, ``BruteForceRabitqIndex(dim, padded_dim, metric, rotator,
    ex_bits, None, "packed")``, given the trained index's ``host`` (the JAX
    attribute): its first searches lay it out and serve ``packed`` (the
    FHT and K4; launch counters zeroed before, read after) with the trained
    index's ids. Returns the launches."""
    import torch
    from rabitq_tpu_torch import BruteForceRabitqIndex

    fresh = BruteForceRabitqIndex(index.dim, index.padded_dim, index.metric, index.rotator,
                                  index.ex_bits, None, "packed")
    fresh.host = index.host
    zero_launches()
    t0 = time.perf_counter()
    ids = bf_ids(fresh, queries_np, params)
    first_s = time.perf_counter() - t0
    launches = read_launches("JAX-shaped brute force", ("fht", "packed_lb_plane"))
    require_equal("JAX-shaped brute force packed ids", ids, want_ids)
    log(f"JAX-shaped brute force (host assigned to BruteForceRabitqIndex(..., None, "
        f"\"packed\")): {len(fresh)} rows; layout and the first packed run {first_s:.2f} s; "
        f"ids equal to the trained index's on all {len(queries_np)} queries; K4 launches "
        f"{launches['packed_lb_plane']}")
    del fresh
    torch.cuda.empty_cache()
    return launches


def check_jax_shaped_mstg(index, data, data_np, queries_np):
    """On the MSTG headline index: ``hierarchical_cluster`` and
    ``closure_assign`` given the rows as a host array (the JAX package's
    shape, no device) against the device-tensor calls ``MstgIndex.build``
    makes (``data_dev=data``), in the build's configuration: the lists
    equal (every segment sum adds in one fixed order). Then ``index.host =
    index.host`` (the JAX setter): ``len`` unchanged, and an ef 8 serving
    run (its path: launch counters zeroed before, read after) returns the
    ids it returned before. Returns the launches."""
    import torch
    from rabitq_tpu_torch.index.mstg.closure import closure_assign
    from rabitq_tpu_torch.index.mstg.clustering import hierarchical_cluster
    from rabitq_tpu_torch.ops.kmeans import auto_assign_dtype

    cfg = index.config
    kw = dict(max_cluster_size=cfg.max_posting_size, branching_factor=cfg.branching_factor,
              balance_weight=cfg.balance_weight, seed=42, refine_iters=cfg.refine_iters,
              assign_dtype=auto_assign_dtype(*data.shape))
    seconds, out = {}, {}
    for name, call in (
        ("clusters host", lambda: hierarchical_cluster(data_np, **kw)),
        ("clusters device", lambda: hierarchical_cluster(data, data_dev=data, **kw)),
        ("closure host", lambda: closure_assign(
            data_np, out["clusters device"].centroids, cfg.closure_epsilon,
            cfg.max_replicas)),
        ("closure device", lambda: closure_assign(
            data, out["clusters device"].centroids, cfg.closure_epsilon, cfg.max_replicas,
            data_dev=data)),
    ):
        t0 = time.perf_counter()
        out[name] = call()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    for what, a, b in (
        ("hierarchical_cluster", out["clusters host"].members, out["clusters device"].members),
        ("closure_assign", out["closure host"], out["closure device"]),
    ):
        if len(a) != len(b):
            raise AssertionError(f"{what} on host rows: {len(a)} lists, device rows {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            require_equal(f"{what} on host rows, list {i}", x, y)
    members = out["closure device"]
    want_ids, _ = serve_mstg(index, queries_np, 8)
    n = len(index)
    index.host = index.host
    zero_launches()
    ids, _ = serve_mstg(index, queries_np, 8)
    launches = read_launches("JAX-shaped MSTG ef=8", ("fht", "fused_bin_scan"))
    if len(index) != n:
        raise AssertionError(f"MSTG host setter: len {len(index)} != {n}")
    require_equal("MSTG ef=8 ids after the host setter", ids, want_ids)
    log(f"JAX-shaped MSTG: hierarchical_cluster on host rows {seconds['clusters host']:.2f} s, "
        f"on the device rows (data_dev) {seconds['clusters device']:.2f} s: "
        f"{len(out['clusters device'].members)} lists, equal; closure_assign "
        f"{seconds['closure host']:.2f} s / {seconds['closure device']:.2f} s: "
        f"{sum(m.size for m in members)} memberships, equal; index.host = index.host: len {n} "
        f"unchanged, ef 8 ids equal; launches {launches}")
    return launches


def bf_arrays(index, queries_np, params):
    """Brute-force search of the queries in blocks of 256 (one dispatch
    each) as (ids, scores) arrays."""
    import numpy as np

    ids = np.full((len(queries_np), params.top_k), -1, np.int64)
    scores = np.full((len(queries_np), params.top_k), np.inf, np.float32)
    for s in range(0, len(queries_np), 256):
        for i, hits in enumerate(index.batch_search(queries_np[s : s + 256], params)):
            ids[s + i, : len(hits)] = [h.id for h in hits]
            scores[s + i, : len(hits)] = [h.score for h in hits]
    return ids, scores


def bf_ids(index, queries_np, params):
    """:func:`bf_arrays`' ids."""
    return bf_arrays(index, queries_np, params)[0]


def check_brute_force(data, queries_np, gt):
    """BruteForceRabitqIndex at full size: train (7 bits, faster config),
    serve through "packed" (the FHT and the packed lower-bound kernel at
    C = 1) and "bf16" with recall@10 and QPS, hold the kernel against its
    plain version on the packed path's own inputs, profile one packed run,
    round-trip the index through RBF1 with equal ids, and last the
    JAX-shaped host assignment (check_jax_shaped_brute_force). Returns
    (launches, K4 check, the JAX-shaped path's launches and seconds)."""
    import tempfile

    import numpy as np
    import torch
    from rabitq_tpu_torch import BruteForceRabitqIndex, BruteForceSearchParams, Metric, load_index

    params = BruteForceSearchParams(top_k=10)
    zero_launches()
    t0 = time.perf_counter()
    index = BruteForceRabitqIndex.train(
        data, total_bits=7, metric=Metric.L2, seed=42, use_faster_config=True,
        scan_dtype="packed", device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    log(f"brute force train: {train_s:.2f} s ({len(index)} rows, 7 bits, faster config)")
    ids_of = {}
    for scan_dtype in ("packed", "bf16"):
        index.scan_dtype = scan_dtype
        bf_ids(index, queries_np, params)
        qps = []
        for _ in range(QPS_RUNS_8BIT):
            t0 = time.perf_counter()
            ids = bf_ids(index, queries_np, params)
            qps.append(len(queries_np) / (time.perf_counter() - t0))
        ids_of[scan_dtype] = ids
        recall = recall_at(ids, gt, 10)
        log(f"brute force {scan_dtype}: recall@10 {recall:.4f}; QPS over {QPS_RUNS_8BIT} runs "
            f"of 8 dispatches of 256 (median [min, max]) {np.median(qps):.0f} "
            f"[{min(qps):.0f}, {max(qps):.0f}]")
        if recall < RECALL_FLOOR:
            raise AssertionError(f"brute force {scan_dtype}: recall@10 {recall:.4f} < "
                                 f"{RECALL_FLOOR}")
    launches = read_launches("brute-force", ("fht", "packed_lb_plane"))
    for scan_dtype in ("packed", "bf16"):
        index.scan_dtype = scan_dtype
        check_fused(f"brute force {scan_dtype}", index,
                    lambda: bf_arrays(index, queries_np, params), len(queries_np) // 256,
                    ties=True)
    log_pool("brute-force", index)
    index.scan_dtype = "packed"
    args = capture_packed_lb_plane(lambda: index.batch_search(queries_np[:256], params), index)
    k4 = check_lb_plane(args, "packed lb plane (G_TABLE, brute force, C = 1)")
    profile_run(lambda: bf_ids(index, queries_np, params), "brute force packed")
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = os.path.join(tmp, "index.rbf")
        t0 = time.perf_counter()
        index.save_to_path(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = load_index(path, scan_dtype="packed", device="cuda")
        ids = bf_ids(loaded, queries_np, params)
        load_s = time.perf_counter() - t0
    if not (loaded.is_brute_force and np.array_equal(ids, ids_of["packed"])):
        raise AssertionError(f"RBF1 reload: ids equal on {np.mean(ids == ids_of['packed']):.5f}")
    log(f"RBF1: {size} bytes; save {save_s:.2f} s (host copy included), load_index and one "
        f"packed serving run {load_s:.2f} s; ids equal after the reload")
    t0 = time.perf_counter()
    jax_shaped = check_jax_shaped_brute_force(index, queries_np, params, ids_of["packed"])
    return launches, k4, jax_shaped, time.perf_counter() - t0


def bridged_workload(data, queries, centers, seed=99):
    """bench.py's replicated MSTG variant drawn on the card: the last 10% of
    the rows replaced by midpoints of pairs of the workload's blob centres
    plus 0.3 x N(0, 1) (rows between two centroids with small residuals,
    which the closure rule replicates), and the second half of the queries
    drawn at midpoints of the same pairs, so that both home lists of a
    bridge are probed together and the dedup runs."""
    import torch

    g = torch.Generator(device=data.device)
    g.manual_seed(seed)
    rows, dim = data.shape
    m = rows // 10
    n_c = centers.shape[0]
    pa = torch.randint(0, n_c, (m,), generator=g, device=data.device)
    pb = (pa + 1 + torch.randint(0, n_c - 1, (m,), generator=g, device=data.device)) % n_c
    bridges = 0.5 * (centers[pa] + centers[pb]) + 0.3 * torch.randn(
        (m, dim), generator=g, device=data.device)
    qm = queries.shape[0] // 2
    qsel = torch.randint(0, m, (queries.shape[0] - qm,), generator=g, device=data.device)
    queries_v = queries.clone()
    queries_v[qm:] = 0.5 * (centers[pa[qsel]] + centers[pb[qsel]]) + 0.3 * torch.randn(
        (queries.shape[0] - qm, dim), generator=g, device=data.device)
    return torch.cat([data[: rows - m], bridges]), queries_v


def serve_mstg(index, queries_np, ef):
    """The MSTG serving call: pipelined, batch 256, upload block 1024, top-10,
    pruning epsilon 0.6 (bench.py's)."""
    from rabitq_tpu_torch import MstgSearchParams

    return index.batch_search_arrays_pipelined(
        queries_np, MstgSearchParams(top_k=10, ef_search=ef, pruning_epsilon=MSTG_EPS),
        batch_size=256, upload_block=1024)


def mstg_variant(name, data, queries, closure_epsilon=None):
    """Build one MSTG variant with bench.py's configuration (rows/500 list
    cap, faster config, FhtKac rotator, 7 bits, fused8, seed 42) and serve
    its queries at each ef: build phases, list sizes and replication, the
    K1 gate's walk and budget, QPS (median [min, max] of 5 runs) and
    recall@10 against an exact brute force on the card (floor 0.90 at the
    largest ef); no result row may hold an id twice. The build and each
    ef's serving are paths of their own: the launch counters are zeroed
    just before and read just after. After each ef's serving, K1 is held
    against its plain version on that path's inputs (one 256-query block).
    Returns (index, {"build" | ef: launches}, {ef: K1 check}, build
    seconds, ground truth)."""
    import numpy as np
    import torch
    from rabitq_tpu_torch import MstgConfig, MstgIndex, MstgSearchParams
    from rabitq_tpu_torch.index.layout import pad_rows
    from rabitq_tpu_torch.ops.fused_scan import TN

    rows = data.shape[0]
    kw = {} if closure_epsilon is None else {"closure_epsilon": closure_epsilon}
    cfg = MstgConfig(max_posting_size=max(rows // 500, 64), faster_config=True,
                     use_rotator=True, rabitq_bits=7, **kw)
    zero_launches()
    t0 = time.perf_counter()
    index = MstgIndex.build(data, cfg, seed=42, scan_dtype="fused8", device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = {"build": read_launches(f"MSTG {name} build", ("fht", "segment_sum", "running_sum"))}
    r = index.build_report
    sizes = np.diff(index._offsets)
    c = r["clustering"]
    log(f"MSTG {name} build: {build_s:.2f} s (clustering {r['clustering_s']} s: "
        f"{c['splits']} splits over levels of {c['levels_s']} s, polish and means "
        f"{c['polish_s']} s; closure "
        f"{r['closure_s']} s, quantize {r['quantize_s']} s, upload {r['upload_s']} s); "
        f"{rows} rows, {index.posting_list_count()} posting lists (max_posting_size "
        f"{cfg.max_posting_size}, closure_epsilon {cfg.closure_epsilon}), list size p50 "
        f"{np.percentile(sizes, 50):.0f} / p95 {np.percentile(sizes, 95):.0f} / max "
        f"{sizes.max()}; {index.total_rows} rows in the lists, replication "
        f"{index.replication_factor():.4f}")
    gt = ground_truth(data, queries, 10)
    queries_np = queries.cpu().numpy()
    index.upload_dtype = "int8"
    recalls, k1 = {}, {}
    n_tiles = pad_rows(index.total_rows, TN) // TN
    for ef in MSTG_EFS:
        zero_launches()
        serve_mstg(index, queries_np, ef)
        tiles = index._fused_max_tiles(ef, batch=256)
        walk = "dense walk" if tiles is None else f"compacted walk, budget {tiles} tiles"
        qps = []
        for _ in range(QPS_RUNS):
            t0 = time.perf_counter()
            ids, dists = serve_mstg(index, queries_np, ef)
            qps.append(len(queries_np) / (time.perf_counter() - t0))
        launches[ef] = read_launches(f"MSTG {name} ef={ef}", ("fht", "fused_bin_scan"))
        if index.scan_dtype != "fused8":
            raise AssertionError(f"MSTG {name}: fused8 was downgraded to {index.scan_dtype}")
        if ids.shape != (len(queries_np), 10) or (ids < 0).any() or not np.isfinite(dists).all():
            raise AssertionError(f"MSTG {name} ef={ef}: malformed results {ids.shape}")
        if (np.diff(dists, axis=1) < 0).any():
            raise AssertionError(f"MSTG {name} ef={ef}: result rows not sorted by distance")
        srt = np.sort(ids, axis=1)
        dup_rows = int(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(axis=1).sum())
        if dup_rows:
            raise AssertionError(f"MSTG {name} ef={ef}: {dup_rows} result rows hold an id twice")
        recalls[ef] = recall_at(ids, gt, 10)
        log(f"serve MSTG {name} ef={ef} eps={MSTG_EPS}: recall@10 {recalls[ef]:.4f}; K1 gate: "
            f"EXACT {index._fused_exact_ok()}, {walk} of {n_tiles}; dedup "
            f"{index._has_replicas()}, no id twice in a row; pipelined int8 QPS over "
            f"{QPS_RUNS} runs (median [min, max]) {np.median(qps):.0f} "
            f"[{min(qps):.0f}, {max(qps):.0f}]")
        params = MstgSearchParams(top_k=10, ef_search=ef, pruning_epsilon=MSTG_EPS)
        k1[ef] = check_bin_scan_run(lambda: index.batch_search(queries_np[:256], params),
                                    f"MSTG {name} ef={ef}", index=index)
        check_fused(f"MSTG {name} ef={ef}", index, lambda: serve_mstg(index, queries_np, ef),
                    len(queries_np) // 256)
    log_pool(f"MSTG {name}", index)
    ef = max(MSTG_EFS)
    if recalls[ef] < RECALL_FLOOR:
        raise AssertionError(f"MSTG {name}: recall@10 {recalls[ef]:.4f} < {RECALL_FLOOR} at ef={ef}")
    return index, launches, k1, build_s, gt


def mstg_recall_witness(index, queries_np, gt):
    """Where the replicated variant's recall goes as ef grows. At each ef,
    on the K1 path: the raw candidates the scan hands the device dedup
    (``rerank`` a query, best first), how many of them are second copies of
    an id, and the device dedup's ids against the host dedup's
    (``_dedup_results``) on the same candidates (must be equal). Then the
    same index and queries through the gather scan (RABITQ_GATHER=1, its
    row limit raised to the budget, both unset after): every row of the
    probed lists scored exactly, no bins, the same dedup. Recall@10 of
    both, over all queries and over the blob and the bridge halves."""
    import numpy as np
    import torch
    from rabitq_tpu_torch.index.scan import gather_budget_bucket

    b = len(queries_np)
    half = b // 2

    def split(ids):
        return (recall_at(ids, gt, 10), recall_at(ids[:half], gt[:half], 10),
                recall_at(ids[half:], gt[half:], 10))

    for ef in MSTG_EFS:
        raw = []
        real = index._dedup_topk_device

        def spy(ids, dists, *, top_k):
            raw.append((ids, dists))
            return real(ids, dists, top_k=top_k)

        index._dedup_topk_device = spy
        try:
            ids, _ = serve_mstg(index, queries_np, ef)
        finally:
            del index._dedup_topk_device
        raw_ids = torch.cat([r[0] for r in raw]).cpu().numpy()[:b]
        raw_d = torch.cat([r[1] for r in raw]).cpu().numpy()[:b]
        host = index._dedup_results(raw_ids, raw_d, 10)
        for qi, row in enumerate(host):
            if sorted(r.id for r in row) != sorted(int(i) for i in ids[qi] if i >= 0):
                raise AssertionError(f"MSTG dedup ef={ef}: query {qi}: device ids "
                                     f"{sorted(ids[qi])} != host {sorted(r.id for r in row)}")
        valid = (raw_ids >= 0) & np.isfinite(raw_d)
        distinct = np.array([np.unique(r[v]).size for r, v in zip(raw_ids, valid)])
        copies = valid.sum(axis=1) - distinct
        k1_recall = split(ids)
        os.environ["RABITQ_GATHER"] = "1"
        os.environ["RABITQ_GATHER_MAX"] = str(gather_budget_bucket(np.diff(index._offsets), ef))
        try:
            budget = index._gather_budget(ef)
            if budget is None:
                raise AssertionError(f"the gather scan's gate declined at ef {ef}")
            g_ids, _ = serve_mstg(index, queries_np, ef)
        finally:
            del os.environ["RABITQ_GATHER"], os.environ["RABITQ_GATHER_MAX"]
        g_recall = split(g_ids)
        log(f"MSTG replicated ef={ef} witness: {raw_ids.shape[1]} candidates a query into the "
            f"dedup, second copies of an id among them mean {copies.mean():.1f} (blob queries "
            f"{copies[:half].mean():.1f}, bridge {copies[half:].mean():.1f}), device dedup ids "
            f"equal to the host dedup's for all {b} queries; recall@10 (all / blob / bridge "
            f"queries): K1 {k1_recall[0]:.4f} / {k1_recall[1]:.4f} / {k1_recall[2]:.4f}, gather "
            f"scan (no bins, R = {budget} rows a query) {g_recall[0]:.4f} / {g_recall[1]:.4f} / "
            f"{g_recall[2]:.4f}")


def check_mstg(data, data_np, queries, centers):
    """The MSTG phase: the headline variant on the 1M rows and a profile of
    one serving run, saved to a native file for the front-end phase, then
    the headline sharded (check_sharded_mstg), then the replicated variant
    (at MSTG_CUT_ROWS rows if the headline build took over
    MSTG_BUILD_CUT_S) and its recall witness. Returns ({(variant, "build" |
    ef): launches}, {(variant, ef): K1 check}, the headline file's path, in
    a temporary directory of the checkout, the sharded headline's launches
    and that check's seconds, and the JAX-shaped calls' launches and
    seconds: check_jax_shaped_mstg on the headline index, after its
    sharded check; then the second headline build's launches and the
    segment-sum check at the polish shape: check_reproducible_mstg)."""
    import tempfile

    import torch

    index, head, k1_head, build_s, gt = mstg_variant("headline", data, queries)
    queries_np = queries.cpu().numpy()
    ef = min(MSTG_EFS)
    profile_run(lambda: serve_mstg(index, queries_np, ef), f"MSTG headline ef={ef}")
    mstg_path = os.path.join(tempfile.mkdtemp(dir=ROOT), "headline.mstg")
    t0 = time.perf_counter()
    index.save_to_path(mstg_path)
    log(f"MSTG headline saved (native file, for the front-end phase): "
        f"{os.path.getsize(mstg_path)} bytes in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    sharded = check_sharded_mstg(index, queries_np, gt)
    sharded_s = time.perf_counter() - t0
    log(f"phase seconds: sharded MSTG {sharded_s:.1f}")
    t0 = time.perf_counter()
    jax_shaped = check_jax_shaped_mstg(index, data, data_np, queries_np)
    jax_shaped_s = time.perf_counter() - t0
    repro, seg_polish = check_reproducible_mstg(index, data, build_s)
    del index
    torch.cuda.empty_cache()
    rows = data.shape[0]
    if build_s > MSTG_BUILD_CUT_S:
        rows = MSTG_CUT_ROWS
        log(f"MSTG replicated variant cut to {rows} rows: the headline build took "
            f"{build_s:.1f} s > {MSTG_BUILD_CUT_S:.0f} s")
    data_v, queries_v = bridged_workload(data[:rows], queries, centers)
    index, repl, k1_repl, _, gt = mstg_variant(
        "replicated", data_v, queries_v, closure_epsilon=0.9)
    if index.replication_factor() <= 1.0:
        raise AssertionError("MSTG replicated: the closure rule replicated no row")
    mstg_recall_witness(index, queries_v.cpu().numpy(), gt)
    del index, data_v
    torch.cuda.empty_cache()
    launches = {("headline", k): v for k, v in head.items()}
    launches.update({("replicated", k): v for k, v in repl.items()})
    k1 = {("headline", k): v for k, v in k1_head.items()}
    k1.update({("replicated", k): v for k, v in k1_repl.items()})
    return (launches, k1, mstg_path, sharded, sharded_s, jax_shaped, jax_shaped_s, repro,
            seg_polish)


def intervals_union(spans):
    """Sorted, merged [start, end) intervals of ``spans``."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def intervals_overlap(x, y):
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(x) and j < len(y):
        lo, hi = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        total += max(0.0, hi - lo)
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def profile_streamed(run, label):
    """One streamed batch under torch.profiler: the host-to-device copy time
    (the copy engine's busy time), the kernels' busy time, and how much of
    the copying ran while a kernel ran (from the trace's timeline)."""
    import tempfile

    import torch
    from rabitq_tpu_torch.utils.profiling import device_trace

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        with device_trace(tmp) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        with open(os.path.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    copies, kernels = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e.get("cat") == "gpu_memcpy" and "HtoD" in str(e.get("name", "")):
            copies.append(span)
        elif e.get("cat") == "kernel":
            kernels.append(span)
    top = top_rows(device_rows(prof))
    cu, ku = intervals_union(copies), intervals_union(kernels)
    copy_ms = sum(b - a for a, b in cu) / 1e3
    kern_ms = sum(b - a for a, b in ku) / 1e3
    hidden_ms = intervals_overlap(cu, ku) / 1e3
    share = f"{100 * hidden_ms / copy_ms:.0f}%" if copy_ms else "no copy recorded"
    log(f"profile streamed {label}: wall {wall_ms:.1f} ms; host-to-device copies {copy_ms:.1f} "
        f"ms busy ({len(copies)} copies), kernels {kern_ms:.1f} ms busy; copying hidden under "
        f"kernels {hidden_ms:.1f} ms ({share}); top: {top}")
    return dict(wall_ms=wall_ms, copy_ms=copy_ms, kernel_ms=kern_ms, hidden_ms=hidden_ms)


def h2d_gbps(chunk):
    """Bare pinned host-to-device rate of one slab: all its tensors copied
    without blocking on one stream, timed with CUDA events (median of 3
    after a warm-up)."""
    import statistics

    import torch

    n_bytes = sum(t.numel() * t.element_size() for t in chunk.values())
    rates = []
    for rep in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dev = [t.to("cuda", non_blocking=True) for t in chunk.values()]
        end.record()
        end.synchronize()
        if rep:
            rates.append(n_bytes / (start.elapsed_time(end) / 1e3) / 1e9)
        del dev
    return statistics.median(rates), n_bytes


def streamed_compute_ms(tier, queries_np, params):
    """The same scans on resident chunks (every slab uploaded beforehand):
    host time of one batch's rotation, scans and fetch, median of 3."""
    import statistics

    import torch
    from rabitq_tpu_torch.index.scan import probe_k_bucket

    resident = [{k: v.to("cuda") for k, v in c.items()} for c in tier._chunks]
    probe_k = probe_k_bucket(params.nprobe, tier.index.cluster_count(), tier.index.scan_dtype)

    def run():
        b, q_rot = tier._rotate(queries_np)
        max_tiles = tier._fused_max_tiles(params.nprobe, q_rot.shape[0])
        out = [tier._scan_chunk(c, q_rot, params, None, max_tiles, probe_k) for c in resident]
        torch.cat([o[0] for o in out], dim=1).cpu()

    run()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        times.append((time.perf_counter() - t0) * 1e3)
    del resident
    torch.cuda.empty_cache()
    return statistics.median(times)


def check_streamed(index, queries_np, gt):
    """The streamed tier at full size on the 7-bit index (the last phase that
    uses it): the in-memory index's own results first (two-stage scan,
    RABITQ_FUSED_EXACT=0 set in this process and unset after, f32 query
    uploads, nprobe 16 and 256; the EXACT scan at nprobe 64), then a
    one-chunk tier held equal to them, then the 4-chunk tier: its chunks,
    upload bytes and bare H2D rate, serving (QPS, recall, batch time beside
    the transfer bound and the compute on resident chunks), a profile, a
    filtered batch, the chunking witness against the one-chunk tier, and
    the packed bin kernel against its plain version on a chunk's inputs;
    last, the wrapped index serves nprobe 64 in memory again with the ids
    it gave before. Returns (launches, {walk: kernel check})."""
    import numpy as np
    import torch
    from rabitq_tpu_torch import SearchParams, StreamedIvfIndex

    upload = index.upload_dtype
    before64, _ = serve(index, queries_np, 64)
    index.upload_dtype = "f32"  # the streamed tier uploads f32 queries
    os.environ["RABITQ_FUSED_EXACT"] = "0"
    try:
        mem = {nprobe: index.batch_search_arrays(queries_np, SearchParams(top_k=10, nprobe=nprobe))
               for nprobe in (16, 256)}
    finally:
        del os.environ["RABITQ_FUSED_EXACT"]
    index.upload_dtype = upload

    t0 = time.perf_counter()
    one = StreamedIvfIndex(index, chunk_rows=ROWS + 512)
    one_s = time.perf_counter() - t0
    if one.n_chunks != 1 or index._layout is not None:
        raise AssertionError(f"one-chunk tier: {one.n_chunks} chunks, layout released "
                             f"{index._layout is None}")
    single = {}
    for nprobe, (m_ids, m_d) in mem.items():
        ids, d = one.batch_search_arrays(queries_np, SearchParams(top_k=10, nprobe=nprobe))
        same = float(np.mean(ids == m_ids))
        rel = float(np.max(np.abs(d - m_d) / np.maximum(np.abs(m_d), 1e-30)))
        log(f"streamed one chunk nprobe={nprobe}: ids equal to the in-memory two-stage scan on "
            f"{same:.5f} of entries, distances within {rel:.3g} relative")
        if same != 1.0 or rel > 1e-5:
            raise AssertionError(f"one-chunk tier differs from the in-memory scan at nprobe {nprobe}")
        single[nprobe] = ids
    del one
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tier = StreamedIvfIndex(index, chunk_rows=STREAM_CHUNK_ROWS)
    init_s = time.perf_counter() - t0
    rows = [int(c["valid"].sum()) for c in tier._chunks]
    pinned = all(t.is_pinned() for c in tier._chunks for t in c.values())
    gbps, chunk_bytes = h2d_gbps(tier._chunks[0])
    upload = sum(t.numel() * t.element_size() for c in tier._chunks for t in c.values())
    bound_ms = upload / (gbps * 1e9) * 1e3
    log(f"streamed tier: {tier.n_chunks} chunks of {rows} rows (chunk_rows {tier.chunk_rows}), "
        f"slabs pinned {pinned}, keys {sorted(tier._chunks[0])}; {upload} bytes uploaded a "
        f"batch ({upload / ROWS:.1f} a row); bare pinned H2D of one chunk "
        f"({chunk_bytes} bytes) {gbps:.2f} GB/s, so a batch's transfer bound is {bound_ms:.1f} ms; "
        f"tier built in {init_s:.1f} s (the one-chunk tier in {one_s:.1f} s)")
    if tier.n_chunks != 4 or not pinned or "binary" in tier._chunks[0]:
        raise AssertionError("the 4-chunk tier is not laid out as expected")

    zero_launches()
    results, qps = {}, {}
    for nprobe in (16, 256):
        params = SearchParams(top_k=10, nprobe=nprobe)
        results[nprobe] = tier.batch_search_arrays(queries_np, params)
        qps[nprobe] = []
        for _ in range(STREAM_QPS_RUNS):
            t0 = time.perf_counter()
            tier.batch_search_arrays(queries_np, params)
            qps[nprobe].append(len(queries_np) / (time.perf_counter() - t0))
    launches = read_launches("streamed", ("fht", "fused_bin_scan_packed_int8_compact",
                                          "fused_bin_scan_packed_int8_dense"))
    walks = {16: tier._fused_max_tiles(16, len(queries_np)),
             256: tier._fused_max_tiles(256, len(queries_np))}
    for nprobe in (16, 256):
        ids, dists = results[nprobe]
        if ids.shape != (len(queries_np), 10) or (ids < 0).any() or not np.isfinite(dists).all():
            raise AssertionError(f"streamed nprobe={nprobe}: malformed results {ids.shape}")
        if (np.diff(dists, axis=1) < 0).any():
            raise AssertionError(f"streamed nprobe={nprobe}: rows not sorted by distance")
        recall, recall_one = recall_at(ids, gt, 10), recall_at(single[nprobe], gt, 10)
        overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, single[nprobe])])
        compute = streamed_compute_ms(tier, queries_np, SearchParams(top_k=10, nprobe=nprobe))
        q = qps[nprobe]
        walk = "dense walk" if walks[nprobe] is None else f"compacted walk, {walks[nprobe]} tiles"
        log(f"serve streamed nprobe={nprobe} ({walk}): recall@10 {recall:.4f} (one chunk "
            f"{recall_one:.4f}, top-10 overlap with it {overlap:.4f}); QPS over "
            f"{STREAM_QPS_RUNS} batches of {len(queries_np)} (median [min, max]) "
            f"{np.median(q):.0f} [{min(q):.0f}, {max(q):.0f}]: batch "
            f"{len(queries_np) / np.median(q) * 1e3:.1f} ms against a transfer bound of "
            f"{bound_ms:.1f} ms and {compute:.1f} ms for the same scans on resident chunks")
        if overlap < 0.98 or recall < recall_one - 0.005:
            raise AssertionError(f"streamed nprobe={nprobe}: 4 chunks against one: overlap "
                                 f"{overlap:.4f}, recall {recall:.4f} against {recall_one:.4f}")
        if nprobe == 256 and recall < RECALL_FLOOR:
            raise AssertionError(f"streamed: recall@10 {recall:.4f} < {RECALL_FLOOR} at nprobe=256")
    profile_streamed(lambda: tier.batch_search_arrays(queries_np, SearchParams(top_k=10, nprobe=16)),
                     "nprobe=16")

    allowed = np.random.default_rng(11).permutation(ROWS)[: ROWS // 2]
    ids, _ = tier.batch_search_arrays(queries_np, SearchParams(top_k=10, nprobe=16), allowed)
    inside = np.isin(ids[ids >= 0], allowed)
    log(f"streamed filtered batch (a seeded half of the ids, nprobe=16): {int((ids >= 0).sum())} "
        f"of {ids.size} slots hold an id, all in the filter {bool(inside.all())}")
    if not inside.all():
        raise AssertionError("the streamed tier returned an id outside the filter")

    checks = {}
    for nprobe, key, walk in ((16, "compact", "compacted"), (256, "dense", "dense")):
        params = SearchParams(top_k=10, nprobe=nprobe)
        checks[key] = check_bin_scan_run(
            lambda: tier.batch_search_arrays(queries_np[:256], params),
            f"streamed chunk 0, nprobe={nprobe}", walk)
    del tier
    torch.cuda.empty_cache()

    after64, _ = serve(index, queries_np, 64)
    log(f"after the tiers: the wrapped index serves nprobe=64 in memory again, ids equal to "
        f"before {np.array_equal(after64, before64)}")
    if not np.array_equal(after64, before64):
        raise AssertionError("the wrapped index serves other ids after its re-layout")
    return launches, checks


def serve_blocks(search, queries_np, block=SHARD_BLOCK):
    """(ids, dists) of ``search`` over the queries in blocks of ``block``."""
    import numpy as np

    outs = [search(queries_np[s : s + block]) for s in range(0, len(queries_np), block)]
    return np.concatenate([o[0] for o in outs]), np.concatenate([o[1] for o in outs])


def timed_runs(run, n_queries, runs):
    """One warm-up ``run()``, then ``runs`` timed ones: (the last result,
    QPS of each)."""
    run()
    qps = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = run()
        qps.append(n_queries / (time.perf_counter() - t0))
    return out, qps


def result_arrays(rows, k=10):
    """SearchResult lists -> (ids [B, k] -1 padded, scores [B, k] +inf padded)."""
    import numpy as np

    ids = np.full((len(rows), k), -1, np.int64)
    scores = np.full((len(rows), k), np.inf, np.float32)
    for i, row in enumerate(rows):
        ids[i, : len(row)] = [h.id for h in row]
        scores[i, : len(row)] = [h.score for h in row]
    return ids, scores


def check_served(what, ids, dists, n, gt=None, floor=None):
    """Shape, padding, finite sorted distances; recall@10 where ``gt`` is
    given, held to ``floor`` where that is given. Returns the recall."""
    import numpy as np

    if ids.shape != (n, 10) or (ids < 0).any() or not np.isfinite(dists).all():
        raise AssertionError(f"{what}: malformed results {ids.shape}")
    if (np.diff(dists, axis=1) < 0).any():
        raise AssertionError(f"{what}: result rows not sorted by distance")
    recall = None if gt is None else recall_at(ids, gt, 10)
    if floor is not None and recall < floor:
        raise AssertionError(f"{what}: recall@10 {recall:.4f} < {floor}")
    return recall


def nearest_objective(index, data):
    """Sum over the rows of the squared distance to the nearest of the
    index's centroids (rotated back): one yardstick for two clusterings."""
    from rabitq_tpu_torch.ops.kmeans import assign_dataset

    return assign_dataset(data, index.rotator.inverse_rotate(index.layout.centroids))[1]


def check_sharded_ivf(index, data, queries_np, gt, mem_qps):
    """The sharded tier over the 7-bit index at full size, SHARDS shards on
    the one card (``devices=[cuda] * SHARDS``), run while the index is
    alive, before the phases after it: the one-shard witness (ids and
    distances equal to the index's own batch_search_arrays, f32 query
    uploads, nprobe 16 and 256), then SHARDS shards served in blocks of
    SHARD_BLOCK queries at nprobe 16 / 64 / 256 (recall@10, top-10 overlap
    with the index, QPS beside the index's one-batch QPS), K1 on shard 0's
    inputs (compacted at 16, dense at 256) and a profile with the merge's
    device time. The serving zeroes the launch counters before and reads
    them after. Returns ({"IVF": launches}, {walk: K1 check}, the
    single-card yardsticks of check_sharded_train)."""
    import numpy as np
    import torch
    from rabitq_tpu_torch import SearchParams
    from rabitq_tpu_torch.ops.fused_scan import TN
    from rabitq_tpu_torch.parallel import sharding

    cuda = torch.device("cuda", torch.cuda.current_device())
    n = len(queries_np)

    # --- the one-shard witness, and the index's own results (f32 uploads)
    upload = index.upload_dtype
    index.upload_dtype = "f32"
    try:
        mem = {nprobe: index.batch_search_arrays(queries_np, SearchParams(top_k=10, nprobe=nprobe))
               for nprobe in (16, 64, 256)}
    finally:
        index.upload_dtype = upload
    one = sharding.ShardedIvfIndex(index, devices=[cuda])
    for nprobe in (16, 256):
        ids, d = one.batch_search_arrays(queries_np, SearchParams(top_k=10, nprobe=nprobe))
        same_ids, same_d = np.array_equal(ids, mem[nprobe][0]), np.array_equal(d, mem[nprobe][1])
        log(f"sharded one shard nprobe={nprobe}: ids equal to the index's {same_ids}, distances "
            f"equal {same_d} ({n} queries, one batch, f32 uploads)")
        if not (same_ids and same_d):
            raise AssertionError(f"one shard differs from the index at nprobe {nprobe}")
    del one

    # --- SHARDS shards on the card
    t0 = time.perf_counter()
    sh = sharding.ShardedIvfIndex(index, devices=[cuda] * SHARDS)
    torch.cuda.synchronize()
    budgets = {nprobe: sh._fused_max_tiles(nprobe, SHARD_BLOCK) for nprobe in (16, 64, 256)}
    log(f"sharded IVF: {SHARDS} shards on {cuda} of {sh._slab_rows} rows each "
        f"({sh._slab_rows // TN} tiles), wrapped in {time.perf_counter() - t0:.2f} s; "
        f"per-shard tile budget a {SHARD_BLOCK}-query block: {budgets} (None: dense walk)")
    zero_launches()
    served = {}
    for nprobe in (16, 64, 256):
        params = SearchParams(top_k=10, nprobe=nprobe)
        served[nprobe] = timed_runs(
            lambda: serve_blocks(lambda q: sh.batch_search_arrays(q, params), queries_np),
            n, QPS_RUNS)
    launches = {"IVF": read_launches(f"sharded IVF ({SHARDS} shards)", (
        "fht", "fused_bin_scan_compact", "fused_bin_scan_dense"))}
    for nprobe, ((ids, d), qps) in served.items():
        recall = check_served(f"sharded nprobe={nprobe}", ids, d, n, gt,
                              RECALL_FLOOR if nprobe == 256 else None)
        overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, mem[nprobe][0])])
        log(f"serve sharded {SHARDS} shards nprobe={nprobe}: recall@10 {recall:.4f} (index "
            f"{recall_at(mem[nprobe][0], gt, 10):.4f}), top-10 overlap with the index "
            f"{overlap:.4f}; QPS over {QPS_RUNS} runs of {n // SHARD_BLOCK} blocks of "
            f"{SHARD_BLOCK} (median [min, max]) {np.median(qps):.0f} [{min(qps):.0f}, "
            f"{max(qps):.0f}] beside the index's one-batch {mem_qps[nprobe]:.0f}")
    k1 = {}
    for nprobe, key, walk in ((16, "compact", "compacted"), (256, "dense", "dense")):
        params = SearchParams(top_k=10, nprobe=nprobe)
        k1[key] = check_bin_scan_run(lambda: sh.batch_search_arrays(queries_np[:SHARD_BLOCK], params),
                                     f"sharded shard 0 of {SHARDS}, nprobe={nprobe}", walk)
    merges = []
    real_merge = sharding._merge_topk
    sharding._merge_topk = lambda *a: merges.append(a) or real_merge(*a)
    try:
        params = SearchParams(top_k=10, nprobe=16)
        busy = profile_run(lambda: serve_blocks(lambda q: sh.batch_search_arrays(q, params),
                                                queries_np),
                           f"sharded {SHARDS} shards nprobe=16")
    finally:
        sharding._merge_topk = real_merge
    merge_ms = queued_us(lambda: real_merge(*merges[0]), 20) / 1e3
    log(f"sharded merge: {len(merges)} a run, {merge_ms:.4f} ms device time each (concatenation, "
        f"stable sort and gather of [{SHARD_BLOCK}, {SHARDS} x 10], queued back to back), "
        f"{100 * merge_ms * len(merges) / busy:.2f}% of the run's busy device time")
    del sh
    torch.cuda.empty_cache()
    single = {"recall64": recall_at(mem[64][0], gt, 10),
              "objective": nearest_objective(index, data)}
    return launches, k1, single


def check_sharded_mstg(mstg, queries_np, gt):
    """The MSTG headline index sharded, SHARDS shards on the one card, run
    while the index is alive, before the replicated variant: served at ef
    8 and 64 in blocks of SHARD_BLOCK (recall@10, floor 0.90 at 64; QPS;
    queries rotated on the card), the launch counters zeroed before and
    read after, then the one-shard witness at ef 64 (the index's ids).
    Returns the launches."""
    import numpy as np
    import torch
    from rabitq_tpu_torch import MstgSearchParams
    from rabitq_tpu_torch.parallel import sharding

    cuda = torch.device("cuda", torch.cuda.current_device())
    n = len(queries_np)
    msh = sharding.ShardedMstgIndex(mstg, devices=[cuda] * SHARDS)
    zero_launches()
    served = {}
    for ef in MSTG_EFS:
        params = MstgSearchParams(top_k=10, ef_search=ef, pruning_epsilon=MSTG_EPS)
        served[ef] = timed_runs(lambda: serve_blocks(
            lambda q: result_arrays(msh.batch_search(q, params)), queries_np), n, QPS_RUNS)
    launches = read_launches(f"sharded MSTG ({SHARDS} shards)", ("fht", "fused_bin_scan"))
    for ef, ((ids, scores), qps) in served.items():
        recall = check_served(f"sharded MSTG ef={ef}", ids, scores, n, gt,
                              RECALL_FLOOR if ef == max(MSTG_EFS) else None)
        log(f"serve sharded {SHARDS} shards MSTG headline ef={ef} eps={MSTG_EPS}: recall@10 "
            f"{recall:.4f}; QPS over {QPS_RUNS} runs (median [min, max]) {np.median(qps):.0f} "
            f"[{min(qps):.0f}, {max(qps):.0f}] (queries rotated on the card)")
    del msh
    params = MstgSearchParams(top_k=10, ef_search=max(MSTG_EFS), pruning_epsilon=MSTG_EPS)
    upload = mstg.upload_dtype
    mstg.upload_dtype = "f32"
    try:
        want = [[h.id for h in row] for row in mstg.batch_search(queries_np, params)]
    finally:
        mstg.upload_dtype = upload
    got = sharding.ShardedMstgIndex(mstg, devices=[cuda]).batch_search(queries_np, params)
    same = [[h.id for h in row] for row in got] == want
    log(f"sharded MSTG one shard ef={max(MSTG_EFS)}: ids equal to the index's {same}")
    if not same:
        raise AssertionError("one MSTG shard differs from the index")
    torch.cuda.empty_cache()
    return launches


def check_sharded_train(data, queries_np, gt, single):
    """ShardedIvfIndex.train on the 1M rows, SHARDS shards on the one card
    (nlist 4096, 7 bits, faster config, fused8, 25 k-means iterations),
    run while the rows are on the card: seconds by phase, the k-means
    objective beside the single-card train's (``single``, from
    check_sharded_ivf), recall@10 at nprobe 64 (floor 0.90). The train and
    its serving are one path for the launch counters. Then the train a
    second time (the reproducible-builds phase): centroids and row ids
    bitwise equal. Returns the launches."""
    import torch
    from rabitq_tpu_torch import SearchParams
    from rabitq_tpu_torch.parallel import sharding

    cuda = torch.device("cuda", torch.cuda.current_device())
    n = len(queries_np)
    zero_launches()
    t0 = time.perf_counter()
    trained = sharding.ShardedIvfIndex.train(
        data, nlist=NLIST, total_bits=7, mesh=sharding.make_mesh(devices=[cuda] * SHARDS),
        seed=42, use_faster_config=True, kmeans_iters=25, scan_dtype="fused8",
    )
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    rep = trained.index.build_report
    params = SearchParams(top_k=10, nprobe=64)
    ids, d = serve_blocks(lambda q: trained.batch_search_arrays(q, params), queries_np)
    launches = read_launches(f"sharded train ({SHARDS} shards) and its serving",
                             ("fht", "fused_bin_scan", "segment_sum", "running_sum"))
    recall = check_served("sharded train nprobe=64", ids, d, n, gt, RECALL_FLOOR)
    obj, obj_single = nearest_objective(trained.index, data), single["objective"]
    log(f"sharded train {SHARDS} shards ({ROWS} x {DIM}, nlist {NLIST}, 7 bits, faster config, "
        f"fused8, 25 k-means iterations): {train_s:.2f} s (k-means with its init "
        f"{rep['kmeans_s']} s, build codes {rep['codes_s']} s, layout and wrap "
        f"{rep['layout_s']} s); k-means objective {rep['kmeans']['objective']:.6g}; "
        f"nearest-centroid objective {obj:.6g} against the single-card train's {obj_single:.6g} "
        f"(ratio {obj / obj_single:.4f}); recall@10 at nprobe 64 {recall:.4f} (single card "
        f"{single['recall64']:.4f})")
    t1 = time.perf_counter()
    again = sharding.ShardedIvfIndex.train(
        data, nlist=NLIST, total_bits=7, mesh=sharding.make_mesh(devices=[cuda] * SHARDS),
        seed=42, use_faster_config=True, kmeans_iters=25, scan_dtype="fused8",
    )
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t1
    rep2 = again.index.build_report
    require_bitwise("second sharded train: centroids", again.index.layout.centroids.cpu().numpy(),
                    trained.index.layout.centroids.cpu().numpy())
    require_bitwise("second sharded train: row ids", again.index.layout.ids.cpu().numpy(),
                    trained.index.layout.ids.cpu().numpy())
    del again
    REPRO_S["sharded train"] = time.perf_counter() - t1
    log(f"reproducible sharded train: run again, {again_s:.2f} s (k-means with its init "
        f"{rep2['kmeans_s']} s, build codes {rep2['codes_s']} s, layout and wrap "
        f"{rep2['layout_s']} s) against the first's {train_s:.2f} s: centroids and row ids "
        f"bitwise equal")
    del trained
    torch.cuda.empty_cache()
    return launches


def check_sharded_8bit(index8, queries_np, gt):
    """The 8-bit index sharded, SHARDS shards on the one card: fused8 at
    nprobe 16 (K3, int8 query, compacted) and packed at 256 (K4 G_TABLE),
    each a path of its own (recall@10, QPS), its kernel then held against
    its plain version on shard 0's inputs. Returns ({path: launches}, K3
    check, K4 check)."""
    import numpy as np
    import torch
    from rabitq_tpu_torch import SearchParams
    from rabitq_tpu_torch.parallel import sharding

    cuda = torch.device("cuda", torch.cuda.current_device())
    n = len(queries_np)
    launches, checks = {}, {}
    for scan_dtype, nprobe, needed in (("fused8", 16, "fused_bin_scan_packed_int8_compact"),
                                       ("packed", 256, "packed_lb_plane")):
        index8.scan_dtype = scan_dtype  # "packed" re-lays the index to the permuted layout
        w = sharding.ShardedIvfIndex(index8, devices=[cuda] * SHARDS)
        if index8.scan_dtype != scan_dtype:
            raise AssertionError(f"{scan_dtype} was downgraded to {index8.scan_dtype}")
        params = SearchParams(top_k=10, nprobe=nprobe)
        zero_launches()
        (ids, d), qps = timed_runs(
            lambda: serve_blocks(lambda q: w.batch_search_arrays(q, params), queries_np),
            n, QPS_RUNS_8BIT)
        launches[f"IVF total_bits=8 {scan_dtype}"] = read_launches(
            f"sharded total_bits=8 {scan_dtype} ({SHARDS} shards)", ("fht", needed))
        recall = check_served(f"sharded total_bits=8 {scan_dtype}", ids, d, n, gt)
        log(f"serve sharded {SHARDS} shards total_bits=8 {scan_dtype} nprobe={nprobe}: recall@10 "
            f"{recall:.4f}; QPS over {QPS_RUNS_8BIT} runs (median [min, max]) {np.median(qps):.0f} "
            f"[{min(qps):.0f}, {max(qps):.0f}]")
        label = f"sharded total_bits=8 shard 0 of {SHARDS}, nprobe={nprobe}"
        block = queries_np[:SHARD_BLOCK]
        if scan_dtype == "fused8":
            checks[scan_dtype] = check_bin_scan_run(
                lambda: w.batch_search_arrays(block, params), label, "compacted")
        else:
            checks[scan_dtype] = check_lb_plane(
                capture_packed_lb_plane(lambda: w.batch_search_arrays(block, params)),
                f"packed lb plane (G_TABLE, {label})")
        del w
        torch.cuda.empty_cache()
    return launches, checks["fused8"], checks["packed"]


def load_ann_module(name):
    """An ann-benchmarks module of the repository, loaded by path as
    ann-benchmarks loads it."""
    import importlib.util

    path = ROOT / "ann_benchmarks" / name / "module.py"
    spec = importlib.util.spec_from_file_location(name.replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cli(*args):
    """``python -m rabitq_tpu_torch`` in a subprocess of the checkout; fails
    unless it exits 0. Returns its standard output."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "rabitq_tpu_torch", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"CLI {args[0]} exited {out.returncode}: {out.stderr[-2000:]}")
    log(f"CLI {args[0]}: exit 0 in {time.perf_counter() - t0:.1f} s")
    return out.stdout


def check_front_ends(data, queries, gt, mstg_path):
    """The front ends at full size: the IVF binding (fit on the 1M rows,
    nlist 4096, 7 bits, fused8; batch_query of the 2048 queries at nprobe
    64 takes the pipelined branch, ids equal to the wrapped index's
    batch_search_arrays), the MSTG binding (load of the headline MSTG file,
    batch_query at ef 64, ids equal to the index's own serving loop), the
    ann-benchmarks IVF module at its nlist_4096 group (nprobe 64), and the
    CLI's build / info / query / sweep on a 100,000-row fvecs slice in
    subprocesses (files in a temporary directory of the checkout,
    deleted). Returns {path: launches}."""
    import tempfile

    import numpy as np
    import torch
    from rabitq_tpu_torch import MstgSearchParams, SearchParams, bindings
    from rabitq_tpu_torch.io import write_fvecs, write_ivecs

    data_np = data.cpu().numpy()
    queries_np = queries.cpu().numpy()
    launches = {}
    t0 = time.perf_counter()
    ivf = bindings.IvfRabitqIndex(DIM)
    ivf.fit(data_np, nlist=NLIST, total_bits=7, scan_dtype="fused8")
    fit_s = time.perf_counter() - t0
    params = SearchParams(top_k=10, nprobe=64)
    # the index's own search in the blocks of 256 the pipelined loop
    # dispatches (a batch of another size takes other GEMM shapes for the
    # centroid distances, whose f32 sums may round otherwise)
    blocks = [ivf.index.batch_search_arrays(queries_np[s : s + 256], params)
              for s in range(0, len(queries_np), 256)]
    want_ids, want_d = (np.concatenate([b[i] for b in blocks]) for i in (0, 1))
    whole_ids, _ = ivf.index.batch_search_arrays(queries_np, params)
    zero_launches()
    res = ivf.batch_query(queries_np, 10, 64)
    launches["IVF binding"] = read_launches("IVF binding", ("fht", "fused_bin_scan_dense"))
    ids = np.stack([r[:, 0].astype(np.int64) for r in res])
    equal = np.array_equal(ids, want_ids) and all(
        np.array_equal(r[:, 1], d) for r, d in zip(res, want_d))
    log(f"IVF binding: fit {fit_s:.2f} s ({len(data_np)} x {DIM} host rows, nlist {NLIST}, 7 bits, "
        f"fused8); "
        f"batch_query of {len(queries_np)} at nprobe 64 (pipelined): ids and distances equal to "
        f"batch_search_arrays over blocks of 256 {equal} (ids equal to one batch of "
        f"{len(queries_np)} on {np.mean(ids == whole_ids):.5f} of entries); recall@10 "
        f"{recall_at(ids, gt, 10):.4f}")
    if not equal:
        raise AssertionError("the IVF binding's results differ from its index's")
    if np.mean(ids == whole_ids) < 0.999:
        raise AssertionError("the IVF binding's ids agree with one batch of the index's on "
                             f"{np.mean(ids == whole_ids):.5f} < 0.999 of entries")
    del ivf
    torch.cuda.empty_cache()

    mstg = bindings.MstgIndex.load(mstg_path)
    mstg.set_query_arguments(ef_search=64, pruning_epsilon=MSTG_EPS)
    params = MstgSearchParams(top_k=10, ef_search=64, pruning_epsilon=MSTG_EPS)
    want = mstg.index.batch_search_pipelined(queries_np, params, batch_size=256)
    zero_launches()
    res = mstg.batch_query(queries_np, 10)
    launches["MSTG binding"] = read_launches("MSTG binding", ("fht",))
    equal = all(np.array_equal(r[:, 0].astype(np.int64), [h.id for h in w])
                for r, w in zip(res, want))
    ids = np.full((len(res), 10), -1, np.int64)
    for i, r in enumerate(res):
        ids[i, : len(r)] = r[:, 0]
    log(f"MSTG binding: load of the headline MSTG file ({os.path.getsize(mstg_path)} bytes, "
        f"scan_dtype {mstg.index.scan_dtype}, {len(mstg)} vectors); batch_query at ef 64: ids "
        f"equal to the index's own {equal}; recall@10 {recall_at(ids, gt, 10):.4f}")
    if not equal or len(mstg) != ROWS:
        raise AssertionError("the MSTG binding's results differ from its index's")
    del mstg
    torch.cuda.empty_cache()

    mod = load_ann_module("rabitq-tpu-torch-ivf")
    t0 = time.perf_counter()
    algo = mod.RabitqTorchIvf("euclidean", {"nlist": 4096, "total_bits": 7, "faster_config": True})
    algo.fit(data_np)
    fit_s = time.perf_counter() - t0
    algo.set_query_arguments({"nprobe": 64})
    zero_launches()
    t0 = time.perf_counter()
    algo.batch_query(queries_np, 10)
    batch_s = time.perf_counter() - t0
    launches["ann-benchmarks IVF"] = read_launches("ann-benchmarks IVF", ("fht",))
    ids = np.stack(algo.get_batch_results())
    recall = recall_at(ids, gt, 10)
    log(f"ann-benchmarks {algo} (nlist_4096 group, scan_dtype {algo.index.index.scan_dtype}): "
        f"fit {fit_s:.2f} s, batch_query of {len(queries_np)} {batch_s:.2f} s, recall@10 "
        f"{recall:.4f}")
    if recall < RECALL_FLOOR:
        raise AssertionError(f"ann-benchmarks IVF module: recall@10 {recall:.4f} < {RECALL_FLOOR}")
    del algo
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        base, qf, gtf = (os.path.join(tmp, f) for f in ("base.fvecs", "q.fvecs", "gt.ivecs"))
        index_path, csv = os.path.join(tmp, "index.rbq"), os.path.join(tmp, "sweep.csv")
        write_fvecs(base, data_np[:CLI_ROWS])
        write_fvecs(qf, queries_np[:CLI_QUERIES])
        write_ivecs(gtf, ground_truth(data[:CLI_ROWS], queries[:CLI_QUERIES], 100).astype(np.int32))
        run_cli("build", "--data", base, "--output", index_path, "--nlist", "1024")
        info = json.loads(run_cli("info", "--index", index_path))
        out = json.loads(run_cli("query", "--index", index_path, "--queries", qf,
                                 "--groundtruth", gtf))
        run_cli("sweep", "--data", base, "--queries", qf, "--groundtruth", gtf, "--method", "ivf",
                "--nprobes", "16", "64", "--stream-reps", "1", "--output", csv)
        with open(csv) as f:
            rows = f.read().strip().splitlines()
    log(f"CLI on {CLI_ROWS} x {DIM} rows and {CLI_QUERIES} queries: info {json.dumps(info)}; "
        f"query (nprobe 64) recall@10 {out['recall']:.4f}, {out['qps']:.0f} QPS; sweep: "
        + " | ".join(rows))
    if info["kind"] != "ivf" or info["vectors"] != CLI_ROWS or out["recall"] < CLI_RECALL_FLOOR:
        raise AssertionError(f"CLI: info {info}, query {out}")
    if rows[0] != "method,config,recall_at_100,latency_ms,qps" or len(rows) != 3:
        raise AssertionError(f"CLI sweep CSV: {rows}")
    return launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from rabitq_tpu_torch import IvfRabitqIndex, Metric, RotatorType, SearchParams
        from rabitq_tpu_torch.ops import _cuda
        from rabitq_tpu_torch.ops.fht import fht_kernel
        from rabitq_tpu_torch.ops.fused_scan import (
            fused_bin_scan_cuda,
            fused_bin_scan_packed_cuda,
        )
        from rabitq_tpu_torch.ops.kmeans import running_sum_kernel, segment_sum_kernel
        from rabitq_tpu_torch.ops.packed_scan import packed_lb_plane_cuda, packed_lb_scan_cuda
    except ImportError as e:
        print(f"chip_smoke: the rabitq_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2

    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}); nvidia-smi:")
    log(smi)

    t0 = time.perf_counter()
    build_logs = _cuda.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(build_logs)} sources")
    # the arguments of each library's shared-memory getter
    dynamic = {"fht": {"rows of 512": (512,), "rows of 16384": (16384,),
                       "rows of 32768 and more": (32768,)},
               "fused_bin_scan": {"direct": ()},
               "packed_bin_scan": {"bits_bf16": (0,), "bits_s8": (1,)},
               "packed_lb_scan": {"both epilogues": ()},
               "build_sums": {}}
    for name, text in build_logs.items():
        for k in _cuda.ptxas_report(text):
            log(f"  {name}: {k['kernel']}: {k['registers']} registers, {k['smem']} bytes static "
                f"shared memory, spills {k['spill_stores']} / {k['spill_loads']} bytes "
                f"(stores / loads)")
            if k["spill_stores"] or k["spill_loads"]:
                raise AssertionError(f"{name}: kernel {k['kernel']} spills registers")
        sizes = ", ".join(f"{m} {_cuda.dynamic_shared_memory(name, *a)}"
                          for m, a in dynamic[name].items())
        log(f"  {name}: dynamic shared memory a block, bytes (as the library says): "
            f"{sizes or 'none'}")

    fht_rows = check_fht()

    # ---- main path ----
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    data, queries, centers = make_workload(ROWS, N_QUERIES, DIM, NLIST // 2, 7, dev)
    torch.cuda.synchronize()
    log(f"workload: {ROWS} x {DIM} + {N_QUERIES} queries drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    gt = ground_truth(data, queries, 10)
    queries_np = queries.cpu().numpy()

    zero_launches()
    t0 = time.perf_counter()
    index = IvfRabitqIndex.train(
        data, nlist=NLIST, total_bits=7, metric=Metric.L2,
        rotator_type=RotatorType.FhtKacRotator, seed=42, use_faster_config=True,
        scan_dtype="fused8", device=dev,
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_fht = fht_kernel.launches
    log(f"train: {build_s:.2f} s; report {json.dumps(index.build_report)}; "
        f"fht launches {build_fht}")
    index.upload_dtype = "int8"
    recalls, one_batch_qps = {}, {}
    t0_serve = time.perf_counter()
    for nprobe in (16, 64, 256):
        params = SearchParams(top_k=10, nprobe=nprobe)
        serve(index, queries_np, nprobe)
        qps = []
        for _ in range(QPS_RUNS):
            t0 = time.perf_counter()
            ids, dists = serve(index, queries_np, nprobe)
            qps.append(len(queries_np) / (time.perf_counter() - t0))
        if ids.shape != (len(queries_np), 10) or (ids < 0).any() or not np.isfinite(dists).all():
            raise AssertionError(f"nprobe={nprobe}: malformed results {ids.shape}")
        if (np.diff(dists, axis=1) < 0).any():
            raise AssertionError(f"nprobe={nprobe}: result rows not sorted by distance")
        index.batch_search_arrays(queries_np, params)  # captures the one-batch graph
        qps_one = []
        for _ in range(QPS_RUNS):
            t0 = time.perf_counter()
            ids2, _ = index.batch_search_arrays(queries_np, params)
            qps_one.append(len(queries_np) / (time.perf_counter() - t0))
        recalls[nprobe] = recall_at(ids, gt, 10)
        one_batch_qps[nprobe] = float(np.median(qps_one))
        log(f"serve nprobe={nprobe}: recall@10 {recalls[nprobe]:.4f} "
            f"(batch_search_arrays {recall_at(ids2, gt, 10):.4f}); QPS over {QPS_RUNS} runs "
            f"(median [min, max]): pipelined int8 {np.median(qps):.0f} "
            f"[{min(qps):.0f}, {max(qps):.0f}], one batch {np.median(qps_one):.0f} "
            f"[{min(qps_one):.0f}, {max(qps_one):.0f}]")
    launches = {
        "fht": fht_kernel.launches,
        "fused_bin_scan_dense": fused_bin_scan_cuda.dense_launches,
        "fused_bin_scan_compact": fused_bin_scan_cuda.compact_launches,
        "segment_sum": segment_sum_kernel.launches,  # the train's k-means
        "running_sum": running_sum_kernel.launches,  # its k-means++ init
    }
    log(f"launches on the main path: {launches}")
    log(f"phase seconds: 7-bit serving {time.perf_counter() - t0_serve:.1f}")
    if min(launches.values()) <= 0 or launches["fht"] <= build_fht:
        raise AssertionError(f"a kernel of the main path never ran in serving: {launches}")
    if recalls[256] < RECALL_FLOOR:
        raise AssertionError(f"recall@10 {recalls[256]:.4f} < {RECALL_FLOOR} at nprobe=256")

    t0 = time.perf_counter()
    compact = check_bin_scan(index, queries_np, 16, "compacted")
    dense = check_bin_scan(index, queries_np, 256, "dense")
    for nprobe in (16, 256):
        profile_serving(index, queries_np, nprobe)
    log(f"phase seconds: 7-bit checks and profiles {time.perf_counter() - t0:.1f}")

    # ---- the same 7-bit index saved and loaded, served from resident
    # queries and through the gather scan; then the brute-force index
    t0 = time.perf_counter()
    persist, load_s, digest = check_persistence(index, queries_np, data)
    log(f"phase seconds: RBQ1 round trip {time.perf_counter() - t0:.1f}")
    # one seed, one index: the train again, while the first index is alive
    repro_ivf, seg_kmeans, scan_init = check_reproducible_ivf(
        index, data, queries_np, digest, (build_s, index.build_report))
    check_kmeanspp_picks()
    t0 = time.perf_counter()
    resident = check_resident(index, queries_np)
    gather = check_gather(index, queries_np, gt)
    log(f"phase seconds: resident queries and gather scan {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    check_fused_ivf(index, queries_np)
    log(f"phase seconds: fused search, 7 bits {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    streamed, k3_streamed = check_streamed(index, queries_np, gt)
    log(f"phase seconds: streamed tier {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    sharded, k1_sharded, single = check_sharded_ivf(index, data, queries_np, gt, one_batch_qps)
    sharded_s = {"IVF": time.perf_counter() - t0}
    log(f"phase seconds: sharded IVF {sharded_s['IVF']:.1f}")
    # the JAX package's call shapes, on each index while it is alive
    t0 = time.perf_counter()
    data_np = data.cpu().numpy()  # the rows as the host array a JAX-shaped call passes
    jax_ivf, k1_jax = check_jax_shaped_ivf(index, data, data_np, queries_np, load_s)
    jax_s = {"IVF": time.perf_counter() - t0}
    del index
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    brute, k4_bf, jax_bf, jax_s["brute force"] = check_brute_force(data, queries_np, gt)
    torch.cuda.empty_cache()
    log(f"phase seconds: brute force {time.perf_counter() - t0 - jax_s['brute force']:.1f}")
    t0 = time.perf_counter()
    (mstg, k1_mstg, mstg_path, sharded["MSTG"], sharded_s["MSTG"], jax_mstg,
     jax_s["MSTG"], repro_mstg, seg_polish) = check_mstg(data, data_np, queries, centers)
    del data_np
    mstg_s = time.perf_counter() - t0 - sharded_s["MSTG"] - jax_s["MSTG"] - REPRO_S["MSTG"]
    log(f"phase seconds: MSTG {mstg_s:.1f} (without the sharded MSTG check, the JAX-shaped "
        f"calls and the second build)")
    log(f"phase seconds: JAX-shaped calls {sum(jax_s.values()):.1f} ("
        + ", ".join(f"{k} {v:.1f}" for k, v in jax_s.items()) + ")")
    t0 = time.perf_counter()
    try:
        front = check_front_ends(data, queries, gt, mstg_path)
    finally:
        shutil.rmtree(os.path.dirname(mstg_path), ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"phase seconds: front ends {time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    sharded["train"] = check_sharded_train(data, queries_np, gt, single)
    sharded_s["train"] = time.perf_counter() - t0 - REPRO_S["sharded train"]
    log(f"phase seconds: sharded train {sharded_s['train']:.1f} (without the second train)")
    log(f"phase seconds: reproducible builds {sum(REPRO_S.values()):.1f} ("
        + ", ".join(f"{k} {v:.1f}" for k, v in REPRO_S.items())
        + "; IVF with the k-means-shape segment sum, MSTG with the polish-shape one)")

    # ---- two-stage and dense paths: total_bits=8 keeps raw ex codes, so the
    # fused scans run two-stage through the packed bin kernel
    zero_launches()
    t0 = time.perf_counter()
    index8 = IvfRabitqIndex.train(
        data, nlist=NLIST, total_bits=8, metric=Metric.L2,
        rotator_type=RotatorType.FhtKacRotator, seed=42, use_faster_config=True,
        scan_dtype="fused8", device=dev,
    )
    torch.cuda.synchronize()
    log(f"train total_bits=8: {time.perf_counter() - t0:.2f} s; report "
        f"{json.dumps(index8.build_report)}; fused EXACT ok {index8._fused_exact_ok()}")
    if index8._fused_exact_ok():
        raise AssertionError("the total_bits=8 index must take the two-stage scan")
    del data
    torch.cuda.empty_cache()
    index8.upload_dtype = "int8"
    t0 = time.perf_counter()
    for scan_dtype, nprobe in (("fused8", 16), ("fused8", 256), ("fused", 16), ("fused", 256),
                               ("packed", 256), ("bf16", 256)):
        index8.scan_dtype = scan_dtype  # "packed" re-lays the index to the permuted layout
        serve(index8, queries_np, nprobe)
        qps = []
        for _ in range(QPS_RUNS_8BIT):
            t1 = time.perf_counter()
            ids, dists = serve(index8, queries_np, nprobe)
            qps.append(len(queries_np) / (time.perf_counter() - t1))
        if index8.scan_dtype != scan_dtype:
            raise AssertionError(f"{scan_dtype} was downgraded to {index8.scan_dtype}")
        if ids.shape != (len(queries_np), 10) or (ids < 0).any() or not np.isfinite(dists).all():
            raise AssertionError(f"{scan_dtype} nprobe={nprobe}: malformed results {ids.shape}")
        if (np.diff(dists, axis=1) < 0).any():
            raise AssertionError(f"{scan_dtype} nprobe={nprobe}: rows not sorted by distance")
        recall = recall_at(ids, gt, 10)
        log(f"serve total_bits=8 {scan_dtype} nprobe={nprobe}: recall@10 {recall:.4f}; "
            f"pipelined int8 QPS over {QPS_RUNS_8BIT} runs (median [min, max]): "
            f"{np.median(qps):.0f} [{min(qps):.0f}, {max(qps):.0f}]")
        if nprobe == 256 and recall < RECALL_FLOOR:
            raise AssertionError(
                f"{scan_dtype}: recall@10 {recall:.4f} < {RECALL_FLOOR} at nprobe=256")
    launches8 = {f"fused_bin_scan_packed_{k}": v
                 for k, v in fused_bin_scan_packed_cuda.launches.items()}
    launches8["packed_lb_plane"] = packed_lb_plane_cuda.launches
    launches8["fht"] = fht_kernel.launches
    launches8["segment_sum"] = segment_sum_kernel.launches  # the 8-bit train's k-means
    launches8["running_sum"] = running_sum_kernel.launches
    # the TPU contract's epilogue is on no path (the sharded "packed" scan
    # takes G_TABLE, as the in-memory one does)
    g_plane_launches = packed_lb_scan_cuda.launches
    log(f"launches on the two-stage and dense paths: {launches8}; packed_lb_scan (G_PLANE, "
        f"on no main path): {g_plane_launches}")
    if min(launches8.values()) <= 0:
        raise AssertionError(f"a kernel of the two-stage or dense path never ran: {launches8}")
    log(f"phase seconds: total_bits=8 serving {time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    for scan_dtype, nprobe in (("fused8", 16), ("fused8", 256), ("fused", 16), ("fused", 256),
                               ("packed", 256), ("bf16", 256)):
        index8.scan_dtype = scan_dtype
        check_fused(f"8 bits {scan_dtype} nprobe={nprobe}", index8,
                    lambda: serve(index8, queries_np, nprobe), len(queries_np) // 256,
                    ties=scan_dtype in ("packed", "bf16"))
    log_pool("8-bit", index8)
    log(f"phase seconds: fused search, 8 bits {time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    index8.scan_dtype = "packed"
    lb = check_packed_lb_scan(index8, queries_np, 256)
    profile_serving(index8, queries_np, 256, label="total_bits=8 packed ")
    index8.scan_dtype = "fused8"  # re-laid back to the cluster-sorted layout
    p_int8_compact = check_bin_scan(index8, queries_np, 16, "compacted")
    p_int8_dense = check_bin_scan(index8, queries_np, 256, "dense")
    profile_serving(index8, queries_np, 16, label="total_bits=8 fused8 ")
    index8.scan_dtype = "fused"
    p_bf16_compact = check_bin_scan(index8, queries_np, 16, "compacted")
    p_bf16_dense = check_bin_scan(index8, queries_np, 256, "dense")
    profile_serving(index8, queries_np, 256, label="total_bits=8 fused ")
    log(f"phase seconds: total_bits=8 checks and profiles {time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    launches_sh8, k3_sharded, k4_sharded = check_sharded_8bit(index8, queries_np, gt)
    sharded.update(launches_sh8)
    sharded_s["8-bit"] = time.perf_counter() - t0
    log(f"phase seconds: sharded 8-bit {sharded_s['8-bit']:.1f}")
    log(f"phase seconds: sharded {sum(sharded_s.values()):.1f} (IVF, MSTG, train, 8-bit: "
        + ", ".join(f"{v:.1f}" for v in sharded_s.values()) + ")")
    del index8
    torch.cuda.empty_cache()

    def entry(name, source, replaces, n, r):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n, "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r.get("bound_by", "bytes"), "library_ms": r.get("library_ms"),
        }

    scan_src = "rabitq_tpu_torch/csrc/fused_bin_scan.cu"
    scan_tpu = "rabitq_tpu/ops/pallas_fused_scan.py:497"
    packed_src = "rabitq_tpu_torch/csrc/packed_bin_scan.cu"
    paths = ((launches, launches8, persist, resident, gather, brute, streamed, jax_ivf, jax_bf,
              jax_mstg, repro_ivf, repro_mstg)
             + tuple(mstg.values()) + tuple(front.values()) + tuple(sharded.values()))
    kernels = [
        entry("fht", "rabitq_tpu_torch/csrc/fht.cu", "rabitq_tpu/ops/pallas_fht.py:49",
              sum(p["fht"] for p in paths), fht_rows[(8192, 512)]),
        entry("fused_bin_scan_compact", scan_src, scan_tpu,
              launches["fused_bin_scan_compact"], compact),
        entry("fused_bin_scan_dense", scan_src, scan_tpu,
              sum(p.get("fused_bin_scan_dense", 0)
                  for p in (launches, persist, resident, front["IVF binding"])), dense),
        entry("fused_bin_scan_packed_int8_compact", packed_src, scan_tpu,
              launches8["fused_bin_scan_packed_int8_compact"], p_int8_compact),
        entry("fused_bin_scan_packed_int8_dense", packed_src, scan_tpu,
              launches8["fused_bin_scan_packed_int8_dense"], p_int8_dense),
        entry("fused_bin_scan_packed_bf16_compact", packed_src, scan_tpu,
              launches8["fused_bin_scan_packed_bf16_compact"], p_bf16_compact),
        entry("fused_bin_scan_packed_bf16_dense", packed_src, scan_tpu,
              launches8["fused_bin_scan_packed_bf16_dense"], p_bf16_dense),
        entry("fused_bin_scan_packed_int8_streamed_compact", packed_src, scan_tpu,
              streamed["fused_bin_scan_packed_int8_compact"], k3_streamed["compact"]),
        entry("fused_bin_scan_packed_int8_streamed_dense", packed_src, scan_tpu,
              streamed["fused_bin_scan_packed_int8_dense"], k3_streamed["dense"]),
        entry("packed_lb_plane", "rabitq_tpu_torch/csrc/packed_lb_scan.cu",
              "rabitq_tpu/ops/pallas_scan.py:141", launches8["packed_lb_plane"], lb["plane"]),
        entry("packed_lb_scan", "rabitq_tpu_torch/csrc/packed_lb_scan.cu",
              "rabitq_tpu/ops/pallas_scan.py:141", g_plane_launches, lb["scan"]),
        entry("packed_lb_plane_brute_force", "rabitq_tpu_torch/csrc/packed_lb_scan.cu",
              "rabitq_tpu/ops/pallas_scan.py:141",
              brute["packed_lb_plane"] + jax_bf["packed_lb_plane"], k4_bf),
        entry("fused_bin_scan_jax_shaped_dense", scan_src, scan_tpu,
              jax_ivf["fused_bin_scan_dense"], k1_jax),
        # a build kernel, not a TPU kernel's counterpart: it stands where the
        # JAX package calls jax.ops.segment_sum (an XLA op) in its builds
        entry("segment_sum", "rabitq_tpu_torch/csrc/build_sums.cu",
              "rabitq_tpu/ops/kmeans.py:214",
              sum(p["segment_sum"] for p in (launches, launches8, sharded["train"], repro_ivf)),
              seg_kmeans),
        entry("segment_sum_mstg_polish", "rabitq_tpu_torch/csrc/build_sums.cu",
              "rabitq_tpu/index/mstg/clustering.py:198",
              sum(mstg[(v, "build")]["segment_sum"] for v in ("headline", "replicated"))
              + repro_mstg["segment_sum"], seg_polish),
        entry("running_sum", "rabitq_tpu_torch/csrc/build_sums.cu",
              "rabitq_tpu/ops/kmeans.py:176",
              sum(p["running_sum"] for p in (launches, launches8, sharded["train"], repro_ivf))
              + sum(mstg[(v, "build")]["running_sum"] for v in ("headline", "replicated"))
              + repro_mstg["running_sum"], scan_init),
    ]
    kernels += [
        entry(f"fused_bin_scan_mstg_{variant}_ef{ef}", scan_src, scan_tpu,
              mstg[(variant, ef)]["fused_bin_scan"], r)
        for (variant, ef), r in k1_mstg.items()
    ]
    kernels += [
        entry("fused_bin_scan_sharded_compact", scan_src, scan_tpu,
              sharded["IVF"]["fused_bin_scan_compact"], k1_sharded["compact"]),
        entry("fused_bin_scan_sharded_dense", scan_src, scan_tpu,
              sharded["IVF"]["fused_bin_scan_dense"], k1_sharded["dense"]),
        entry("fused_bin_scan_packed_int8_sharded_compact", packed_src, scan_tpu,
              sharded["IVF total_bits=8 fused8"]["fused_bin_scan_packed_int8_compact"],
              k3_sharded),
        entry("packed_lb_plane_sharded", "rabitq_tpu_torch/csrc/packed_lb_scan.cu",
              "rabitq_tpu/ops/pallas_scan.py:141",
              sharded["IVF total_bits=8 packed"]["packed_lb_plane"], k4_sharded),
    ]
    for k in kernels:
        if not all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"non-finite timing for {k['name']}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
