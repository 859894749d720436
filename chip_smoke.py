#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``rabitq_tpu_torch``) on one NVIDIA GPU.

Phases, one line each:
  1. device: the card's name, and nvidia-smi's name and power limit;
  2. build: compile every kernel from ``rabitq_tpu_torch/csrc`` with nvcc
     (one process per source, all at once);
  3. fht: the FHT kernel against its plain version on [256, 512] and
     [8192, 512] f32 (must be bitwise equal), with times and bound;
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
     with times and bound;
  6. profile: device time by kernel and the device's busy share over one
     pipelined serving run at nprobe 16 and 256 (torch.profiler).
Then one JSON line of kernel numbers, nvidia-smi's line again, and last
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.

Usage: python3 chip_smoke.py (no arguments; one card).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, CUDA cores (the FHT's adds)
BF16_TENSOR_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores (the bin scan's dot)
ROWS, DIM, N_QUERIES, NLIST = 1_000_000, 960, 2048, 4096  # bench.py's headline
RECALL_FLOOR = 0.90  # recall@10 at nprobe=256
QPS_RUNS = 5  # timed serving runs per nprobe (after one warm-up)


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


def make_workload(rows, n_queries, dim, n_centers, seed, device):
    """bench.py's make_workload drawn on the card: overlapping Gaussian
    blobs, queries from the same mixture, sigma = 1.5 * (dim / 128)^0.25."""
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

    return draw(rows), draw(n_queries)


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
    for rows in (256, 8192):
        x = torch.randn((rows, 512), generator=g, device="cuda")
        k_out = fht_kernel(x)
        p_out = fht_plain(x)
        torch.cuda.synchronize()
        err = float((k_out - p_out).abs().max())
        if not torch.equal(k_out, p_out):
            raise AssertionError(f"fht [{rows}, 512]: kernel != plain (max |err| {err})")
        ms = cuda_ms(lambda: fht_kernel(x), 50)
        plain_ms = cuda_ms(lambda: fht_plain(x), 20)
        n_bytes = 2 * rows * 512 * 4
        ops = rows * 512 * 9
        bound = max(n_bytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
        log(f"fht [{rows}, 512]: bitwise equal; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms (bytes)")
        rows_out[rows] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, err=err)
    return rows_out


def bin_scan_bound(args):
    """Least time for the bin scan on these inputs: the plane rows it must
    read (listed tiles, or all), the other inputs and outputs once, and
    2 * D flops per (query, row) pair it must score, at the bf16 tensor
    rate: the int8 codes are exact in bf16, so a tensor-core kernel could
    do this work (the CUDA-core f32 kernel is slower than that yardstick)."""
    from rabitq_tpu_torch.ops.fused_scan import TN, n_bins

    plane, q, _, _, _, _, g1, c_blk = args[:8]
    tiles, tcount = args[8], args[9]
    n, d = plane.shape
    bq = q.shape[0]
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
        rows * d + rows * 12 + q.numel() * 4 + bq * 4 + g1.numel() * 2 + c_blk.numel() * 4
        + 2 * bq * n_bins() * 4 + bq * 128 * 4
    )
    ops = 2 * pair_tiles * TN * d
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / BF16_TENSOR_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_bin_scan(index, queries_np, nprobe):
    """Kernel vs plain on the exact inputs the main path hands the kernel
    for one 256-query block at this nprobe."""
    import torch
    from rabitq_tpu_torch import SearchParams
    from rabitq_tpu_torch.ops import fused_scan

    captured = []
    real = fused_scan.fused_bin_scan

    def spy(*a, **kw):
        captured.append(a + (kw.get("tiles"), kw.get("tcount")))
        return real(*a, **kw)

    fused_scan.fused_bin_scan = spy
    try:
        index.batch_search_arrays(queries_np[:256], SearchParams(top_k=10, nprobe=nprobe))
    finally:
        fused_scan.fused_bin_scan = real
    args = captured[0]
    walk = "dense" if args[8] is None else "compacted"
    kv, ki, ko = fused_scan.fused_bin_scan_cuda(*args)
    pv, pi, po = fused_scan.fused_bin_scan_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(ko, po):
        raise AssertionError(f"bin scan ({walk}): offered counts differ")
    finite = pv < fused_scan.BIG / 2
    if not torch.equal(finite, kv < fused_scan.BIG / 2):
        raise AssertionError(f"bin scan ({walk}): different bins filled")
    err = float((kv - pv)[finite].abs().max()) if bool(finite.any()) else 0.0
    if not torch.allclose(kv[finite], pv[finite], rtol=1e-5, atol=1e-3):
        raise AssertionError(f"bin scan ({walk}): values differ, max |err| {err}")
    agree = float((ki == pi).float().mean())
    if agree < 0.999:
        raise AssertionError(f"bin scan ({walk}): bins_idx agree on {agree:.5f} < 0.999")
    ms = cuda_ms(lambda: fused_scan.fused_bin_scan_cuda(*args), 10)
    plain_ms = cuda_ms(lambda: fused_scan.fused_bin_scan_plain(*args), 2)
    bound, bound_by = bin_scan_bound(args)
    extra = ""
    if args[8] is not None:
        cnt = args[9].clamp(max=args[8].shape[1])
        extra = (f", lists of {args[8].shape[1]} slots, {int(cnt.sum())} tiles listed over "
                 f"{cnt.numel()} blocks of {args[1].shape[0] // cnt.numel()} queries")
    log(f"bin scan ({walk}, nprobe={nprobe}, q {tuple(args[1].shape)}, plane "
        f"{tuple(args[0].shape)}{extra}): offered equal, max |err| {err:.3g}, idx agree "
        f"{agree:.5f}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.3f} ms ({bound_by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, err=err)


def profile_serving(index, queries_np, nprobe):
    """Device time by kernel over one pipelined serving run, and the share
    of the run's wall time the device was busy (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rabitq_tpu_torch import SearchParams

    params = SearchParams(top_k=10, nprobe=nprobe)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        index.batch_search_arrays_pipelined(queries_np, params, batch_size=256, upload_block=1024)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    top = "; ".join(f"{name[:48]} x{n} {ms:.2f} ms" for ms, name, n in rows[:8])
    log(f"profile nprobe={nprobe}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.0f}%); top: {top}")


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
        from rabitq_tpu_torch.ops.fused_scan import fused_bin_scan_cuda
    except ImportError as e:
        print(f"chip_smoke: the rabitq_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2

    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}); nvidia-smi:")
    log(smi)

    t0 = time.perf_counter()
    build_logs = _cuda.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(build_logs)} kernels")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    fht_rows = check_fht()

    # ---- main path ----
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    data, queries = make_workload(ROWS, N_QUERIES, DIM, NLIST // 2, 7, dev)
    torch.cuda.synchronize()
    log(f"workload: {ROWS} x {DIM} + {N_QUERIES} queries drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    gt = ground_truth(data, queries, 10)
    queries_np = queries.cpu().numpy()

    fht_kernel.launches = 0
    fused_bin_scan_cuda.dense_launches = 0
    fused_bin_scan_cuda.compact_launches = 0
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
    recalls = {}
    for nprobe in (16, 64, 256):
        params = SearchParams(top_k=10, nprobe=nprobe)
        index.batch_search_arrays_pipelined(queries_np, params, batch_size=256, upload_block=1024)
        qps = []
        for _ in range(QPS_RUNS):
            t0 = time.perf_counter()
            ids, dists = index.batch_search_arrays_pipelined(
                queries_np, params, batch_size=256, upload_block=1024
            )
            qps.append(len(queries_np) / (time.perf_counter() - t0))
        if ids.shape != (len(queries_np), 10) or (ids < 0).any() or not np.isfinite(dists).all():
            raise AssertionError(f"nprobe={nprobe}: malformed results {ids.shape}")
        if (np.diff(dists, axis=1) < 0).any():
            raise AssertionError(f"nprobe={nprobe}: result rows not sorted by distance")
        qps_one = []
        for _ in range(QPS_RUNS):
            t0 = time.perf_counter()
            ids2, _ = index.batch_search_arrays(queries_np, params)
            qps_one.append(len(queries_np) / (time.perf_counter() - t0))
        recalls[nprobe] = recall_at(ids, gt, 10)
        log(f"serve nprobe={nprobe}: recall@10 {recalls[nprobe]:.4f} "
            f"(batch_search_arrays {recall_at(ids2, gt, 10):.4f}); QPS over {QPS_RUNS} runs "
            f"(median [min, max]): pipelined int8 {np.median(qps):.0f} "
            f"[{min(qps):.0f}, {max(qps):.0f}], one batch {np.median(qps_one):.0f} "
            f"[{min(qps_one):.0f}, {max(qps_one):.0f}]")
    launches = {
        "fht": fht_kernel.launches,
        "fused_bin_scan_dense": fused_bin_scan_cuda.dense_launches,
        "fused_bin_scan_compact": fused_bin_scan_cuda.compact_launches,
    }
    log(f"launches on the main path: {launches}")
    if min(launches.values()) <= 0 or launches["fht"] <= build_fht:
        raise AssertionError(f"a kernel of the main path never ran in serving: {launches}")
    if recalls[256] < RECALL_FLOOR:
        raise AssertionError(f"recall@10 {recalls[256]:.4f} < {RECALL_FLOOR} at nprobe=256")

    compact = check_bin_scan(index, queries_np, 16)
    dense = check_bin_scan(index, queries_np, 256)
    for nprobe in (16, 256):
        profile_serving(index, queries_np, nprobe)

    def entry(name, source, replaces, n, r):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n, "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r.get("bound_by", "bytes"), "library_ms": None,
        }

    scan_src = "rabitq_tpu_torch/csrc/fused_bin_scan.cu"
    scan_tpu = "rabitq_tpu/ops/pallas_fused_scan.py:497"
    kernels = [
        entry("fht", "rabitq_tpu_torch/csrc/fht.cu", "rabitq_tpu/ops/pallas_fht.py:49",
              launches["fht"], fht_rows[8192]),
        entry("fused_bin_scan_compact", scan_src, scan_tpu,
              launches["fused_bin_scan_compact"], compact),
        entry("fused_bin_scan_dense", scan_src, scan_tpu,
              launches["fused_bin_scan_dense"], dense),
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
