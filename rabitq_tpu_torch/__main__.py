"""rabitq_tpu_torch command-line interface (port of ``rabitq_tpu/__main__.py``).

The build / query / sweep / info flows of the reference's examples
(``examples/benchmark_gist.rs``, ``examples/recall_qps_sweep.rs``):

    python -m rabitq_tpu_torch build  --data base.fvecs --output index.rbq \
        --index-type ivf --nlist 4096 --total-bits 7
    python -m rabitq_tpu_torch query  --index index.rbq --queries q.fvecs \
        --k 10 --nprobe 64 [--groundtruth gt.ivecs]
    python -m rabitq_tpu_torch sweep  --data base.fvecs --queries q.fvecs \
        --groundtruth gt.ivecs --output sweep.csv
    python -m rabitq_tpu_torch info   --index index.rbq

Every subcommand takes ``--device`` (default: the card; ``cpu`` runs on
the host). ``sweep`` writes the reference's CSV schema
(``benchmarks/gist_1m_results/recall_qps_fixed.csv``:
method,config,recall_at_100,latency_ms,qps). ``main(argv)`` runs in-process.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _load_data(path, limit=None):
    from .io.vecio import read_fvecs

    data = read_fvecs(path, limit)
    log(f"loaded {data.shape[0]} x {data.shape[1]} from {path}")
    return data


def cmd_build(args):
    from . import (
        BruteForceRabitqIndex,
        IvfRabitqIndex,
        Metric,
        MstgConfig,
        MstgIndex,
        RotatorType,
    )

    data = _load_data(args.data, args.limit)
    metric = Metric.from_str(args.metric)
    rotator = (
        RotatorType.FhtKacRotator if args.rotator in ("fht", "random") else RotatorType.MatrixRotator
    )
    if bool(args.centroids) != bool(args.assignments):
        raise SystemExit(
            "--centroids and --assignments must be given together "
            "(precomputed clustering needs both)"
        )
    t0 = time.time()
    if args.index_type == "ivf":
        if args.centroids and args.assignments:
            # precomputed clustering (e.g. FAISS), like the reference's
            # fit_with_clusters binding (python_bindings.rs:443)
            from .io.vecio import read_fvecs, read_ids

            index = IvfRabitqIndex.train_with_clusters(
                data,
                read_fvecs(args.centroids),
                read_ids(args.assignments),
                total_bits=args.total_bits,
                metric=metric,
                rotator_type=rotator,
                seed=args.seed,
                use_faster_config=args.faster,
                device=args.device,
            )
        else:
            index = IvfRabitqIndex.train(
                data,
                nlist=args.nlist,
                total_bits=args.total_bits,
                metric=metric,
                rotator_type=rotator,
                seed=args.seed,
                use_faster_config=args.faster,
                device=args.device,
            )
    elif args.index_type == "brute_force":
        index = BruteForceRabitqIndex.train(
            data,
            total_bits=args.total_bits,
            metric=metric,
            rotator_type=rotator,
            seed=args.seed,
            use_faster_config=args.faster,
            device=args.device,
        )
    else:
        cfg = MstgConfig(
            max_posting_size=args.max_posting_size,
            branching_factor=args.branching_factor,
            rabitq_bits=args.total_bits,
            faster_config=args.faster,
            metric=metric,
            use_rotator=args.mstg_rotator,
        )
        index = MstgIndex.build(data, cfg, seed=args.seed, device=args.device)
    log(f"build: {time.time()-t0:.1f}s")
    index.save_to_path(args.output)
    log(f"saved -> {args.output}")


def _open_index(path, device):
    from . import MstgIndex, load_index

    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"MSTG":
        return MstgIndex.load_from_path(path, device=device), "mstg"
    idx = load_index(path, device=device)
    return idx.inner, idx.kind


def _search(index, kind, queries, k, args):
    from . import BruteForceSearchParams, MstgSearchParams, SearchParams

    if kind == "ivf":
        return index.batch_search(queries, SearchParams(top_k=k, nprobe=args.nprobe))
    if kind == "brute_force":
        return index.batch_search(queries, BruteForceSearchParams(top_k=k))
    return index.batch_search(
        queries,
        MstgSearchParams(
            ef_search=args.ef_search, pruning_epsilon=args.pruning_epsilon, top_k=k
        ),
    )


def _recall(results, gt, k):
    hits = 0
    total = 0
    for res, g in zip(results, gt):
        ids = {h.id for h in res[:k]}
        hits += len(ids & set(g[:k].tolist()))
        total += k
    return hits / max(total, 1)


def _recall_ids(id_rows, gt, k):
    """`_recall` for array-shaped results ([B, >=k] int32, -1 padding)."""
    hits = 0
    total = 0
    for row, g in zip(id_rows, gt):
        ids = {int(i) for i in row[:k] if i >= 0}
        hits += len(ids & set(g[:k].tolist()))
        total += k
    return hits / max(total, 1)


def cmd_query(args):
    index, kind = _open_index(args.index, args.device)
    queries = _load_data(args.queries, args.limit)
    t0 = time.time()
    results = _search(index, kind, queries, args.k, args)
    dt = time.time() - t0
    log(f"{len(queries)} queries in {dt:.3f}s ({len(queries)/dt:.1f} QPS)")
    if args.groundtruth:
        from .io.vecio import read_groundtruth

        gt = read_groundtruth(args.groundtruth)
        rec = _recall(results, gt, args.k)
        print(json.dumps({"recall": rec, "qps": len(queries) / dt, "k": args.k}))
    else:
        for qi, res in enumerate(results[: args.show]):
            print(qi, [(h.id, round(h.score, 4)) for h in res[:5]])


def cmd_info(args):
    index, kind = _open_index(args.index, args.device)
    info = {"kind": kind, "vectors": len(index), "dim": index.dim}
    if kind == "ivf":
        info.update(
            clusters=index.cluster_count(),
            padded_dim=index.padded_dim,
            ex_bits=index.ex_bits,
            metric=index.metric.value,
        )
    elif kind == "mstg":
        info.update(
            posting_lists=index.posting_list_count(),
            replication=round(index.replication_factor(), 3),
            rabitq_bits=index.config.rabitq_bits,
            memory_bytes=index.memory_usage(),
        )
    else:
        info.update(padded_dim=index.padded_dim, ex_bits=index.ex_bits)
    print(json.dumps(info))


def cmd_sweep(args):
    """Recall/QPS sweep writing the reference CSV schema
    (``examples/recall_qps_sweep.rs``)."""
    from . import (
        IvfRabitqIndex,
        Metric,
        MstgConfig,
        MstgIndex,
        MstgSearchParams,
        SearchParams,
    )
    from .io.vecio import read_groundtruth

    data = _load_data(args.data, args.limit)
    queries = _load_data(args.queries, args.query_limit)
    gt = read_groundtruth(args.groundtruth)[: len(queries)]
    k = args.k

    rows = ["method,config,recall_at_%d,latency_ms,qps" % k]

    # recall comes from the resident queries, the qps/latency columns from
    # a sustained stream: the pipelined serving loop (int8 query uploads,
    # b=256, upload_block=1024) over stream_reps x queries, best of two
    # timed runs. latency_ms is the amortized per-query time (1000/qps), as
    # in the reference CSV's schema (examples/recall_qps_sweep.rs).
    def sustained_qps(run_stream, n_stream):
        run_stream()  # warm-up/compile
        best = 0.0
        for _ in range(2):
            t0 = time.time()
            run_stream()
            best = max(best, n_stream / (time.time() - t0))
        return best

    if args.method in ("ivf", "both"):
        if args.index:
            index = IvfRabitqIndex.load_from_path(
                args.index, scan_dtype=args.scan_dtype, device=args.device
            )
            log(f"loaded index {args.index}")
        else:
            index = IvfRabitqIndex.train(
                data, nlist=args.nlist, total_bits=args.total_bits,
                metric=Metric.L2, seed=args.seed, use_faster_config=True,
                scan_dtype=args.scan_dtype, device=args.device,
            )
        index.upload_dtype = "int8"
        stream = np.tile(queries, (args.stream_reps, 1))
        # recall columns run from device-resident queries: uploaded once,
        # every nprobe re-dispatches them
        qcache = index.upload_queries(queries)
        for nprobe in args.nprobes:
            params = SearchParams(top_k=k, nprobe=nprobe, rerank=args.rerank)
            ids, _ = index.batch_search_resident(qcache, params)
            rec = _recall_ids(ids, gt, k)
            qps = sustained_qps(
                lambda: index.batch_search_arrays_pipelined(
                    stream, params, batch_size=256, upload_block=1024
                ),
                stream.shape[0],
            )
            lat = 1000.0 / qps
            rows.append(f"IVF,nprobe={nprobe},{rec},{lat},{qps}")
            log(rows[-1])

    if args.method in ("mstg", "both"):
        cfg = MstgConfig(
            max_posting_size=args.max_posting_size,
            branching_factor=args.branching_factor,
            rabitq_bits=args.total_bits,
            faster_config=True,
        )
        index = MstgIndex.build(data, cfg, seed=args.seed, device=args.device)
        index.scan_dtype = args.scan_dtype
        index.upload_dtype = "int8"
        stream = np.tile(queries, (args.stream_reps, 1))
        qcache = index.upload_queries(queries)  # resident recall runs
        for ef in args.efs:
            for eps in args.epsilons:
                params = MstgSearchParams(
                    ef_search=ef, pruning_epsilon=eps, top_k=k, rerank=args.rerank
                )
                rec = _recall(index.batch_search_resident(qcache, params), gt, k)
                # the arrays variant: building SearchResult objects (~300k a
                # repetition at k=100) would dominate the timing
                qps = sustained_qps(
                    lambda: index.batch_search_arrays_pipelined(
                        stream, params, batch_size=256, upload_block=1024
                    ),
                    stream.shape[0],
                )
                lat = 1000.0 / qps
                rows.append(f"MSTG,\"ef={ef}, eps={eps}\",{rec},{lat},{qps}")
                log(rows[-1])

    out = "\n".join(rows) + "\n"
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
        log(f"wrote {args.output}")
    else:
        print(out)


def _device_flag(parser) -> None:
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the card; 'cpu' for the host)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="rabitq_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build an index from an fvecs file")
    b.add_argument("--data", required=True)
    b.add_argument("--output", required=True)
    b.add_argument("--index-type", choices=["ivf", "brute_force", "mstg"], default="ivf")
    b.add_argument("--nlist", type=int, default=4096)
    b.add_argument("--total-bits", type=int, default=7)
    b.add_argument("--metric", default="l2")
    b.add_argument("--rotator", default="fht")
    b.add_argument("--seed", type=int, default=42)
    b.add_argument("--faster", action="store_true", default=True)
    b.add_argument("--no-faster", dest="faster", action="store_false")
    b.add_argument("--max-posting-size", type=int, default=5000)
    b.add_argument("--branching-factor", type=int, default=10)
    b.add_argument("--limit", type=int, default=None)
    b.add_argument("--mstg-rotator", action="store_true",
                   help="rotate before MSTG quantization (an extension of the reference)")
    b.add_argument("--centroids", default=None, help="precomputed centroids fvecs")
    b.add_argument("--assignments", default=None, help="precomputed cluster-id ivecs")
    _device_flag(b)
    b.set_defaults(func=cmd_build)

    q = sub.add_parser("query", help="query an index with fvecs queries")
    q.add_argument("--index", required=True)
    q.add_argument("--queries", required=True)
    q.add_argument("--k", type=int, default=10)
    q.add_argument("--nprobe", type=int, default=64)
    q.add_argument("--ef-search", type=int, default=150)
    q.add_argument("--pruning-epsilon", type=float, default=0.6)
    q.add_argument("--groundtruth", default=None)
    q.add_argument("--limit", type=int, default=None)
    q.add_argument("--show", type=int, default=5)
    _device_flag(q)
    q.set_defaults(func=cmd_query)

    i = sub.add_parser("info", help="print index metadata")
    i.add_argument("--index", required=True)
    _device_flag(i)
    i.set_defaults(func=cmd_info)

    s = sub.add_parser("sweep", help="recall/QPS sweep (reference CSV schema)")
    s.add_argument("--data", required=True)
    s.add_argument("--queries", required=True)
    s.add_argument("--groundtruth", required=True)
    s.add_argument("--output", default=None)
    s.add_argument("--method", choices=["ivf", "mstg", "both"], default="both")
    s.add_argument("--k", type=int, default=100)
    s.add_argument("--nlist", type=int, default=1024)
    s.add_argument("--total-bits", type=int, default=7)
    s.add_argument("--seed", type=int, default=42)
    s.add_argument("--nprobes", type=int, nargs="+", default=[4, 8, 16, 32, 64, 128])
    s.add_argument("--efs", type=int, nargs="+", default=[50, 100, 200, 400])
    s.add_argument("--epsilons", type=float, nargs="+", default=[0.3, 0.6, 1.0])
    s.add_argument("--max-posting-size", type=int, default=5000)
    s.add_argument("--branching-factor", type=int, default=10)
    s.add_argument("--limit", type=int, default=None)
    s.add_argument("--query-limit", type=int, default=None)
    s.add_argument("--scan-dtype", default="bf16",
                   choices=["f32", "bf16", "int8", "packed", "fused", "fused8"])
    s.add_argument("--rerank", type=int, default=None,
                   help="survivor re-rank budget (default: max(4k, 400); "
                   "raise to ~40x k for high-recall k=100 sweeps)")
    s.add_argument("--index", default=None,
                   help="reuse a saved IVF index instead of building "
                   "(ivf method only)")
    s.add_argument("--stream-reps", type=int, default=3,
                   help="sustained-stream length multiplier for the QPS "
                   "columns (queries tiled this many times through the "
                   "pipelined serving loop)")
    _device_flag(s)
    s.set_defaults(func=cmd_sweep)

    args = ap.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
