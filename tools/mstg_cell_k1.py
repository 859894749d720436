#!/usr/bin/env python3
"""K1 on the MSTG benchmark cell's own path, on one card.

Builds the index of ``portbench/configs/mstg-gist1m-7b.json`` on the rows of
``portbench/data.blobs`` for one seed (through ``portbench/programs/mstg.py``,
as the cell builds it), prints the build's phases, the posting lists' sizes
and replication, the walk the bin scan takes at the configuration's ef and
the device memory's peak, serves one query set as the cell does (recall@10
against ``portbench/reference/exact_knn.py``), then holds the fused EXACT bin
scan (K1) against its plain version on the inputs that path hands it for one
256-query block (``chip_smoke.check_bin_scan_run``), failing unless that
block took the walk the index's gate chose for it.

    PYTHONPATH=. python3 tools/mstg_cell_k1.py [--seed N]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=2190000001)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    from portbench import data, spec
    from portbench.reference import exact_knn
    from rabitq_tpu_torch import MstgSearchParams
    from rabitq_tpu_torch.index.layout import pad_rows
    from rabitq_tpu_torch.ops.fused_scan import TN

    dev = torch.device("cuda", 0)
    cfg = json.loads((ROOT / "portbench/configs/mstg-gist1m-7b.json").read_text())
    program = spec.program_kind("mstg")
    chip_smoke.log(chip_smoke.smi_line())
    ds = cfg["dataset"]
    rows, queries = data.blobs(ds, ds["queries"], data.generator(args.seed, dev), dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    index = program.build(cfg, rows, dev)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    r = index.build_report
    sizes = np.diff(index._offsets)
    chip_smoke.log(
        f"build {build_s:.3f} s (upload {r['upload_s']:.3f}, clustering {r['clustering_s']:.3f}, "
        f"closure {r['closure_s']:.3f}, quantize {r['quantize_s']:.3f}); "
        f"{index.posting_list_count()} lists, sizes min {sizes.min()} p50 "
        f"{np.percentile(sizes, 50):.0f} p95 {np.percentile(sizes, 95):.0f} max {sizes.max()}; "
        f"replication {index.replication_factor():.4f}; quant_dim {index.quant_dim}")
    s = cfg["serving"]
    ef = s["nprobe"]
    queries_np = queries.cpu().numpy()
    ids, dists = program.batch(index, cfg, queries_np)
    torch.cuda.synchronize(dev)
    gt, _ = exact_knn.top_k(rows, queries, s["top_k"])
    recall = chip_smoke.recall_at(ids, gt.cpu().numpy(), s["top_k"])
    tiles = index._plan.max_tiles(index.scan_dtype, ef)
    n_tiles = pad_rows(index.total_rows, TN) // TN
    walk = "dense" if tiles is None else "compacted"
    chip_smoke.log(
        f"serve ef {ef} eps {s['pruning_epsilon']}: recall@10 {recall:.4f}; scan_dtype "
        f"{index.scan_dtype}, EXACT {index._plan.fused_exact(index.scan_dtype)}, {walk} walk "
        f"({tiles if tiles is not None else n_tiles} of {n_tiles} tiles); dedup "
        f"{index._has_replicas()}; device memory peak {torch.cuda.max_memory_allocated(dev)} B")
    params = MstgSearchParams(top_k=s["top_k"], ef_search=ef, pruning_epsilon=s["pruning_epsilon"])
    k1 = chip_smoke.check_bin_scan_run(
        lambda: index.batch_search(queries_np[: s["batch_size"]], params),
        f"MSTG reference defaults ef={ef}", walk, index=index)
    print(json.dumps({"ok": True, "lists": index.posting_list_count(), "recall_at_10": recall,
                      "walk": walk, "build_s": build_s, "k1": k1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
