#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process:

    python3 portbench/limits.py --workload <cell> --seeds <n> [<n> ...] \
        --control-seeds <n> [<n> ...] [--seconds <s>] [--out <file.jsonl>]

For each seed, one run of the cell (a short window at the cell's own load
and sizes) through the program as configured, and for each control seed one
run of its control: the program with its next lower precision switched on
(``CONTROL``: int8 query uploads become int4). Prints the compared numbers
of every run, then the lower reading (the worst the program gave) and the
upper reading (the best the control gave) of each. The benchmark's own runs
never run the control.
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CONTROL = {"serving": {"upload_dtype": {"int8": "int4"}}}  # the step below each stated precision


def control_config(config: dict) -> dict:
    """``config`` with each stated precision in ``CONTROL`` one step lower."""
    out = copy.deepcopy(config)
    for group, keys in CONTROL.items():
        for key, lower in keys.items():
            if out[group][key] in lower:
                out[group][key] = lower[out[group][key]]
    return out


def readings(results: list, side: str) -> dict:
    """Each number's reading over one side's ``results``: for the program
    the worst (the lowest of a floor, the highest of a ceiling), for the
    control the one nearest to passing (the highest of a floor, the lowest
    of a ceiling)."""
    out = {}
    for name, check in results[0]["checks"].items():
        vals = [r["checks"][name]["value"] for r in results]
        floor = check["limit"].startswith(">=")
        out[name] = (min if floor == (side == "program") else max)(vals)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, spec

    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    control = copy.copy(cell)
    control.config = control_config(cell.config)
    sides = {"program": [], "control": []}
    out = open(args.out, "a") if args.out else None
    for side, c, seeds in (("program", cell, args.seeds), ("control", control, args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            r = harness.run_cell(c, seed, args.seconds, False, device, time.perf_counter())
            line = {"cell": cell.name, "side": side, "seed": seed, "correct": r["correct"],
                    "numbers": {k: v["value"] for k, v in r["checks"].items()},
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
            sides[side].append(r)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    summary = {side: readings(rs, side) for side, rs in sides.items() if rs}
    print(json.dumps({"cell": cell.name, "readings": summary}), flush=True)
    if out:
        out.write(json.dumps({"cell": cell.name, "readings": summary}) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
