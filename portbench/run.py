#!/usr/bin/env python3
"""Run one cell of the benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``. With
``--trace 0`` the result reports the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the device's busy and window
seconds. The last line of standard output is the result as one JSON object;
the last lines of standard error are each compared number beside its limit.
It needs as many CUDA devices as the cell asks for and exits with code 2
without them. ``--rehearse`` runs the cell on the CPU at the configuration's
``rehearsal`` sizes through the program's plain versions of its kernels: the
device is then named ``cpu`` and no device metric is written.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402 - set-up is timed from the first line
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rabitq_tpu")  # top-level module names


def forbidden_modules(names=None) -> list:
    """Module names (default: the loaded modules) whose top-level name, the
    part before the first dot, is one of ``FORBIDDEN``, compared whole."""
    return sorted({name.split(".")[0] for name in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, spec

    cell = spec.load_cell(args.workload)
    if args.rehearse:
        device = torch.device("cpu")
    elif not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); found {count}",
              file=sys.stderr)
        return 2
    else:
        device = torch.device("cuda", 0)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules loaded that the port must not load: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']}) {'ok' if c['ok'] else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
