"""One run of one cell: set-up, the measured window, the traced sub-window,
the check against the reference, and the result line."""

from __future__ import annotations

import copy
import gc
import math
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import data, generator, judge, roofline, spec
from portbench import trace as trace_mod


@dataclass
class Context:
    """What a kind of call gets: the configuration and mix as run, the
    program's module, the rows on the device, the query sets on the host
    ([sets, n, D] f32) and the run's generator for further draws."""

    config: dict
    mix: dict
    program: object
    device: torch.device
    rows: torch.Tensor
    queries: np.ndarray
    gen: torch.Generator


@dataclass
class Run:
    """What a metric reader reads (``metrics/<name>.py``: ``read(run)``)."""

    cell: str
    config: dict
    mix: dict
    on_card: bool
    setup_s: float
    window: generator.Window
    counters: dict = field(default_factory=dict)
    numbers: dict = field(default_factory=dict)  # the compared numbers (judge)
    trace: trace_mod.Trace | None = None
    traced_window: generator.Window | None = None
    roofline: dict | None = None  # probes, cluster sizes, dim, k of the traced blocks


def rehearsal_config(config: dict) -> dict:
    """A configuration or mix with its ``rehearsal`` values, for a run on
    the CPU."""
    out = copy.deepcopy(config)
    for key, value in config.get("rehearsal", {}).items():
        if isinstance(value, dict):
            out[key].update(value)
        else:
            out[key] = value
    return out


def device_entry(device: torch.device, peak) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": None}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float) -> dict:
    """Run ``cell`` once; returns the result object (``checks`` last).
    ``t_start`` is the host clock at the process's start: set-up counts
    from it."""
    config, mix = cell.config, cell.mix
    if device.type != "cuda":
        config, mix = rehearsal_config(config), rehearsal_config(mix)
    program = spec.program_kind(config["index"]["kind"])
    kind = spec.call_kind(mix["call"])
    k = config["serving"]["top_k"]

    g = data.generator(seed, device)
    ds = config["dataset"]
    rows, queries = data.blobs(ds, mix["query_sets"] * ds["queries"], g, device)
    queries = queries.cpu().numpy().reshape(mix["query_sets"], ds["queries"], ds["dim"])
    ctx = Context(config, mix, program, device, rows, queries, g)
    calls = kind.Calls(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    window = generator.closed_loop(calls, seconds)
    print(window.summary(), file=sys.stderr)
    run = Run(cell.name, config, mix, device.type == "cuda", setup_s, window, calls.counters())
    if trace:
        run.trace, run.traced_window = generator.traced(
            calls, mix["traced_calls"], len(window.calls), device)
    try:
        check_queries, groups = calls.finish()
    except Exception:  # noqa: BLE001 - a run whose answers cannot be read is judged incorrect
        traceback.print_exc(file=sys.stderr)
        check_queries, groups = queries.reshape(-1, ds["dim"]), []
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    member = program.membership(calls.index) if trace and calls.index is not None else None
    del calls, ctx
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    failed = window.attempted - window.answered
    if run.traced_window is not None:
        failed += run.traced_window.attempted - run.traced_window.answered
    q_dev = torch.as_tensor(np.ascontiguousarray(check_queries, np.float32), device=device)
    run.numbers = judge.measure(rows, q_dev, groups, k, failed)  # no answers: recall 0
    checks = judge.checks(run.numbers, config["limits"])
    if run.on_card and member is not None and run.trace.blocks:
        means, sizes = roofline.cluster_means(rows, member["row_ids"], member["cluster_of"],
                                              member["n_clusters"])
        run.roofline = {"probes": roofline.probes(q_dev, means, config["serving"]["nprobe"]),
                        "sizes": sizes, "dim": member["dim"], "k": k}

    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec.metric_reader(m["name"])(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(c["ok"] for c in checks.values()),
        "attempted": window.attempted + (run.traced_window.attempted if trace else 0),
        "failed": failed,
        "metrics": metrics,
        "device": device_entry(device, peak),
    }
    if trace and run.on_card:
        result["device"]["busy_s"] = trace_mod.busy_s(run.trace)
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": trace_mod.top(trace_mod.device_ops(run.trace)),
                               "idle_gaps": trace_mod.top(trace_mod.idle_gaps(run.trace))}
    result["checks"] = checks
    return result
