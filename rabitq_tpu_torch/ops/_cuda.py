"""Build and load the port's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` exposes plain C entry points. It is compiled
at first use with ``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so``
(the hash is of the source and the shared headers ``csrc/*.cuh``, so an
edited kernel rebuilds) and loaded with ``ctypes``; no PyTorch headers are involved, so a build takes seconds.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Wrappers pass tensor pointers (``data_ptr()``) and the current CUDA stream
as ``c_void_p``; every entry point returns ``cudaGetLastError()`` after its
launch, and :func:`check_launch` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fht", "fused_bin_scan", "packed_bin_scan", "packed_lb_scan", "build_sums")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# entry point -> (source, C symbol, argtypes in order)
_SIGNATURES = {
    "fht": ("fht", "rabitq_fht", (_P, _P, _L, _I, _P)),
    "fused_bin_scan": ("fused_bin_scan", "rabitq_bin_scan", (_P,) * 13 + (_I,) * 6 + (_P,)),
    "packed_bin_scan": (
        "packed_bin_scan", "rabitq_packed_bin_scan", (_P,) * 16 + (_I,) * 7 + (_P,),
    ),
    "packed_lb_scan": (
        "packed_lb_scan", "rabitq_packed_lb_scan", (_P,) * 7 + (_L, _I, _I, _P),
    ),
    "packed_lb_plane": (
        "packed_lb_scan", "rabitq_packed_lb_plane", (_P,) * 11 + (_L, _I, _I, _I, _P),
    ),
    "segment_sum": ("build_sums", "rabitq_segment_sum", (_P,) * 4 + (_L, _L, _I, _P)),
    "running_sum": ("build_sums", "rabitq_running_sum", (_P, _P, _L, _P)),
}

_entries: dict = {}  # kernel name -> (library, entry point)
_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found: put it on PATH or set CUDA_HOME")


def library_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every listed source that has no current library, one
    ``nvcc`` process per source, all started together. Returns
    ``{name: compiler log}`` (``-Xptxas -v`` register and shared-memory
    report; empty for a library that was already built). Raises
    :class:`KernelBuildError` naming every source that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [
            nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu"),
        ]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise KernelBuildError("kernel build failed: " + "\n".join(failed))
    return logs


def ptxas_report(log: str) -> list[dict]:
    """What ``-Xptxas -v`` said of each kernel in one build log: ``kernel``
    (mangled name), ``registers``, ``smem`` (static shared memory, bytes),
    ``spill_stores`` and ``spill_loads`` (bytes)."""
    out = []
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = dict(kernel=m.group(1), registers=0, smem=0, spill_stores=0, spill_loads=0)
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
    return out


def entry(name: str):
    """The C entry point ``name`` (its source built first if needed), with
    its argtypes set."""
    with _lock:
        loaded = _entries.get(name)
        if loaded is None:
            source, symbol, argtypes = _SIGNATURES[name]
            build_all((source,))
            lib = ctypes.CDLL(str(library_path(source)))
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            loaded = _entries[name] = (lib, fn)  # the library stays loaded
        return loaded[1]


def dynamic_shared_memory(name: str, *args: int) -> int:
    """Dynamic shared memory (bytes) a block of the tensor-core kernel behind
    entry point ``name`` takes, as its library says (``<C symbol>_smem_bytes``;
    ``args`` are that getter's int arguments, e.g. whether the query is int8)."""
    entry(name)
    fn = getattr(_entries[name][0], _SIGNATURES[name][1] + "_smem_bytes")
    fn.argtypes = [_I] * len(args)
    fn.restype = _I
    return fn(*args)


def check_inputs(want, device, what: str) -> None:
    """Raise unless every ``(tensor, dtype)`` of ``want`` is a contiguous
    tensor of that dtype on CUDA device ``device``."""
    for t, dtype in want:
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{what} inputs must all lie on one CUDA device")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what} needs contiguous {dtype}, got {t.dtype}")


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
