"""Phase times of the long-row selection kernel on the card.

Builds a copy of ``rabitq_tpu_torch/csrc/select.cu`` with ``%globaltimer``
stamps at the phase boundaries of cluster 0's first block (its local
histogram pass, the cluster barrier, the histogram merge and digit pick, the
collection, the wave's barrier and the ordering of its winners) into
``rabitq_tpu_torch/_build/``, runs it on survivor-like planes of [256,
1,000,064] (negated distances 1000 +- 50: 94% -inf or all finite; bf16 and
f32) with k = 400, checks the indices against the plain version, and prints
the mean microseconds of each phase a row. Needs nvcc and one card:

    PYTHONPATH=. python3 tools/select_trace.py

The stamps are placed after fixed lines of the kernel's source; an edit that
moves one fails the build here with the line it looked for.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from rabitq_tpu_torch.ops import _cuda, select

STAMPS = (  # (tag, the source line the stamp follows)
    (1, "        const bool incomplete = __syncthreads_or(short_of_slots);"
        "  // some keys off the hint not buffered\n"),
    (2, "        cluster.sync();\n        for (int i = t; i < RADIX; i += THREADS) {"
        "  // every block's bin i, all loads in flight\n"),
    (3, "        const uint32_t d = pick[0], below = pick[1], in_bin = pick[2];\n"),
    (5, "    cluster.sync();  // the wave's candidates and meta are written\n"),
    (6, "      __syncthreads();  // shared memory is written again by the next wave\n"),
)
PHASES = {0: "start", 1: "local histogram", 2: "cluster barrier", 3: "merge + pick",
          4: "collect", 5: "wave barrier", 6: "order winners"}
STAMP = r'''
__device__ unsigned long long trace_buf[2048];
#define TRACE(tag) do { if (blockIdx.x == 0 && threadIdx.x == 0 && trace_n < 2048) { \
  unsigned long long g_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_)); \
  trace_buf[trace_n++] = ((unsigned long long)(tag) << 56) | (g_ & ((1ull << 56) - 1)); } } while (0)
'''


def traced_source() -> str:
    src = (_cuda.CSRC / "select.cu").read_text()

    def after(line, text):
        nonlocal src
        if src.count(line) != 1:
            raise SystemExit(f"select_trace: the kernel no longer has this line once:\n{line}")
        src = src.replace(line, line + text)

    after("__device__ unsigned long long spilled_rows;"
          "  // rows that took the spill, since the last reset\n", STAMP)
    after("  int par = 0;\n", "  int trace_n = 0;\n  TRACE(0);\n")
    for tag, line in STAMPS:
        after(line, f"        TRACE({tag});\n")
    collect = "      if (rank == 0 && t == 0) {\n        m[1] = prefix;"
    if src.count(collect) != 1:
        raise SystemExit("select_trace: the kernel no longer writes a row's meta where expected")
    src = src.replace(collect, "      TRACE(4);\n" + collect)
    return src + ('\nextern "C" int rabitq_trace(void* out) { cudaError_t e = cudaMemcpyFromSymbol('
                  'out, trace_buf, sizeof trace_buf); static unsigned long long z[2048]; '
                  'if (e == cudaSuccess) e = cudaMemcpyToSymbol(trace_buf, z, sizeof z); '
                  'return (int)e; }\n')


def build():
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = _cuda.BUILD_DIR / "select_trace.cu", _cuda.BUILD_DIR / "libselect_trace.so"
    src.write_text(traced_source())
    cmd = [_cuda.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)]
    subprocess.run(cmd, check=True)
    so = ctypes.CDLL(str(lib))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    so.rabitq_top_k.argtypes = [p] * 7 + [ll, ll, i, i, i, i, p]
    so.rabitq_trace.argtypes = [p]
    return so


def trace(so, name, x, k):
    rows = x.contiguous()
    r, n = rows.shape
    plan = select.plan_for(rows, k)
    dev = rows.device
    values = torch.empty((r, k), dtype=x.dtype, device=dev)
    indices = torch.empty((r, k), dtype=torch.int32, device=dev)
    cand = torch.empty((plan.blocks, select.CAND), dtype=torch.int64, device=dev)
    meta = torch.empty((plan.blocks, select.META), dtype=torch.int32, device=dev)
    spill = [torch.empty((2, min(r, plan.blocks), k), dtype=torch.int32, device=dev)
             for _ in range(2)]
    buf = (ctypes.c_ulonglong * 2048)()
    for _ in range(3):  # the last run's stamps are kept
        so.rabitq_trace(ctypes.cast(buf, ctypes.c_void_p))
        err = so.rabitq_top_k(rows.data_ptr(), values.data_ptr(), indices.data_ptr(),
                              cand.data_ptr(), meta.data_ptr(), spill[0].data_ptr(),
                              spill[1].data_ptr(), r, n, k, plan.cluster, plan.clusters,
                              int(x.dtype == torch.bfloat16),
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"select_trace: launch failed ({err})")
        torch.cuda.synchronize()
    so.rabitq_trace(ctypes.cast(buf, ctypes.c_void_p))
    ok = torch.equal(indices, select.top_k_plain(x, k)[1])
    stamps = [(v >> 56, v & ((1 << 56) - 1)) for v in buf if v]
    sums, counts, npass = {}, {}, 0
    for (tag, t1), (_, t0) in zip(stamps[1:], stamps[:-1]):
        key = PHASES[tag]
        if tag == 1:
            npass += 1
            key = f"{key} {npass}"
        if tag in (4, 5):
            npass = 0
        sums[key] = sums.get(key, 0.0) + (t1 - t0) / 1e3
        counts[key] = counts.get(key, 0) + 1
    total = (stamps[-1][1] - stamps[0][1]) / 1e3
    parts = ", ".join(f"{key} {sums[key] / counts[key]:.2f} x{counts[key]}" for key in sums)
    print(f"trace {name} {tuple(x.shape)} k={k}: clusters of {plan.cluster}, "
          f"{plan.rows_in_flight} rows in flight; indices equal to the plain version: {ok}; "
          f"cluster 0's block 0: {total:.1f} us; mean us a row: {parts}", flush=True)
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("select_trace needs a CUDA device")
    so = build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    lb = -(1000.0 + 50.0 * torch.randn((256, 1_000_064), generator=g, device=dev))
    masked = torch.where(torch.rand(lb.shape, generator=g, device=dev) < 0.94, float("-inf"), lb)
    oks = [trace(so, "masked bf16", masked.to(torch.bfloat16), 400),
           trace(so, "finite bf16", lb.to(torch.bfloat16), 400),
           trace(so, "masked f32", masked, 400),
           trace(so, "finite f32", lb, 400)]
    print(torch.cuda.get_device_name(0))
    return 0 if all(oks) else 1


if __name__ == "__main__":
    raise SystemExit(main())
