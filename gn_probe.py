#!/usr/bin/env python3
"""Where B2a's time goes on the card: source-edited builds of
``diga_tpu_torch/csrc/group_norm.cu``, and a trace of B2a's device kernels.

    python3 gn_probe.py
    python3 gn_probe.py --trace [ROOT]

Run from the root of a checkout on a machine with the card (one H100).  The
first form builds these variants of the B2a kernel from the source in the
checkout (one nvcc each, in parallel, into ``diga_tpu_torch/_build/probe/``)
and, at the three path sites in bf16, prints:

  - ``probe empty``: the launch alone (every block returns at entry);
  - ``probe stream_only``: the launch and the read of x (every block
    returns when its rows are summed): the floor of any one-launch B2a at
    the site; ``stream_only_registers`` the same through registers;
  - ``probe full``: the kernel as the port builds it;
  - ``probe registers``: the register alternative, the same clusters and
    fold with the ring replaced by ``ROWS_IN_FLIGHT`` 16-byte loads per
    thread straight from device memory, four blocks a SM with only the
    scratch as shared memory (its own grid); ``registers_ring_grid`` the
    same loop at two blocks a SM with the ring's shared memory (the ring's
    grid);

each timed as ``chip_smoke.py`` phase 7 times B2a (CUDA events around
back-to-back calls queued behind a sleep kernel), and

  - ``probe steps``: the median ``clock64()`` cycles each block spends in
    each step of one call (streaming, the lanes' fold, the cluster
    exchange, the ticket, the fold), over all blocks and over the blocks
    that folded a slice, for ``full`` and ``registers``.

The variants exist only in the build directory; the port never loads them.

``--trace`` prints instead, per path site, B2a's device kernels of one call
from a torch.profiler trace (each kernel's duration, the gaps between them,
the call's span).  With ROOT, the package is imported from that checkout
(for example an older one whose B2a was two kernels).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

SITES = [(1, 129, 257, 256), (1, 65, 129, 256), (6, 65, 113, 256)]  # chip_smoke's three
SLEEP_CYCLES_PER_MS = 2_000_000  # torch.cuda._sleep at the H100's clock of at most 1.98 GHz
ROWS_IN_FLIGHT = 8  # the register alternative's 16-byte loads per thread
STEPS = ["entry", "stream end", "lanes in smem", "cluster wait", "row sent", "gathered",
         "slice written", "ticket", "fold loads", "fold combined", "group fold"]
STREAM_END = "  cluster_arrive_relaxed();  // this block's ring is free, its mbarrier initialised\n"
RING = "  T* ring = reinterpret_cast<T*>(smem);\n"
SMEM = ("  return kStages * kTileBytes > scratch_bytes(c, elem) ? kStages * kTileBytes\n"
        "                                                       : scratch_bytes(c, elem);\n")
BOUNDS = "__launch_bounds__(kThreads, 2)"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def edit(src: str, anchor: str, new: str) -> str:
    if src.count(anchor) != 1:
        raise SystemExit(f"gn_probe: anchor not found once in group_norm.cu: {anchor!r}")
    return src.replace(anchor, new)


def registers(src: str, own_grid: bool) -> str:
    """The ring's copy loop replaced by ROWS_IN_FLIGHT 16-byte loads per
    thread; with ``own_grid``, four blocks a SM and the scratch alone as
    shared memory."""
    u = ROWS_IN_FLIGHT
    loop = (
        "  {\n"
        "    const T* base = img + v * N;\n"
        "    int r = r0 + lane;\n"
        f"    for (; r + {u - 1} * lanes < r1; r += {u} * lanes) {{\n"
        f"      uint4 a[{u}];\n"
        "#pragma unroll\n"
        f"      for (int u = 0; u < {u}; ++u)\n"
        "        a[u] = __ldg(reinterpret_cast<const uint4*>(base + (long long)(r + u * lanes) * c));\n"
        "#pragma unroll\n"
        f"      for (int u = 0; u < {u}; ++u) accumulate<T>(a[u], s, s2);\n"
        "    }\n"
        "    for (; r < r1; r += lanes)\n"
        "      accumulate<T>(__ldg(reinterpret_cast<const uint4*>(base + (long long)r * c)), s, s2);\n"
        "  }\n\n")
    if src.count(RING) != 1 or src.count(STREAM_END) != 1:
        raise SystemExit("gn_probe: the ring's loop not found once in group_norm.cu")
    i, j = src.index(RING), src.index(STREAM_END)
    src = src[:i] + loop + src[j:]
    if own_grid:
        src = edit(src, SMEM, "  return scratch_bytes(c, elem);\n")
        src = edit(src, BOUNDS, "__launch_bounds__(kThreads, 4)")
    return src


def stream_only(src: str) -> str:
    """Every block returns when its rows are summed (the sums kept live)."""
    return edit(src, STREAM_END,
                "  float keep = 0.f;\n"
                "  for (int k = 0; k < N; ++k) keep += s[k] + s2[k];\n"
                "  if (keep == 1.2345f) part[tid] = keep;\n  return;\n" + STREAM_END)


def clocked(src: str) -> str:
    """clock64() per block at each step boundary, read back by gn_probe_read."""
    clk = edit(src, "namespace {\n\nconstexpr int kThreads",
               f"__device__ long long g_clk[16384][{len(STEPS)}];\n"
               "#define STEP(k) if (threadIdx.x == 0) "
               "g_clk[blockIdx.y * gridDim.x + blockIdx.x][k] = clock64();\n"
               "namespace {\n\nconstexpr int kThreads")
    marks = [
        ("  const int nv = c / N, lanes = blockDim.x / nv;\n", 0, True),
        (STREAM_END, 1, True),
        ("  __syncthreads();\n  cluster_wait();  // every peer's ring is free", 2, True),
        ("  cluster_wait();  // every peer's ring is free, its mbarrier initialised\n", 3, False),
        ("  mbar_wait(&gather, 0);  // every rank's row of this block's slice\n", 4, True),
        ("  mbar_wait(&gather, 0);  // every rank's row of this block's slice\n", 5, False),
        ("  unsigned* ticket = tickets + b * kCluster + rank;\n", 6, True),
        ("  if (!last) return;\n", 7, True),
        ("  __syncthreads();\n  for (int j = tid; j < cols; j += blockDim.x) {\n", 8, True),
        ("  const float* ts = reinterpret_cast<const float*>(red);", 9, True),
        ("  if (tid == 0) *ticket = 0;", 10, True),
    ]
    for anchor, k, before in marks:
        clk = edit(clk, anchor, f"  STEP({k})\n" + anchor if before else anchor + f"  STEP({k})\n")
    return clk + (
        '\nextern "C" int gn_probe_read(void* host, int n) {\n'
        "  cudaError_t e = cudaDeviceSynchronize();\n  if (e != cudaSuccess) return (int)e;\n"
        f"  return (int)cudaMemcpyFromSymbol(host, g_clk, (size_t)n * {len(STEPS)} * 8);\n}}\n"
        'extern "C" int gn_probe_clear() {\n  void* p;\n'
        "  cudaError_t e = cudaGetSymbolAddress(&p, g_clk);\n"
        "  if (e != cudaSuccess) return (int)e;\n"
        "  return (int)cudaMemset(p, 0, sizeof(g_clk));\n}\n")


def variants(src: str) -> dict:
    reg = registers(src, own_grid=True)
    return {
        "full": src,
        "empty": edit(src, "  float s[N], s2[N];\n",
                      "  if (hw < 0) part[0] = 0.f;\n  return;\n  float s[N], s2[N];\n"),
        "stream_only": stream_only(src),
        "stream_only_registers": stream_only(reg),
        "registers": reg,
        "registers_ring_grid": registers(src, own_grid=False),
        "clock": clocked(src),
        "clock_registers": clocked(reg),
    }


def build(srcs: dict, build_dir: str, nvcc: str, flags: list) -> dict:
    os.makedirs(build_dir, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        cu = os.path.join(build_dir, f"gn_{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen([nvcc, *flags, "-o", cu[:-3] + ".so", cu],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"gn_probe: nvcc failed for {name}:\n{log}")
        for line in log.splitlines():
            if "gn_stats_kernel" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}")
        libs[name] = os.path.join(build_dir, f"gn_{name}.so")
    return libs


def site_inputs(shape, gen):
    """Enough seeded bf16 copies of x to exceed the 50 MB L2 when cycled,
    and f32 scale/bias."""
    import torch

    c = shape[-1]
    n_buf = max(2, -(-int(120e6) // (int(np.prod(shape)) * 2)))
    xs = [(torch.randn(shape, generator=gen, device="cuda") + 1.0).to(torch.bfloat16)
          for _ in range(n_buf)]
    sc = torch.rand(c, generator=gen, device="cuda") + 0.5
    bi = torch.randn(c, generator=gen, device="cuda") * 0.1
    return xs, sc, bi


def trace(card: str, n_calls: int = 20) -> None:
    """B2a's device kernels per call at the path sites, from a torch.profiler
    trace of ``n_calls`` back-to-back bf16 calls queued behind a sleep
    kernel (cold L2): each kernel's mean duration, the gap between
    consecutive kernels of one call, the call's span (first start to last
    end) and the gap between calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diga_tpu_torch.ops import group_norm as G

    print(f"gn_trace package {os.path.dirname(G.__file__)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in SITES:
        xs, sc, bi = site_inputs(shape, gen)
        with torch.inference_mode():
            for x in xs:  # warm-up: build, plan, workspace
                G.group_norm_stats(x, sc, bi)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(int(10 * SLEEP_CYCLES_PER_MS))
                for i in range(n_calls):
                    G.group_norm_stats(xs[i % len(xs)], sc, bi)
                torch.cuda.synchronize()
        with tempfile.TemporaryDirectory(prefix="gn_trace_") as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        kernels = sorted((e for e in events if e.get("cat") == "kernel"
                          and "spin_kernel" not in e["name"]), key=lambda e: e["ts"])
        del xs
        if not kernels or len(kernels) % n_calls:
            print(f"gn_trace shape={shape}: {len(kernels)} kernel records for {n_calls} calls "
                  f"(records lost) | card={card}", flush=True)
            continue
        k = len(kernels) // n_calls
        calls = [kernels[i * k:(i + 1) * k] for i in range(n_calls)]
        names = [(re.search(r"\b(\w+_kernel)\b", e["name"]) or re.match(r".{0,40}", e["name"]))[0]
                 for e in calls[0]]
        end = [[e["ts"] + e["dur"] for e in c] for c in calls]
        durs = [float(np.mean([c[j]["dur"] for c in calls])) for j in range(k)]
        gaps = [float(np.mean([c[j + 1]["ts"] - end[i][j] for i, c in enumerate(calls)]))
                for j in range(k - 1)]
        span = float(np.mean([end[i][-1] - c[0]["ts"] for i, c in enumerate(calls)]))
        between = float(np.mean([calls[i + 1][0]["ts"] - end[i][-1] for i in range(n_calls - 1)]))
        print(f"gn_trace shape={shape} bf16 torch.profiler {n_calls} back-to-back calls, us: "
              + ", ".join(f"{n} {d:.2f}" for n, d in zip(names, durs))
              + f"; gap inside a call {[round(g, 2) for g in gaps]}; call span {span:.2f}; "
              f"gap between calls {between:.2f} | card={card}", flush=True)


def probe(card: str) -> None:
    import torch

    import chip_smoke as S
    from diga_tpu_torch.ops import group_norm as G
    from diga_tpu_torch.ops import native

    def use(path: str) -> ctypes.CDLL:
        """Route the wrapper to a variant's library (its own occupancy,
        so its own grid and shared-memory allowance)."""
        lib = ctypes.CDLL(path)
        native._loaded["group_norm"] = lib
        G._lib.cache_clear()
        G.max_clusters.cache_clear()
        return lib

    with open(os.path.join(native.CSRC_DIR, native.SOURCES["group_norm"])) as f:
        libs = build(variants(f.read()), os.path.join(native.BUILD_DIR, "probe"),
                     native.nvcc(), native.NVCC_FLAGS)
    gen = torch.Generator(device="cuda").manual_seed(S.SEED)
    sites = {shape: site_inputs(shape, gen) for shape in SITES}
    fn = G.group_norm_stats
    for name in ("empty", "stream_only", "stream_only_registers", "full", "registers",
                 "registers_ring_grid"):
        use(libs[name])
        for shape, (xs, sc, bi) in sites.items():
            with torch.inference_mode():
                fn(xs[0], sc, bi)
                t = S.time_us(fn, [(x, sc, bi) for x in xs])[0]
            print(f"probe {name} shape={shape} bf16: {t:.2f} us (events, back-to-back) "
                  f"| grid {S.gn_plan(xs[0]).grid} | card={card}", flush=True)
    for name in ("clock", "clock_registers"):
        lib = use(libs[name])
        lib.gn_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for shape, (xs, sc, bi) in sites.items():
            with torch.inference_mode():
                fn(xs[0], sc, bi)
                plan = S.gn_plan(xs[0])
                n = plan.chunks * plan.batch
                torch.cuda.synchronize()
                if lib.gn_probe_clear():
                    raise SystemExit("gn_probe: clearing the clock stamps failed")
                torch.cuda._sleep(int(2 * SLEEP_CYCLES_PER_MS))
                fn(xs[1], sc, bi)
                buf = np.zeros((n, len(STEPS)), np.int64)
                if lib.gn_probe_read(buf.ctypes.data, n):
                    raise SystemExit("gn_probe: reading the clock stamps failed")
            # every block stamps steps 0-7; the blocks that fold a slice, all
            d = np.diff(buf.astype(np.float64), axis=1)
            folded = buf[:, -1] != 0
            cells = []
            for k in range(len(STEPS) - 1):
                seen = buf[:, k + 1] != 0
                all_k = np.median(d[seen, k]) if seen.any() else float("nan")
                fold_k = np.median(d[folded, k]) if folded.any() else float("nan")
                cells.append(f"{STEPS[k]} -> {STEPS[k + 1]} {all_k:.0f} | {fold_k:.0f}")
            print(f"probe steps {name} shape={shape} grid={plan.grid}, clock64 cycles, median "
                  f"over all blocks | the {int(folded.sum())} folding blocks: " + "; ".join(cells)
                  + f" | card={card}", flush=True)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True)
    print(f"probe sm clock after the run: {clocks.stdout.strip()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", nargs="?", const="", default=None, metavar="ROOT",
                    help="trace B2a's device kernels per call instead; with ROOT, of the "
                         "package in that checkout")
    args = ap.parse_args(argv)
    if args.trace:
        sys.path.insert(0, os.path.abspath(args.trace))
    import torch

    if not torch.cuda.is_available():
        print("gn_probe: torch.cuda.is_available() is False; this script runs on the card",
              file=sys.stderr)
        return 1
    card = card_line()
    if args.trace is not None:
        trace(card)
    else:
        probe(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
