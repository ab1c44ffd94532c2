"""Run the event-loop kernels of `csrc/event_loop.cu` on the CPU.

    python3 scripts/emulate_event_loop.py [--cases 16 8 4] [--hand 6]
        [--routes warp block] [--json rows.json] [--sanitize thread]

The CUDA source compiles only where `nvcc` is. This script compiles it
with g++ (C++20) against a stub CUDA runtime instead: each block runs its
threads as `std::thread`s; `__syncthreads` and `__syncwarp` are
`std::barrier`s of the block and of the warp; the warp intrinsics
(`__shfl_sync`, `__shfl_xor_sync`, `__ballot_sync`, `__all_sync`,
`__any_sync`, `__reduce_max_sync`, `__reduce_min_sync`) exchange each lane's value through relaxed atomics
between fences, which order nothing else for ThreadSanitizer, and abort
on a mask that leaves the calling lane out or that its lanes name
differently; `__popc`, `__ffs`, `__clz` and the bit casts are the
builtins; a `cp.async` read-ahead is a plain copy; `__dmul_rn` and its kin
are the plain operators, built with `-ffp-contract=off`; dynamic shared
memory is a per-block buffer filled with garbage. It then runs small
sweeps of `chip_smoke.py`'s phase-6 suites through `executor="device"` on
the CPU (`--cases` for `table2_trace`, `stress_trace`, `stress_live`; 0
skips one), records every event-loop call of the device engines, adds
with `--hand` phase 2's hand-made batches at that many cases each
(`chip_smoke.hand_event_batches`, two of them above the warp route's 32
lanes), and passes each call through the emulated launch functions on
each route of `--routes`: end clocks and step counts must equal the
plain version's bit for bit, a flagged call (a horizon overflow, the
step guard) must raise the same error from both, and the warp route must
refuse a case too large for it. `--json` writes one row a call and
route. It exits non-zero on any difference.

`--sanitize thread` builds with ThreadSanitizer, which reports a data
race between the emulated threads, as a missing `__syncthreads` or
`__syncwarp` gives (a shuffle or a vote does not stand in for one); run
the script with `LD_PRELOAD=$(g++ -print-file-name=libtsan.so)` then
(`address` and libasan likewise). Needs g++ 11 or later; nothing here
needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.core.engine import device_stepper  # noqa: E402
from repro_torch.kernels import build, event_loop  # noqa: E402
from repro_torch.sim.sweep import run_sweep  # noqa: E402

STUB = r'''
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#include <math.h>

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename K>
inline int cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
inline int cudaGetLastError() { return 0; }

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)

struct Dim { int x = 0, y = 0; };
struct EmuBlock {
  std::barrier<> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  std::vector<uint64_t> votes;                    // __syncthreads_and / _or
  std::unique_ptr<std::atomic<uint64_t>[]> slots;  // 2 a thread: a warp
  std::unique_ptr<std::atomic<unsigned>[]> masks;  // intrinsic's values
  std::unique_ptr<std::atomic<uint64_t>[]> arrived;  // a warp's arrivals
  explicit EmuBlock(int n)
      : bar(n), votes(n), slots(new std::atomic<uint64_t>[2 * n]),
        masks(new std::atomic<unsigned>[2 * n]),
        arrived(new std::atomic<uint64_t>[n / 32]) {
    for (int w = 0; w < n / 32; ++w) {
      warp_bars.push_back(std::make_unique<std::barrier<>>(32));
      arrived[w].store(0);
    }
  }
};
inline thread_local Dim threadIdx, blockIdx, blockDim, gridDim;
inline thread_local EmuBlock* emu_block = nullptr;
inline thread_local char* emu_smem = nullptr;
inline thread_local uint64_t emu_calls = 0;   // this thread's warp intrinsics

inline void __syncthreads() { emu_block->bar.arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_block->warp_bars[threadIdx.x >> 5]->arrive_and_wait();
}
inline int __syncthreads_and(int p) {
  emu_block->votes[threadIdx.x] = p != 0;
  __syncthreads();
  int r = 1;
  for (uint64_t v : emu_block->votes) r &= (int)v;
  __syncthreads();
  return r;
}
inline int __syncthreads_or(int p) {
  emu_block->votes[threadIdx.x] = p != 0;
  __syncthreads();
  int r = 0;
  for (uint64_t v : emu_block->votes) r |= (int)v;
  __syncthreads();
  return r;
}

// A warp intrinsic: every lane of the warp posts its value and the mask it
// names, waits for the others and reads what it needs (`f` over the warp's
// 32 slots). The values go through relaxed atomics between fences, which
// ThreadSanitizer does not take for synchronisation: as on the card, only
// __syncwarp and __syncthreads order the kernel's own memory. The slots
// alternate between two rows, so a lane that runs ahead to the next
// intrinsic overwrites nothing still read. A mask that leaves the lane out,
// or that a lane in it names otherwise, aborts: CUDA leaves the result
// undefined.
template <typename T>
inline uint64_t emu_bits(T v) {
  uint64_t b = 0;
  std::memcpy(&b, &v, sizeof(T));
  return b;
}
template <typename T>
inline T emu_as(uint64_t b) {
  T v;
  std::memcpy(&v, &b, sizeof(T));
  return v;
}
template <typename T, typename F>
inline auto emu_warp(unsigned mask, T v, F f) {
  const int lane = threadIdx.x & 31, base = threadIdx.x - lane;
  const int row = (int)(emu_calls++ & 1) * blockDim.x;
  EmuBlock& blk = *emu_block;
  blk.slots[row + threadIdx.x].store(emu_bits(v), std::memory_order_relaxed);
  blk.masks[row + threadIdx.x].store(mask, std::memory_order_relaxed);
  std::atomic_thread_fence(std::memory_order_release);
  std::atomic<uint64_t>& arrived = blk.arrived[threadIdx.x >> 5];
  arrived.fetch_add(1, std::memory_order_relaxed);
  while (arrived.load(std::memory_order_relaxed) < 32 * emu_calls)
    std::this_thread::yield();
  std::atomic_thread_fence(std::memory_order_acquire);
  if (!(mask >> lane & 1)) { std::fprintf(stderr, "lane not in mask\n"); std::abort(); }
  uint64_t vals[32];
  for (int i = 0; i < 32; ++i) {
    vals[i] = blk.slots[row + base + i].load(std::memory_order_relaxed);
    if ((mask >> i & 1)
        && blk.masks[row + base + i].load(std::memory_order_relaxed) != mask) {
      std::fprintf(stderr, "lanes of one mask name different masks\n");
      std::abort();
    }
  }
  return f(vals, lane);
}
template <typename T>
inline T __shfl_xor_sync(unsigned mask, T v, int o) {
  return emu_warp(mask, v, [&](const uint64_t* s, int lane) {
    return emu_as<T>(s[(lane ^ o) & 31]); });
}
template <typename T>
inline T __shfl_sync(unsigned mask, T v, int src) {
  return emu_warp(mask, v, [&](const uint64_t* s, int) {
    return emu_as<T>(s[src & 31]); });
}
inline unsigned __ballot_sync(unsigned mask, int p) {
  return emu_warp(mask, (uint64_t)(p != 0), [&](const uint64_t* s, int) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r |= (unsigned)((mask >> i & 1) && s[i]) << i;
    return r; });
}
inline int __all_sync(unsigned mask, int p) {
  return __ballot_sync(mask, p) == mask;
}
inline int __any_sync(unsigned mask, int p) {
  return __ballot_sync(mask, p) != 0;
}
inline unsigned __reduce_max_sync(unsigned mask, unsigned v) {
  return emu_warp(mask, v, [&](const uint64_t* s, int) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i)
      if (mask >> i & 1) r = std::max(r, emu_as<unsigned>(s[i]));
    return r; });
}
inline unsigned __reduce_min_sync(unsigned mask, unsigned v) {
  return emu_warp(mask, v, [&](const uint64_t* s, int) {
    unsigned r = ~0u;
    for (int i = 0; i < 32; ++i)
      if (mask >> i & 1) r = std::min(r, emu_as<unsigned>(s[i]));
    return r; });
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline long long __double_as_longlong(double x) { return emu_as<long long>(emu_bits(x)); }
inline double __longlong_as_double(long long x) { return emu_as<double>(emu_bits(x)); }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
using std::max;
using std::min;

template <typename K, typename... A>
void emu_launch(K kernel, int blocks, int threads, size_t smem, A... args) {
  for (int b = 0; b < blocks; ++b) {
    EmuBlock blk(threads);
    std::vector<char> mem(smem + 64, (char)0x7f);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx.x = t; blockIdx.x = b; blockDim.x = threads;
        gridDim.x = blocks; gridDim.y = 1;
        emu_block = &blk; emu_smem = mem.data();
        kernel(args...);
      });
    for (auto& th : ts) th.join();
  }
}
'''


def emulated_source() -> str:
    """event_loop.cu with its shared buffer and launches made the stub's."""
    src = (build.CSRC / "event_loop.cu").read_text()
    src = src.replace("extern __shared__ double smem[];",
                      "double* smem = (double*)emu_smem;")
    src, n = re.subn(r"(\w+_kernel)<<<([^,]+), ([^,]+), ([^,]+), "
                     r"\(cudaStream_t\)stream>>>\(",
                     r"emu_launch(\1, \2, \3, \4, ", src)
    if n != 4:
        raise RuntimeError(f"found {n} launches to rewrite, not 4")
    return src


def compile_library(out: Path, sanitize: str | None) -> ctypes.CDLL:
    (out / "cuda_runtime.h").write_text(STUB)
    (out / "event_loop_emu.cpp").write_text(emulated_source())
    cmd = ["g++", "-std=c++20", "-O1", "-g", "-ffp-contract=off", "-fPIC",
           "-shared", "-pthread", f"-I{out}", str(out / "event_loop_emu.cpp"),
           "-o", str(out / "libemu.so")]
    if sanitize:
        cmd.insert(1, f"-fsanitize={sanitize}")
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(str(out / "libemu.so"))
    build._bind_event_loops(lib)
    return lib


def emulate(lib, name: str, ctx, tables, t0, guard: int,
            route: str) -> np.ndarray | None:
    """One call through the emulated launch function on `route`, on CPU
    pointers; None where the launch function refuses the route."""
    num_nodes = ctx.stack.shape[2]
    t = torch.from_numpy(np.ascontiguousarray(t0, dtype=np.float64))
    code = event_loop.ROUTES[route]
    if name == "round_events":
        hu, hv = (event_loop.node_table(a, num_nodes, "hops")
                  for a in tables[:2])
        nh = np.ascontiguousarray(tables[2], dtype=np.int32)
        B, R, T, H = hu.shape
        out = torch.full((3, R, B), -7.0, dtype=torch.float64)
        err = lib.round_events_launch(
            *event_loop._ctx_args(ctx), ctx.shares.data_ptr(),
            *event_loop._shape_args(ctx, B), hu.ctypes.data, hv.ctypes.data,
            nh.ctypes.data, R, T, H, t.data_ptr(), guard, out.data_ptr(),
            code, None)
    else:
        c, p = (event_loop.node_table(a, num_nodes, "edges")
                for a in tables[:2])
        d = np.ascontiguousarray(tables[2], dtype=np.int32)
        v = np.ascontiguousarray(tables[3], dtype=np.uint8)
        B, E = c.shape
        out = torch.full((3, 1, B), -7.0, dtype=torch.float64)
        err = lib.pipeline_events_launch(
            *event_loop._ctx_args(ctx), ctx.duplex.data_ptr(),
            ctx.shares.data_ptr(), *event_loop._shape_args(ctx, B),
            c.ctypes.data, p.ctypes.data, d.ctypes.data, v.ctypes.data, E,
            t.data_ptr(), guard, out.data_ptr(), code, None)
    if err == 1 and route == "warp":       # cudaErrorInvalidValue
        return None
    if err:
        raise RuntimeError(f"{name}: emulated launch returned {err}")
    return out.numpy()


def recorded_calls(cases) -> list:
    """Every event-loop call of the device engines in small CPU sweeps of
    phase 6's suites: (name, label, ctx, tables, t0, guard, plain packed
    output)."""
    calls = []
    original = device_stepper._EngineBase._events

    def events(self, loop, *tables, t0):
        def recording(ctx, *args, guard, **kwargs):
            packed = loop(ctx, *args, guard=guard, **kwargs)
            calls.append((loop.__name__, f"{suite} call {len(calls)}", ctx,
                          tuple(np.array(a) for a in args[:-1]),
                          np.array(args[-1]), guard, packed.numpy().copy()))
            return packed
        recording.__name__ = loop.__name__
        return original(self, recording, *tables, t0=t0)

    device_stepper._EngineBase._events = events
    try:
        for suite, n in zip(chip_smoke.SWEEP_SUITES, cases):
            if n:
                chip_smoke.SWEEP_SUITES[suite]["cases"] = n
                run_sweep(chip_smoke.make_suite(suite), executor="device",
                          device="cpu")
    finally:
        device_stepper._EngineBase._events = original
    return calls


def hand_calls(cases: int) -> list:
    """`chip_smoke.py`'s hand-made batches of phase 2 at `cases` cases,
    with the plain version's packed outputs, as `recorded_calls`."""
    calls = []
    for name, ctx, tables, t0, label, guard, _ in \
            chip_smoke.hand_event_batches("cpu", cases):
        want = chip_smoke.WRAPPERS[name](ctx, *tables, t0, guard=guard)
        calls.append((name, label, ctx, tables, t0, guard, want.numpy()))
    return calls


def raised(flags: np.ndarray) -> str | None:
    try:
        event_loop.check_flags(flags)
    except RuntimeError as e:
        return type(e).__name__
    return None


def check(lib, call, route: str) -> dict:
    """One call on one route against the plain version's output."""
    name, label, ctx, tables, t0, guard, want = call
    got = emulate(lib, name, ctx, tables, t0, guard, route)
    lanes = chip_smoke.event_lanes(name, tables)
    fits = event_loop.warp_route_fits(lanes, ctx.stack.shape[2])
    row = dict(name=name, label=label, route=route, lanes=lanes,
               shape=list(want.shape))
    if route == "warp" and (got is None or not fits):
        row.update(result="refused" if got is None else "took a case too "
                   "large for the warp route", same=got is None and not fits)
        return row
    flagged = raised(want[event_loop.FLAGS])
    if flagged:
        row.update(same=raised(got[event_loop.FLAGS]) == flagged,
                   result=f"raised {flagged}")
    else:
        row.update(same=bool(np.array_equal(got, want)),
                   result=f"chain {chip_smoke.event_steps(want)} steps")
    return row


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cases", type=int, nargs=3, default=[16, 8, 4],
                        help="cases of each phase-6 suite's sweep (0: none)")
    parser.add_argument("--hand", type=int, default=0,
                        help="also phase 2's hand-made batches at this "
                        "many cases each")
    parser.add_argument("--routes", nargs="+", default=list(event_loop.ROUTES),
                        choices=list(event_loop.ROUTES))
    parser.add_argument("--sanitize", choices=("thread", "address"))
    parser.add_argument("--json", type=Path, help="write every row here")
    args = parser.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        lib = compile_library(Path(tmp), args.sanitize)
        for n, m in ((0, 1), (13, 14), (300, 70)):
            if (lib.round_events_smem(n, m)
                    != event_loop.round_smem_bytes(n, m)
                    or lib.pipeline_events_smem(n, m)
                    != event_loop.pipeline_smem_bytes(n, m)):
                raise SystemExit("shared-memory sizes differ")
        calls = recorded_calls(args.cases)
        if args.hand:
            calls += hand_calls(args.hand)
        rows = []
        for call in calls:
            for route in args.routes:
                row = check(lib, call, route)
                rows.append(row)
                print(f"{row['name']} {row['label']} {tuple(row['shape'])} "
                      f"{route}: {row['result']}"
                      + ("" if row["same"] else " / DIFFERS"))
    bad = sum(not row["same"] for row in rows)
    print(f"{len(calls)} calls on {len(args.routes)} routes, {bad} differ")
    if args.json:
        args.json.write_text(json.dumps(rows, indent=1))
    if bad or not calls:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
