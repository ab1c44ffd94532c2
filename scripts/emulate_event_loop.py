"""Run the event-loop kernels of `csrc/event_loop.cu` on the CPU.

    python3 scripts/emulate_event_loop.py [--cases 16 8 4] [--sanitize thread]

The CUDA source compiles only where `nvcc` is. This script compiles it
with g++ (C++20) against a stub CUDA runtime instead: each block runs its
threads as `std::thread`s joined by a `std::barrier`; `__syncthreads_and`
/ `_or` and `__shfl_xor_sync` exchange through an array between two
barrier waits; `__dmul_rn` and its kin are the plain operators, built with
`-ffp-contract=off`; dynamic shared memory is a per-block buffer filled
with garbage. It then runs small sweeps of `chip_smoke.py`'s phase-6
suites through `executor="device"` on the CPU (`--cases` for
`table2_trace`, `stress_trace`, `stress_live`), records every event-loop
call of the device engines, and passes each through the emulated launch
functions: end clocks and step counts must equal the plain version's bit
for bit, and a flagged call (a horizon overflow) must raise the same
error from both. It exits non-zero on any difference.

`--sanitize thread` builds with ThreadSanitizer, which reports a data
race between the emulated threads, as a missing barrier gives; run the
script with `LD_PRELOAD=$(g++ -print-file-name=libtsan.so)` then
(`address` and libasan likewise). Needs g++ 11 or later; nothing here
needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
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
#include <barrier>
#include <cmath>
#include <cstdint>
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
#define __launch_bounds__(x)

struct Dim { int x = 0; };
struct EmuBlock {
  std::barrier<> bar;
  std::vector<int> ivals;
  std::vector<double> dvals;
  explicit EmuBlock(int n) : bar(n), ivals(n), dvals(n) {}
};
inline thread_local Dim threadIdx, blockIdx, blockDim;
inline thread_local EmuBlock* emu_block = nullptr;
inline thread_local char* emu_smem = nullptr;

inline void __syncthreads() { emu_block->bar.arrive_and_wait(); }
inline int __syncthreads_and(int p) {
  emu_block->ivals[threadIdx.x] = p != 0;
  __syncthreads();
  int r = 1;
  for (int v : emu_block->ivals) r &= v;
  __syncthreads();
  return r;
}
inline int __syncthreads_or(int p) {
  emu_block->ivals[threadIdx.x] = p != 0;
  __syncthreads();
  int r = 0;
  for (int v : emu_block->ivals) r |= v;
  __syncthreads();
  return r;
}
inline double __shfl_xor_sync(unsigned, double v, int o) {
  emu_block->dvals[threadIdx.x] = v;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const double r = emu_block->dvals[threadIdx.x - lane + (lane ^ o)];
  __syncthreads();
  return r;
}
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
    if n != 2:
        raise RuntimeError(f"found {n} launches to rewrite, not 2")
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


def emulate(lib, name: str, ctx, tables, t0, guard: int) -> np.ndarray:
    """One call through the emulated launch function, on CPU pointers."""
    num_nodes = ctx.stack.shape[2]
    t = torch.from_numpy(np.ascontiguousarray(t0, dtype=np.float64))
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
            None)
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
            t.data_ptr(), guard, out.data_ptr(), None)
    if err:
        raise RuntimeError(f"{name}: emulated launch returned {err}")
    return out.numpy()


def recorded_calls(cases) -> list:
    """Every event-loop call of the device engines in small CPU sweeps of
    phase 6's suites: (name, ctx, tables, t0, guard, plain packed output)."""
    calls = []
    original = device_stepper._EngineBase._events

    def events(self, loop, *tables, t0):
        def recording(ctx, *args, guard, **kwargs):
            packed = loop(ctx, *args, guard=guard, **kwargs)
            calls.append((loop.__name__, ctx,
                          tuple(np.array(a) for a in args[:-1]),
                          np.array(args[-1]), guard, packed.numpy().copy()))
            return packed
        recording.__name__ = loop.__name__
        return original(self, recording, *tables, t0=t0)

    device_stepper._EngineBase._events = events
    try:
        for name, n in zip(chip_smoke.SWEEP_SUITES, cases):
            chip_smoke.SWEEP_SUITES[name]["cases"] = n
            run_sweep(chip_smoke.make_suite(name), executor="device",
                      device="cpu")
    finally:
        device_stepper._EngineBase._events = original
    return calls


def raised(flags: np.ndarray) -> str | None:
    try:
        event_loop.check_flags(flags)
    except RuntimeError as e:
        return type(e).__name__
    return None


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cases", type=int, nargs=3, default=[16, 8, 4])
    parser.add_argument("--sanitize", choices=("thread", "address"))
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
        bad = 0
        for name, ctx, tables, t0, guard, want in calls:
            got = emulate(lib, name, ctx, tables, t0, guard)
            flagged = raised(want[event_loop.FLAGS])
            if flagged:
                same = raised(got[event_loop.FLAGS]) == flagged
                line = f"raised {flagged}" + ("" if same else " / differs")
            else:
                same = np.array_equal(got, want)
                line = ("bit-equal" if same else "DIFFERS") + \
                    f", chain {int(want[1].max(axis=1).sum())} steps"
            bad += not same
            print(f"{name} (3, {want.shape[1]}, {want.shape[2]}): {line}")
    print(f"{len(calls)} calls, {bad} differ")
    if bad or not calls:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
