"""Latency of the warp primitives an event step can be built from, on the
card.

    python3 scripts/warp_primitives_bench.py [--json results/prims.json]

Builds a small CUDA source with `nvcc` (sm_90a) into a temporary
directory. One warp runs each primitive `ITERS` times in a dependent
chain (each input depends on the last result), between two `clock64()`
reads; the script prints the cycles an iteration, for lanes split into 1,
4, 13 or 32 groups where the primitive takes groups. Primitives: the
fan-in group by `__match_any_sync` and by five bit-plane ballots; a group's
maximum by `__reduce_max_sync` over each lane's own group mask, by a
shuffle fold of 64-bit keys over the warp, by pointer jumping along the
group's lanes with shuffles, and a full-warp `__reduce_max_sync`; the
step's minimum by a `__shfl_xor_sync` butterfly of float64 `tmin`s and by
two full-warp `__reduce_min_sync`s on 64-bit keys; a float64 divide; a
64-bit modulo; and the loop alone (`loop_baseline`, in every other row
too). The event-loop kernels in
`src/repro_torch/kernels/csrc/event_loop.cu` take the cheapest of each.
Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402

ITERS = 4096
GROUPS = (1, 4, 13, 32)
OPS = ("match_any", "ballot_match", "redux_max_own_group",
       "shfl_key_max_group", "redux_max_full", "shfl_xor_tmin_butterfly",
       "redux_min_full_key64", "f64_divide", "i64_modulo",
       "pointer_jump_group_max", "loop_baseline")

SOURCE = r'''
#include <cuda_runtime.h>
#include <math.h>
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double tmin(double a, double b) {
  if (isnan(a) || isnan(b)) return a + b;
  return b < a ? b : a;
}

__device__ __forceinline__ unsigned ballot_match(int key) {
  unsigned g = kFull;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const bool bit = key >> k & 1;
    const unsigned plane = __ballot_sync(kFull, bit);
    g &= bit ? plane : ~plane;
  }
  return g;
}

__global__ void prims(int op, int iters, int groups,
                      unsigned long long* cycles, double* sink) {
  const int lane = threadIdx.x & 31;
  const int key = lane % groups;
  const unsigned group = __match_any_sync(kFull, key);
  unsigned acc = lane;                 // stays below 2^16: acc >> 31 == 0
  double d = 1.0 + lane;
  long long n = 1000003 + lane;
  __syncwarp();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    const int zero = (int)(acc >> 31);
    switch (op) {
      case 0: acc = (acc + __popc(__match_any_sync(kFull, key + zero))) & 0xffff; break;
      case 1: acc = (acc + __popc(ballot_match(key + zero))) & 0xffff; break;
      case 2: acc = (acc + __reduce_max_sync(group, acc)) & 0xffff; break;
      case 3: {
        const unsigned long long k = (unsigned long long)acc << 20 | lane;
        unsigned long long mx = 0;
#pragma unroll 4
        for (int j = 0; j < 32; ++j) {
          const unsigned long long kj = __shfl_sync(kFull, k, j);
          if (group >> j & 1) mx = kj > mx ? kj : mx;
        }
        acc = (acc + (unsigned)mx) & 0xffff;
        break;
      }
      case 4: acc = (acc + __reduce_max_sync(kFull, acc)) & 0xffff; break;
      case 5: {
        double v = d;
        for (int o = 16; o > 0; o >>= 1) v = tmin(v, __shfl_xor_sync(kFull, v, o));
        d = d + v * 1e-300;
        break;
      }
      case 6: {
        const unsigned long long k = (unsigned long long)__double_as_longlong(d);
        const unsigned hi = (unsigned)(k >> 32);
        const unsigned top = __reduce_min_sync(kFull, hi);
        const unsigned lo = __reduce_min_sync(kFull, hi == top ? (unsigned)k : kFull);
        d = d + __longlong_as_double((long long)((unsigned long long)top << 32 | lo)) * 1e-300;
        break;
      }
      case 7: d = 1.0 + 1.0 / d; break;
      case 8: n = (n % 977) + 1000003 + lane; break;
      case 9: {                        // event_loop.cu's group_max
        unsigned long long k = (unsigned long long)acc << 20 | lane;
        const unsigned above = group & ~((2u << lane) - 1);
        int next = above ? __ffs(above) - 1 : lane;
        while (__any_sync(kFull, next != lane)) {
          const unsigned long long k_next = __shfl_sync(kFull, k, next);
          const int next_next = __shfl_sync(kFull, next, next);
          k = k_next > k ? k_next : k;
          next = next_next == next ? lane : next_next;
        }
        acc = (acc + (unsigned)__shfl_sync(kFull, k, __ffs(group) - 1)) & 0xffff;
        break;
      }
      case 10: acc = (acc + 1 + zero) & 0xffff; break;
    }
  }
  const long long t1 = clock64();
  if (lane == 0) cycles[0] = (unsigned long long)(t1 - t0);
  sink[lane] = d + acc + (double)n;
}

extern "C" int prims_launch(int op, int iters, int groups, void* cycles,
                            void* sink) {
  prims<<<1, 32>>>(op, iters, groups, (unsigned long long*)cycles,
                   (double*)sink);
  return (int)cudaGetLastError();
}
'''


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", type=Path)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("warp_primitives_bench: no card")
    with tempfile.TemporaryDirectory() as tmp:
        src, so = Path(tmp) / "prims.cu", Path(tmp) / "libprims.so"
        src.write_text(SOURCE)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", str(src),
                        "-o", str(so)], check=True)
        lib = ctypes.CDLL(str(so))
        lib.prims_launch.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
        sink = torch.zeros(32, dtype=torch.float64, device="cuda")
        rows = {}
        for i, op in enumerate(OPS):
            for groups in GROUPS:
                best = None
                for _ in range(3):           # the least of three runs
                    err = lib.prims_launch(i, ITERS, groups,
                                           ctypes.c_void_p(cycles.data_ptr()),
                                           ctypes.c_void_p(sink.data_ptr()))
                    torch.cuda.synchronize()
                    if err:
                        raise RuntimeError(f"{op}: cudaError_t {err}")
                    c = cycles.item() / ITERS
                    best = c if best is None else min(best, c)
                rows[f"{op} groups={groups}"] = best
                print(f"{op:26s} groups={groups:2d}: {best:8.1f} cycles")
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            dict(device=torch.cuda.get_device_name(0), cycles=rows), indent=1))


if __name__ == "__main__":
    main()
