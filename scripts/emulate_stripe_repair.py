"""Run the batched stripe reconstruct of `csrc/gf256_matmul.cu` on the CPU.

    python3 scripts/emulate_stripe_repair.py [--stripes 1 4 37]
        [--sizes 1 17 4096 4099] [--json rows.json] [--sanitize address]

The CUDA source compiles only where `nvcc` is. This script compiles
`gf256_matmul.cu` with g++ (C++20) against the stub CUDA runtime of
`scripts/emulate_event_loop.py` (each block's threads as `std::thread`s,
`__syncthreads` a `std::barrier`, blocks one after another, dynamic
shared memory a per-block buffer filled with garbage), with `uint4`,
`dim3` and static `__shared__` arrays added and `bit_mask`'s `prmt` in
its C form. It then passes `chip_smoke.py`'s small batches of phase 2
(`small_stripe_batches`: one and two lost rows mixed, rows of `--sizes`
bytes in a byte space of two buffers, helper rows aligned, 3 bytes past
alignment or mixed, destination rows among rows that must stay as they
were) through the emulated `gf256_reconstruct_stripes_launch`, with the
tables the wrapper computes (`row_addresses`, `stripe_base`,
`stripe_tables`). Each
output must equal the plain version's (`ref.gf256_reconstruct_stripes_ref`)
bit for bit, and no byte outside the destination rows may change. A
launch with no stripes must be refused. `--json` writes one row a batch.
It exits non-zero on any difference. Needs g++ 11 or later; nothing here
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
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
from emulate_event_loop import STUB  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.gf256_matmul import (row_addresses,  # noqa: E402
                                              stripe_base, stripe_tables)

EXTRA = r'''
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return uint4{a, b, c, d};
}
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
// a static __shared__ array is one for all threads; blocks run one after
// another, so it is the block's own
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

template <typename K, typename... A>
void emu_launch(K kernel, dim3 grid, int threads, size_t smem, A... args) {
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      EmuBlock blk(threads);
      std::vector<char> mem(smem + 64, (char)0x7f);
      std::vector<std::thread> ts;
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([&, t] {
          threadIdx.x = t; blockIdx.x = (int)bx; blockIdx.y = (int)by;
          blockDim.x = threads; gridDim.x = (int)grid.x;
          gridDim.y = (int)grid.y;
          emu_block = &blk; emu_smem = mem.data();
          kernel(args...);
        });
      for (auto& th : ts) th.join();
    }
}
'''


def emulated_source() -> str:
    """gf256_matmul.cu with its dynamic shared buffers and launches made
    the stub's."""
    src = (build.CSRC / "gf256_matmul.cu").read_text()
    src, n = re.subn(r"extern __shared__ __align__\(16\) uint32_t (\w+)\[\];",
                     r"uint32_t* \1 = (uint32_t*)emu_smem;", src)
    if n != 3:
        raise RuntimeError(f"found {n} dynamic shared buffers, not 3")
    src, n = re.subn(r"(\w+(?:<\w+>)?)<<<([^,]+), ([^,]+), ([^,]+), "
                     r"([^>]+)>>>\(", r"emu_launch(\1, \2, \3, \4, ", src)
    if n != 5:
        raise RuntimeError(f"found {n} launches to rewrite, not 5")
    return src


def compile_library(out: Path, sanitize: str | None) -> ctypes.CDLL:
    (out / "cuda_runtime.h").write_text(STUB + EXTRA)
    (out / "gf256_emu.cpp").write_text(emulated_source())
    cmd = ["g++", "-std=c++20", "-O1", "-g", "-fno-strict-aliasing", "-fPIC",
           "-shared", "-pthread", f"-I{out}", str(out / "gf256_emu.cpp"),
           "-o", str(out / "libemu.so")]
    if sanitize:
        cmd.insert(1, f"-fsanitize={sanitize}")
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(str(out / "libemu.so"))
    # the launch function's signature as `build._bind` gives it (the
    # library holds none of the other sources' functions)
    class Signatures:
        def __getattr__(self, name):
            setattr(self, name, types.SimpleNamespace())
            return getattr(self, name)

    signatures = Signatures()
    build._bind(signatures)
    fn = lib.gf256_reconstruct_stripes_launch
    fn.argtypes = signatures.gf256_reconstruct_stripes_launch.argtypes
    fn.restype = signatures.gf256_reconstruct_stripes_launch.restype
    return lib


def emulate(lib, plan, bufs: list, n: int,
            stripes: int | None = None) -> tuple[int, list]:
    """One launch of the emulated kernel on copies of `bufs` (of
    `stripes` stripes, by default all of the plan's)."""
    out = [t.clone() for t in bufs]
    base = stripe_base(out)
    cols, rec = stripe_tables(plan.coeffs, plan.patterns,
                              row_addresses(out, plan.src_off, n),
                              row_addresses(out, plan.dst_off, n), base)
    err = lib.gf256_reconstruct_stripes_launch(
        cols.ctypes.data, rec.ctypes.data, base,
        rec.shape[0] if stripes is None else stripes,
        plan.src_off.shape[1], plan.dst_off.shape[1], n, None)
    return err, out


def check(lib, label: str, plan, bufs: list, n: int) -> dict:
    err, got = emulate(lib, plan, bufs, n)
    want = ref.gf256_reconstruct_stripes_ref(
        plan.coeffs, plan.patterns, [t.clone() for t in bufs], plan.src_off,
        plan.dst_off, n)
    got, want, was = (torch.cat(x) for x in (got, want, bufs))
    rows = np.zeros(was.numel(), dtype=bool)
    for off in plan.dst_off[plan.dst_off >= 0]:
        rows[off: off + n] = True
    outside = torch.from_numpy(~rows)
    return dict(label=label, stripes=len(plan.patterns), n=n, launch=err,
                same=err == 0 and bool(torch.equal(got, want)),
                untouched=bool(torch.equal(got[outside], was[outside])),
                rows_written=bool(not torch.equal(got[~outside],
                                                  was[~outside])))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--stripes", type=int, nargs="+", default=[1, 4, 37],
                        help="stripes of the small batches")
    parser.add_argument("--sizes", type=int, nargs="+",
                        default=[1, 17, 4096, 4099], help="row bytes")
    parser.add_argument("--sanitize", choices=("thread", "address"))
    parser.add_argument("--json", type=Path, help="write every row here")
    args = parser.parse_args()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        lib = compile_library(Path(tmp), args.sanitize)
        batches = list(chip_smoke.small_stripe_batches(
            "cpu", args.stripes, args.sizes))
        _, plan, bufs, n = batches[0]
        refused = emulate(lib, plan, bufs, n, stripes=0)[0] != 0
        for label, plan, bufs, n in batches:
            row = check(lib, label, plan, bufs, n)
            rows.append(row)
            ok = row["same"] and row["untouched"] and row["rows_written"]
            print(f"{label}: " + ("equal" if ok else f"DIFFERS {row}"))
    bad = sum(not (r["same"] and r["untouched"] and r["rows_written"])
              for r in rows)
    print(f"{len(rows)} launches, {bad} differ; a launch of no stripes "
          + ("refused" if refused else "NOT refused"))
    if args.json:
        args.json.write_text(json.dumps(dict(rows=rows, refused=refused),
                                        indent=1))
    if bad or not rows or not refused:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
