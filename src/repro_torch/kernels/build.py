"""Build and load the CUDA kernels in `csrc/` (plain C interface, ctypes).

The sources are compiled by `nvcc` for `sm_90a` at first use, one `nvcc`
process per source started together, and linked into one shared library
under `build/kernels/<hash>/` at the repository root. The hash covers every
source and the compiler flags, so an edited source builds anew and an
unchanged one loads the library already built. Nothing here runs at import
time, and nothing falls back: if `nvcc` is missing, a compile fails or the
library does not load, `load_library` raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libreprotorch_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float       # 0.0 when an existing build was loaded
    log: str                   # nvcc's output (ptxas register/smem report)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be "
        "built without it")


def _compile(out_dir: Path) -> tuple[Path, str]:
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(prefix="tmp-", dir=out_dir))
    procs = []
    for src in _sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp_lib = work / LIB_NAME
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
         *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    final = out_dir / LIB_NAME
    os.replace(tmp_lib, final)        # atomic: a concurrent loader sees all or nothing
    shutil.rmtree(work, ignore_errors=True)
    return final, "\n".join(log)


def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gf256_matmul_planes_launch.argtypes = [p, p, p, i32, i32, i64, p]
    lib.gf256_matmul_planes_launch.restype = i32
    lib.xor_reduce_rows_launch.argtypes = [ctypes.POINTER(p), i32, p, i64, p]
    lib.xor_reduce_rows_launch.restype = i32
    lib.gf256_scale_planes_launch.argtypes = [p, p, p, i32, i64, p]
    lib.gf256_scale_planes_launch.restype = i32
    lib.xor_reduce_groups_launch.argtypes = [p, p, p, p, i32, i32, i64, p]
    lib.xor_reduce_groups_launch.restype = i32
    lib.gf256_matmul_bytes_launch.argtypes = [p, p, p, i32, i32, i64, p]
    lib.gf256_matmul_bytes_launch.restype = i32
    lib.gf256_scale_bytes_launch.argtypes = [p, p, p, p, i32, i64, i64, p]
    lib.gf256_scale_bytes_launch.restype = i32
    lib.gf256_reconstruct_stripes_launch.argtypes = [p, p, p, i64, i32,
                                                     i32, i64, p]
    lib.gf256_reconstruct_stripes_launch.restype = i32
    _bind_event_loops(lib)


def _bind_event_loops(lib: ctypes.CDLL) -> None:
    """The functions of `event_loop.cu`."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ctx = [p] * 8                     # a batch's context
    lib.round_events_launch.argtypes = [
        *ctx, p, i32, i32, i32, i32, i32, p, p, p, i32, i32, i32, p, i64, p,
        i32, p]
    lib.round_events_launch.restype = i32
    lib.pipeline_events_launch.argtypes = [
        *ctx, p, p, i32, i32, i32, i32, i32, p, p, p, p, i32, p, i64, p, i32,
        p]
    lib.pipeline_events_launch.restype = i32
    lib.round_events_smem.argtypes = [i32, i32]
    lib.round_events_smem.restype = i64
    lib.pipeline_events_smem.argtypes = [i32, i32]
    lib.pipeline_events_smem.restype = i64


@functools.lru_cache(maxsize=1)
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; raises on failure."""
    out_dir = BUILD_ROOT / source_digest()
    path = out_dir / LIB_NAME
    seconds, log = 0.0, ""
    if not path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tic = time.perf_counter()
        path, log = _compile(out_dir)
        seconds = time.perf_counter() - tic
    lib = ctypes.CDLL(str(path))
    _bind(lib)
    return KernelLibrary(lib=lib, path=path, build_seconds=seconds, log=log)


def check_launch(err: int, name: str) -> None:
    """Raise on a non-zero `cudaError_t` returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
