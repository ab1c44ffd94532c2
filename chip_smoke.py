"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--json PATH]

Phases (any failure is an uncaught exception and a non-zero exit):

0. the card's name and power limit (`nvidia-smi`), the torch version;
   raises when no CUDA device is visible;
1. build the CUDA kernels from `src/repro_torch/kernels/csrc` (nvcc, sm_90a);
2. hold each of the nine kernels against its plain PyTorch version on the
   card, bit-exact, at the CPU-test shapes and the main paths' shapes, and
   time both beside the least time the card could take for the same work
   and, where one exists, one PyTorch call computing the same function
   (`library_ms`): a kernel's `ms` is its own device time from
   torch.profiler (mean of 20 launches), `ms_events` and `ms_single` the
   wrapper's call by CUDA events (20 back to back; the median of 20 single
   calls), the plain and library times 20 calls back to back; the
   byte-domain GF(256) kernels also at misaligned row offsets and against
   the plane route (`bitplane.pack`, plane kernel, `unpack`);
   `xor_reduce_words` in both its forms, a (k, W) tensor and k separate
   rows, at k up to 33 (chained launches), rows at word offsets 0, 1 and
   3, and on ragged byte rows through `ops.xor_reduce`; at 128 MiB rows
   (k = 2 and 3, both forms); `gf256_matmul_bytes` also at phase 7's
   checkpoint encode, (2, 4) over 3,451 stripes of 256 KiB (3.62e9 bytes
   in, 1.81e9 out), and at a load's per-stripe reconstruct, (1, 4) and
   (2, 4) x 256 KiB (the launches the batched kernel replaced);
   `gf256_reconstruct_stripes` (every stripe of a checkpoint load in one
   launch) on small batches from a seeded generator (1, 4 and 37 stripes,
   one and two lost rows mixed, rows of 4096 and 4099 bytes in a byte
   space of two buffers, helper rows aligned, 3 bytes past alignment or
   0 / 1 / 3 mixed, destination rows among rows that must stay as they
   were), then at phase 7's load layouts with domains (1, 5) and (1, 2)
   lost (3,451 stripes of 256 KiB from `place_stripes`: the blob's
   windows and the spare rows of random bytes), each bit for bit over
   every buffer and the full-width ones timed beside their bound, the
   per-stripe launches they replace and the plain version's checking
   call; the two-row folds (`xor_reduce_words`,
   the grouped fold at G=4 K=2) and their `torch.bitwise_xor` yardstick
   in turns, each by the profiler (the means of two windows: fold,
   yardstick, yardstick, fold) and the yardstick by events too; the
   sweep's event loops (`round_events_kernel`, `pipeline_events_kernel`,
   from `jax_stepper.py`'s jitted programs): first the shared-memory
   sizes of `event_loop.py` against the source's, then hand-made batches
   from a seeded generator (48 cases on 14 nodes: epochs crossed, traces
   cycled and clamped, static networks, R = 1 and 6 rounds with idle
   rounds, trees of depth 0, 1, random and a chain, a case without an
   edge) that must give the plain version's end clocks and step counts,
   a 2-epoch live horizon that must raise `EpochHorizonError` and a
   guard of 3 steps that must raise `RuntimeError` on both routes; then
   one device sweep of each phase-6 suite, recording the engines' largest
   batch of each wrapper at R = 1 and R > 1, each held the same way and
   timed (the kernel by the profiler, the plain version 2 calls by
   events) beside its bound (the epochs each case reached, the tables
   and outputs once; float64 operations at 34e12/s), its serial chain of
   steps and µs a step; `library_ms` is null (no PyTorch call runs an
   event loop);
3. the serial repair path at full size: the repair-demo scenario (RS(6,3)
   on the Aliyun Table III matrix under markov churn, 128 MB chunks)
   planned and simulated for every single-failure scheme, a 128 MiB-per-
   block stripe encoded on the card, the BMF plan's repair executed
   through the kernels and verified byte-exact; the kernels' launch
   counters (and calls of `bitplane.pack` / `unpack`, which must be 0)
   are set to 0 just before and read just after; then one more repair is
   traced with torch.profiler (device time by kernel, the device's idle
   share; no bit-slicing op may show, nor a `torch.stack` copy
   (`CatArray`) before a fold);
4. small-input checks: every scheme's plan executed on the card equals the
   CPU plain path byte for byte and verifies, serially and as one mixed
   batch (all 8 schemes, failures (0,) and (0, 4), 4099 bytes);
5. the batched data plane at full size: B=4 stripes of 3 x 128 MiB, one
   plan each (traditional, PPR, BMF, PPT), repaired by one
   `execute_plans_batch` call on the card and verified; counters set to 0
   just before and read just after; wall time (first call, median of 5),
   peak device memory, and one torch.profiler trace; then the same at
   B=8 (the four schemes twice: HDFS's default of 8 EC reconstruction
   threads per DataNode);
6. the Monte-Carlo repair sweep (`repro_torch.sim.sweep.run_sweep`) at the
   sizes the JAX package's sweep benchmarks run: the paper's Table II
   suite (1024 two-failure RS(7,4) cases frozen to 64-epoch traces), the
   stress suite (512 single-failure RS(14,10) 1024 MB cases frozen to
   256-epoch traces) and a live suite (128 such cases of 256 MB chunks
   under markov churn, four schemes), each through `executor="device"`
   (the device stepper on the card: its event loops in the two
   event-loop kernels) and `executor="vectorized"` (numpy on the host);
   a frozen suite is built once (in phase 2) and replayed by every run,
   the live one
   is built anew for each run (its epochs are sampled inside the run).
   Fails if a case's rounds, relay hops or time (1e-6 rtol) differ
   between the two, if any batch ran on the host steppers, if the live
   suite never grew its epoch horizon, if `verify_bytes=16` verifies not
   every pair, or if the sweep's launches (counters set to 0 just before,
   read just after) are not one `gf256_scale_bytes` and one
   `xor_reduce_groups_words` per data-plane round and one event-loop
   kernel per device engine call (`COUNTS.round_calls`,
   `pipeline_calls`), at least one a suite; the event loops' plain
   versions then run the device sweep once, held to the vectorized
   engine and traced (wall, idle share, host syncs), not timed; prints wall time and
   cases/s of both executors (median of 3, in turns), host syncs, horizon
   doublings, and one torch.profiler trace of each device sweep (device
   busy time, idle share, top kernels);
7. the EC-checkpointed trainer at full width: first the free disk space
   of the temporary checkpoint directory is checked (2.5 x 5.43e9 bytes,
   or it raises); then `repro_torch.launch.train.run` trains smollm_360m
   (32 layers, d=960) at B=8, T=1024 for 8 steps, saves asynchronously at
   step 4, loses failure domains (1, 5) at step 6, repairs the step-4
   checkpoint, resumes and saves at the end; the final checkpoint is
   loaded twice, with domains (3,) and (1, 5) lost, and every leaf is
   compared with the state in memory byte for byte on the card; the
   counters are set to 0 just before the run and each load and read
   just after: the run launches one `gf256_matmul_bytes` per save and one
   `gf256_reconstruct_stripes` for the repair of every stripe that lost
   a data block, each load one `gf256_reconstruct_stripes` (repairing
   1,725 and 3,451 stripes at full width), no other kernel and no
   bit-slicing; each load's stages (read and CRC, h2d, repair, assemble)
   and its peak device memory above what was held before it (against the
   state's bytes) are printed;
   the loss of one more step from the restored state must equal the
   in-memory state's within 1e-5; prints each step's loss, time and
   tokens/s, each save's stages (snapshot, layout, encode, device-to-host
   copy, CRC, write; host clock), the repairs, peak device memory, and
   the save's encode kernel (timed in phase 2) beside its bound, and one
   steady train step traced with torch.profiler (device busy time by
   kernel kind, idle share, top kernels). The checkpoint directory is
   removed;
8. serving (`repro_torch.launch.serve`, `serve/serve_step.py`, the
   transformer's KV-cache prefill and decode, plain PyTorch on the card):
   8a. the launcher serves qwen2_15b at its full width and depth (28
   layers, d=1536, 1.54e9 params, bf16; random params from seed 0): B=8
   prompts of 512 tokens, 32 greedy tokens; prints the prefill's time,
   each decode step's (host clock, each ended by a synchronize; first and
   median), tokens/s and peak device memory, and the decode step's bound
   (every weight byte and the filled k / v positions read once at 3.35
   TB/s); then one steady decode step traced with torch.profiler (busy
   time by kernel kind, idle share, launches a step);
   8b. tests/test_serve_equiv.py's invariant at full width and depth:
   qwen2_15b prefills 512 tokens and decodes 8, each step's logits
   against the teacher-forced forward pass within 0.15;
   8c. the same for gemma3_4b at full width, 6 layers (one 5:1 block),
   past its 1,024-token window (prompt 1,100: the sliced decode runs and
   its slices move), and qwen2vl_2b at full width, 2 layers, with a
   patch grid in pos3 and vision embeddings, each within 0.1;
   8d. prefill and 8 greedy decode steps on the card against the same
   params on the CPU (fed the card's tokens): qwen2_15b with the int8 KV
   cache, 2 layers, logits within 0.1; moonlight_16b_a3b at full width
   (64 experts, top-6), 2 layers, in fp32 within 2e-2 and in bf16
   reported only; the greedy tokens equal wherever the card's top-2
   margin exceeds twice the tolerance (the tolerances and their reasons
   are at `SERVE_EQUIV` / `SERVE_CPU`);
   8e. the nine kernels' launch counters, set to 0 before 8a and read
   after it and after 8d: serving launches none of them;
9. the other model families (`models/{rwkv6,mamba2,zamba2,whisper}.py`,
   their serve steps and the trainer; plain PyTorch on the card, no kernel
   of this repo):
   9a. the serve launcher serves zamba2_7b at its full width and depth
   (81 mamba2 layers, 13 shared-attention points, d=3584, 6.97e9 params,
   bf16; random params from seed 0): B=8 prompts of 512 tokens, 32 greedy
   tokens; prints the prefill's time (the run's and a warm one), each
   decode step's (first, median, range), tokens/s, peak device memory,
   the decode step's bound (every weight byte, the SSM and conv states
   read and written and the filled k / v of the 13 points read, at 3.35
   TB/s), and one steady decode step traced (busy time by kernel kind,
   idle share, launches);
   9b. decode == forward at full width: rwkv6_16b at 24 layers (B=2,
   512 + 8 tokens) and its chunk invariance (the forward at chunk 16
   against 64), zamba2_7b at 12 layers (512 + 8), whisper_medium at 24 +
   24 layers over 1,500 frames (a 4-token prompt + 8), each step's
   logits within the tolerances stated at `FAMILY_EQUIV`, and each
   family's decode-step median;
   9c. prefill and 8 greedy decode steps on the card against the same
   params on the CPU (fed the card's tokens), in fp32 at full width:
   rwkv6 at 2 layers, zamba2 at 6 (one shared point), whisper at 2 + 2,
   within the tolerances at `FAMILY_CPU`;
   9d. `make_train_step` (AdamW, fp32 moments), 3 steps each at full
   width: rwkv6_16b at 24 layers (B=8, T=1,024), whisper_medium at 24 +
   24 (B=8, 1,500 frames, 448 tokens), zamba2_7b at 12 layers (B=8,
   T=1,024; its full depth's params, gradients and moments need 8.4e10
   bytes): finite losses, changed params, step times, peak memory and one
   more step traced;
   9e. the nine kernels' launch counters, set to 0 before 9a and read
   after 9d: none;
10. the multi-device half (`models/sharding.py` on DTensors,
   `launch/mesh.py`, `ft/elastic.py`, `launch/dryrun.py`):
   10a. a one-rank NCCL process group on the loopback and
   `make_test_mesh(data=1, model=1)`: phase 7's smollm_360m (full width,
   B=8, T=1024) trains 3 steps with `MeshRules(mesh=...)` from the same
   init and batches as a no-mesh run, every op through DTensor dispatch
   (the losses within `MESH_LOSS_TOL`; every leaf a DTensor on the
   card); the DTensor state's EC checkpoint (leaves gathered whole) is
   byte-equal to the plain save of the same values; domains (1, 5) are
   lost and the load repairs through one `gf256_reconstruct_stripes`
   launch (the counters set to 0 before the saves and
   the load and read after each); `reshard_state` onto a fresh mesh and
   one more step, whose loss equals the no-mesh resume's;
   10b. `launch/dryrun.py` at production size, each cell in its own
   process, all at once, started after phase 2 and run beside phases 3
   to 11 (their results read after 11):
   smollm_360m train_4k on the (16, 16) and (2, 16, 16) meshes,
   qwen2_15b decode_32k and grok1_314b train_4k on (16, 16), over fake
   256- and 512-rank worlds and fake tensors on the card's device type
   (nothing allocated): each record's per-device
   bytes (printed beside the earlier release's, `DRYRUN_BEFORE`), FLOPs,
   collective bytes by kind, dominant roofline term (the H100 SXM's
   datasheet constants) and seconds; fails if a cell does not fit the
   card's 80e9 bytes;
11. the port's example programs (`examples/torch_*.py`), run after 10a
   (beside 10b's cells, host work in other processes): each imported
   in this process and its `main(device="cuda")` called under
   `contextlib.redirect_stdout`, its output echoed and its wall time
   kept, the nine kernels' launch counters set to 0 just before and read
   just after. Fails if the repair demo does not print `byte-exact:
   True` or launches other than one `gf256_matmul_bytes` for the encode
   and one a helper and one `xor_reduce_words` a helper but the first of
   each job (1 + 3 and 2); if the device sweep's difference is >= 1e-6 or
   a batch ran on the host steppers; if the quickstart does not repair 4
   blocks across 4 stripes or resume at step 61; if a model example
   prints a loss that is not finite; if an EC example launches other than
   one `gf256_matmul_bytes` a save and one `gf256_reconstruct_stripes` a
   load that repaired (the saves and the repairs counted at
   `ECCheckpointer`); or if any other
   example launches one of the nine kernels (the device sweep launches
   one event-loop kernel per device engine call).

Each phase's wall seconds are printed as `{"phase_wall_s": {...}}` after
phase 11. The second-to-last line is the kernels' JSON record, the last
line `{"ok": true, "device": {...}}`. `--json PATH` also writes every
record.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import importlib.util
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import ECCheckpointer  # noqa: E402
from repro_torch.checkpoint import ec_checkpoint  # noqa: E402
from repro_torch.core import executor, topology  # noqa: E402
from repro_torch.core.bandwidth import BandwidthProcess, IngressModel  # noqa: E402
from repro_torch.core.engine import dataplane, device_stepper  # noqa: E402
from repro_torch.core.engine.arrays import compile_plan, decompile  # noqa: E402
from repro_torch.core.ppt import build_ppt_tree, ppt_round_plan  # noqa: E402
from repro_torch.core.simulator import (MULTI_SCHEMES, SINGLE_SCHEMES,  # noqa: E402
                                        RepairSimulator, Scenario)
from repro_torch.data.pipeline import SyntheticStream  # noqa: E402
from repro_torch.ec import bitplane, gf256  # noqa: E402
from repro_torch.ec import stripe as stripe_lib  # noqa: E402
from repro_torch.ec.rs import RSCode  # noqa: E402
from repro_torch.kernels import event_loop, ops, ref  # noqa: E402
from repro_torch.kernels import build as kernel_build  # noqa: E402
from repro_torch.kernels.build import load_library  # noqa: E402
from repro_torch.kernels.gf256_matmul import (gf256_matmul_bytes,  # noqa: E402
                                              gf256_matmul_planes,
                                              gf256_reconstruct_stripes,
                                              gf256_scale_bytes,
                                              gf256_scale_planes)
from repro_torch.kernels.xor_reduce import (chain_plan,  # noqa: E402
                                            xor_reduce_groups_words,
                                            xor_reduce_words)
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.ft.elastic import reshard_state  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh, rules_for  # noqa: E402
from repro_torch.models.sharding import tree_shardings  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import (mamba2, rwkv6, transformer,  # noqa: E402
                                 whisper, zamba2)
from repro_torch.serve import serve_step  # noqa: E402
from repro_torch.sim.suite import (MonteCarloSuite, SampleSpace,  # noqa: E402
                                   TraceSuite)
from repro_torch.sim.sweep import run_sweep  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.train_step import (TrainConfig, init_state,  # noqa: E402
                                          make_train_step, state_logical)

MIB = 1 << 20
BLOCK_BYTES = 128 * MIB            # the paper's 128 MB chunk; HDFS block size
W_PLANES = BLOCK_BYTES // 32       # plane words per 128 MiB block
W_WORDS = BLOCK_BYTES // 4         # 32-bit words per 128 MiB block
REPS = 20
PROFILE_ATTEMPTS = 3
HEAD = 4 * MIB                     # bytes compared with the host's copy
BATCHES = (4, 8)                   # phase 5: stripes in one batched repair
BATCH_SCHEMES = ("traditional", "ppr", "bmf", "ppt")
SWEEP_REPEATS = 3                  # phase 6: timed runs of each executor
SWEEP_VERIFY = 16                  # phase 6: cases byte-verified per sweep
# phase 6's suites: the parameters of the JAX package's sweep benchmarks
# (benchmarks/bench_table2.py:23-32, bench_sweep.py:62-73), copied since
# the benchmarks import that package. The live suite is the stress suite
# unfrozen, at HDFS's common 256 MB block size and with the four
# single-failure schemes (BMF replans, so a horizon overflow rolls its
# splices back): its repairs outrun the first 64-epoch horizon, and 128
# cases keep every batch's epoch stack under the stepper's budget up to a
# 1024-epoch horizon.
SWEEP_SUITES = {
    "table2_trace": dict(cases=1024, code=(7, 4), chunk_mb=32.0,
                         pattern="double", base_seed=0, epochs=64,
                         schemes=("mppr", "random", "msrepair")),
    "stress_trace": dict(cases=512, code=(14, 10), chunk_mb=1024.0,
                         pattern="single", base_seed=17, epochs=256,
                         schemes=("traditional", "ppr")),
    "stress_live": dict(cases=128, code=(14, 10), chunk_mb=256.0,
                        pattern="single", base_seed=17, epochs=None,
                        schemes=("traditional", "ppr", "ppt", "bmf")),
}
# phase 7: the train launcher at smollm_360m's full width; its checkpoints
# are RS(6,4) at 256 KiB chunks on 8 failure domains, 5.43e9 bytes of
# domain files a save (3,618,211,204 bytes of state in 3,451 stripes)
TRAIN_ARGS = ["--arch", "smollm_360m", "--full", "--seq-len", "1024",
              "--batch", "8", "--steps", "8", "--ckpt-every", "4",
              "--fail-at", "6", "--microbatches", "1"]
CKPT_BYTES = 5.43e9
CKPT_STRIPES, CKPT_CHUNK = 3451, 1 << 18
TRAIN_LOSSES = ((3,), (1, 5))      # domains lost by the two checked loads
# phase 2: the batched reconstruct at phase 7's load layouts with these
# domains lost (one lost data block a stripe; one or two mixed), and the
# RS(6,4) repair patterns of its small batches, f = 1 and 2
STRIPE_LOSSES = ((1, 5), (1, 2))
STRIPE_PATTERNS = (((1,), (0, 2, 3, 4)), ((0, 1), (2, 3, 4, 5)),
                   ((3,), (0, 1, 2, 4)), ((2, 3), (0, 1, 4, 5)))
# the traced train step's kernels by kind (cuBLAS fp32 GEMMs are the
# unembedding's; its bf16 GEMMs are the `nvjet` / `cutlass` ones)
TRAIN_STEP_GROUPS = (
    ("attention (sdpa)", ("flash", "fmha", "attention")),
    ("gemm fp32", ("f32f32", "sgemm")),
    ("gemm bf16", ("nvjet", "gemm", "cutlass")),
    ("reduce", ("reduce_kernel",)),
    ("copy / cast", ("copy",)),
    ("index / embedding", ("index", "embedding", "gather", "scatter")),
    ("elementwise", ("elementwise",)),
)
# phase 8: serving. 8a: the serve launcher at qwen2_15b's full width and
# depth (28 layers, d=1536, 12 heads, 2 KV heads, d_ff 8960, vocab
# 151,936, bf16): B=8 prompts of 512 tokens, 32 greedy tokens.
SERVE_ARGS = ["--arch", "qwen2_15b", "--full", "--batch", "8",
              "--prompt-len", "512", "--gen-tokens", "32"]
# 8b-8c: tests/test_serve_equiv.py's invariant (prefill T-k tokens, decode
# k, each step's logits against the teacher-forced forward) at full width.
# The reference holds it to 0.06 at 2 reduced layers (bf16 params, fp32
# accumulation in another order). The gap grows with depth, since every
# layer's output is rounded to bf16 on both paths in another order: on the
# CPU, qwen2_15b's widths with d_ff and the vocabulary cut measured
# 0.029-0.038 at 2 layers and 0.063-0.069 at 28. The card adds its own
# kernels on each path (flash SDPA in the prefill and the forward, cuBLAS
# GEMMs of M = B in the decode), and the full vocabulary puts more logits
# under the max: 0.15 at 28 layers, 0.1 at 2 and 6. gemma3 runs past its
# 1,024-token window (the sliced decode, its slices moving); qwen2vl with
# a (t, h, w) grid in pos3 and vision embeddings over an 8 x 8 patch grid.
SERVE_EQUIV = {
    "qwen2_15b": dict(layers=None, batch=2, prompt=512, steps=8, tol=0.15),
    "gemma3_4b": dict(layers=6, batch=2, prompt=1100, steps=8, tol=0.1),
    "qwen2vl_2b": dict(layers=2, batch=2, prompt=256, steps=8, vision=64,
                       tol=0.1),
}
# 8d: prefill + decode on the card against the same params on the CPU, the
# CPU fed the card's greedy tokens. The dense int8 cache in bf16 (the
# serving dtype): the two sides round each layer in other orders (the
# card's flash SDPA, cuBLAS), measured up to 0.045 on the CPU between the
# fused and chunked attention routes at 2 layers, and an int8 level may
# flip with it: 0.1. Moonlight in fp32 at its full widths: bf16 routing is
# chaotic across devices (a router input an ulp away flips an expert or a
# capacity drop: on the CPU the two attention routes moved logits by up
# to 1.5 at 64 experts), while fp32 keeps the routing equal. What is left
# are the bf16 roundings the reference makes inside an fp32 model (q, k,
# v and the probabilities, the MoE dispatch and combine), which fp32
# reassociation flips here and there, each by 2^-8 of an operand: on the
# CPU at these widths (d_ff and the vocabulary cut) a 1e-7 relative
# perturbation moved the logits by 0.007-0.013, and the first chip run
# measured 0.009-0.016 against the 2e-2 set before it. Moonlight in bf16
# runs too, and its gap is reported, not held. Greedy tokens must agree wherever the card's
# top-2 margin exceeds twice the tolerance (a closer call may go either
# way, since the two sides round differently); the close calls are
# counted.
SERVE_CPU = {
    "qwen2_15b_int8": dict(arch="qwen2_15b", layers=2, batch=2, prompt=64,
                           steps=8, kv_dtype="int8", tol=0.1),
    "moonlight_16b_a3b_fp32": dict(arch="moonlight_16b_a3b", layers=2,
                                   batch=2, prompt=64, steps=8,
                                   dtype="float32", tol=2e-2),
    "moonlight_16b_a3b_bf16": dict(arch="moonlight_16b_a3b", layers=2,
                                   batch=2, prompt=64, steps=8, tol=None),
}
HBM_BYTES_PER_S = 3.35e12          # the decode bound's memory rate (H100 SXM)
# phase 9: the other model families, plain PyTorch on the card. 9a: the
# serve launcher at zamba2_7b's full width and depth (81 mamba2 layers, 13
# shared-attention points and 3 trailing layers, d=3584, 112 SSM heads of
# 64 x 64, 32 KV heads of 112, vocab 32,000; 6.97e9 params, bf16): B=8
# prompts of 512 tokens, 32 greedy tokens.
FAMILY_SERVE_ARGS = ["--arch", "zamba2_7b", "--full", "--batch", "8",
                     "--prompt-len", "512", "--gen-tokens", "32"]
# 9b: decode == forward at full width (prefill T-k tokens, decode k, each
# step's logits against the teacher-forced forward): rwkv6_16b at all 24
# layers with its chunk invariance (the forward at the WKV chunk of 64
# against 16), zamba2_7b at 12 layers (2 shared points), whisper_medium
# at 24 + 24 layers over 1,500 frames (a 4-token prompt). Tolerances, from
# `scripts/family_tolerances.py --cases equiv` (the CPU at these widths
# with d_ff cut to 1,024 and the vocabulary to 8,192; B=2, these prompts):
# the bf16 models round every layer's output on both paths in other
# orders, and the recurrent families carry each rounding forward in
# their state. rwkv6 in bf16 is chaotic at random init: its chunk-16 and
# chunk-64 forwards (the same sums in fp32, then rounded to bf16)
# differed by 0.93 and decode from the forward by 0.07-0.34 (growing over
# the 8 steps), while in fp32 the chunkings agree to 3.1e-3 and decode to
# 1.2e-3 (`unembed`'s bf16 rounding). So rwkv6 is held in fp32 (2e-2 on
# both, phase 8's fp32 bar) and its bf16 run is reported, not held.
# zamba2 in bf16 measured 0.06-0.21 over the 8 steps (growing; the
# forward's SDPA against the decode's chunked softmax, the chunked SSD
# against its recurrence): 0.3 on the card, whose kernels round in their
# own orders again; in fp32 1.1e-3 to 2.4e-3: 2e-2. whisper in bf16
# measured 0.041-0.046 at 24 + 24 layers: phase 8's 0.15 for full depth.
FAMILY_EQUIV = {
    "rwkv6_16b_fp32": dict(arch="rwkv6_16b", layers=None, batch=2,
                           prompt=512, steps=8, dtype="float32", tol=2e-2,
                           chunk_tol=2e-2),
    "rwkv6_16b": dict(layers=None, batch=2, prompt=512, steps=8, tol=None,
                      chunk_tol=None),
    "zamba2_7b": dict(layers=12, batch=2, prompt=512, steps=8, tol=0.3),
    "zamba2_7b_fp32": dict(arch="zamba2_7b", layers=12, batch=2, prompt=512,
                           steps=8, dtype="float32", tol=2e-2),
    "whisper_medium": dict(layers=None, batch=2, frames=1500, prompt=4,
                           steps=8, tol=0.15),
}
# 9c: prefill + 8 greedy decode steps on the card against the same params
# on the CPU (fed the card's tokens), in fp32 at full width: rwkv6 at 2
# layers, zamba2 at 6 (one shared point), whisper at 2 + 2 over 1,500
# frames. The fp32 models still round q, k, v and the probabilities (and
# `unembed`'s inputs) to bf16 as the reference does, and the card's
# reassociated fp32 sums flip some of those roundings: on the CPU at these
# widths (d_ff and the vocabulary cut) a 1e-7 relative perturbation of
# the params moved the logits by up to 1.5e-3 (rwkv6), 2.0e-3 (zamba2)
# and 6.0e-3 (whisper) (`scripts/family_tolerances.py --cases cpu`):
# phase 8's fp32 bar of 2e-2 for all three.
FAMILY_CPU = {
    "rwkv6_16b_fp32": dict(arch="rwkv6_16b", layers=2, batch=2, prompt=64,
                           steps=8, dtype="float32", tol=2e-2),
    "zamba2_7b_fp32": dict(arch="zamba2_7b", layers=6, batch=2, prompt=64,
                           steps=8, dtype="float32", tol=2e-2),
    "whisper_medium_fp32": dict(arch="whisper_medium", layers=2, batch=2,
                                frames=1500, prompt=4, steps=8,
                                dtype="float32", tol=2e-2),
}
# 9d: `train_step.make_train_step` (AdamW, fp32 moments) at full width, 3
# steps each: rwkv6_16b and whisper_medium at full depth, zamba2_7b at 12
# layers: at its full depth the params, gradients and two fp32 moments
# alone take 6.97e9 x 12 = 8.4e10 bytes, more than the card's 80 GB.
# whisper's stream gives 1,500 frames and 448 decoder tokens.
FAMILY_TRAIN = {
    "rwkv6_16b": dict(layers=None, batch=8, seq=1024, steps=3),
    "whisper_medium": dict(layers=None, batch=8, seq=1500, steps=3),
    "zamba2_7b": dict(layers=12, batch=8, seq=1024, steps=3),
}

KERNELS = {
    "gf256_matmul_planes": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/gf256_matmul.cu",
        replaces="src/repro/kernels/gf256_matmul.py:40"),
    "xor_reduce_words": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/xor_reduce.cu",
        replaces="src/repro/kernels/xor_reduce.py:26"),
    "gf256_scale_planes": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/gf256_matmul.cu",
        replaces="src/repro/kernels/gf256_matmul.py:74"),
    "xor_reduce_groups_words": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/xor_reduce.cu",
        replaces="src/repro/kernels/xor_reduce.py:54"),
    "gf256_matmul_bytes": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/gf256_matmul.cu",
        replaces="src/repro/kernels/gf256_matmul.py:40"),
    "gf256_scale_bytes": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/gf256_matmul.cu",
        replaces="src/repro/kernels/gf256_matmul.py:74"),
    # the checkpoint load's per-stripe products, all stripes in one launch
    "gf256_reconstruct_stripes": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/gf256_matmul.cu",
        replaces="src/repro/kernels/gf256_matmul.py:40"),
    # the jitted device programs of the JAX package's sweep (not Pallas)
    "round_events": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/event_loop.cu",
        replaces="src/repro/core/engine/jax_stepper.py:170"),
    "pipeline_events": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/event_loop.cu",
        replaces="src/repro/core/engine/jax_stepper.py:241"),
}
WRAPPERS = {"gf256_matmul_planes": gf256_matmul_planes,
            "xor_reduce_words": xor_reduce_words,
            "gf256_scale_planes": gf256_scale_planes,
            "xor_reduce_groups_words": xor_reduce_groups_words,
            "gf256_matmul_bytes": gf256_matmul_bytes,
            "gf256_scale_bytes": gf256_scale_bytes,
            "gf256_reconstruct_stripes": gf256_reconstruct_stripes,
            "round_events": event_loop.round_events,
            "pipeline_events": event_loop.pipeline_events}
EVENT_LOOPS = ("round_events", "pipeline_events")


def _counted(fn):
    def wrapper(*args, **kwargs):
        wrapper.calls += 1
        return fn(*args, **kwargs)

    wrapper.calls = 0
    return wrapper


# calls of the bit-slicing around the plane kernels; no main path makes any
bitplane.pack = _counted(bitplane.pack)
bitplane.unpack = _counted(bitplane.unpack)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peak_rates(name: str) -> dict:
    """Published peaks used for `bound_ms` (NVIDIA data sheets; the CUDA
    programming guide's throughput table for 32-bit logic ops)."""
    mem = 2.0e12 if "PCIe" in name else 3.35e12       # H100 PCIe / SXM HBM
    try:
        clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    except (subprocess.SubprocessError, ValueError, IndexError):
        clock_hz = 1.98e9
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # compute capability 9.0: 64 results per clock per SM for 32-bit
    # bitwise ops; a 3-input LOP3 does one AND and one XOR
    return dict(mem_bytes_per_s=mem, lop3_per_s=sms * 64 * clock_hz,
                sms=sms, sm_clock_hz=clock_hz)


def bound(nbytes: float, ops: float, peaks: dict) -> tuple[float, str]:
    t_bytes = nbytes / peaks["mem_bytes_per_s"] * 1e3
    t_ops = ops / peaks["lop3_per_s"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps: int = REPS) -> float:
    """Device time of one call: `reps` calls enqueued back to back between
    two CUDA events, after a warm-up call, over `reps`. The host's work
    around each launch overlaps the device's work of the previous one."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_single(fn, reps: int = REPS) -> float:
    """Median over `reps` single calls, each between two CUDA events: the
    device time plus whatever the device waits for the host to launch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_device_ms(fn, label: str, reps: int = REPS,
                     attempts: int = PROFILE_ATTEMPTS) -> tuple[float, int]:
    """Mean device time of the one kernel each call of `fn` launches (its
    name holds `label`), over `reps` calls, from torch.profiler's CUDA
    activity records: the kernel alone, whatever the host does around it.
    Returns it with the number of profiled windows it took.

    The profiler now and then loses an activity record (one kernel of 20
    missing, seen on an H100; on one machine one of every window, as if
    the window's first launch came before the profiler took records). So
    a window makes one call more than it times, first, and times the last
    `reps` of the kernels it shows, which are `reps` calls of `fn` with one
    record lost or none. A window that shows fewer is profiled again, up
    to `attempts` windows. More kernels than calls is a fault of the
    wrapper or the label and raises at once."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for attempt in range(1, attempts + 1):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(reps + 1):
                fn()
            torch.cuda.synchronize()
        kernels = sorted((ev.time_range.start, ev.time_range.elapsed_us())
                         for ev in prof.events()
                         if ev.device_type == torch.autograd.DeviceType.CUDA
                         and label in ev.name)
        if len(kernels) > reps + 1:
            raise AssertionError(
                f"{len(kernels)} '{label}' kernels in {reps + 1} calls")
        if len(kernels) >= reps:
            return sum(us for _, us in kernels[-reps:]) / reps / 1e3, attempt
        seen.append(len(kernels))
    raise AssertionError(f"'{label}' kernels in {attempts} windows of "
                         f"{reps + 1} calls: {seen}")


def kernel_times(fn, label: str) -> dict:
    """A kernel wrapper's times: `ms` the kernel alone (profiler, with the
    windows it took in `profile_windows`), `ms_events` a call back to back
    and `ms_single` a single call (CUDA events, the wrapper's host work
    included where the card waits on it)."""
    ms, windows = kernel_device_ms(fn, label)
    return dict(ms=ms, profile_windows=windows, ms_events=cuda_ms(fn),
                ms_single=cuda_ms_single(fn))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def random_words(rng: np.random.Generator, shape) -> torch.Tensor:
    host = rng.integers(-(1 << 31), 1 << 31, size=shape, dtype=np.int32)
    return torch.from_numpy(host).cuda()


def device_bytes(seed: int, shape) -> torch.Tensor:
    """Random uint8 bytes made on the card from a seeded generator (the
    full-size inputs: several GiB, too slow to draw on the host)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                         generator=gen)


def device_words(seed: int, shape) -> torch.Tensor:
    shape = tuple(shape)
    return device_bytes(seed, shape[:-1] + (4 * shape[-1],)).view(torch.int32)


def table_gather_ms(coeffs: np.ndarray, data: torch.Tensor) -> tuple[float, torch.Tensor]:
    """The one-call yardstick of the byte-level premultiply: a `MUL_TABLE`
    gather, row i of `data` through table row `coeffs[i]` (the int32 index
    copy of the bytes is made before the clock starts). Never used by the
    port."""
    table = gf256.mul_table(data.device)
    rows = torch.from_numpy(coeffs.astype(np.int64)).cuda()[:, None]
    index = data.int()
    ms = cuda_ms(lambda: table[rows, index])
    return ms, table[rows, index]


def with_0_and_1(coeffs: np.ndarray) -> np.ndarray:
    flat = coeffs.reshape(-1)
    flat[0] = 1                        # coefficients 1 and 0 take part too
    if flat.size > 1:
        flat[1] = 0
    return coeffs


def check_gf256(rng, peaks, m, k, w, timed):
    coeff = with_0_and_1(rng.integers(0, 256, size=(m, k), dtype=np.uint8))
    masks = bitplane.coeff_to_masks(coeff, "cuda")
    planes = random_words(rng, (k, 8, w))
    got = gf256_matmul_planes(masks, planes)
    torch.cuda.synchronize()
    want = ref.gf256_matmul_planes_ref(masks, planes)
    torch.cuda.synchronize()
    rec = dict(kernel="gf256_matmul_planes", shape=f"m={m} k={k} W={w}",
               max_abs_err=max_abs_err(got, want))
    if rec["max_abs_err"] != 0:
        raise AssertionError(f"gf256_matmul_planes disagrees: {rec}")
    if timed:
        nbytes = 4 * 8 * w * (k + m) + masks.numel() * 4
        lop3 = 64 * m * k * w
        bms, by = bound(nbytes, lop3, peaks)
        rec.update(**kernel_times(lambda: gf256_matmul_planes(masks, planes),
                                  "gf256_matmul_planes"),
                   plain_ms=cuda_ms(
                       lambda: ref.gf256_matmul_planes_ref(masks, planes)),
                   bound_ms=bms, bound_by=by, library_ms=None,
                   bytes=nbytes, lop3_ops=lop3)
        if (m, k) == (1, 1):   # the premultiply: one table gather of 128 MiB
            data = device_bytes(11, (1, 32 * w))
            rec["library_ms"], _ = table_gather_ms(coeff[:, 0], data)
            del data
    return rec


def check_scale(rng, peaks, m, w, timed):
    coeffs = with_0_and_1(rng.integers(0, 256, size=m, dtype=np.uint8))
    masks = bitplane.coeff_to_masks(coeffs[:, None], "cuda")
    planes = device_words(int(rng.integers(1 << 30)), (m, 8, w))
    got = gf256_scale_planes(masks, planes)
    torch.cuda.synchronize()
    want = ref.gf256_scale_planes_ref(masks, planes)
    torch.cuda.synchronize()
    rec = dict(kernel="gf256_scale_planes", shape=f"M={m} W={w}",
               max_abs_err=max_abs_err(got, want))
    if rec["max_abs_err"] != 0:
        raise AssertionError(f"gf256_scale_planes disagrees: {rec}")
    del got, want
    if timed:
        nbytes = 2 * m * 32 * w + masks.numel() * 4
        lop3 = 64 * m * w
        bms, by = bound(nbytes, lop3, peaks)
        rec.update(**kernel_times(lambda: gf256_scale_planes(masks, planes),
                                  "gf256_scale_planes"),
                   plain_ms=cuda_ms(
                       lambda: ref.gf256_scale_planes_ref(masks, planes)),
                   bound_ms=bms, bound_by=by, bytes=nbytes, lop3_ops=lop3)
        del planes
        torch.cuda.empty_cache()
        # the byte-level entry point (pack, kernel, unpack) on M chunks of
        # 32 * W bytes, against the one-call table gather on the same bytes
        data = device_bytes(12, (m, 32 * w))
        rec["ops_gf256_scale_batch_ms"] = cuda_ms(
            lambda: ops.gf256_scale_batch(coeffs, data), reps=5)
        by_op = ops.gf256_scale_batch(coeffs, data)
        torch.cuda.empty_cache()
        rec["library_ms"], by_table = table_gather_ms(coeffs, data)
        if not torch.equal(by_op, by_table):
            raise AssertionError("ops.gf256_scale_batch != MUL_TABLE gather")
        del data, by_op, by_table
        torch.cuda.empty_cache()
    return rec


def device_rows(rng: np.random.Generator, rows: int, n: int,
                offset: int = 0) -> torch.Tensor:
    """(rows, n) uint8 on the card from the host generator; with `offset`,
    a contiguous view `offset` bytes into a larger allocation, so its rows
    start off 16-byte alignment."""
    host = rng.integers(0, 256, size=offset + rows * n, dtype=np.uint8)
    return torch.from_numpy(host).cuda()[offset:].view(rows, n)


def byte_kernel_record(rec, peaks, n, ins, outs, pairs, time_kernel,
                       time_plain) -> None:
    """Times and bounds of a byte-domain GF(256) kernel: `ins` input and
    `outs` output rows of n bytes, `pairs` (output, input) products. The
    bound counts each row read or written once (plus 32 bytes of column
    words a pair) and 8 LOP3 a pair per 4 bytes, the bit-matrix product
    the plane kernels count too; `design_ops` is the kernel's own count,
    15 ops per input and 4 bytes to expand the bit masks besides."""
    nbytes = n * (ins + outs) + 32 * pairs
    lop3 = 2 * pairs * n
    design_ops = (n // 4) * (15 * ins + 8 * pairs)
    bms, by = bound(nbytes, lop3, peaks)
    rec.update(**kernel_times(time_kernel, rec["kernel"]),
               plain_ms=cuda_ms(time_plain),
               bound_ms=bms, bound_by=by, bytes=nbytes, lop3_ops=lop3,
               design_ops=design_ops,
               design_ops_ms=design_ops / peaks["lop3_per_s"] * 1e3,
               library_ms=None)


def draw_coeffs(rng, shape, timed) -> np.ndarray:
    """Coefficients for a check: 0 and 1 among them, or for a timed check
    none (the plain versions skip 0 and copy for 1; the kernels do not)."""
    if timed:
        return rng.integers(2, 256, size=shape, dtype=np.uint8)
    return with_0_and_1(rng.integers(0, 256, size=shape, dtype=np.uint8))


def check_matmul_bytes(rng, peaks, m, k, n, timed, offset=0):
    coeff = draw_coeffs(rng, (m, k), timed)
    data = (device_bytes(15, (k, n)) if timed
            else device_rows(rng, k, n, offset))
    got = gf256_matmul_bytes(coeff, data)
    torch.cuda.synchronize()
    want = ref.gf256_matmul_bytes_ref(coeff, data)
    torch.cuda.synchronize()
    rec = dict(kernel="gf256_matmul_bytes",
               shape=f"m={m} k={k} n={n} offset={offset}",
               max_abs_err=max_abs_err(got, want))
    if rec["max_abs_err"] != 0:
        raise AssertionError(f"gf256_matmul_bytes disagrees: {rec}")
    del want
    if timed:
        byte_kernel_record(
            rec, peaks, n, k, m, m * k,
            lambda: gf256_matmul_bytes(coeff, data),
            lambda: ref.gf256_matmul_bytes_ref(coeff, data))
        if (m, k) == (1, 1):   # the premultiply: one table gather of 128 MiB
            rec["library_ms"], by_table = table_gather_ms(coeff[:, 0], data)
            if not torch.equal(got, by_table):
                raise AssertionError("gf256_matmul_bytes != MUL_TABLE gather")
    return rec


def check_scale_bytes(rng, peaks, m, n, timed, offset=0):
    coeffs = draw_coeffs(rng, m, timed)
    data = (device_bytes(16, (m, n)) if timed
            else device_rows(rng, m, n, offset))
    got = gf256_scale_bytes(coeffs, data)
    torch.cuda.synchronize()
    want = ref.gf256_scale_batch_ref(coeffs, data)
    torch.cuda.synchronize()
    rec = dict(kernel="gf256_scale_bytes",
               shape=f"M={m} n={n} offset={offset}",
               max_abs_err=max_abs_err(got, want))
    if rec["max_abs_err"] != 0:
        raise AssertionError(f"gf256_scale_bytes disagrees: {rec}")
    del want
    if timed:
        byte_kernel_record(
            rec, peaks, n, m, m, m,
            lambda: gf256_scale_bytes(coeffs, data),
            lambda: ref.gf256_scale_batch_ref(coeffs, data))
        torch.cuda.empty_cache()
        rec["library_ms"], by_table = table_gather_ms(coeffs, data)
        if not torch.equal(got, by_table):
            raise AssertionError("gf256_scale_bytes != MUL_TABLE gather")
    return rec


def check_plane_route(rng, m, k, n):
    """The two ports of each Pallas kernel agree: the byte kernels against
    `bitplane.pack`, the plane kernel and `unpack` on the same bytes."""
    coeff = with_0_and_1(rng.integers(0, 256, size=(m, k), dtype=np.uint8))
    data = device_rows(rng, k, n)
    planes = gf256_matmul_planes(bitplane.coeff_to_masks(coeff, "cuda"),
                                 bitplane.pack(data))
    by_matmul = max_abs_err(gf256_matmul_bytes(coeff, data),
                            bitplane.unpack(planes, n))
    coeffs = coeff[0].copy()
    masks = bitplane.coeff_to_masks(coeffs[:, None], "cuda")
    planes = gf256_scale_planes(masks, bitplane.pack(data))
    by_scale = max_abs_err(gf256_scale_bytes(coeffs, data),
                           bitplane.unpack(planes, n))
    torch.cuda.synchronize()
    recs = [dict(kernel="gf256_matmul_bytes", max_abs_err=by_matmul,
                 shape=f"plane route m={m} k={k} n={n}"),
            dict(kernel="gf256_scale_bytes", max_abs_err=by_scale,
                 shape=f"plane route M={k} n={n}")]
    for rec in recs:
        if rec["max_abs_err"] != 0:
            raise AssertionError(f"byte and plane routes disagree: {rec}")
    return recs


def check_groups(peaks, words, table, timed, label):
    """`xor_reduce_groups_words` on (T, W) words with a (G, Kmax) index
    table (or, with `table=None`, on (G, K, W) words) against its plain
    version; bound: each referenced row read once, each output written."""
    index = None if table is None else torch.from_numpy(table).cuda()
    got = xor_reduce_groups_words(words, table)
    torch.cuda.synchronize()
    want = ref.xor_reduce_groups_words_ref(words, index)
    torch.cuda.synchronize()
    rec = dict(kernel="xor_reduce_groups_words", shape=label,
               max_abs_err=max_abs_err(got, want))
    if rec["max_abs_err"] != 0:
        raise AssertionError(f"xor_reduce_groups_words disagrees: {rec}")
    if timed:
        w = words.shape[-1]
        if table is None:
            g, k = words.shape[0], words.shape[1]
            rows, entries = g * k, g * k
        else:
            g = table.shape[0]
            live = table[table >= 0]
            rows, entries = np.unique(live).size, live.size
        nbytes = 4 * w * (rows + g)
        bms, by = bound(nbytes, max(entries - g, 0) * w, peaks)
        rec.update(**kernel_times(
                       lambda: xor_reduce_groups_words(words, table),
                       "xor_reduce_groups"),
                   plain_ms=cuda_ms(
                       lambda: ref.xor_reduce_groups_words_ref(words, index)),
                   bound_ms=bms, bound_by=by, bytes=nbytes,
                   rows_read=rows, groups=g)
        if table is None and words.shape[1] == 2:   # the one-call yardstick
            add_xor_yardstick(rec, lambda: xor_reduce_groups_words(words),
                              "xor_reduce_groups", words[:, 0], words[:, 1])
        else:
            rec["library_ms"] = None
    return rec


def add_xor_yardstick(rec: dict, fn, label: str, a: torch.Tensor,
                      b: torch.Tensor) -> None:
    """Time a two-row fold `fn` (its kernel's name holds `label`) against
    its one-call yardstick `torch.bitwise_xor(a, b)`, never used by the
    port, into `rec`: each kernel alone (profiler) in two windows, in turns
    (fold, yardstick, yardstick, fold), so that a drift of the card falls
    on both alike; on an H100 the first window after heavier work ran
    2-3 % slow. `ms` and `library_ms` become the means of the pairs (the
    window `kernel_times` took first is kept as `ms_first_window`); the
    yardstick is also timed back to back by CUDA events."""
    def yardstick():
        return torch.bitwise_xor(a, b)

    f1, _ = kernel_device_ms(fn, label)
    y1, _ = kernel_device_ms(yardstick, "BitwiseXor")
    y2, _ = kernel_device_ms(yardstick, "BitwiseXor")
    f2, _ = kernel_device_ms(fn, label)
    rec.update(ms_first_window=rec["ms"], ms=(f1 + f2) / 2,
               ms_in_turns=[f1, f2], library_ms=(y1 + y2) / 2,
               library_ms_in_turns=[y1, y2],
               library_ms_events=cuda_ms(yardstick))


def rows_on_card(host: np.ndarray, offsets, dtype) -> list[torch.Tensor]:
    """Row i of `host` on the card as a view `offsets[i % len(offsets)]`
    elements into an allocation of its own."""
    rows = []
    for i, row in enumerate(host):
        off = offsets[i % len(offsets)]
        big = torch.zeros(off + row.size + 3, dtype=dtype, device="cuda")
        big[off:off + row.size] = torch.from_numpy(row).cuda()
        rows.append(big[off:off + row.size])
    return rows


def check_xor(rng, k, w, offsets) -> dict:
    """`xor_reduce_words` in both forms against its plain version, bit for
    bit: the dense (k, W) form as a view `offsets[0]` words into a larger
    tensor, the rows form with row i `offsets[i % len]` words into its own
    allocation; each call launches once per step of `chain_plan(k)`."""
    host = rng.integers(-(1 << 31), 1 << 31, size=(k, w), dtype=np.int32)
    off = offsets[0]
    big = torch.zeros(off + k * w + 3, dtype=torch.int32, device="cuda")
    big[off:off + k * w] = torch.from_numpy(host.reshape(-1)).cuda()
    dense = big[off:off + k * w].view(k, w)
    rows = rows_on_card(host, offsets, torch.int32)
    want = ref.xor_reduce_ref(dense)
    before = xor_reduce_words.launches
    by_dense, by_rows = xor_reduce_words(dense), xor_reduce_words(rows)
    torch.cuda.synchronize()
    launched = xor_reduce_words.launches - before
    rec = dict(kernel="xor_reduce_words",
               shape=f"k={k} W={w} word offsets={offsets}",
               max_abs_err=max(max_abs_err(by_dense, want),
                               max_abs_err(by_rows, want)))
    if rec["max_abs_err"] != 0 or launched != 2 * len(chain_plan(k)):
        raise AssertionError(f"xor_reduce_words disagrees: {rec}, "
                             f"{launched} launches")
    return rec


def check_xor_bytes(rng, k, n, offsets) -> dict:
    """`ops.xor_reduce` on k uint8 rows of n bytes, row i `offsets[i % len]`
    bytes into its own allocation (the head, tail and misaligned paths of
    the kernel), against the plain version, bit for bit."""
    host = rng.integers(0, 256, size=(k, n), dtype=np.uint8)
    rows = rows_on_card(host, offsets, torch.uint8)
    got = ops.xor_reduce(rows)
    torch.cuda.synchronize()
    rec = dict(kernel="xor_reduce_words",
               shape=f"ops.xor_reduce k={k} nbytes={n} byte offsets={offsets}",
               max_abs_err=max_abs_err(got, ref.xor_reduce_ref(rows)))
    if rec["max_abs_err"] != 0 or not np.array_equal(
            got.cpu().numpy(), np.bitwise_xor.reduce(host, axis=0)):
        raise AssertionError(f"ops.xor_reduce disagrees: {rec}")
    return rec


def time_xor(peaks, k, form) -> dict:
    """`xor_reduce_words` on k rows of 128 MiB, as one (k, W) tensor
    (`form="dense"`) or as k separate allocations (`"rows"`, the serial
    repair's form), checked against its plain version and timed; at k = 2
    beside the `torch.bitwise_xor` yardstick. Bound: each row read once,
    the output written once."""
    dense = device_words(17, (k, W_WORDS))
    words = dense if form == "dense" else [row.clone() for row in dense]
    if form == "rows":
        del dense
    got = xor_reduce_words(words)
    torch.cuda.synchronize()
    want = ref.xor_reduce_ref(words)
    rec = dict(kernel="xor_reduce_words", shape=f"k={k} W={W_WORDS} {form}",
               max_abs_err=max_abs_err(got, want))
    if rec["max_abs_err"] != 0:
        raise AssertionError(f"xor_reduce_words disagrees: {rec}")
    del got, want
    nbytes = 4 * W_WORDS * (k + 1)
    bms, by = bound(nbytes, (k - 1) * W_WORDS, peaks)
    rec.update(**kernel_times(lambda: xor_reduce_words(words),
                              "xor_reduce_words"),
               plain_ms=cuda_ms(lambda: ref.xor_reduce_ref(words)),
               bound_ms=bms, bound_by=by, bytes=nbytes)
    if k == 2:
        add_xor_yardstick(rec, lambda: xor_reduce_words(words),
                          "xor_reduce_words", words[0], words[1])
    else:
        rec["library_ms"] = None
    del words
    torch.cuda.empty_cache()
    return rec


def bytes_err(a: torch.Tensor, b: torch.Tensor, chunk: int = 1 << 28) -> int:
    """`max_abs_err` of two uint8 tensors of any size, a chunk at a time
    (no int64 copy of several GB)."""
    a, b = a.reshape(-1), b.reshape(-1)
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return max((max_abs_err(a[i: i + chunk], b[i: i + chunk])
                for i in range(0, a.numel(), chunk)), default=0)


def small_stripe_batches(device="cuda", stripes=(1, 4, 37),
                         sizes=(4096, 4099), seed=19):
    """Phase 2's small batches of `gf256_reconstruct_stripes`, from a
    seeded generator, laid out as a checkpoint load lays them out: RS(6,4)
    patterns (`STRIPE_PATTERNS`) with one and two lost rows mixed, rows of
    `sizes` bytes, in a byte space of two buffers. The first (the blob)
    holds a stripe's first k - f helpers and, at scattered even slots of
    its second half, its f lost rows, whose odd slots and tail must stay
    as they were; the second (the spare rows) its last f helpers. Helper
    rows lie all aligned, all 3 bytes past 16-byte alignment (the lost
    rows too: a scalar head and tail around the vectors) or 0, 1 and 3
    past it mixed. Yields (label, plan, bufs, n), the plan an
    `ec_checkpoint.StripeRepair` whose offsets index the buffers'
    concatenation."""
    code = RSCode(6, 4)
    coeffs = [code.repair_coeffs(*pat) for pat in STRIPE_PATTERNS]
    rng = np.random.default_rng(seed)
    for count in stripes:
        for n in sizes:
            for misalign in ((0,), (3,), (0, 1, 3)):
                patterns = rng.integers(0, len(coeffs), size=count)
                patterns[: min(count, 2)] = [0, 1][: min(count, 2)]
                slot = -(-n // 16) * 16 + 16
                blob = (count * code.k + 2 * count * code.m) * slot + 7
                order = rng.permutation(count * code.m)
                src_off = np.zeros((count, code.k), dtype=np.int64)
                dst_off = np.full((count, code.m), -1, dtype=np.int64)
                spare = 0
                for s, pat in enumerate(patterns):
                    f = coeffs[pat].shape[0]
                    for i in range(code.k):
                        at = misalign[(s + i) % len(misalign)]
                        if i < code.k - f:
                            src_off[s, i] = (s * code.k + i) * slot + at
                        else:
                            src_off[s, i] = blob + spare * slot + at
                            spare += 1
                    for o in range(f):
                        dst_off[s, o] = ((count * code.k
                                          + 2 * order[s * code.m + o]) * slot
                                         + misalign[0])
                bufs = [torch.from_numpy(rng.integers(
                    0, 256, size=size, dtype=np.uint8)).to(device)
                    for size in (blob, spare * slot + 16)]
                plan = ec_checkpoint.StripeRepair(
                    coeffs, patterns, src_off, dst_off, [],
                    int((dst_off >= 0).sum()), None)
                yield (f"S={count} n={n} misalign={misalign}", plan, bufs, n)


def load_layout(lost: tuple, seed: int):
    """Phase 7's load with domains `lost` lost, as `ECCheckpointer.load`
    lays it out on the card: `CKPT_STRIPES` RS(6,4) stripes of
    `CKPT_CHUNK` bytes on 8 domains (`place_stripes`), the blob in windows
    of `ec_checkpoint.WINDOW_BYTES` and the spare rows, all random bytes,
    and `ec_checkpoint.plan_repair`'s plan. Returns (plan, bufs)."""
    code = RSCode(6, 4)
    stripes = stripe_lib.place_stripes(CKPT_STRIPES, code, 8)
    alive = {(s.stripe_id, b) for s in stripes
             for b, node in enumerate(s.node_ids) if node not in lost}
    plan = ec_checkpoint.plan_repair(code, stripes, alive, CKPT_CHUNK)
    rows = CKPT_STRIPES * code.k
    per_window = ec_checkpoint.WINDOW_BYTES // CKPT_CHUNK
    sizes = [min(per_window, rows - w) * CKPT_CHUNK
             for w in range(0, rows, per_window)]
    return plan, [device_bytes(seed + i, (size,)) for i, size in
                  enumerate(sizes + [len(plan.spare) * CKPT_CHUNK])]


def check_stripes(peaks, label: str, plan, bufs: list, n: int,
                  per_stripe: dict | None = None) -> dict:
    """`gf256_reconstruct_stripes` on one batch against its plain version,
    bit for bit over every buffer (the destination rows and every byte
    around them). With `per_stripe` ({f: phase 2's `gf256_matmul_bytes`
    record at (f, 4) x n}) it is timed: `ms` by the profiler, `plain_ms`
    the checking call of the plain version by events, the bound (each row
    read or written once, the column words once, 2 LOP3 a byte of an
    (output, input) pair), and `per_stripe_ms`, the per-stripe launches
    it replaces (one `gf256_matmul_bytes` a stripe at its f) at their
    profiled times."""
    def kernel(out):
        return gf256_reconstruct_stripes(plan.coeffs, plan.patterns, out,
                                         plan.src_off, plan.dst_off, n)

    got = kernel([t.clone() for t in bufs])
    want = [t.clone() for t in bufs]
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    ref.gf256_reconstruct_stripes_ref(plan.coeffs, plan.patterns, want,
                                      plan.src_off, plan.dst_off, n)
    end.record()
    end.synchronize()
    fs = np.array([plan.coeffs[p].shape[0] for p in plan.patterns])
    k = plan.src_off.shape[1]
    rec = dict(kernel="gf256_reconstruct_stripes", shape=label,
               stripes=len(fs), patterns=len(plan.coeffs),
               outputs_per_stripe=np.bincount(fs).tolist(),
               max_abs_err=max(bytes_err(a, b) for a, b in zip(got, want)))
    if rec["max_abs_err"] != 0:
        raise AssertionError(f"gf256_reconstruct_stripes disagrees: {rec}")
    del got, want
    if per_stripe is not None:
        pairs = int(fs.sum()) * k
        nbytes = n * int((k + fs).sum()) + 32 * pairs
        bms, by = bound(nbytes, 2 * pairs * n, peaks)
        rec.update(**kernel_times(lambda: kernel(bufs),
                                  "gf256_reconstruct_stripes"),
                   plain_ms=start.elapsed_time(end),
                   bound_ms=bms, bound_by=by, bytes=nbytes, lop3_ops=2 * pairs * n,
                   library_ms=None,
                   per_stripe_launches=len(fs),
                   per_stripe_ms=float(sum(per_stripe[f]["ms"] for f in fs)))
    return rec


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    for name in EVENT_LOOPS:
        WRAPPERS[name].routes.update(dict.fromkeys(event_loop.ROUTES, 0))
    bitplane.pack.calls = bitplane.unpack.calls = 0


def read_launches() -> dict:
    """Each kernel's launches since `reset_launches`; raises if anything
    bit-sliced its bytes in that time."""
    if bitplane.pack.calls or bitplane.unpack.calls:
        raise AssertionError(f"bitplane.pack ran {bitplane.pack.calls} and "
                             f"unpack {bitplane.unpack.calls} times")
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def demo_scenario(failed=(0,)) -> tuple:
    cluster, bw = topology.aliyun_matrix()
    code = RSCode(6, 3)
    bwp = BandwidthProcess(base=bw, change_interval=2.0, mode="markov",
                           sigma=1.0, rho=0.9, seed=15)
    sc = Scenario(num_nodes=6, code=code, failed=failed, bw=bwp,
                  ingress=IngressModel(seed=15, duplex=0.5), chunk_mb=128)
    return cluster, code, sc


# device kernels grouped under short labels: the port's own kernels, the
# plain-torch ops of the bit-slicing around the plane kernels, then the rest
KERNEL_LABELS = ("gf256_matmul_bytes", "gf256_scale_bytes",
                 "gf256_matmul_planes", "xor_reduce_words",
                 "gf256_scale_planes", "xor_reduce_groups", "sum_functor",
                 "lshift", "rshift", "BitwiseAndFunctor", "BitwiseOrFunctor",
                 "BitwiseXorFunctor", "copy", "Fill", "CatArray", "index")
# the labels of `bitplane.pack` / `unpack`'s ops: no profiled path has any
PACK_LABELS = ("sum_functor", "lshift", "rshift", "BitwiseAndFunctor",
               "BitwiseOrFunctor")


def profile_repair(repair, phase: str = "profile_repair",
                   forbid: tuple = ()) -> dict:
    """One repair under torch.profiler: device kernel time by label, and the
    device's idle share of the repair's wall time (one stream: kernels do
    not overlap, so busy time is their sum). Raises if a label of `forbid`
    or of the bit-slicing shows.

    The profiler was seen to lose every activity record of a window on an
    H100 (the repair synchronises, and ran its kernels); a window that
    shows no device time is profiled again with another repair (the same
    bytes), up to `PROFILE_ATTEMPTS` windows, and only then raises."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(PROFILE_ATTEMPTS):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            tic = time.perf_counter()
            repair()
            wall_ms = (time.perf_counter() - tic) * 1e3
        by_label: dict[str, float] = {}
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            label = next((lb for lb in KERNEL_LABELS if lb in ev.name),
                         "other")
            by_label[label] = (by_label.get(label, 0.0)
                               + ev.time_range.elapsed_us() / 1e3)
        busy_ms = sum(by_label.values())
        if busy_ms > 0:
            break
    else:
        raise AssertionError(f"{phase}: no device time in "
                             f"{PROFILE_ATTEMPTS} profiled repairs")
    packing = sorted(set(by_label) & set(PACK_LABELS))
    if packing:
        raise AssertionError(f"{phase}: bit-slicing ops on the card: "
                             f"{packing}")
    shown = sorted(set(by_label) & set(forbid))
    if shown:
        raise AssertionError(f"{phase}: {shown} on the card: {by_label}")
    rec = dict(phase=phase, wall_ms=wall_ms, device_busy_ms=busy_ms,
               device_idle_share=1.0 - busy_ms / wall_ms,
               device_ms_by_label=dict(sorted(by_label.items(),
                                              key=lambda kv: -kv[1])))
    print(json.dumps(rec))
    return rec


def main_path(records: list) -> dict:
    """Phase 3: plan + simulate every single-failure scheme, encode a
    128 MiB-per-block stripe on the card, execute the BMF repair there."""
    cluster, code, sc = demo_scenario()
    sim = RepairSimulator(sc)
    results = {}
    for scheme in ("traditional", "ppr", "ppt", "bmf"):
        r = sim.run(scheme)
        results[scheme] = r
        print(f"-- {scheme}: {float(r.total_time)!r} s simulated over "
              f"{r.num_rounds} round(s)")
        if r.plan:
            for i, rnd in enumerate(r.plan.rounds):
                print(f"   round {i + 1}: " + ", ".join(
                    "->".join(cluster.name(x) for x in t.path)
                    for t in rnd.transfers))
        for line in r.log:
            print("   " + line)
    bmf = results["bmf"]

    rng = np.random.default_rng(0)
    data_np = rng.integers(0, 256, size=(code.k, BLOCK_BYTES), dtype=np.uint8)
    data = torch.from_numpy(data_np).cuda()
    torch.cuda.synchronize()

    reset_launches()
    tic = time.perf_counter()
    codeword = code.encode(data)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - tic
    tic = time.perf_counter()
    ex = executor.execute_plan(bmf.plan, code, codeword, device="cuda")
    torch.cuda.synchronize()
    repair_s = time.perf_counter() - tic
    launches = read_launches()

    head = 4 * MIB
    want_parity = gf256.gf_matmul_np(code.generator[code.k:],
                                     data_np[:, :head])
    if not np.array_equal(codeword[code.k:, :head].cpu().numpy(), want_parity):
        raise AssertionError("encoded parity (first 4 MiB) disagrees with "
                             "gf_matmul_np")
    lost = ex.reconstructed[0]
    if not (ex.verified is True and lost.is_cuda
            and lost.shape == (BLOCK_BYTES,)):
        raise AssertionError(f"BMF repair not verified: {ex.verified}")
    if not np.array_equal(lost[:head].cpu().numpy(), data_np[0, :head]):
        raise AssertionError("repaired block (first 4 MiB) != lost data")
    # the encode and one premultiply per helper, in bytes; no plane kernel;
    # one fold of two buffers for each helper but the first of a job
    helpers = sum(len(job.helpers) for job in bmf.plan.jobs)
    if (launches["gf256_matmul_bytes"] != 1 + helpers
            or launches["xor_reduce_words"] != helpers - len(bmf.plan.jobs)
            or launches["gf256_matmul_planes"] or launches["gf256_scale_planes"]
            or launches["gf256_scale_bytes"]
            or launches["xor_reduce_groups_words"]
            or launches["gf256_reconstruct_stripes"]):
        raise AssertionError(f"serial path launches {launches}")

    encode_steady = []            # the counted first call also grew the allocator
    for _ in range(5):
        tic = time.perf_counter()
        code.encode(data)
        torch.cuda.synchronize()
        encode_steady.append(time.perf_counter() - tic)

    def repair():
        executor.execute_plan(bmf.plan, code, codeword, device="cuda")
        torch.cuda.synchronize()

    steady = []                   # the first call above also grew the allocator
    for _ in range(5):
        tic = time.perf_counter()
        repair()
        steady.append(time.perf_counter() - tic)
    rec = dict(phase="main_path", block_bytes=BLOCK_BYTES,
               verified=ex.verified, bytes_moved=ex.bytes_moved,
               encode_wall_s=encode_s,
               encode_wall_s_median_of_5=statistics.median(encode_steady),
               repair_wall_s=repair_s,
               repair_wall_s_median_of_5=statistics.median(steady),
               launches=launches,
               simulated_s={s: float(r.total_time) for s, r in results.items()},
               bmf_log=bmf.log)
    print(json.dumps(rec))
    records.append(rec)
    # the fold reads its two buffers in place: no `torch.stack` copy
    records.append(profile_repair(repair, forbid=("CatArray",)))
    del data, codeword, ex, lost
    torch.cuda.empty_cache()
    return launches


def small_checks(records: list) -> None:
    """Phase 4: every scheme's plan, card vs CPU plain path, 4099 bytes."""
    rng = np.random.default_rng(1)
    for failed, schemes in (((0,), ("traditional", "ppr", "bmf",
                                    "bmf_static")),
                            ((0, 4), MULTI_SCHEMES)):
        _, code, sc = demo_scenario(failed)
        data = torch.from_numpy(
            rng.integers(0, 256, size=(code.k, 4099), dtype=np.uint8))
        cw_cpu = code.encode(data)
        cw_gpu = code.encode(data.cuda())
        if not torch.equal(cw_gpu.cpu(), cw_cpu):
            raise AssertionError("encode: card != CPU plain path")
        for scheme in schemes:
            plan = RepairSimulator(sc).run(scheme).plan
            on_gpu = executor.execute_plan(plan, code, cw_gpu, device="cuda")
            on_cpu = executor.execute_plan(plan, code, cw_cpu, device="cpu")
            same = all(torch.equal(on_gpu.reconstructed[j].cpu(),
                                   on_cpu.reconstructed[j])
                       for j in on_cpu.reconstructed)
            if not (on_gpu.verified and on_cpu.verified and same
                    and on_gpu.bytes_moved == on_cpu.bytes_moved):
                raise AssertionError(f"{scheme} failed={failed}: card and "
                                     "CPU repairs disagree")
    # one mixed batch: all 8 schemes under both failure patterns
    plans, cws = [], []
    for failed in ((0,), (0, 4)):
        _, code, sc = demo_scenario(failed)
        for scheme in SINGLE_SCHEMES + MULTI_SCHEMES:
            plans.append(scheme_plan(sc, scheme))
            cws.append(code.encode(torch.from_numpy(
                rng.integers(0, 256, size=(code.k, 4099), dtype=np.uint8))))
    code = RSCode(6, 3)
    on_cpu = dataplane.execute_plans_batch(plans, code, cws, device="cpu")
    on_gpu = dataplane.execute_plans_batch(
        plans, code, [cw.cuda() for cw in cws], device="cuda")
    same = all(torch.equal(on_gpu.reconstructed[b][j].cpu(), blk)
               for b, rec in enumerate(on_cpu.reconstructed)
               for j, blk in rec.items())
    if not (on_gpu.all_verified and on_cpu.all_verified and same
            and np.array_equal(on_gpu.bytes_moved, on_cpu.bytes_moved)):
        raise AssertionError("mixed batch: card and CPU plain path disagree")
    rec = dict(phase="small_checks", ok=True, mixed_batch_cases=len(plans))
    print(json.dumps(rec))
    records.append(rec)


def scheme_plan(sc, scheme: str):
    """The executed plan of one scheme; PPT plans a pipeline tree, whose
    bytes move through its store-and-forward lowering `ppt_round_plan`."""
    if scheme == "ppt":
        return ppt_round_plan(build_ppt_tree(sc.make_jobs()[0],
                                             sc.bw.matrix_at(0.0)))
    return RepairSimulator(sc).run(scheme).plan


def batch_layout(batch: int):
    """Phase 5's plans (one per stripe, the four schemes in turn),
    compiled, with the batch's round tables as `execute_plans_batch`
    lowers them on the host."""
    _, code, sc = demo_scenario()
    schemes = [BATCH_SCHEMES[b % len(BATCH_SCHEMES)] for b in range(batch)]
    plans = [compile_plan(scheme_plan(sc, s)) for s in schemes]
    n_nodes = max(pa.num_nodes for pa in plans)
    slots = max(pa.num_jobs for pa in plans) * n_nodes
    _, steps, _ = dataplane._schedule(plans, n_nodes, slots)
    return code, plans, slots, steps


def batched_path(records: list, batch: int) -> dict:
    """Phase 5: `batch` stripes of 3 x 128 MiB, one plan each, repaired by
    one `execute_plans_batch` call on the card."""
    code, plans, slots, steps = batch_layout(batch)
    rng = np.random.default_rng(5)
    heads, cws = [], []
    for _ in range(batch):
        data = np.frombuffer(bytearray(rng.bytes(code.k * BLOCK_BYTES)),
                             dtype=np.uint8).reshape(code.k, BLOCK_BYTES)
        heads.append(data[0, :HEAD].copy())
        cws.append(code.encode(torch.from_numpy(data).cuda()))
        del data
    torch.cuda.synchronize()
    serial_moved = []
    for pa, cw in zip(plans, cws):
        ex = executor.execute_plan(decompile(pa), code, cw, device="cuda")
        if not ex.verified:
            raise AssertionError("serial repair of a batch plan not verified")
        serial_moved.append(ex.bytes_moved)
        del ex
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def run():
        return dataplane.execute_plans_batch(plans, code, cws, device="cuda")

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    tic = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - tic
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    if not res.all_verified:
        raise AssertionError(f"batched repair not verified: {res.verified}")
    for b, rec in enumerate(res.reconstructed):
        lost = rec[0]
        if not (lost.is_cuda and lost.shape == (BLOCK_BYTES,)
                and np.array_equal(lost[:HEAD].cpu().numpy(), heads[b])):
            raise AssertionError(f"case {b}: repaired block != lost data")
    if res.bytes_moved.tolist() != serial_moved:
        raise AssertionError(f"bytes_moved {res.bytes_moved.tolist()} != "
                             f"serial {serial_moved}")
    want = {name: 0 for name in WRAPPERS}
    want.update(gf256_scale_bytes=1, xor_reduce_groups_words=len(steps))
    if launches != want:
        raise AssertionError(f"batched path launches {launches} != {want}")
    del res, lost
    steady = []
    for _ in range(5):
        tic = time.perf_counter()
        run()
        torch.cuda.synchronize()
        steady.append(time.perf_counter() - tic)
    rec = dict(phase="batched_path", stripes=batch,
               schemes=[BATCH_SCHEMES[b % len(BATCH_SCHEMES)]
                        for b in range(batch)],
               block_bytes=BLOCK_BYTES, all_verified=True,
               bytes_moved=serial_moved, rounds=len(steps),
               groups_per_round=[int(s.groups.shape[0]) for s in steps],
               kmax_per_round=[int(s.groups.shape[1]) for s in steps],
               wall_s_first=first_s, wall_s_median_of_5=statistics.median(steady),
               wall_s_all=steady, max_memory_allocated=peak,
               launches=launches)
    print(json.dumps(rec))
    records.append(rec)

    def traced():
        run()
        torch.cuda.synchronize()

    records.append(profile_repair(traced,
                                  phase=f"profile_batched_path_b{batch}"))
    del cws
    torch.cuda.empty_cache()
    return launches


def make_suite(name: str):
    """A phase-6 suite: 14 nodes under hot (2 s markov) churn; frozen to
    recorded traces where `epochs` is set."""
    p = SWEEP_SUITES[name]
    space = SampleSpace(codes=(p["code"],), cluster_sizes=(14,),
                        chunk_mb=(p["chunk_mb"],), regimes=("hot2s",),
                        failure_patterns=(p["pattern"],))
    live = MonteCarloSuite(name, p["cases"], space, schemes=p["schemes"],
                           base_seed=p["base_seed"])
    if p["epochs"] is None:
        return live
    return TraceSuite.freeze(live, num_epochs=p["epochs"], name=name)


def sweep_max_rel_err(got, want, name: str) -> float:
    """Raises unless every case and scheme has the same rounds and relay
    hops and a time within 1e-6 rtol; returns the largest relative error."""
    worst = 0.0
    for cg, cw in zip(got.cases, want.cases, strict=True):
        if set(cg.results) != set(cw.results):
            raise AssertionError(f"{name} case {cw.index}: schemes differ")
        for s, rw in cw.results.items():
            rg = cg.results[s]
            rel = abs(rg.total_time - rw.total_time) / abs(rw.total_time)
            if (rg.num_rounds != rw.num_rounds
                    or rg.relay_hops != rw.relay_hops or not rel <= 1e-6):
                raise AssertionError(
                    f"{name} case {cw.index} {s}: device "
                    f"({rg.num_rounds}, {rg.relay_hops}, {rg.total_time!r}) "
                    f"!= vectorized ({rw.num_rounds}, {rw.relay_hops}, "
                    f"{rw.total_time!r})")
            worst = max(worst, rel)
    return worst


def profile_device(fn, phase: str, groups: tuple = ()) -> dict:
    """One call of `fn` under torch.profiler: device busy time (kernels of
    one stream do not overlap, so it is their sum), the idle share of the
    wall time, kernel launches and the kernels that took the most time;
    with `groups`, (label, name substrings) pairs, also the device time
    and kernels of each label (a kernel goes to the first that matches,
    else to "other")."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tic) * 1e3
    by_name: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rec = by_name.setdefault(ev.name[:80], [0, 0.0])
        rec[0] += 1
        rec[1] += ev.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in by_name.values())
    if busy_ms <= 0:
        raise AssertionError(f"{phase}: no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    rec = dict(phase=phase, wall_ms_profiled=wall_ms, device_busy_ms=busy_ms,
               device_idle_share=1.0 - busy_ms / wall_ms,
               device_kernels=sum(n for n, _ in by_name.values()),
               top_kernels_ms={k: ms for k, (_, ms) in top})
    if groups:
        by_label: dict[str, list] = {}
        for name, (n, ms) in by_name.items():
            label = next((lb for lb, keys in groups
                          if any(key in name for key in keys)), "other")
            acc = by_label.setdefault(label, [0, 0.0])
            acc[0] += n
            acc[1] += ms
        rec["device_ms_by_label"] = {
            lb: dict(kernels=n, ms=ms) for lb, (n, ms) in
            sorted(by_label.items(), key=lambda kv: -kv[1][1])}
    return rec


def sweep_suite(records: list, name: str, device: str = "cuda") -> dict:
    """Phase 6 for one suite: checks, timings and a trace; returns the
    launches of its byte-verified device sweep."""
    counts = device_stepper.COUNTS
    p = SWEEP_SUITES[name]
    start = time.perf_counter()
    frozen, build_s = frozen_suite(name) if p["epochs"] else (None, 0.0)

    def suite():
        return frozen or make_suite(name)

    vec = run_sweep(suite(), executor="vectorized")
    reset_launches()
    counts.reset()
    dev = run_sweep(suite(), executor="device",
                    verify_bytes=SWEEP_VERIFY, device=device)
    torch.cuda.synchronize()
    launches = read_launches()
    checked = counts.as_dict()
    worst = sweep_max_rel_err(dev, vec, name)
    bv = dev.byte_verification
    if not bv.verified or len({i for i, _ in bv.checked}) != SWEEP_VERIFY:
        raise AssertionError(f"{name}: byte verification {bv}")
    # one data-plane call: one premultiply, one segment fold per round;
    # one event-loop launch per engine call
    want = {k: 0 for k in WRAPPERS}
    want.update(gf256_scale_bytes=1, xor_reduce_groups_words=bv.rounds,
                round_events=checked["round_calls"],
                pipeline_events=checked["pipeline_calls"])
    if launches != want or not sum(launches[k] for k in EVENT_LOOPS):
        raise AssertionError(f"{name}: sweep launches {launches} != {want}")
    routes = {k: dict(WRAPPERS[k].routes) for k in EVENT_LOOPS}
    if any(r["block"] for r in routes.values()):
        raise AssertionError(f"{name}: a suite batch took the block route: "
                             f"{routes}")
    if checked["host_batches"] or not checked["device_batches"]:
        raise AssertionError(f"{name}: batch routes {checked}")
    if p["epochs"] is None and not checked["horizon_grows"]:
        raise AssertionError(f"{name}: the live suite never grew its "
                             f"epoch horizon: {checked}")

    walls: dict[str, list] = {"vectorized": [], "device": []}
    timed_counts = []
    for i in range(SWEEP_REPEATS):        # in turns: v, d, d, v, v, d
        for ex in (("vectorized", "device") if i % 2 == 0
                   else ("device", "vectorized")):
            runs_on = suite()
            counts.reset()
            tic = time.perf_counter()
            run_sweep(runs_on, executor=ex, device=device)
            torch.cuda.synchronize()
            walls[ex].append(time.perf_counter() - tic)
            if ex == "device":
                timed_counts.append(counts.as_dict())
                if counts.host_batches:
                    raise AssertionError(f"{name}: host batches {counts}")
    runs_on = suite()
    counts.reset()
    prof = profile_device(lambda: run_sweep(runs_on, executor="device",
                                            device=device),
                          f"profile_sweep_{name}")
    if counts.host_batches:
        raise AssertionError(f"{name}: host batches {counts}")
    prof.update(counts=counts.as_dict())
    # the event loops' plain versions on the card, once: held to the
    # vectorized engine, traced, not timed
    runs_on = suite()
    counts.reset()
    reset_launches()
    with plain_event_loops():
        plain_out = []
        plain = profile_device(
            lambda: plain_out.append(run_sweep(runs_on, executor="device",
                                               device=device)),
            f"profile_sweep_{name}_plain")
    plain.update(counts=counts.as_dict(),
                 max_rel_err=sweep_max_rel_err(plain_out[0], vec, name))
    if counts.host_batches or any(read_launches()[k] for k in EVENT_LOOPS):
        raise AssertionError(f"{name}: the plain route took {counts} and "
                             f"launched {read_launches()}")
    cases = len(vec.cases)
    wall = {ex: statistics.median(w) for ex, w in walls.items()}
    rec = dict(phase="sweep", suite=name, cases=cases,
               schemes=list(p["schemes"]), epochs=p["epochs"],
               build_s=build_s, phase_s=time.perf_counter() - start,
               max_rel_err=worst, wall_s_median_of_3=wall, wall_s_all=walls,
               cases_per_s={ex: cases / w for ex, w in wall.items()},
               device_over_vectorized=wall["vectorized"] / wall["device"],
               counts_checked_run=checked, counts_timed_runs=timed_counts,
               planning_s={ex: sum(r.planning_time for c in sw.cases
                                   for r in c.results.values())
                           for ex, sw in (("vectorized", vec),
                                          ("device", dev))},
               byte_verification=dict(pairs=len(bv.checked), nbytes=bv.nbytes,
                                      verified=bv.verified,
                                      rounds=bv.rounds),
               launches=launches, launch_routes=routes, profile=prof,
               plain_route=plain)
    print(json.dumps(rec))
    records.append(rec)
    return launches


def sweep_phase(records: list, device: str = "cuda") -> dict:
    """Phase 6: the three suites; returns their summed launches."""
    total = {k: 0 for k in WRAPPERS}
    for name in SWEEP_SUITES:
        for k, n in sweep_suite(records, name, device).items():
            total[k] += n
    return total


# ------------------------------------------------------- phase 2: event loops
# The sweep's event loops held on the card: hand-made batches from a seeded
# generator, then the largest batch each wrapper got in one device sweep of
# each of phase 6's suites. The kernels' float64 work has no entry in the
# on-chip guide's table: FP64_PER_S is the H100 SXM data sheet's float64
# rate outside the tensor cores.
FP64_PER_S = 34e12
EVENT_GUARD = 100_000              # device_stepper._GUARD
FLOOR_STEPS = 100_000              # the step yardstick's chain
ROUTE_KEYS = ("ms", "ms_turns", "us_per_step", "bound_ms",
              "chain_floor_ms", "max_rel_err", "steps")
EVENT_KERNELS = {("round_events", "warp"): "round_events_warp_kernel",
                 ("round_events", "block"): "round_events_kernel",
                 ("pipeline_events", "warp"): "pipeline_events_warp_kernel",
                 ("pipeline_events", "block"): "pipeline_events_kernel"}
_FROZEN: dict = {}                 # phase 6's frozen suites, built once


def frozen_suite(name: str):
    """A trace-frozen phase-6 suite, built at its first use and replayed
    after; returns (suite, seconds the build took)."""
    if name not in _FROZEN:
        tic = time.perf_counter()
        _FROZEN[name] = (make_suite(name), time.perf_counter() - tic)
    return _FROZEN[name]


def synthetic_ctx(rng, B: int, N: int, E: int, M: int, *, interval,
                  cycle, can_ovf, device="cuda") -> event_loop.EventCtx:
    """A batch context: E epochs of random bandwidth (3-30 MB/s) a case,
    chunks of 8-64 MB, per-case epoch lengths (inf = a static network),
    trace cycling or clamping, ingress parameters and Dirichlet fan-in
    shares."""
    stack = rng.uniform(3.0, 30.0, (B, E, N, N))
    shares = np.zeros((B, N, M + 1, M))
    shares[:, :, :, 0] = 1.0
    for m in range(2, M + 1):
        shares[:, :, m, :m] = rng.dirichlet(np.ones(m), (B, N))
    f64 = dict(dtype=torch.float64, device=device)
    return event_loop.EventCtx(
        stack=torch.tensor(stack, **f64),
        interval=torch.tensor(np.broadcast_to(interval, (B,)), **f64),
        num_ep=torch.full((B,), E, dtype=torch.int64, device=device),
        cycle=torch.tensor(np.broadcast_to(cycle, (B,)), device=device),
        can_ovf=torch.tensor(np.broadcast_to(can_ovf, (B,)), device=device),
        chunk=torch.tensor(rng.uniform(8.0, 64.0, B), **f64),
        degrade=torch.tensor(rng.uniform(0.0, 0.3, B), **f64),
        floor=torch.tensor(rng.uniform(0.2, 0.6, B), **f64),
        duplex=torch.tensor(rng.uniform(0.5, 1.0, B), **f64),
        shares=torch.tensor(shares, **f64))


def synthetic_rounds(rng, B: int, R: int, T: int, H: int, N: int,
                     idle: float = 0.3):
    """(B, R, T, H) hop tables of random paths over distinct nodes, hop
    counts 1..H, and a share `idle` of (case, round) rows with no transfer
    at all (padding transfers inside a row too)."""
    paths = np.argsort(rng.random((B, R, T, N)), axis=-1)[..., :H + 1]
    n_hops = rng.integers(0, H + 1, (B, R, T))
    n_hops[rng.random((B, R)) < idle] = 0
    return paths[..., :-1].copy(), paths[..., 1:].copy(), n_hops


def synthetic_trees(rng, B: int, N: int, shape: str):
    """(B, N - 1) edge tables of random repair trees over nodes 0..N-1 (0
    the root): "flat" (every node's parent the root: depth 1), "zero"
    (the same at depth 0: no level is scanned), "deep" (a chain), "mixed"
    (a random recursive tree), "scrambled" (that tree with depths drawn
    from -1..4, which need not nest), with some edges missing and one case
    with no edge."""
    E = N - 1
    child = np.tile(np.arange(1, N), (B, 1))
    parent = np.zeros((B, E), dtype=np.int64)
    for b in range(B):
        for e, c in enumerate(range(1, N)):
            parent[b, e] = {"flat": 0, "zero": 0, "deep": c - 1}.get(
                shape, int(rng.integers(0, c)))
    depth = np.zeros((B, E), dtype=np.int64)
    for e in range(E):                  # parents come before their children
        depth[:, e] = np.where(parent[:, e] == 0, 1,
                               depth[np.arange(B), np.maximum(parent[:, e] - 1,
                                                               0)] + 1)
    if shape == "zero":
        depth[:] = 0
    if shape == "scrambled":
        depth = rng.integers(-1, 5, (B, E))
    valid = rng.random((B, E)) < 0.85
    valid[0] = False
    return child, parent, depth, valid


def event_steps(packed: np.ndarray) -> int:
    """The serial chain: for each round the most steps any case took."""
    return int(packed[event_loop.STEPS].max(axis=1, initial=0).sum())


def event_bound(name: str, ctx, tables, packed: np.ndarray,
                peaks: dict) -> tuple[float, str, float, float]:
    """(bound_ms, bound_by, bytes, ops) of one call on this run's data:
    every table, parameter and output once, the share table once, and of
    the epoch stack only the epochs each case reached (through the clock
    it ended at); the float64 operations of the steps each case took
    (~10 a transfer or 12 an edge, 4 a node, 2 an edge a depth level)."""
    _, E, N, _ = ctx.stack.shape
    t_end = packed[event_loop.T_END][-1]
    interval = ctx.interval.cpu().numpy()
    num_ep = ctx.num_ep.cpu().numpy()
    with np.errstate(invalid="ignore"):
        reached = np.where(np.isfinite(interval),
                           np.floor(t_end / interval) + 1, 1)
    reached = np.minimum(np.minimum(reached, num_ep), E).sum()
    small = sum(getattr(ctx, f).numel() * getattr(ctx, f).element_size()
                for f in ("interval", "num_ep", "cycle", "can_ovf", "chunk",
                          "degrade", "floor", "duplex", "shares"))
    nbytes = (reached * N * N * 8 + small + sum(np.asarray(a).size * 4
                                                for a in tables)
              + 8 * packed.shape[2] + packed.size * 8)
    steps = packed[event_loop.STEPS].sum()
    if name == "round_events":
        ops = steps * (10 * tables[0].shape[2] + 4 * N)
    else:
        levels = int(np.max(tables[2], initial=0))
        ops = steps * (12 * tables[0].shape[1] + 4 * N
                       + 2 * tables[0].shape[1] * levels)
    t_bytes = nbytes / peaks["mem_bytes_per_s"] * 1e3
    t_ops = ops / FP64_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            ) + (float(nbytes), float(ops))


def hand_event_batches(device="cuda", B: int = 48):
    """Phase 2's hand-made event-loop batches, as (name, ctx, tables, t0,
    label, guard, expected error or None): epochs crossed, cycled,
    clamped and static; R = 1 and 6; trees of depth 0, 1, random, a
    chain and depths that do not nest; a round and a tree above the warp
    route's 32 lanes and nodes (the block kernels); a horizon overflow
    and a 3-step guard."""
    rng = np.random.default_rng(17)
    N = 14
    # epochs crossed: per-case intervals 0.2-2 s over 16 epochs, the
    # trace cycled (even cases) or clamped (odd) past its end, and static
    # networks (interval inf) in a third of the cases
    interval = rng.uniform(0.2, 2.0, B)
    interval[::3] = np.inf
    cycle = np.arange(B) % 2 == 0
    for R, T, H in ((1, 13, 1), (1, 9, 4), (6, 12, 3)):
        ctx = synthetic_ctx(rng, B, N, 16, 6, interval=interval, cycle=cycle,
                            can_ovf=False, device=device)
        tables = synthetic_rounds(rng, B, R, T, H, N)
        yield ("round_events", ctx, tables, rng.uniform(0.0, 5.0, B),
               f"hand R={R} T={T} H={H}", EVENT_GUARD, None)
    for shape in ("zero", "flat", "mixed", "deep", "scrambled"):
        ctx = synthetic_ctx(rng, B, N, 16, N - 1, interval=interval,
                            cycle=cycle, can_ovf=False, device=device)
        yield ("pipeline_events", ctx, synthetic_trees(rng, B, N, shape),
               rng.uniform(0.0, 5.0, B), f"hand tree {shape}", EVENT_GUARD,
               None)
    # a live horizon of 2 short epochs: some case outruns it
    ctx = synthetic_ctx(rng, B, N, 2, 6, interval=0.05, cycle=False,
                        can_ovf=True, device=device)
    overflow = event_loop.EpochHorizonError
    yield ("round_events", ctx,
           synthetic_rounds(rng, B, 3, 12, 3, N, idle=0.0), np.zeros(B),
           "hand horizon overflow", EVENT_GUARD, overflow)
    yield ("pipeline_events", ctx, synthetic_trees(rng, B, N, "mixed"),
           np.zeros(B), "hand horizon overflow", EVENT_GUARD, overflow)
    # a guard of 3 steps
    ctx = synthetic_ctx(rng, B, N, 16, 6, interval=0.05, cycle=True,
                        can_ovf=False, device=device)
    yield ("round_events", ctx,
           synthetic_rounds(rng, B, 2, 12, 3, N, idle=0.0), np.zeros(B),
           "hand guard 3", 3, RuntimeError)
    yield ("pipeline_events", ctx, synthetic_trees(rng, B, N, "deep"),
           np.zeros(B), "hand guard 3", 3, RuntimeError)
    # above the warp route's 32 lanes and nodes: 40 transfers, 47 edges
    # on 48 nodes
    N = 48
    ctx = synthetic_ctx(rng, B, N, 16, 6, interval=interval, cycle=cycle,
                        can_ovf=False, device=device)
    yield ("round_events", ctx, synthetic_rounds(rng, B, 2, 40, 3, N),
           rng.uniform(0.0, 5.0, B), "hand N=48 R=2 T=40 H=3", EVENT_GUARD,
           None)
    ctx = synthetic_ctx(rng, B, N, 16, N - 1, interval=interval,
                        cycle=cycle, can_ovf=False, device=device)
    yield ("pipeline_events", ctx, synthetic_trees(rng, B, N, "mixed"),
           rng.uniform(0.0, 5.0, B), "hand N=48 tree mixed", EVENT_GUARD,
           None)


def event_lanes(name: str, tables) -> int:
    """A call's transfers (a round) or edges (a tree) a case."""
    return np.shape(tables[0])[2 if name == "round_events" else 1]


@functools.lru_cache(maxsize=1)
def step_floor_library() -> ctypes.CDLL:
    """The step yardstick, `scripts/event_step_floor.cu` (a measurement,
    not a kernel of the port), built with nvcc into build/step_floor/."""
    src = Path(__file__).resolve().parent / "scripts" / "event_step_floor.cu"
    out = src.parents[1] / "build" / "step_floor"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libevent_step_floor.so"
    subprocess.run([kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-shared",
                    str(src), "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.event_step_floor_launch.argtypes = [
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.event_step_floor_launch.restype = ctypes.c_int
    return lib


def step_floor_us() -> float:
    """µs of the step yardstick: one warp doing a step's least dependent
    work, FLOOR_STEPS steps in a chain."""
    lib = step_floor_library()
    out = torch.empty(32, dtype=torch.float64, device="cuda")

    def chain():
        kernel_build.check_launch(lib.event_step_floor_launch(
            0.75, 3.0, 16.0, FLOOR_STEPS, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "event_step_floor")

    return cuda_ms(chain, reps=5) * 1e3 / FLOOR_STEPS


def hold_event_loop(name: str, ctx, tables, t0, label: str, *,
                    guard: int = EVENT_GUARD, expect=None, peaks=None,
                    floor_us: float | None = None) -> list:
    """Each route of the kernel against its plain version on the card, on
    the same inputs: equal end clocks (max abs and rel err printed) and
    equal step counts, no flag; or, with `expect` an exception type, all
    must raise it. The warp route is held where the case fits it, and must
    refuse it where not. With `peaks` (a timed check), also the routes'
    times, taken in turns (warp, block, block, warp), the bound, the
    chain's floor (`floor_us` a step) and µs a step. One record a route."""
    wrapper = WRAPPERS[name]

    def run(route=None, use_kernel=True):
        return wrapper(ctx, *tables, t0, guard=guard, use_kernel=use_kernel,
                       _route=route)

    want = run(use_kernel=False).cpu().numpy()
    fits = event_loop.warp_route_fits(event_lanes(name, tables),
                                      ctx.stack.shape[2])
    routes = list(event_loop.ROUTES) if fits else ["block"]
    if not fits:
        try:
            run("warp")
        except event_loop.DeviceUnsupported:
            pass
        else:
            raise AssertionError(f"{name} {label}: the warp route took a "
                                 "case too large for it")
    recs = []
    for route in routes:
        got = run(route).cpu().numpy()
        rec = dict(kernel=name, route=route, shape=label,
                   cases=int(got.shape[2]), rounds=int(got.shape[1]))
        recs.append(rec)
        if expect is not None:
            raised = []
            for packed in (got, want):
                try:
                    event_loop.check_flags(packed[event_loop.FLAGS])
                    raised.append(None)
                except expect as e:
                    raised.append(type(e).__name__)
            if raised != [expect.__name__] * 2:
                raise AssertionError(f"{name} {label} ({route}): kernel and "
                                     f"plain raised {raised}, not "
                                     f"{expect.__name__}")
            rec.update(raised=expect.__name__, max_abs_err=0.0)
            continue
        if got[event_loop.FLAGS].any() or want[event_loop.FLAGS].any():
            raise AssertionError(f"{name} {label} ({route}): flags "
                                 f"{got[2]} / {want[2]}")
        err = np.abs(got[event_loop.T_END] - want[event_loop.T_END])
        rel = err / np.maximum(np.abs(want[event_loop.T_END]), 1e-300)
        rec.update(max_abs_err=float(err.max(initial=0.0)),
                   max_rel_err=float(rel.max(initial=0.0)),
                   steps=event_steps(want),
                   steps_equal=bool(np.array_equal(got[event_loop.STEPS],
                                                   want[event_loop.STEPS])))
        rec["t_end_equal"] = bool(np.array_equal(got[event_loop.T_END],
                                                 want[event_loop.T_END]))
        if not (rec["steps_equal"] and rec["t_end_equal"]):
            raise AssertionError(f"{name} {label}: kernel and plain differ: "
                                 f"{rec}")
    if peaks is not None and expect is None:
        turns = {route: [] for route in routes}
        for route in routes + routes[::-1]:
            turns[route].append(kernel_times(
                lambda: run(route), EVENT_KERNELS[name, route]))
        plain_ms = cuda_ms(lambda: run(use_kernel=False), reps=2)
        bms, by, nbytes, ops = event_bound(name, ctx, tables, want, peaks)
        for rec in recs:
            ts = turns[rec["route"]]
            rec.update(ms=statistics.mean(t["ms"] for t in ts),
                       ms_turns=[t["ms"] for t in ts],
                       profile_windows=sum(t["profile_windows"] for t in ts),
                       ms_events=statistics.mean(t["ms_events"] for t in ts),
                       ms_single=statistics.mean(t["ms_single"] for t in ts),
                       plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                       bytes=nbytes, fp64_ops=ops,
                       chain_floor_ms=rec["steps"] * floor_us * 1e-3,
                       library_ms=None)  # no PyTorch call runs an event loop
            rec["us_per_step"] = rec["ms"] * 1e3 / max(rec["steps"], 1)
    for rec in recs:
        print(json.dumps(rec))
    return recs


@contextlib.contextmanager
def recorded_event_loops():
    """While active, keeps for each event-loop wrapper and each of R = 1
    and R > 1 the device engines' call of the most (cases x rounds x
    transfers or edges) that ran to its end, its inputs copied:
    {(name, R > 1): (ctx, tables, t0)}."""
    kept: dict = {}
    sizes: dict = {}
    original = device_stepper._EngineBase._events

    def events(self, loop, *tables, t0):
        t_end = original(self, loop, *tables, t0=t0)   # raises on a flag
        shape = np.shape(tables[0])
        key = (loop.__name__, len(shape) == 4 and shape[1] > 1)
        if math.prod(shape) > sizes.get(key, -1):
            sizes[key] = math.prod(shape)
            kept[key] = (self.ctx, tuple(np.array(a) for a in tables),
                         np.array(t0, dtype=float))
        return t_end

    device_stepper._EngineBase._events = events
    try:
        yield kept
    finally:
        device_stepper._EngineBase._events = original


def event_loop_checks(records: list, peaks: dict,
                      device: str = "cuda") -> dict:
    """Phase 2 for the event loops; returns each kernel's timed record."""
    if device == "cuda":
        lib = load_library().lib
        for n, m in ((0, 1), (13, 14), (300, 70)):
            if (lib.round_events_smem(n, m)
                    != event_loop.round_smem_bytes(n, m)
                    or lib.pipeline_events_smem(n, m)
                    != event_loop.pipeline_smem_bytes(n, m)):
                raise AssertionError("event_loop.py's shared-memory sizes "
                                     "differ from event_loop.cu's")
    floor_us = step_floor_us()
    records.append(dict(phase="event_step_floor", steps=FLOOR_STEPS,
                        us_per_step=floor_us))
    print(json.dumps(records[-1]))
    for name, ctx, tables, t0, label, guard, expect in hand_event_batches(
            device):
        records.extend(hold_event_loop(name, ctx, tables, t0, label,
                                       guard=guard, expect=expect))

    timed: dict = {}
    for name in SWEEP_SUITES:
        tic = time.perf_counter()
        suite = (frozen_suite(name)[0] if SWEEP_SUITES[name]["epochs"]
                 else make_suite(name))
        with recorded_event_loops() as kept:
            run_sweep(suite, executor="device", device=device)
        torch.cuda.synchronize()
        # R > 1 first: a whole plan's rounds are the kernel's longest work
        for (kname, multi), (ctx, tables, t0) in sorted(kept.items(),
                                                        reverse=True):
            recs = hold_event_loop(
                kname, ctx, tables, t0,
                f"{name} largest batch, R {'> 1' if multi else '= 1'}",
                peaks=peaks, floor_us=floor_us)
            by_route = {}
            for rec in recs:
                rec.update(suite=name, record_s=time.perf_counter() - tic)
                by_route[rec["route"]] = {k: rec[k] for k in ROUTE_KEYS}
            records.extend(recs)
            if kname not in timed:     # the main path's route, both beside
                timed[kname] = dict(recs[0], routes=by_route)
        del kept
        torch.cuda.empty_cache()
    missing = set(EVENT_LOOPS) - set(timed)
    if missing:
        raise AssertionError(f"phase 6's suites called no {missing}")
    return timed


@contextlib.contextmanager
def plain_event_loops():
    """While active, device engines run the event loops' plain torch
    versions (`use_kernel=False`) instead of the kernels."""
    factories = (device_stepper.make_round_engine,
                 device_stepper.make_pipeline_engine)
    device_stepper.make_round_engine = functools.partial(factories[0],
                                                         use_kernel=False)
    device_stepper.make_pipeline_engine = functools.partial(
        factories[1], use_kernel=False)
    try:
        yield
    finally:
        (device_stepper.make_round_engine,
         device_stepper.make_pipeline_engine) = factories


def lost_data_stripes(num_stripes: int, lost: tuple) -> int:
    """Stripes of an RS(6,4) checkpoint on 8 domains that lose a data
    block with the domains `lost` (the RAID-5 rotation of
    `ec/stripe.py`): the stripes a load repairs, all in one launch of
    `gf256_reconstruct_stripes`."""
    code = RSCode(6, 4)
    return sum(any(s.node_ids[b] in lost for b in range(code.k))
               for s in stripe_lib.place_stripes(num_stripes, code, 8))


def same_bytes(a, b) -> bool:
    """Two train states equal leaf by leaf, byte for byte, where they lie."""
    pa, pb = tree.items(a), tree.items(b)
    return [p for p, _ in pa] == [p for p, _ in pb] and all(
        x.dtype == y.dtype and x.shape == y.shape and x.device == y.device
        and torch.equal(x.reshape(-1).view(torch.uint8),
                        y.reshape(-1).view(torch.uint8))
        for (_, x), (_, y) in zip(pa, pb))


def train_phase(records: list, enc: dict, device: str = "cuda") -> dict:
    """Phase 7: `repro_torch.launch.train.run` at full width (trains,
    saves async, loses domains (1, 5) at step 6, repairs, resumes, saves
    at the end), then the final checkpoint loaded twice and the resume's
    loss checked; `enc` is phase 2's record of the encode kernel at the
    save's shape. Returns the phase's record."""
    start = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        free = shutil.disk_usage(work).free
        if free < 2.5 * CKPT_BYTES:
            raise RuntimeError(f"phase 7 needs {2.5 * CKPT_BYTES:.4g} bytes "
                               f"free in {work}, has {free}")
        argv = [*TRAIN_ARGS, "--ckpt-dir", str(work), "--device", device]
        args = train_launch.parse_args(argv)
        cfg, shape, tcfg = train_launch.configs(args)
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        tic = time.perf_counter()
        state, recs = train_launch.run(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - tic
        run_launches = read_launches()
        peak = torch.cuda.max_memory_allocated()

        steps = [r for r in recs if r["event"] == "step"]
        saves = [r for r in recs if r["event"] == "save"]
        repair, = [r for r in recs if r["event"] == "repair"]
        losses = [r["loss"] for r in steps]
        if not np.isfinite(losses).all():
            raise AssertionError(f"phase 7: a loss is not finite: {losses}")
        tokens = args.batch * args.seq_len
        for r in steps:
            print(f"   step {r['step']}: loss {r['loss']!r} "
                  f"{r['seconds'] * 1e3:.1f} ms "
                  f"({tokens / r['seconds']:.0f} tokens/s)")
        later = [r["seconds"] for r in steps[1:]]
        print(f"   first step {steps[0]['seconds']:.3f} s, median of the "
              f"rest {statistics.median(later):.3f} s "
              f"({tokens / statistics.median(later):.0f} tokens/s), peak "
              f"device memory {peak} bytes")
        for r in saves:
            print(f"   save {r['step']}: " + ", ".join(
                f"{k} {v:.3f} s" for k, v in r["seconds"].items())
                + f" (the encode kernel alone: {enc['ms']:.4f} ms by the "
                f"profiler, bound {enc['bound_ms']:.4f} ms)")
        print(f"   repair at step {repair['step']}: {repair}")

        ck = train_launch.checkpointer(args, device)
        final = ck.latest_step()
        manifest = json.loads(
            (Path(ck._step_dir(final)) / "manifest.json").read_text())
        stripes = manifest["num_stripes"]
        if (stripes, manifest["chunk_bytes"]) != (CKPT_STRIPES, CKPT_CHUNK):
            raise AssertionError(f"phase 7: {stripes} stripes of "
                                 f"{manifest['chunk_bytes']} bytes, phase 2 "
                                 f"timed {CKPT_STRIPES} of {CKPT_CHUNK}")
        # the run: one encode a save, one reconstruct of every stripe that
        # lost a data block at the injected failure
        want = {k: 0 for k in WRAPPERS}
        want["gf256_matmul_bytes"] = len(saves)
        want["gf256_reconstruct_stripes"] = 1
        if (run_launches != want
                or repair["stripes_repaired"] != lost_data_stripes(stripes,
                                                                   (1, 5))
                or repair["blocks_repaired"] != repair["stripes_repaired"]):
            raise AssertionError(f"phase 7 run: launches {run_launches} != "
                                 f"{want}, repair {repair}")

        # domains that hold no block count as lost too (a small state)
        held = {d for st in stripe_lib.place_stripes(stripes, RSCode(6, 4), 8)
                for d in st.node_ids}
        loads, restored = {}, None
        for lost in TRAIN_LOSSES:
            restored = None
            reset_launches()
            torch.cuda.synchronize()
            held_bytes = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            tic = time.perf_counter()
            restored, report = ck.load(state, lost_domains=lost)
            torch.cuda.synchronize()
            wall = time.perf_counter() - tic
            # the load's own peak: what it allocated above what was held
            # before it (the template state among it), its leaves included
            load_peak = torch.cuda.max_memory_allocated() - held_bytes
            launches = read_launches()
            want = {k: 0 for k in WRAPPERS}
            want["gf256_reconstruct_stripes"] = 1
            repaired = lost_data_stripes(stripes, lost)
            if (launches != want
                    or report.blocks_repaired != repaired
                    or report.stripes_repaired != repaired
                    or report.lost_domains != tuple(
                        sorted(set(lost) | (set(range(8)) - held)))
                    or not (report.sim and report.sim.total_time > 0)):
                raise AssertionError(f"phase 7 load {lost}: launches "
                                     f"{launches} != {want}, {report}")
            if not same_bytes(restored, state):
                raise AssertionError(f"phase 7 load {lost}: a leaf differs "
                                     "from the state in memory")
            loads[str(lost)] = dict(
                launches={k: v for k, v in launches.items() if v},
                blocks_repaired=report.blocks_repaired,
                stripes_repaired=report.stripes_repaired,
                sim_total_time=float(report.sim.total_time),
                repair_wall_s=report.wall_seconds, load_wall_s=wall,
                stages_s=dict(ck.last_load), peak_bytes=load_peak,
                peak_over_state=load_peak / manifest["total_bytes"])
            print(f"   load {lost}: {json.dumps(loads[str(lost)])}")
            print(f"   load {lost} peak device memory: {load_peak} bytes "
                  f"above the {held_bytes} held before it, "
                  f"{load_peak / manifest['total_bytes']:.4f} x the state's "
                  f"{manifest['total_bytes']} bytes")
            print(f"   load {lost} stages: " + ", ".join(
                f"{k} {v:.3f} s" for k, v in ck.last_load.items()))

        # resume: one more step from the restored state and from the state
        # in memory, on the same batch; the forward pass is deterministic
        step_fn = make_train_step(cfg, tcfg)
        batch = SyntheticStream(cfg, shape).batch_at(args.steps)
        loss_restored = float(step_fn(restored, batch)[1]["loss"])
        loss_memory = float(step_fn(state, batch)[1]["loss"])
        if not abs(loss_restored - loss_memory) < 1e-5:
            raise AssertionError(f"phase 7 resume: loss {loss_restored!r} "
                                 f"from the restored state, {loss_memory!r} "
                                 "from the state in memory")
        del restored
        # where a steady step's time goes on the card
        traced = profile_device(lambda: step_fn(state, batch),
                                "profile_train_step", TRAIN_STEP_GROUPS)
        print(json.dumps(traced))
        del state
        torch.cuda.empty_cache()
        rec = dict(
            phase="train_checkpoint", argv=TRAIN_ARGS,
            state_bytes=manifest["total_bytes"], num_stripes=stripes,
            step_s=[r["seconds"] for r in steps],
            steps_trained=[r["step"] for r in steps],
            first_step_s=steps[0]["seconds"],
            median_step_s=statistics.median(later),
            tokens_per_s_median=tokens / statistics.median(later),
            losses=losses, max_memory_allocated=peak, run_wall_s=run_s,
            saves=saves, repair=repair, run_launches=run_launches,
            loads=loads, resume_loss=dict(restored=loss_restored,
                                          memory=loss_memory),
            encode_kernel=dict(shape=enc["shape"], ms=enc["ms"],
                               bound_ms=enc["bound_ms"],
                               bound_by=enc["bound_by"],
                               plain_ms=enc["plain_ms"],
                               max_abs_err=enc["max_abs_err"]),
            profile=traced,
            launches={"run": run_launches,
                      **{f"load_{lost}": {k: v["launches"].get(k, 0)
                                          for k in WRAPPERS}
                         for lost, v in loads.items()}},
            phase_s=time.perf_counter() - start)
        print(json.dumps(rec))
        records.append(rec)
        return rec
    finally:
        shutil.rmtree(work, ignore_errors=True)


def arch_config(arch: str, layers: int | None = None, dtype: str | None = None):
    """A published config, its depth cut to `layers` (the encoder's too)
    and its dtype replaced where given; the widths stay."""
    changes = {}
    if layers is not None:
        changes["num_layers"] = layers
        if get_arch(arch).is_encoder_decoder:
            changes["encoder_layers"] = layers
    if dtype is not None:
        changes["dtype"] = dtype
    return dataclasses.replace(get_arch(arch), **changes)


def device_params(cfg, seed: int, device) -> dict:
    """Random params drawn on `device` from a seeded generator."""
    return model_lib.init_params(
        torch.Generator(device=device).manual_seed(seed), cfg)


def prompt_tokens(cfg, batch: int, length: int, seed: int, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, length),
                                         dtype=np.int64).astype(np.int32)
                            ).to(device)


def vision_inputs(cfg, batch: int, length: int, vision: int, seed: int,
                  device):
    """pos3 (3, B, T) with the first `vision` positions on a square
    (t=0, h, w) patch grid and the text after it at the grid's side and
    on, all three streams alike (Qwen2-VL's layout), and stub vision
    embeddings (B, vision, d) at the token embeddings' scale."""
    side = int(round(vision ** 0.5))
    grid = np.arange(vision)
    text = np.arange(length - vision) + side
    pos3 = np.stack([np.concatenate([np.zeros(vision, int), text]),
                     np.concatenate([grid // side, text]),
                     np.concatenate([grid % side, text])]).astype(np.int32)
    pos3 = np.ascontiguousarray(np.broadcast_to(pos3[:, None],
                                                (3, batch, length)))
    gen = torch.Generator(device=device).manual_seed(seed)
    embeds = torch.randn((batch, vision, cfg.d_model), generator=gen,
                         device=device) / cfg.d_model ** 0.5
    return torch.from_numpy(pos3).to(device), embeds.to(torch.bfloat16)


@torch.inference_mode()
def decode_vs_forward(params, cfg, tokens, steps: int, pos3=None,
                      vision=None, chunk: int = 1024) -> list[float]:
    """tests/test_serve_equiv.py's invariant: prefill T-k tokens, decode
    the last k, each step's logits against the teacher-forced forward's
    at that position; returns each step's largest difference."""
    b, t = tokens.shape
    p = t - steps
    logits, _ = transformer.forward(params, cfg, tokens, pos3=pos3,
                                    vision_embeds=vision, chunk=chunk,
                                    remat=False)
    _, cache = transformer.prefill(
        params, cfg, tokens[:, :p], max_len=t, chunk=chunk,
        pos3=None if pos3 is None else pos3[:, :, :p], vision_embeds=vision)
    errs = []
    for i in range(p, t):
        lg, cache = transformer.decode_step(
            params, cfg, tokens[:, i], cache, chunk=chunk,
            pos3=None if pos3 is None else pos3[:, :, i:i + 1])
        if not torch.isfinite(lg).all():
            raise AssertionError(f"phase 8: {cfg.name} decode step {i} "
                                 "logits are not finite")
        errs.append(float((lg - logits[:, i]).abs().max()))
    return errs


def equiv_check(name: str, spec: dict, device, params=None) -> dict:
    """8b/8c: one config of `SERVE_EQUIV` held to its tolerance."""
    cfg = arch_config(name, spec["layers"])
    if params is None:
        params = device_params(cfg, 1, device)
    length = spec["prompt"] + spec["steps"]
    tokens = prompt_tokens(cfg, spec["batch"], length, 2, device)
    pos3 = vision = None
    if spec.get("vision"):
        pos3, vision = vision_inputs(cfg, spec["batch"], length,
                                     spec["vision"], 3, device)
    tic = time.perf_counter()
    errs = decode_vs_forward(params, cfg, tokens, spec["steps"], pos3, vision,
                             chunk=min(1024, spec["prompt"]))
    rec = dict(arch=name, layers=cfg.num_layers, batch=spec["batch"],
               prompt=spec["prompt"], steps=spec["steps"],
               vision_positions=spec.get("vision", 0), tol=spec["tol"],
               max_abs_err=max(errs), step_errs=errs,
               seconds=time.perf_counter() - tic)
    if cfg.attn_kind == "sliding":
        w = cfg.sliding_window
        rec["window_starts"] = [min(max(i - (w - 1), 0), length - w)
                                for i in range(spec["prompt"], length)]
    print(f"   decode == forward, {name} ({cfg.num_layers} layers): "
          f"{json.dumps(rec)}")
    if not max(errs) < spec["tol"]:
        raise AssertionError(f"phase 8: {name} decode differs from the "
                             f"forward pass by {max(errs)!r} >= "
                             f"{spec['tol']}")
    return rec


def serve_chunk(cfg, prompt: int) -> int:
    """The attention chunk a serve run uses: the launcher's min(1024,
    prompt) for decoder-only configs; 1,024 for whisper, whose encoder
    attends over the frames, not the prompt."""
    return 1024 if cfg.is_encoder_decoder else min(1024, prompt)


def frames_on(cfg, batch: int, frames: int, seed: int, device):
    """Stub encoder frame embeddings (B, frames, d), standard normal from
    `seed` (numpy), fp32 on `device`."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (batch, frames, cfg.d_model)).astype(np.float32)).to(device)


@torch.inference_mode()
def greedy_logits(params, cfg, batch: dict, steps: int, kv_dtype: str,
                  forced=None) -> tuple[list, list]:
    """Prefill, then `steps` decode steps: each stage's logits (on the
    host) and the token fed next, the argmax or, with `forced`, those
    tokens. The transformer runs its KV-cache path with `kv_dtype`; the
    other families their serve steps (`serve/serve_step.py`)."""
    tokens = batch["tokens"]
    chunk = serve_chunk(cfg, tokens.shape[1])
    max_len = tokens.shape[1] + steps
    if model_lib.family_module(cfg) is transformer:
        logits, cache = transformer.prefill(params, cfg, tokens, max_len,
                                            chunk=chunk, kv_dtype=kv_dtype)

        def step(token, cache):
            return transformer.decode_step(params, cfg, token, cache,
                                           chunk=chunk)
    else:
        logits, cache = serve_step.make_prefill(
            cfg, chunk=chunk, max_len=max_len)(params, batch)
        make = (serve_step.make_whisper_decode_step if cfg.is_encoder_decoder
                else serve_step.make_decode_step)
        fn = make(cfg, chunk=chunk)

        def step(token, cache):
            return fn(params, token, cache)
    outs, fed = [logits.float().cpu()], []
    for i in range(steps):
        token = (forced[i].to(tokens.device) if forced is not None
                 else torch.argmax(logits, dim=-1).to(torch.int32))
        fed.append(token.cpu())
        logits, cache = step(token, cache)
        outs.append(logits.float().cpu())
    return outs, fed


def card_vs_cpu(name: str, spec: dict, device, phase: str = "phase 8") -> dict:
    """8d / 9c: prefill + greedy decode on the card against the same
    params on the CPU, which is fed the card's tokens; each stage's logits
    within the tolerance and the greedy tokens equal wherever the card's
    top-2 margin exceeds twice it (`tol=None`: reported, not held)."""
    cfg = arch_config(spec["arch"], spec["layers"], spec.get("dtype"))
    kv_dtype = spec.get("kv_dtype", "bf16")
    params = device_params(cfg, 4, device)
    batch = {"tokens": prompt_tokens(cfg, spec["batch"], spec["prompt"], 5,
                                     device)}
    if cfg.is_encoder_decoder:
        batch["frames"] = frames_on(cfg, spec["batch"], spec["frames"], 6,
                                    device)
    tic = time.perf_counter()
    card, fed = greedy_logits(params, cfg, batch, spec["steps"], kv_dtype)
    card_s = time.perf_counter() - tic
    params = tree.map(lambda x: x.cpu(), params)
    tic = time.perf_counter()
    cpu, _ = greedy_logits(params, cfg, {k: v.cpu() for k, v in
                                         batch.items()}, spec["steps"],
                           kv_dtype, forced=fed)
    cpu_s = time.perf_counter() - tic
    del params
    errs = [float((a - b).abs().max()) for a, b in zip(card, cpu)]
    tol = spec["tol"]
    agree = close = 0
    for a, b in zip(card, cpu):
        top2 = a.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        same = a.argmax(-1) == b.argmax(-1)
        agree += int(same.sum())
        if tol is not None:
            clear = margin > 2 * tol
            close += int((~clear).sum())
            if not bool(same[clear].all()):
                raise AssertionError(f"{phase}: {name}: a greedy token "
                                     "differs between the card and the CPU "
                                     "at a clear margin")
    rec = dict(case=name, arch=cfg.name, layers=cfg.num_layers,
               dtype=cfg.dtype, kv_dtype=kv_dtype, batch=spec["batch"],
               prompt=spec["prompt"], frames=spec.get("frames"),
               steps=spec["steps"], tol=tol,
               max_abs_err=max(errs), stage_errs=errs,
               greedy_tokens_equal=agree, greedy_tokens=len(card) *
               spec["batch"], close_calls=close if tol is not None else None,
               card_s=card_s, cpu_s=cpu_s)
    print(f"   card vs CPU, {name}: {json.dumps(rec)}")
    for lg in card:
        if not torch.isfinite(lg).all():
            raise AssertionError(f"{phase}: {name}: card logits not finite")
    if tol is not None and not max(errs) < tol:
        raise AssertionError(f"{phase}: {name}: card and CPU logits differ "
                             f"by {max(errs)!r} >= {tol}")
    return rec


def kv_read_bytes(cfg, batch: int, positions: int, elem: int = 2) -> int:
    """Bytes of k and v a decode step reads over every layer."""
    return (2 * cfg.num_layers * batch * positions * cfg.num_kv_heads
            * cfg.hd * elem)


def serve_phase(records: list, device: str = "cuda") -> dict:
    """Phase 8: 8a the serve launcher at qwen2_15b's full width, then one
    decode step traced; 8b-8c decode == forward at full width; 8d card
    against CPU; 8e the kernels' launches while serving (none)."""
    start = time.perf_counter()
    args = serve_launch.parse_args(SERVE_ARGS)
    cfg = get_arch(args.arch).reduced() if args.reduced else \
        get_arch(args.arch)
    reset_launches()
    params, run = serve_launch.run([*SERVE_ARGS, "--device", device])
    run_launches = read_launches()
    if any(run_launches.values()):
        raise AssertionError(f"phase 8: serving launched {run_launches}")
    tokens = run["tokens"]
    if (tuple(tokens.shape) != (args.batch, args.gen_tokens)
            or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size):
        raise AssertionError(f"phase 8: generated {tuple(tokens.shape)} "
                             f"tokens in [{int(tokens.min())}, "
                             f"{int(tokens.max())}]")
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in tree.leaves(params))
    steps_ms = [t * 1e3 for t in run["decode_step_s"]]
    # a decode step at cache index i reads every weight once and the
    # i + 1 filled positions of k and v in every layer
    bounds_ms = [(weight_bytes + kv_read_bytes(cfg, args.batch,
                                               args.prompt_len + i + 1))
                 / HBM_BYTES_PER_S * 1e3 for i in range(args.gen_tokens)]
    median_ms = statistics.median(steps_ms[1:])
    print(f"   prefill ({args.batch} x {args.prompt_len} tokens) "
          f"{run['prefill_s'] * 1e3:.3f} ms; decode first "
          f"{steps_ms[0]:.3f} ms, median {median_ms:.3f} ms "
          f"({args.batch / median_ms * 1e3:.1f} tokens/s) against a bound "
          f"of {statistics.median(bounds_ms):.4f} ms ({weight_bytes} weight "
          f"bytes); peak device memory {run['peak_memory_bytes']} bytes")

    # one steady decode step under the profiler
    batch = serve_launch.prompts(cfg, args.batch, args.prompt_len, args.seed)
    chunk = min(1024, args.prompt_len)
    with torch.inference_mode():
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        prefill = serve_step.make_prefill(cfg, chunk=chunk,
                                          max_len=args.prompt_len + 4)
        torch.cuda.synchronize()
        tic = time.perf_counter()
        logits, cache = prefill(params, batch)     # warm: the run's came first
        torch.cuda.synchronize()
        prefill_warm_ms = (time.perf_counter() - tic) * 1e3
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        step = serve_step.make_decode_step(cfg, chunk=chunk)
        _, cache = step(params, token, cache)
        traced = profile_device(lambda: step(params, token, cache),
                                "profile_decode_step", TRAIN_STEP_GROUPS)
    print(json.dumps(traced))
    print(f"   a second prefill {prefill_warm_ms:.3f} ms; the traced decode "
          f"step: {traced['device_kernels']} kernels, device busy "
          f"{traced['device_busy_ms']:.3f} ms of "
          f"{traced['wall_ms_profiled']:.3f}")
    del cache, logits

    equiv = []
    for name, spec in SERVE_EQUIV.items():
        same = name == cfg.name and spec["layers"] is None
        equiv.append(equiv_check(name, spec, device,
                                 params if same else None))
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    vs_cpu = [card_vs_cpu(name, spec, device)
              for name, spec in SERVE_CPU.items()]
    torch.cuda.empty_cache()
    phase_launches = read_launches()
    if any(phase_launches.values()):
        raise AssertionError(f"phase 8: launches {phase_launches}")
    rec = dict(
        phase="serve", argv=SERVE_ARGS, weight_bytes=weight_bytes,
        prefill_ms=run["prefill_s"] * 1e3, prefill_warm_ms=prefill_warm_ms,
        decode_step_ms=steps_ms,
        decode_first_ms=steps_ms[0], decode_median_ms=median_ms,
        decode_tokens_per_s=args.batch / median_ms * 1e3,
        run_tokens_per_s=run["tokens_per_s"], run_wall_s=run["seconds"],
        decode_bound_ms=statistics.median(bounds_ms),
        decode_bound_by="bytes",
        max_memory_allocated=run["peak_memory_bytes"],
        sample=tokens[0, :12].tolist(), profile=traced,
        launches_per_decode_step=traced["device_kernels"],
        decode_vs_forward=equiv, card_vs_cpu=vs_cpu,
        launches={"run": run_launches, "phase": phase_launches},
        phase_s=time.perf_counter() - start)
    print(json.dumps(rec))
    records.append(rec)
    return rec


def zamba2_step_bytes(cfg, params, batch: int, positions: int) -> int:
    """Bytes a zamba2 decode step must move with `positions` filled cache
    slots: every weight byte read once, every layer's SSM (fp32) and conv
    state read and written once, and the filled k / v of every shared
    point read once."""
    weights = sum(p.numel() * p.element_size() for p in tree.leaves(params))
    d_in, heads, n, conv_dim = mamba2.dims(cfg)
    ssm = cfg.num_layers * batch * heads * mamba2.MAMBA_HEAD_DIM * n * 4
    conv = cfg.num_layers * batch * (mamba2.CONV_K - 1) * conv_dim * 2
    kv = (2 * zamba2.num_shared_points(cfg) * batch * positions
          * cfg.num_kv_heads * cfg.hd * 2)
    return weights + 2 * ssm + 2 * conv + kv


def family_serve(device) -> dict:
    """9a: the serve launcher at zamba2_7b's full width and depth, each
    decode step beside its bound, then a warm prefill and one steady
    decode step traced."""
    args = serve_launch.parse_args(FAMILY_SERVE_ARGS)
    cfg = get_arch(args.arch).reduced() if args.reduced else \
        get_arch(args.arch)
    params, run = serve_launch.run([*FAMILY_SERVE_ARGS, "--device", device])
    tokens = run["tokens"]
    if (tuple(tokens.shape) != (args.batch, args.gen_tokens)
            or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab_size):
        raise AssertionError(f"phase 9a: generated {tuple(tokens.shape)} "
                             f"tokens in [{int(tokens.min())}, "
                             f"{int(tokens.max())}]")
    n_params = sum(p.numel() for p in tree.leaves(params))
    steps_ms = [t * 1e3 for t in run["decode_step_s"]]
    bounds_ms = [zamba2_step_bytes(cfg, params, args.batch,
                                   args.prompt_len + i + 1)
                 / HBM_BYTES_PER_S * 1e3 for i in range(args.gen_tokens)]
    median_ms = statistics.median(steps_ms[1:])
    print(f"   zamba2_7b ({n_params} params): prefill ({args.batch} x "
          f"{args.prompt_len} tokens) {run['prefill_s'] * 1e3:.3f} ms; "
          f"decode first {steps_ms[0]:.3f} ms, median {median_ms:.3f} ms "
          f"({min(steps_ms[1:]):.3f}-{max(steps_ms[1:]):.3f}; "
          f"{args.batch / median_ms * 1e3:.1f} tokens/s) against a bound "
          f"of {statistics.median(bounds_ms):.4f} ms; peak device memory "
          f"{run['peak_memory_bytes']} bytes")
    batch = serve_launch.prompts(cfg, args.batch, args.prompt_len, args.seed)
    chunk = min(1024, args.prompt_len)
    with torch.inference_mode():
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        prefill = serve_step.make_prefill(cfg, chunk=chunk,
                                          max_len=args.prompt_len + 4)
        torch.cuda.synchronize()
        tic = time.perf_counter()
        logits, cache = prefill(params, batch)     # warm: the run's came first
        torch.cuda.synchronize()
        prefill_warm_ms = (time.perf_counter() - tic) * 1e3
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        step = serve_step.make_decode_step(cfg, chunk=chunk)
        _, cache = step(params, token, cache)
        traced = profile_device(lambda: step(params, token, cache),
                                "profile_zamba2_decode_step",
                                TRAIN_STEP_GROUPS)
    print(json.dumps(traced))
    print(f"   a second prefill {prefill_warm_ms:.3f} ms; the traced decode "
          f"step: {traced['device_kernels']} kernels, device busy "
          f"{traced['device_busy_ms']:.3f} ms of "
          f"{traced['wall_ms_profiled']:.3f}")
    del cache, logits, params
    torch.cuda.empty_cache()
    return dict(
        argv=FAMILY_SERVE_ARGS, params=n_params,
        prefill_ms=run["prefill_s"] * 1e3, prefill_warm_ms=prefill_warm_ms,
        decode_step_ms=steps_ms, decode_first_ms=steps_ms[0],
        decode_median_ms=median_ms,
        decode_range_ms=[min(steps_ms[1:]), max(steps_ms[1:])],
        decode_tokens_per_s=args.batch / median_ms * 1e3,
        run_tokens_per_s=run["tokens_per_s"], run_wall_s=run["seconds"],
        decode_bound_ms=statistics.median(bounds_ms),
        decode_bound_by="bytes",
        max_memory_allocated=run["peak_memory_bytes"],
        sample=tokens[0, :12].tolist(), profile=traced,
        launches_per_decode_step=traced["device_kernels"])


@torch.inference_mode()
def family_equiv(name: str, spec: dict, device) -> dict:
    """9b: one case of `FAMILY_EQUIV`: each decode step's logits against
    the teacher-forced forward's at its position, within the tolerance
    (`tol=None`: reported, not held); rwkv6's forward at chunk 16 against
    chunk 64 too."""
    cfg = arch_config(spec.get("arch", name), spec["layers"],
                      spec.get("dtype"))
    params = device_params(cfg, 1, device)
    length = spec["prompt"] + spec["steps"]
    tokens = prompt_tokens(cfg, spec["batch"], length, 2, device)
    batch = {"tokens": tokens[:, :spec["prompt"]]}
    chunk = serve_chunk(cfg, spec["prompt"])
    rec = dict(case=name, arch=cfg.name, layers=cfg.num_layers,
               dtype=cfg.dtype, batch=spec["batch"], prompt=spec["prompt"],
               steps=spec["steps"], tol=spec["tol"])
    tic = time.perf_counter()
    if cfg.is_encoder_decoder:
        batch["frames"] = frames_on(cfg, spec["batch"], spec["frames"], 3,
                                    device)
        rec["frames"] = spec["frames"]
        full, _ = whisper.forward(params, cfg, batch["frames"], tokens,
                                  chunk=chunk, remat=False)
        step = serve_step.make_whisper_decode_step(cfg, chunk=chunk)
    else:
        if cfg.ssm_kind == "rwkv6":
            full, _ = rwkv6.forward(params, cfg, tokens, remat=False)
            c16, _ = rwkv6.forward(params, cfg, tokens, chunk=16,
                                   remat=False)
            rec["chunk_16_vs_64"] = float((c16 - full).abs().max())
            rec["chunk_tol"] = spec["chunk_tol"]
            del c16
        else:
            full, _ = zamba2.forward(params, cfg, tokens, attn_chunk=chunk,
                                     remat=False)
        step = serve_step.make_decode_step(cfg, chunk=chunk)
    _, cache = serve_step.make_prefill(cfg, chunk=chunk, max_len=length)(
        params, batch)
    errs, step_ms = [], []
    for i in range(spec["prompt"], length):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = step(params, tokens[:, i], cache)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(lg).all():
            raise AssertionError(f"phase 9b: {name} decode step {i} logits "
                                 "are not finite")
        errs.append(float((lg - full[:, i]).abs().max()))
    rec.update(max_abs_err=max(errs), step_errs=errs, decode_step_ms=step_ms,
               decode_median_ms=statistics.median(step_ms),
               seconds=time.perf_counter() - tic)
    print(f"   decode == forward, {name} ({cfg.num_layers} layers): "
          f"{json.dumps(rec)}")
    if not np.isfinite(rec.get("chunk_16_vs_64", 0.0)):
        raise AssertionError(f"phase 9b: {name}: a forward is not finite")
    if spec["tol"] is not None and not max(errs) < spec["tol"]:
        raise AssertionError(f"phase 9b: {name} decode differs from the "
                             f"forward pass by {max(errs)!r} >= "
                             f"{spec['tol']}")
    if rec.get("chunk_tol") is not None and \
            not rec["chunk_16_vs_64"] < spec["chunk_tol"]:
        raise AssertionError(f"phase 9b: {name} forward at chunk 16 differs "
                             f"from chunk 64 by {rec['chunk_16_vs_64']!r} >= "
                             f"{spec['chunk_tol']}")
    del params, cache, full
    torch.cuda.empty_cache()
    return rec


def family_train(name: str, spec: dict, device) -> dict:
    """9d: `spec["steps"]` train steps (AdamW, fp32 moments) at full width
    on the synthetic stream: each step's loss finite, the params changed;
    step times, peak memory and one more step traced."""
    cfg = arch_config(name, spec["layers"])
    shape = ShapeConfig("chip", "train", spec["seq"], spec["batch"])
    tcfg = TrainConfig(adamw=AdamWConfig(peak_lr=3e-3, warmup_steps=1))
    torch.cuda.reset_peak_memory_stats()
    state = init_state(7, cfg, tcfg, device=device)
    n_params = sum(p.numel() for p in tree.leaves(state["params"]))
    params0 = state["params"]
    step_fn = make_train_step(cfg, tcfg)
    stream = SyntheticStream(cfg, shape)
    losses, step_s = [], []
    for i in range(spec["steps"]):
        batch = stream.batch_at(i)
        torch.cuda.synchronize()
        tic = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - tic)
    peak = torch.cuda.max_memory_allocated()
    changed = sum(not torch.equal(a, b) for a, b in
                  zip(tree.leaves(params0), tree.leaves(state["params"])))
    leaves = len(tree.leaves(params0))
    del params0
    tokens = {k: list(v.shape) for k, v in batch.items()}
    traced = profile_device(lambda: step_fn(state, batch),
                            f"profile_{name}_train_step", TRAIN_STEP_GROUPS)
    rec = dict(arch=name, layers=cfg.num_layers, params=n_params,
               batch_shapes=tokens, losses=losses, step_s=step_s,
               first_step_s=step_s[0],
               median_step_s=statistics.median(step_s[1:]),
               max_memory_allocated=peak, leaves_changed=changed,
               leaves=leaves, profile=traced)
    print(f"   train {name} ({cfg.num_layers} layers, {n_params} params, "
          f"{tokens}): {json.dumps({k: v for k, v in rec.items() if k != 'profile'})}")
    print(json.dumps(traced))
    if not np.isfinite(losses).all():
        raise AssertionError(f"phase 9d: {name}: a loss is not finite: "
                             f"{losses}")
    if changed == 0:
        raise AssertionError(f"phase 9d: {name}: no param changed")
    del state, batch
    torch.cuda.empty_cache()
    return rec


def family_phase(records: list, device: str = "cuda") -> dict:
    """Phase 9: 9a zamba2_7b served at full width; 9b decode == forward at
    full width; 9c card against CPU in fp32; 9d train steps; 9e the eight
    kernels' launches over all of it (none)."""
    start = time.perf_counter()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    serve = family_serve(device)
    equiv = [family_equiv(name, spec, device)
             for name, spec in FAMILY_EQUIV.items()]
    vs_cpu = [card_vs_cpu(name, spec, device, phase="phase 9c")
              for name, spec in FAMILY_CPU.items()]
    torch.cuda.empty_cache()
    trains = [family_train(name, spec, device)
              for name, spec in FAMILY_TRAIN.items()]
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"phase 9: launches {launches}")
    rec = dict(phase="families", serve=serve, decode_vs_forward=equiv,
               card_vs_cpu=vs_cpu, train=trains, launches=launches,
               phase_s=time.perf_counter() - start)
    print(json.dumps(rec))
    records.append(rec)
    return rec


# phase 10: the multi-device half. 10a: the trainer on a one-card mesh
# (NCCL, one rank) at phase 7's full width and shape, from the same init
# and batches as a no-mesh run; its checkpoint, repair and re-mesh.
MESH_ARGS = [a for a in TRAIN_ARGS if a not in ("--fail-at", "6")]
MESH_STEPS = 3
MESH_LOST = (1, 5)
# the mesh run's losses against the no-mesh run's: on a 1x1 mesh every op
# runs through DTensor dispatch and the regions of `local_map` on the
# whole tensors, the same kernels but for the MLP's and the projections'
# products (`a @ b` where the no-mesh path calls `torch.einsum`), whose
# bf16 results may differ in their last bit
MESH_LOSS_TOL = 2e-2
# 10b: the dry run (`launch/dryrun.py`) at production size on fake 256-
# and 512-rank worlds, each cell in its own process, all four at once;
# every tensor is fake, nothing is allocated on the card
DRYRUN_CELLS = (("smollm_360m", "train_4k", "single"),
                ("smollm_360m", "train_4k", "multi"),
                ("qwen2_15b", "decode_32k", "single"),
                ("grok1_314b", "train_4k", "single"))
DRYRUN_TIMEOUT_S = 600
# each cell's per-device bytes (arguments + eager peak) before the loss
# on a mesh became vocab-parallel: NVIDIA H100 80GB HBM3, 700 W, torch
# 2.11, rounded as PERF.md's phase 10b table (kept for the comparison
# printed beside this run's)
DRYRUN_BEFORE = {("smollm_360m", "train_4k", "single"): 59.85e9,
                 ("smollm_360m", "train_4k", "multi"): 55.71e9,
                 ("qwen2_15b", "decode_32k", "single"): 0.607e9,
                 ("grok1_314b", "train_4k", "single"): 101.99e9}


def _on(x, device: str) -> bool:
    local = x.to_local() if isinstance(x, DTensor) else x
    return local.device.type == torch.device(device).type


def mesh_train(records: list, device: str = "cuda") -> dict:
    """Phase 10a: `make_train_step` with `MeshRules` on a one-rank mesh
    against the no-mesh step, the EC checkpoint of the DTensor state
    (byte-equal to the plain save), the repair after losing domains
    `MESH_LOST` and one more step on a fresh mesh. Returns its record."""
    start = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    backend = "nccl" if device == "cuda" else "gloo"
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_IB_DISABLE", "1")
    dist.init_process_group(backend, init_method=f"file://{work / 'store'}",
                            rank=0, world_size=1)
    try:
        free = shutil.disk_usage(work).free
        if free < 2.5 * CKPT_BYTES:
            raise RuntimeError(f"phase 10a needs {2.5 * CKPT_BYTES:.4g} "
                               f"bytes free in {work}, has {free}")
        argv = [*MESH_ARGS, "--ckpt-dir", str(work / "mesh"),
                "--device", device]
        args = train_launch.parse_args(argv)
        cfg, shape, tcfg = train_launch.configs(args)
        stream = SyntheticStream(cfg, shape)
        batches = [stream.batch_at(i) for i in range(MESH_STEPS + 1)]
        step = make_train_step(cfg, tcfg)
        state0 = init_state(args.seed, cfg, tcfg, device=device)

        plain, plain_losses = state0, []
        for b in batches[:MESH_STEPS]:
            plain, m = step(plain, b)
            plain_losses.append(float(m["loss"]))
        del plain

        mesh = make_test_mesh(data=1, model=1, device=device)
        rules = rules_for(mesh)
        logical = state_logical(cfg, tcfg, rules)
        placed = reshard_state(state0, rules.dmesh,
                               tree_shardings(rules, state0, logical))
        del state0
        mesh_step = make_train_step(cfg, tcfg, rules)
        mesh_losses, step_s = [], []
        for b in batches[:MESH_STEPS]:
            tic = time.perf_counter()
            placed, m = mesh_step(placed, b)
            loss = m["loss"]
            if not (isinstance(loss, DTensor) and _on(loss, device)):
                raise AssertionError(f"phase 10a: the loss is {type(loss)} "
                                     f"on {loss.device}")
            mesh_losses.append(float(loss.full_tensor()))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - tic)
        off = [p for p, x in tree.items(placed)
               if not (isinstance(x, DTensor) and _on(x, device))]
        if off:
            raise AssertionError(f"phase 10a: leaves off the mesh or the "
                                 f"card: {off[:5]}")
        diffs = [abs(a - b) for a, b in zip(mesh_losses, plain_losses)]
        print(f"   mesh losses {mesh_losses}, no-mesh {plain_losses}, "
              f"|diff| {diffs}; mesh step s {step_s}")
        if not (np.isfinite(mesh_losses).all()
                and max(diffs) <= MESH_LOSS_TOL):
            raise AssertionError(f"phase 10a: mesh losses {mesh_losses} vs "
                                 f"no-mesh {plain_losses}")

        # the EC checkpoint of the DTensor state and of its whole values
        reset_launches()
        ck = train_launch.checkpointer(args, device)
        tic = time.perf_counter()
        ck.save(MESH_STEPS, placed, wait=True)
        save_s = time.perf_counter() - tic
        whole = tree.map(lambda x: x.full_tensor(), placed)
        plain_args = train_launch.parse_args(
            [*MESH_ARGS, "--ckpt-dir", str(work / "plain"), "--device",
             device])
        ck_plain = train_launch.checkpointer(plain_args, device)
        ck_plain.save(MESH_STEPS, whole, wait=True)
        save_launches = read_launches()
        mesh_dir = Path(ck._step_dir(MESH_STEPS))
        plain_dir = Path(ck_plain._step_dir(MESH_STEPS))
        names = sorted(p.name for p in mesh_dir.iterdir())
        if names != sorted(p.name for p in plain_dir.iterdir()) or any(
                (mesh_dir / n).read_bytes() != (plain_dir / n).read_bytes()
                for n in names):
            raise AssertionError("phase 10a: the mesh state's checkpoint "
                                 "files differ from the plain save's")
        shutil.rmtree(work / "plain")
        manifest = json.loads((mesh_dir / "manifest.json").read_text())
        stripes = manifest["num_stripes"]
        want = {k: 0 for k in WRAPPERS}
        want["gf256_matmul_bytes"] = 2                # one encode a save
        if save_launches != want:
            raise AssertionError(f"phase 10a saves: launches "
                                 f"{save_launches} != {want}")

        # lose MESH_LOST, repair on load, re-mesh and step once more
        reset_launches()
        tic = time.perf_counter()
        restored, report = ck.load(whole, lost_domains=MESH_LOST)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - tic
        load_launches = read_launches()
        want = {k: 0 for k in WRAPPERS}
        want["gf256_reconstruct_stripes"] = 1
        if (load_launches != want
                or report.stripes_repaired != lost_data_stripes(stripes,
                                                                MESH_LOST)):
            raise AssertionError(f"phase 10a load: launches {load_launches}"
                                 f" != {want}, {report}")
        if not same_bytes(restored, whole):
            raise AssertionError("phase 10a load: a leaf differs from the "
                                 "state saved")
        del placed, whole
        fresh = rules_for(make_test_mesh(data=1, model=1, device=device))
        replaced = reshard_state(restored, fresh.dmesh, tree_shardings(
            fresh, restored, state_logical(cfg, tcfg, fresh)))
        resumed = float(make_train_step(cfg, tcfg, fresh)(
            replaced, batches[MESH_STEPS])[1]["loss"].full_tensor())
        del replaced
        resumed_plain = float(step(restored, batches[MESH_STEPS])[1]["loss"])
        print(f"   resumed on a fresh mesh: loss {resumed!r}, no-mesh "
              f"{resumed_plain!r}")
        if not abs(resumed - resumed_plain) <= MESH_LOSS_TOL:
            raise AssertionError(f"phase 10a resume: {resumed} vs "
                                 f"{resumed_plain}")
        del restored
        torch.cuda.empty_cache()
        rec = dict(phase="mesh_train", argv=MESH_ARGS, backend=backend,
                   mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                   mesh_losses=mesh_losses, plain_losses=plain_losses,
                   loss_diffs=diffs, loss_tol=MESH_LOSS_TOL,
                   mesh_step_s=step_s, save_s=save_s, load_s=load_s,
                   num_stripes=stripes, files_equal=True,
                   save_launches=save_launches["gf256_matmul_bytes"],
                   load_launches=load_launches["gf256_reconstruct_stripes"],
                   load_stages_s=dict(ck.last_load),
                   stripes_repaired=report.stripes_repaired,
                   resume_loss=dict(mesh=resumed, plain=resumed_plain),
                   launches={"saves": save_launches, "load": load_launches},
                   phase_s=time.perf_counter() - start)
        print(json.dumps(rec))
        records.append(rec)
        return rec
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)


def dryrun_cmd(arch: str, shape: str, mesh: str, out: str,
               device: str) -> list[str]:
    """The command line of one dry-run cell (its own process: a fresh
    fake world)."""
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            arch, "--shape", shape, "--mesh", mesh, "--out", out,
            "--device", device, "--force"]


def dryrun_phase(records: list, device: str = "cuda", during=None) -> dict:
    """Phase 10b: the cells of `DRYRUN_CELLS`, each through
    `python -m repro_torch.launch.dryrun` in its own process, all at
    once (host work only: fake tensors), with `during()` run in this
    process while they run; fails if a cell fails, does not fit the card
    or allocates on the card. Returns its record."""
    start = time.perf_counter()
    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    procs, cells = [], []
    try:
        for arch, shape, mesh in DRYRUN_CELLS:
            log = open(Path(out) / f"{arch}__{shape}__{mesh}.log", "w")
            procs.append((arch, shape, mesh, time.perf_counter(), log,
                          subprocess.Popen(dryrun_cmd(arch, shape, mesh, out,
                                                      device),
                                           cwd=root, env=env, stdout=log,
                                           stderr=subprocess.STDOUT)))
        ended = {}                  # each process's own seconds

        def watch(i: int, tic: float, proc) -> None:
            proc.wait()
            ended[i] = time.perf_counter() - tic

        watchers = [threading.Thread(target=watch, args=(i, tic, proc),
                                     daemon=True)
                    for i, (*_, tic, _, proc) in enumerate(procs)]
        for w in watchers:
            w.start()
        if during is not None:
            during()
        deadline = start + DRYRUN_TIMEOUT_S
        for w in watchers:
            w.join(timeout=max(0.0, deadline - time.perf_counter()))
        if len(ended) < len(procs):
            raise AssertionError(f"phase 10b: cells still running after "
                                 f"{DRYRUN_TIMEOUT_S} s")
        for i, (arch, shape, mesh, tic, log, proc) in enumerate(procs):
            rc, seconds = proc.returncode, ended[i]
            log.close()
            if rc != 0:
                tail = Path(log.name).read_text()[-3000:]
                raise AssertionError(f"phase 10b: {arch} {shape} {mesh} "
                                     f"exited {rc}: {tail}")
            r = json.loads((Path(out) / f"{arch}__{shape}__{mesh}.json")
                           .read_text())
            h = r["hlo_analysis"]
            if not (r["ok"] and h["flops_per_device"] > 0
                    and r["chips"] == (512 if mesh == "multi" else 256)
                    and r["device_allocated_bytes"] in (0, None)):
                raise AssertionError(f"phase 10b: {r}")
            cell = dict(arch=arch, shape=shape, mesh=mesh, chips=r["chips"],
                        seconds=seconds, step_run_s=r["compile_s"],
                        per_device_bytes=r["per_device_bytes"],
                        per_device_bytes_before=DRYRUN_BEFORE[
                            (arch, shape, mesh)],
                        fits=r["fits"], memory=r["memory_analysis"],
                        device_allocated_bytes=r["device_allocated_bytes"],
                        flops_per_device=h["flops_per_device"],
                        bytes_per_device=h["bytes_per_device"],
                        collective_by_kind=h["collective_by_kind"],
                        collective_counts=h["collective_counts"],
                        ops=h["ops"], roofline=r["roofline"],
                        params_total=r["params_total"],
                        model_flops_global=r["model_flops_global"],
                        useful_compute_ratio=r["useful_compute_ratio"])
            print(f"   dryrun {arch} {shape} {mesh}: per-device bytes "
                  f"{cell['per_device_bytes']:.4e} (before: "
                  f"{cell['per_device_bytes_before']:.4e}); "
                  f"{json.dumps(cell)}")
            cells.append(cell)
        misfits = [(c["arch"], c["shape"], c["mesh"], c["per_device_bytes"])
                   for c in cells if not c["fits"]]
        if misfits:
            raise AssertionError(f"phase 10b: cells past the card's "
                                 f"{dryrun.HBM_BYTES} bytes a device: "
                                 f"{misfits}")
    finally:
        for *_, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(out, ignore_errors=True)
    rec = dict(phase="dryrun", device=device, cells=cells,
               constants=dryrun.CONSTANTS,
               phase_s=time.perf_counter() - start)
    records.append(rec)
    return rec


def mesh_phase(records: list, device: str = "cuda", then=None) -> dict:
    """Phase 10a, then `then()` (phase 11); returns {"launches": 10a's,
    "then": what `then()` returned}."""
    train = mesh_train(records, device)
    return {"launches": train["launches"],
            "then": then() if then is not None else {}}


# phase 11: the port's example programs, in the order they were ported
EXAMPLES = ("repair_demo", "device_sweep", "quickstart", "multinode_recovery",
            "serve_demo", "sweep_demo", "vectorized_sweep")
EXAMPLES_DIR = Path(__file__).resolve().parent / "examples"
EC_EXAMPLES = ("quickstart", "multinode_recovery")


def load_example(name: str):
    """`examples/torch_<name>.py` as a module of this process."""
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", EXAMPLES_DIR / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def checkpoint_calls():
    """Counts `ECCheckpointer` saves, the loads that repaired a stripe
    and the stripes they repaired while active."""
    calls = {"saves": 0, "repairs": 0, "stripes_repaired": 0}
    save, load = ECCheckpointer.save, ECCheckpointer.load

    def counted_save(self, *args, **kwargs):
        calls["saves"] += 1
        return save(self, *args, **kwargs)

    def counted_load(self, *args, **kwargs):
        state, report = load(self, *args, **kwargs)
        calls["stripes_repaired"] += report.stripes_repaired
        calls["repairs"] += report.stripes_repaired > 0
        return state, report

    ECCheckpointer.save, ECCheckpointer.load = counted_save, counted_load
    try:
        yield calls
    finally:
        ECCheckpointer.save, ECCheckpointer.load = save, load


def run_example(name: str, device: str) -> dict:
    """`main(device=device)` of one example, its output echoed, with the
    launches, checkpoint calls and device-stepper routes of its run."""
    mod = load_example(name)
    cuda = torch.device(device).type == "cuda"
    out = io.StringIO()
    print(f"== phase 11: examples/torch_{name}.py ==")
    with checkpoint_calls() as ckpt:
        device_stepper.COUNTS.reset()
        if cuda:
            torch.cuda.synchronize()
        reset_launches()
        tic = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                mod.main(device=device)
            if cuda:
                torch.cuda.synchronize()
        finally:
            print(out.getvalue(), end="")
        wall_s = time.perf_counter() - tic
        launches = read_launches()
    return dict(lines=out.getvalue().splitlines(), wall_s=wall_s,
                launches=launches, checkpoint=dict(ckpt),
                stepper=device_stepper.COUNTS.as_dict())


def expected_launches(name: str, run: dict) -> dict:
    """The launches each kernel must show in the run of one example."""
    want = {kname: 0 for kname in WRAPPERS}
    if name == "repair_demo":
        _, _, sc = demo_scenario()
        plan = RepairSimulator(sc).run("bmf").plan
        helpers = sum(len(job.helpers) for job in plan.jobs)
        want["gf256_matmul_bytes"] = 1 + helpers
        want["xor_reduce_words"] = helpers - len(plan.jobs)
    elif name in EC_EXAMPLES:
        want["gf256_matmul_bytes"] = run["checkpoint"]["saves"]
        want["gf256_reconstruct_stripes"] = run["checkpoint"]["repairs"]
    # one event-loop launch per device engine call (the device sweep)
    want["round_events"] = run["stepper"]["round_calls"]
    want["pipeline_events"] = run["stepper"]["pipeline_calls"]
    return want


def examples_phase(records: list, device: str = "cuda") -> dict:
    """Phase 11: every `examples/torch_*.py` through its `main`, checked
    by its printed lines and its launches. Returns {name: launches}."""
    start = time.perf_counter()
    runs = {}
    for name in EXAMPLES:
        run = runs[name] = run_example(name, device)
        lines, text = run["lines"], "\n".join(run["lines"])
        if name == "repair_demo" and "byte-exact: True" not in text:
            raise AssertionError("phase 11: the repair demo printed no "
                                 "`byte-exact: True`")
        if name == "device_sweep":
            parity = [ln for ln in lines if ln.startswith("16-case sweep")]
            diff = float(parity[0].rsplit("= ", 1)[1]) if parity else math.inf
            run["max_rel_diff"] = diff
            if not diff < 1e-6:
                raise AssertionError(f"phase 11: device sweep differs from "
                                     f"the serial engine by {diff}")
            if run["stepper"]["host_batches"] or not \
                    run["stepper"]["device_batches"]:
                raise AssertionError(f"phase 11: device sweep routes "
                                     f"{run['stepper']}")
        if name == "quickstart" and not (
                "  repaired 4 blocks across 4 stripes" in lines
                and "  restored train state at step 61 — resuming" in lines):
            raise AssertionError("phase 11: the quickstart did not repair 4 "
                                 "blocks across 4 stripes and resume at 61")
        if name in EC_EXAMPLES:
            losses = [float(x) for ln in lines for x in re.findall(
                r"loss (-?(?:\d+\.\d+|nan|inf))", ln)]
            run["losses"] = losses
            if not losses or not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"phase 11: {name} losses {losses}")
        want = expected_launches(name, run)
        if run["launches"] != want:
            raise AssertionError(f"phase 11: {name} launched "
                                 f"{run['launches']}, not {want}")
    rec = dict(phase="examples", device=device,
               examples={name: {k: v for k, v in run.items() if k != "lines"}
                         for name, run in runs.items()},
               phase_s=time.perf_counter() - start)
    print(json.dumps(rec))
    records.append(rec)
    return {name: run["launches"] for name, run in runs.items()}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", type=Path, default=None,
                        help="also write every record to this file")

    args = parser.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = nvidia_smi("name,power.limit")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name} "
          f"({smi})")
    peaks = peak_rates(name)
    records: list = [dict(phase="device", nvidia_smi=smi, torch=torch.__version__,
                          **peaks)]

    # wall seconds of each phase, from the end of the one before it
    marks = [("start", time.perf_counter())]

    def mark(phase: str) -> None:
        marks.append((phase, time.perf_counter()))

    lib = load_library()
    mark("build")
    print(f"kernels built in {lib.build_seconds:.1f} s -> {lib.path}")
    print(lib.log)

    rng = np.random.default_rng(0)
    timed: dict[str, dict] = {}
    errs = {name: 0 for name in KERNELS}
    for m, k in ((1, 1), (3, 6), (2, 16)):
        for w in (1, 513):
            rec = check_gf256(rng, peaks, m, k, w, timed=False)
            errs["gf256_matmul_planes"] = max(errs["gf256_matmul_planes"],
                                              rec["max_abs_err"])
    # the fold in both forms, chained past KMAX rows, at word offsets 0, 1
    # and 3 (alike and mixed), then on ragged and misaligned byte rows
    for k in (2, 3, 5, 16, 17, 33):
        for w in (1, 513, 1024):
            for offsets in ((0,), (1,), (3,), (1, 3, 0)):
                records.append(check_xor(rng, k, w, offsets))
    for k in (2, 3, 17):
        for n in (1, 33, 4099, 4096, 4112):
            for offsets in ((0,), (3,), (0, 1, 3)):
                records.append(check_xor_bytes(rng, k, n, offsets))
    # main-path shapes: the helper premultiply (1,1) and the RS(6,3) encode
    # (3,3) at 128 MiB blocks, plus a six-data-block encode (3,6)
    for m, k in ((1, 1), (3, 3), (3, 6)):
        rec = check_gf256(rng, peaks, m, k, W_PLANES, timed=True)
        print(json.dumps(rec))
        records.append(rec)
        timed.setdefault("gf256_matmul_planes", rec)   # (1,1) is the repair's
        torch.cuda.empty_cache()
    for k in (2, 3):
        for form in ("rows", "dense"):
            rec = time_xor(peaks, k, form)
            print(json.dumps(rec))
            records.append(rec)
            timed.setdefault("xor_reduce_words", rec)   # k=2 rows: the repair's

    # the batched data plane's kernels: CPU-test shapes, then full width
    for m in (1, 5):
        for w in (1, 513):
            records.append(check_scale(rng, peaks, m, w, timed=False))
    tables = (np.array([[0, 1, 2, -1], [3, -1, -1, -1], [4, 5, -1, -1],
                        [6, 2, 0, 1], [-1, -1, -1, -1]]),   # ragged, K=1, repeats
              np.array([[5], [5], [0]]))                     # K=1 only
    for w in (1, 513, 1024):
        words = device_words(int(rng.integers(1 << 30)), (7, w))
        for table in tables:
            records.append(check_groups(peaks, words, table, False,
                                        f"T=7 G={table.shape[0]} W={w}"))
        records.append(check_groups(peaks, words.reshape(7, 1, w), None,
                                    False, f"dense G=7 K=1 W={w}"))
    batch = BATCHES[0]
    rec = check_scale(rng, peaks, 3 * batch, W_PLANES, timed=True)
    print(json.dumps(rec))
    records.append(rec)
    timed["gf256_scale_planes"] = rec
    _, _, slots, steps = batch_layout(batch)
    big = max(steps, key=lambda s: int((s.groups >= 0).sum()))
    words = device_words(13, (batch * slots, W_WORDS))
    rec = check_groups(peaks, words, big.groups, True,
                       f"largest batch round: T={batch * slots} "
                       f"G={big.groups.shape[0]} Kmax={big.groups.shape[1]} "
                       f"W={W_WORDS}")
    print(json.dumps(rec))
    records.append(rec)
    del words
    torch.cuda.empty_cache()
    words = device_words(14, (4, 2, W_WORDS))
    rec = check_groups(peaks, words, None, True, f"dense G=4 K=2 W={W_WORDS}")
    print(json.dumps(rec))
    records.append(rec)
    timed["xor_reduce_groups_words"] = rec
    del words
    torch.cuda.empty_cache()

    # the byte-domain GF(256) kernels the byte entry points launch: the
    # CPU-test shapes, at a 16-byte aligned and a misaligned row offset,
    # the plane route, then full width
    for n in (1, 33, 4099, 4096 + 16):
        for offset in (0, 3):
            for m, k in ((1, 1), (3, 6), (2, 16), (5, 3)):
                records.append(check_matmul_bytes(rng, peaks, m, k, n, False,
                                                  offset))
            for m in (1, 5):
                records.append(check_scale_bytes(rng, peaks, m, n, False,
                                                 offset))
    records.extend(check_plane_route(rng, 3, 6, 4099))
    for m, k in ((1, 1), (3, 3), (3, 6)):
        rec = check_matmul_bytes(rng, peaks, m, k, BLOCK_BYTES, True)
        print(json.dumps(rec))
        records.append(rec)
        timed.setdefault("gf256_matmul_bytes", rec)    # (1,1) is the repair's
        torch.cuda.empty_cache()
    rec = check_scale_bytes(rng, peaks, 3 * batch, BLOCK_BYTES, True)
    print(json.dumps(rec))
    records.append(rec)
    timed["gf256_scale_bytes"] = rec
    torch.cuda.empty_cache()
    # phase 7's save: the (2, 4) encode over all 3,451 stripes at once
    # (timed here: in late phases the profiler was seen to lose records)
    checkpoint_encode = check_matmul_bytes(rng, peaks, 2, 4,
                                           CKPT_STRIPES * CKPT_CHUNK, True)
    print(json.dumps(checkpoint_encode))
    records.append(checkpoint_encode)
    torch.cuda.empty_cache()
    # a load's reconstruct of one stripe, (lost, 4) helper rows of 256
    # KiB: the launches one launch of the batched kernel replaces
    per_stripe = {}
    for m in (1, 2):
        rec = per_stripe[m] = check_matmul_bytes(rng, peaks, m, 4, CKPT_CHUNK,
                                                 True)
        rec["path"] = ("a checkpoint load's per-stripe reconstruct, which "
                       "the batched kernel replaces")
        print(json.dumps(rec))
        records.append(rec)
    # phase 7's and 10a's loads: every stripe's reconstruct in one launch;
    # the small mixed batches, then the full-width load layouts
    for label, plan, bufs, n in small_stripe_batches("cuda"):
        records.append(check_stripes(peaks, label, plan, bufs, n))
    for i, lost in enumerate(STRIPE_LOSSES):
        plan, bufs = load_layout(lost, 40 + 100 * i)
        rec = check_stripes(peaks, f"load of {CKPT_STRIPES} stripes x "
                            f"{CKPT_CHUNK} B, domains {lost} lost", plan, bufs,
                            CKPT_CHUNK, per_stripe)
        print(json.dumps(rec))
        records.append(rec)
        timed.setdefault("gf256_reconstruct_stripes", rec)   # (1, 5): phase 7's
        del plan, bufs
        torch.cuda.empty_cache()
    timed.update(event_loop_checks(records, peaks))
    for rec in records[1:]:
        if "kernel" in rec:
            errs[rec["kernel"]] = max(errs[rec["kernel"]], rec["max_abs_err"])

    mark("kernels")
    got = {}

    def paths() -> None:
        """Phases 3 to 11, run beside 10b's dry-run cells (host work in
        other processes)."""
        got["serial"] = main_path(records)
        small_checks(records)
        got["batch"] = [batched_path(records, b) for b in BATCHES]
        mark("serial_and_batched")
        got["sweep"] = sweep_phase(records)
        mark("sweep")
        got["train"] = train_phase(records, checkpoint_encode)["launches"]
        mark("train_checkpoint")
        got["serve"] = serve_phase(records)["launches"]["phase"]
        mark("serve")
        got["families"] = family_phase(records)["launches"]
        mark("families")
        got["mesh"] = mesh_phase(records, then=lambda: examples_phase(records))
        mark("mesh_and_examples")

    dryrun_phase(records, during=paths)
    mark("dryrun_wait")
    serial_launches, batch_launches = got["serial"], got["batch"]
    sweep_launches, train_launches = got["sweep"], got["train"]
    serve_launches, family_launches = got["serve"], got["families"]
    mesh_launches, examples_launches = (got["mesh"]["launches"],
                                        got["mesh"]["then"])
    walls = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    walls["total"] = marks[-1][1] - marks[0][1]
    records.append(dict(phase="phase_wall_s", **walls))
    print(json.dumps({"phase_wall_s": walls}))
    print(json.dumps({"launches": {"serial": serial_launches,
                                   **{f"batched_b{b}": lc for b, lc in
                                      zip(BATCHES, batch_launches)},
                                   "sweep": sweep_launches,
                                   "train_checkpoint": train_launches,
                                   "serve": serve_launches,
                                   "families": family_launches,
                                   "mesh": mesh_launches,
                                   "examples": examples_launches}}))
    # each kernel's launches on the path that runs it, the batched ones at
    # B=4, the event loops' in phase 6, the stripes' in phase 7's run (a
    # new dict: the phases' records keep their own counts); the plane
    # kernels run on no path
    launches = {**serial_launches,
                **{k: batch_launches[0][k] for k in ("gf256_scale_planes",
                                                     "gf256_scale_bytes",
                                                     "xor_reduce_groups_words")},
                **{k: sweep_launches[k] for k in EVENT_LOOPS},
                "gf256_reconstruct_stripes":
                    train_launches["run"]["gf256_reconstruct_stripes"]}

    kernels = []
    for kname, meta in KERNELS.items():
        t = timed[kname]
        kernels.append(dict(
            name=kname, **meta, launches=launches[kname],
            launches_sweep=sweep_launches[kname],
            launches_checkpoint={k: v[kname]
                                 for k, v in train_launches.items()},
            launches_serve=serve_launches[kname],
            launches_families=family_launches[kname],
            launches_mesh={k: v[kname] for k, v in mesh_launches.items()},
            launches_examples={k: v[kname]
                               for k, v in examples_launches.items()},
            max_abs_err=errs[kname], ms=t["ms"], ms_events=t["ms_events"],
            ms_single=t["ms_single"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"],
            library_ms_events=t.get("library_ms_events"), shape=t["shape"],
            **({k: t[k] for k in ("steps", "us_per_step", "max_rel_err",
                                  "chain_floor_ms", "routes")}
               if kname in EVENT_LOOPS else {}),
            **({"launch_route": t["route"]} if kname in EVENT_LOOPS else {}),
            **({k: t[k] for k in ("per_stripe_ms", "per_stripe_launches")}
               if kname == "gf256_reconstruct_stripes" else {})))
    device = {"platform": "gpu", "kind": name,
              "count": torch.cuda.device_count()}
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            dict(records=records, kernels=kernels, device=device), indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
