"""Dry run of the assigned (arch x shape x mesh) cells at production
size, in one process, allocating nothing on any device.

The JAX package lowers and compiles each cell over 512 forced host
devices. Here a "fake" process group (`torch.distributed`'s test
backend: collectives do nothing) gives one process a world of 256 or 512
ranks, so the production meshes of `launch/mesh.py` exist; the state,
batch and caches are fake tensors (`FakeTensorMode`: shapes, dtypes and
devices, no storage) on `--device` (default `cuda`, so the card's
dispatch routes are the ones traced), placed as DTensors by
`tree_shardings`; and one train step, prefill or decode step runs
eagerly on rank 0's shards under `hlo_analysis.Analyzer`, which counts
the local ops, their bytes and the collectives.

Each record has the reference's keys where the quantity exists, and an
`analysis` field that says how each number was obtained. The roofline's
constants are the NVIDIA H100 SXM's datasheet figures, not
measurements: 989e12 dense bf16 tensor-core FLOP/s, 3.35e12 B/s of
HBM3, 450e9 B/s a direction of NVLink 4; a cell fits when its
per-device bytes are at most the card's 80e9.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm_360m \\
        --shape train_4k --mesh single [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list | --all
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, get_arch
from repro_torch.ft.elastic import reshard_state
from repro_torch.launch import hlo_analysis
from repro_torch.launch.cells import plan_for
from repro_torch.launch.mesh import make_production_mesh, rules_for
from repro_torch.models import model as M
from repro_torch.models import whisper as W
from repro_torch.models.sharding import tree_constrain, tree_shardings
from repro_torch.serve import serve_step as S
from repro_torch.train import train_step as T

# NVIDIA H100 SXM datasheet constants for the roofline (not measured)
PEAK_FLOPS = 989e12          # dense bf16 tensor-core FLOP/s / card
HBM_BW = 3.35e12             # HBM3 bytes/s / card
LINK_BW = 450e9              # NVLink 4 bytes/s / card, one direction
HBM_BYTES = 80e9             # HBM3 capacity / card

CONSTANTS = {
    "peak_flops": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
    "link_bytes_per_s": LINK_BW, "hbm_bytes": HBM_BYTES,
    "source": "NVIDIA H100 SXM datasheet: dense bf16 tensor-core FLOP/s, "
              "HBM3 bandwidth and capacity, NVLink 4 per direction; not "
              "measured",
}

ANALYSIS = {
    "lower_s": "seconds to make the fake state / params, batch and cache "
               "and place them as DTensors",
    "compile_s": "seconds of the step's eager run on fake tensors (there "
                 "is no compile)",
    "memory_analysis.argument_size_in_bytes":
        "exact: local-shard bytes of the step's arguments on rank 0",
    "memory_analysis.output_size_in_bytes":
        "exact: local-shard bytes of the step's outputs that share no "
        "storage with its arguments",
    "memory_analysis.peak_live_bytes":
        "the largest sum of live local storages the step made, tracked "
        "op by op (an eager peak, not XLA's temp_size)",
    "per_device_bytes": "argument_size_in_bytes + peak_live_bytes; fits "
                        "when <= hbm_bytes",
    "hlo_analysis": "launch/hlo_analysis.Analyzer over rank 0's local "
                    "ops: matmul-family FLOPs, operand + result bytes of "
                    "every non-view op (eager, unfused: an upper "
                    "estimate), c10d_functional collective operand bytes",
    "params_total / params_active / model_flops_global":
        "the reference's count_params, active_params and model_flops",
    "roofline": "per-device FLOPs, bytes and collective bytes over the "
                "constants",
}


def count_params(struct_tree) -> int:
    return sum(int(np.prod(tuple(leaf.shape)))
               for leaf in tree.leaves(struct_tree))


def active_params(cfg, params_struct) -> int:
    total = count_params(params_struct)
    if cfg.moe is None:
        return total
    # expert weights activate top_k / num_experts
    expert = 0
    for keys, leaf in tree.items(params_struct):
        if "moe" in keys and any(k in ("wi_gate", "wi_up", "wo")
                                 for k in keys):
            expert += int(np.prod(tuple(leaf.shape)))
    frac = cfg.moe.top_k / cfg.moe.num_experts
    return total - expert + int(expert * frac)


def model_flops(cfg, shape, n_active: int) -> float:
    b, t = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if cfg.is_encoder_decoder:
            t = t + min(cfg.max_decoder_len, t)
        return 6.0 * n_active * b * t
    if shape.kind == "prefill":
        return 2.0 * n_active * b * t
    return 2.0 * n_active * b            # decode: one token per sequence


# ------------------------------------------------------------- fake world
def fake_world(world_size: int) -> None:
    """A "fake" process group of `world_size` ranks in this process (rank
    0), replacing any other group this process holds."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world_size):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _local_bytes(tensors) -> int:
    return sum(t.to_local().numel() * t.to_local().element_size()
               if hasattr(t, "to_local") else t.numel() * t.element_size()
               for t in tensors if isinstance(t, torch.Tensor))


def _storages(tensors) -> set:
    out = set()
    for t in tensors:
        if isinstance(t, torch.Tensor):
            local = t.to_local() if hasattr(t, "to_local") else t
            out.add(local.untyped_storage()._cdata)
    return out


def _place(rules, values: dict, logical: dict) -> dict:
    return reshard_state(values, rules.dmesh,
                         tree_shardings(rules, values, logical))


# --------------------------------------------------------------- cell build
def build_cell(arch_id: str, shape_name: str, mesh_kind: str, *,
               device: str = "cuda", mesh=None, cfg=None, shape=None,
               plan=None):
    """The cell's step and its arguments, on fake tensors placed on the
    mesh: returns (run, args, cfg, shape, params). `mesh` (default: the
    production mesh of `mesh_kind`, on a fake world of its size), `cfg`,
    `shape` and `plan` override the cell's own (the reduced cells of the
    tests)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg or get_arch(arch_id)
    shape = shape or SHAPES[shape_name]
    plan = plan or plan_for(cfg, shape)
    if mesh is None:
        fake_world(512 if mesh_kind == "multi" else 256)
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                    device=device)
    rules = rules_for(mesh)
    # a cache's write position lives on the host, outside the fake mode
    idx = torch.zeros((), dtype=torch.int32)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        gen = torch.Generator(device=device).manual_seed(0)
        batch_logical = M.batch_logical(cfg, shape)
        batch = _place(rules, M.input_specs(cfg, shape, device=device),
                       batch_logical)
        if shape.kind == "train":
            tcfg = plan.train
            state = T.init_state(gen, cfg, tcfg, device=device)
            state = _place(rules, state, T.state_logical(cfg, tcfg, rules))
            step = T.make_train_step(cfg, tcfg, rules)
            return (fake, step, (state, batch)), cfg, shape, state["params"]

        params = tree.map(lambda p: p.to(device), M.init_params(gen, cfg))
        params = _place(rules, params, M.logical_params(
            cfg, rules, decode=shape.kind == "decode"))
        if shape.kind == "prefill":
            prefill = S.make_prefill(cfg, rules, chunk=plan.attn_chunk,
                                     max_len=shape.seq_len)
            return (fake, prefill, (params, batch)), cfg, shape, params

        b, s = shape.global_batch, shape.seq_len
        if cfg.is_encoder_decoder:
            kv, hd = cfg.num_kv_heads, cfg.hd
            self_cache = W.init_self_cache(cfg, b, cfg.max_decoder_len,
                                           rules, device=device)
            del self_cache["idx"]
            kv_axes = (None, "batch", None, "tp", None)
            cache = _place(rules, {
                "self": self_cache,
                "xk": torch.zeros((cfg.num_layers, b, s, kv, hd),
                                  dtype=torch.bfloat16, device=device),
                "xv": torch.zeros((cfg.num_layers, b, s, kv, hd),
                                  dtype=torch.bfloat16, device=device),
            }, {"self": {"k": kv_axes, "v": kv_axes, "pos": ("batch", None)},
                "xk": kv_axes, "xv": kv_axes})
            cache["self"]["idx"] = idx
            decode = S.make_whisper_decode_step(cfg, rules, plan.decode_chunk)
            return ((fake, decode, (params, batch["token"], cache)), cfg,
                    shape, params)
        cache = M.init_cache(cfg, b, s, rules, kv_dtype=plan.kv_dtype,
                             device=device)
        logical = M.cache_logical(cfg, rules, kv_dtype=plan.kv_dtype)
        has_idx = cache.pop("idx", None) is not None
        logical.pop("idx", None)
        cache = tree_constrain(rules, cache, logical)
        if has_idx:
            cache["idx"] = idx
        decode = S.make_decode_step(cfg, rules, plan.decode_chunk)
        args = (params, batch["token"], cache)
        if cfg.mrope:
            args = args + (batch["pos3"],)
        return (fake, decode, args), cfg, shape, params


def run_cell(arch_id: str, shape_name: str, mesh_kind: str, out_dir: str,
             *, skip_existing: bool = True, device: str = "cuda", mesh=None,
             cfg=None, shape=None, plan=None) -> dict:
    """Build, run and analyze one cell; write and return its record."""
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir,
                            f"{arch_id}__{shape_name}__{mesh_kind}.json")
    if skip_existing and os.path.exists(out_path):
        with open(out_path) as f:
            return json.load(f)
    t0 = time.time()
    (fake, fn, args), cfg, shape, params = build_cell(
        arch_id, shape_name, mesh_kind, device=device, mesh=mesh, cfg=cfg,
        shape=shape, plan=plan)
    t_lower = time.time() - t0
    arg_leaves = [x for a in args for x in
                  (tree.leaves(a) if isinstance(a, dict) else [a])]
    t0 = time.time()
    with fake:
        out, analysis = hlo_analysis.analyze(fn, *args)
    t_run = time.time() - t0
    out_leaves = [x for o in (out if isinstance(out, tuple) else (out,))
                  for x in (tree.leaves(o) if isinstance(o, dict) else [o])]
    seen = _storages(arg_leaves)
    fresh = [t for t in out_leaves if isinstance(t, torch.Tensor)
             and not _storages([t]) <= seen]
    chips = dist.get_world_size()
    n_total = count_params(params)
    n_active = active_params(cfg, params)
    flops_pd = float(analysis["flops_per_device"])
    bytes_pd = float(analysis["bytes_per_device"])
    coll_pd = float(analysis["collective_bytes_per_device"])
    terms = {"compute_s": flops_pd / PEAK_FLOPS,
             "memory_s": bytes_pd / HBM_BW,
             "collective_s": coll_pd / LINK_BW}
    dominant = max(terms, key=terms.get)
    mflops = model_flops(cfg, shape, n_active)
    mem = {"argument_size_in_bytes": _local_bytes(arg_leaves),
           "output_size_in_bytes": _local_bytes(fresh),
           "peak_live_bytes": analysis["peak_live_bytes"]}
    per_device = mem["argument_size_in_bytes"] + mem["peak_live_bytes"]
    record = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
        "chips": chips, "device": device,
        "ok": True,
        "lower_s": round(t_lower, 1), "compile_s": round(t_run, 1),
        "memory_analysis": mem,
        "hlo_analysis": {
            "flops_per_device": flops_pd,
            "bytes_per_device": bytes_pd,
            "collective_bytes_per_device": coll_pd,
            "collective_by_kind": analysis["collective_by_kind"],
            "collective_counts": analysis["collective_counts"],
            "ops": analysis["ops"],
        },
        "params_total": n_total,
        "params_active": n_active,
        "model_flops_global": mflops,
        "hlo_flops_global": flops_pd * chips,
        "useful_compute_ratio": (mflops / (flops_pd * chips)
                                 if flops_pd else None),
        "roofline": {**terms, "dominant": dominant},
        "per_device_bytes": per_device,
        "fits": per_device <= HBM_BYTES,
        # the card's allocator after the step: 0 (every tensor is fake)
        "device_allocated_bytes": (torch.cuda.memory_allocated()
                                   if torch.device(device).type == "cuda"
                                   else None),
        "constants": CONSTANTS,
        "analysis": ANALYSIS,
    }
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"[dryrun] {arch_id} x {shape_name} x {mesh_kind}: OK "
          f"(build {t_lower:.0f}s run {t_run:.0f}s, dominant={dominant}, "
          f"per-dev {per_device / 2**30:.2f} GiB)")
    print("  memory:", mem)
    print("  flops=%.3e bytes=%.3e coll=%.3e" % (flops_pd, bytes_pd,
                                                 coll_pd))
    return record


def all_cells() -> list[tuple[str, str, str]]:
    cells = []
    for arch in ARCH_IDS:
        cfg = get_arch(arch)
        for shape in applicable_shapes(cfg):
            for mesh in ("single", "multi"):
                cells.append((arch, shape, mesh))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for c in all_cells():
            print(*c)
        return
    if args.all:
        failures = []
        for arch, shape, mesh in all_cells():
            out_path = os.path.join(args.out,
                                    f"{arch}__{shape}__{mesh}.json")
            if os.path.exists(out_path) and not args.force:
                print(f"[dryrun] skip cached {arch} x {shape} x {mesh}")
                continue
            # a fresh process per cell: a fresh world, bounded memory
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", mesh,
                 "--out", args.out, "--device", args.device, "--force"])
            if r.returncode != 0:
                failures.append((arch, shape, mesh))
        if failures:
            print("FAILED cells:", failures)
            sys.exit(1)
        print("all cells OK")
        return
    run_cell(args.arch, args.shape, args.mesh, args.out,
             skip_existing=not args.force, device=args.device)


if __name__ == "__main__":
    main()
