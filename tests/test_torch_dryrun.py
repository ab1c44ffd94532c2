"""The port's dry run (`launch/dryrun.py`), its analyzer
(`launch/hlo_analysis.py`) and `launch/summarize.py`, on the CPU.

* The 11 reduced cells of `tests/test_dryrun_small.py` (8 archs train,
  3 decode; the reference's own run of them fails on jax 0.9) run on a
  fake (2, 2, 2) pod/data/model mesh of 8 ranks and write records with
  the reference's keys.
* The analyzer's counterparts of `tests/test_hlo_analysis.py`, exact: a
  plain matmul's FLOPs; L matmuls give L times that (eager execution
  runs every iteration, so there are no trip counts to multiply); a
  weight sharded on its contraction dim over a 4-rank mesh gives rank 0
  L x 2 x m x (k / 4) x k FLOPs and at least L all-reduces.
* `count_params` / `active_params` / `model_flops` equal the
  reference's on its `jax.eval_shape` trees, all ten archs, exactly.
* The mesh loss (`model.cross_entropy` on vocab-sharded DTensor logits)
  makes no local tensor larger than the rank's logits shard, forward or
  backward, on a fake 2 x 2 mesh, for a vocabulary the tensor axis
  divides and one it cuts unevenly; a reduced train cell whose logits
  dominate (vocabulary 8,192, T = 256) peaks below one global
  microbatch's fp32 logits (8 of its local shards on this mesh), which
  the loss used to build on every rank.
* `--list` prints the reference's 66 cells.
* `summarize` prints the reference's tables for the same records, every
  column but the limiter note, which names the card's units.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import jax
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._pytree import tree_flatten

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_arch as jget_arch
from repro.launch import summarize as jsummarize
from repro.models import model as JM
from repro_torch.configs import ARCH_IDS, SHAPES, get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import summarize
from repro_torch.launch.cells import CellPlan
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model as M
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import TrainConfig

TRAIN = ["qwen2_15b", "grok1_314b", "smollm_360m", "gemma3_4b",
         "whisper_medium", "rwkv6_16b", "zamba2_7b", "qwen2vl_2b"]
DECODE = ["qwen2_15b", "rwkv6_16b", "zamba2_7b"]
RECORD_KEYS = {"arch", "shape", "mesh", "chips", "ok", "lower_s",
               "compile_s", "memory_analysis", "hlo_analysis",
               "params_total", "params_active", "model_flops_global",
               "hlo_flops_global", "useful_compute_ratio", "roofline",
               "per_device_bytes"}


@pytest.fixture(scope="module")
def world():
    D.fake_world(8)
    yield make_test_mesh(multi_pod=True, data=2, model=2, device="cpu")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dryrun"))


def _reduced_cell(world, out_dir, arch, kind):
    cfg = get_arch(arch).reduced()
    if kind == "train":     # the reference test's shapes and plan
        shape = ShapeConfig("t", "train", 16, 8)
        plan = CellPlan(train=TrainConfig(adamw=AdamWConfig(),
                                          microbatches=2, attn_chunk=8))
    else:
        shape = ShapeConfig("d", "decode", 32, 8)
        plan = CellPlan(decode_chunk=16)
    return D.run_cell(arch, shape.name, "multi", out_dir,
                      skip_existing=False, device="cpu", mesh=world,
                      cfg=cfg, shape=shape, plan=plan)


def _check(record, out_dir):
    assert RECORD_KEYS <= set(record), RECORD_KEYS - set(record)
    assert record["ok"] and record["chips"] == 8
    h = record["hlo_analysis"]
    assert h["flops_per_device"] > 0 and h["bytes_per_device"] > 0
    assert h["collective_bytes_per_device"] > 0
    assert set(h["collective_by_kind"]) <= set(H.COLLECTIVE_KINDS)
    mem = record["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["peak_live_bytes"] > 0
    assert record["per_device_bytes"] == (mem["argument_size_in_bytes"]
                                          + mem["peak_live_bytes"])
    assert record["roofline"]["dominant"] in ("compute_s", "memory_s",
                                              "collective_s")
    path = os.path.join(out_dir, f"{record['arch']}__{record['shape']}"
                        f"__multi.json")
    with open(path) as f:
        assert json.load(f)["hlo_analysis"] == h


@pytest.mark.parametrize("arch", TRAIN)
def test_reduced_train_runs_on_multipod_mesh(world, out_dir, arch):
    record = _reduced_cell(world, out_dir, arch, "train")
    _check(record, out_dir)
    # a train step reduces its gradients over the data ranks
    assert record["hlo_analysis"]["collective_counts"].get(
        "reduce-scatter", 0) + record["hlo_analysis"][
        "collective_counts"].get("all-reduce", 0) > 0


@pytest.mark.parametrize("arch", DECODE)
def test_reduced_decode_runs_on_multipod_mesh(world, out_dir, arch):
    record = _reduced_cell(world, out_dir, arch, "decode")
    _check(record, out_dir)
    assert record["model_flops_global"] == 2.0 * record["params_active"] * 8


# --------------------------------------------------------- the mesh loss
class _Largest(H.Analyzer):
    """The analyzer, also noting the most elements of any local tensor
    the step's ops make (DTensor's own shape inference on global-shape
    fake tensors is no device's work, and is not counted)."""

    largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented and not self._paused:
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize("vocab", [64, 63])
def test_mesh_loss_holds_no_tensor_larger_than_its_shard(world, vocab):
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    with FakeTensorMode():
        logits = distribute_tensor(torch.zeros(8, 16, vocab), mesh,
                                   [Shard(0), Shard(2)], src_data_rank=None)
        logits.requires_grad_()
        labels = distribute_tensor(torch.zeros(8, 16, dtype=torch.int32),
                                   mesh, [Shard(0), Replicate()],
                                   src_data_rank=None)
        with implicit_replication(), _Largest() as mode:
            loss = M.cross_entropy(logits, labels)
            loss.backward()
    assert isinstance(loss, DTensor) and loss.shape == ()
    assert all(p.is_replicate() for p in loss.placements)
    assert logits.grad.placements == logits.placements
    assert logits.to_local().shape == (4, 16, 32)
    assert mode.largest == logits.to_local().numel()


def test_reduced_train_peak_is_below_the_global_logits(world, out_dir):
    cfg = dataclasses.replace(get_arch("smollm_360m").reduced(),
                              vocab_size=8192)
    shape = ShapeConfig("t", "train", 256, 16)
    plan = CellPlan(train=TrainConfig(adamw=AdamWConfig(), microbatches=2,
                                      attn_chunk=32))
    record = D.run_cell("smollm_360m", shape.name, "multi", out_dir,
                        skip_existing=False, device="cpu", mesh=world,
                        cfg=cfg, shape=shape, plan=plan)
    rows = shape.global_batch // plan.train.microbatches      # 8, global
    local_shard = (rows // 4) * shape.seq_len * (cfg.vocab_size // 2) * 4
    global_logits = rows * shape.seq_len * cfg.vocab_size * 4
    assert global_logits == 8 * local_shard
    assert record["memory_analysis"]["peak_live_bytes"] < global_logits


# ----------------------------------------------------------- the analyzer
def test_plain_matmul_flops_exact():
    m, k, n = 64, 128, 32
    _, r = H.analyze(torch.matmul, torch.zeros(m, k), torch.zeros(k, n))
    assert r["flops_per_device"] == 2 * m * k * n
    # operands and result, f32
    assert r["bytes_per_device"] == 4 * (m * k + k * n + m * n)
    assert r["collective_bytes_per_device"] == 0


def test_loop_of_matmuls_counts_every_iteration():
    """The reference multiplies a scan body by its trip count; eager
    execution runs every iteration, so L matmuls give L x the FLOPs."""
    L_, m, k = 6, 8, 32

    def f(w, x):
        for w_l in w:
            x = x @ w_l
        return x.sum()

    _, r = H.analyze(f, torch.zeros(L_, k, k), torch.zeros(m, k))
    assert r["flops_per_device"] == L_ * 2 * m * k * k


def test_sharded_contraction_counts_local_flops_and_all_reduces(world):
    """A weight sharded on its contraction dim over 4 ranks: rank 0 does
    2 x m x (k / 4) x k a layer (a mode over the DTensors would count
    the global 2 x m x k x k) and all-reduces each layer's output."""
    L_, m, k = 5, 8, 64
    mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("model",))
    with FakeTensorMode():
        ws = [distribute_tensor(torch.zeros(k, k), mesh, [Shard(0)],
                                src_data_rank=None) for _ in range(L_)]
        x = distribute_tensor(torch.zeros(m, k), mesh, [Replicate()],
                              src_data_rank=None)

        def f(x):
            for w in ws:
                x = torch.tanh(x @ w)
            return x

        _, r = H.analyze(f, x)
    assert r["flops_per_device"] == L_ * 2 * m * (k // 4) * k
    assert r["collective_counts"].get("all-reduce", 0) >= L_
    assert r["collective_by_kind"]["all-reduce"] == L_ * m * k * 4


# ------------------------------------------------- params and model flops
def _reference_dryrun():
    """The reference's dryrun module, imported without keeping the
    512-device XLA_FLAGS it sets for its own process."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_match_reference(arch):
    JD = _reference_dryrun()
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    with FakeTensorMode():
        params = M.init_params(torch.Generator().manual_seed(0), cfg)
    jparams = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    assert D.count_params(params) == JD.count_params(jparams)
    n = D.active_params(cfg, params)
    assert n == JD.active_params(jcfg, jparams)
    for name in SHAPES:
        assert D.model_flops(cfg, SHAPES[name], n) == \
            JD.model_flops(jcfg, JSHAPES[name], n)


# ----------------------------------------------------- the command line
def _run(*args):
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


_GROK_ONE_LAYER = """
import dataclasses, json, sys
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun as D
cfg = dataclasses.replace(get_arch("grok1_314b"), num_layers=1)
rec = D.run_cell("grok1_314b", "train_4k", "single", sys.argv[1],
                 skip_existing=False, device="cpu", cfg=cfg)
print(json.dumps(rec))
"""


def test_grok_router_trains_on_the_production_mesh(tmp_path):
    """grok1_314b at its full widths, one layer deep, one train_4k step on
    the fake (16, 16) world: the MoE router's product on DTensors goes
    through `sharding.mesh_matmul`. As a DTensor einsum, its gradient
    bmm ((1, 6144, 131072) x (1, 131072, 8)) failed DTensor's cost
    search on fake tensors (`aten._local_scalar_dense`). In its own
    process: the 256-rank fake world replaces this module's."""
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _GROK_ONE_LAYER,
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    record = json.loads(out.stdout.splitlines()[-1])
    assert record["ok"] and record["chips"] == 256 and record["fits"]
    h = record["hlo_analysis"]
    assert h["flops_per_device"] > 0 and h["collective_bytes_per_device"] > 0
    assert h["collective_counts"].get("all-reduce", 0) > 0


def test_list_matches_reference():
    got = _run("repro_torch.launch.dryrun", "--list")
    assert got == _run("repro.launch.dryrun", "--list")
    assert len(got.splitlines()) == 66


def test_summarize_prints_the_reference_tables(world, out_dir):
    """The same records through both `summarize`s: equal lines, but for
    the limiter note (the last column of the roofline rows)."""
    for arch in ("smollm_360m", "rwkv6_16b"):
        _reduced_cell(world, out_dir, arch, "train")

    def printed(mod):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main([out_dir]) if mod is summarize else _ref_main(out_dir)
        return buf.getvalue().splitlines()

    got, want = printed(summarize), printed(jsummarize)
    assert len(got) == len(want) and len(got) > 8
    notes, roofline = set(), False
    for a, b in zip(got, want):
        roofline = roofline or a.startswith("## Roofline")
        data_row = a.startswith("| ") and not a.startswith("| arch |")
        if roofline and data_row:
            assert a.split("|")[:-2] == b.split("|")[:-2]
            notes.add(a.split("|")[-2].strip())
        else:
            assert a == b
    assert notes and notes <= set(summarize.LIMITER_NOTES.values())


def _ref_main(dirname):
    argv, sys.argv = sys.argv, ["summarize", dirname]
    try:
        jsummarize.main()
    finally:
        sys.argv = argv
