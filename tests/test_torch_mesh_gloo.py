"""The port's mesh paths on real ranks: four gloo processes on the CPU
form a (2, 2) ("data", "model") mesh, run reduced train and decode steps
on DTensors, and are held to the port's single-device steps (same state,
same batch) and the train steps also to the reference's.

Cases, each at float32:
  * gemma_2b (MQA: one KV head) trains in the "heads_repkv" layout
    (microbatched) and decodes in the "hd" layout (head_dim sharded, the
    scores all-reduced);
  * smollm with 3 heads trains in the "seq" layout (T sharded);
  * grok-1's MoE trains with its 4 experts sharded (expert parallelism);
  * qwen2 decodes with its KV heads sharded;
  * smollm with an odd vocabulary of 257: its loss and gradients (the
    rules replicate a vocabulary the tensor axis does not divide), then
    a table and logits whose vocabulary is cut by hand over the 2-way
    tensor axis as DTensor cuts it, 129 rows and 128: the lookup and the
    vocab-parallel loss must find the second slice at offset 129.

Tolerances. The mesh and the single device differ by the order of fp32
sums (partial matmuls over sharded dims, all-reduces), which the bf16
roundings the model's arithmetic keeps at float32 (attention's q, k, v
and probabilities, the unembedding's operands) can turn into one bf16
ulp: measured on this run, the loss within 1.4e-5 of the single device
(held to 5e-5) and 4.6e-5 of the reference (held to 1e-4; the single
device's own distance is 4.4e-5), the grad norm within 3.1e-4 relative
(held to 2e-3). The train state is one step in, so Adam's update is not
sign-like; its update (params after minus before) agrees with the
single device's to 1.2% in L2 and with the reference's to 1.0% (held to
3%; the single device and the reference differ by 0.75%: elements with
near-zero gradients take Adam's direction from noise). Decode caches
agree to 1e-6 (held to 1e-5) and logits to 7.7e-3 (held to 3e-2: the
final norm's output, 1e-6 apart, rounds to bf16 before the unembedding,
and an element that rounds the other way moves a logit by one bf16 ulp
of itself times its table weight). The odd-vocabulary case is held as
the train cases are: its loss to the single device at 5e-5 (measured
7.6e-6) and to the reference at 1e-4 (1.1e-5; the single device's own
distance is 3.8e-6), each gradient leaf to the single device's at 2e-3
in relative L2 (measured at most 5.0e-4) and 3e-3 of its largest
element (9.4e-4); the lookup exactly (a row plus zeros); the loss on
hand-cut logits and its gradient at 1e-6 (measured 0 and 9.3e-9: the
same fp32 sums, split in two); the table's gradient, sums of a few
cotangent rows, at 1e-5 (4.8e-7). The world is started once for the
module; a rank that hangs fails the fixture after 90 s (each process
group has a 60 s timeout) instead of holding the suite.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _gloo_worker
from repro.configs import get_arch as jget_arch
from repro.models import model as JM
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import convert, tree
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as T

WORLD = 4
JOIN_S = 90
TRAIN = {
    "gemma_2b": dict(microbatches=2),
    "smollm_3heads": dict(),
    "grok1_314b": dict(),
}
DECODE = ("gemma_2b", "qwen2_15b")


def _cfgs(name: str):
    arch = "smollm_360m" if name == "smollm_3heads" else name
    kw = {"dtype": "float32"}
    if name == "smollm_3heads":
        kw.update(num_heads=3, num_kv_heads=1)
    return (dataclasses.replace(get_arch(arch).reduced(), **kw),
            dataclasses.replace(jget_arch(arch).reduced(), **kw))


def _train_case(name: str):
    """A state one port step in (so Adam's moments are not zero and its
    update is not sign-like), the next batch, and what the port's single
    device and the reference make of them."""
    cfg, jcfg = _cfgs(name)
    adamw = dict(peak_lr=5e-3, warmup_steps=1)
    tcfg = T.TrainConfig(adamw=opt.AdamWConfig(**adamw), attn_chunk=8,
                         **TRAIN[name])
    jtcfg = jts.TrainConfig(adamw=jopt.AdamWConfig(**adamw), attn_chunk=8,
                            **TRAIN[name])
    stream = SyntheticStream(cfg, ShapeConfig("t", "train", 16, 8))
    step = T.make_train_step(cfg, tcfg)
    state, _ = step(T.init_state(0, cfg, tcfg, device="cpu"),
                    stream.batch_at(0))
    batch = stream.batch_at(1)
    single = step(state, batch)
    jstate = jax.tree.map(jnp.asarray, convert.state_to_numpy(state))
    jnew, jm = jax.jit(jts.make_train_step(jcfg, jtcfg))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    case = {"kind": "train", "cfg": cfg, "tcfg": tcfg, "state": state,
            "batch": batch, "shrink": name == "gemma_2b"}
    want = {"single": single, "ref_loss": float(jm["loss"]),
            "ref_params": jax.tree.leaves(jnew["params"])}
    return case, want


def _decode_case(name: str):
    cfg, _ = _cfgs(name)
    params = M.init_params(torch.Generator().manual_seed(1), cfg)
    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (8, 6)).astype(np.int32))
    _, cache = M.family_module(cfg).prefill(params, cfg, prompt, 16,
                                            chunk=4)
    token = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (8,)).astype(np.int32))
    case = {"kind": "decode", "cfg": cfg, "params": params, "token": token,
            "cache": tree.map(torch.clone, cache), "chunk": 4}
    logits, new = M.decode_step(params, cfg, token, cache, chunk=4)
    return case, {"logits": logits, "cache": new}


VOCAB = 257


def _vocab_case():
    """The odd-vocabulary case: a train batch, and a table, tokens,
    logits and labels that reach both of the table's slices (rows 0-128
    and 129-256 on the 2-way tensor axis), with what the single device
    and the reference make of them."""
    kw = {"dtype": "float32", "vocab_size": VOCAB}
    cfg = dataclasses.replace(get_arch("smollm_360m").reduced(), **kw)
    jcfg = dataclasses.replace(jget_arch("smollm_360m").reduced(), **kw)
    params = M.init_params(torch.Generator().manual_seed(3), cfg)
    stream = SyntheticStream(cfg, ShapeConfig("t", "train", 16, 8))
    batch = {k: torch.as_tensor(v) for k, v in stream.batch_at(0).items()}
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    loss = M.train_loss(tree.unflatten(params, leaves), cfg, batch, chunk=8)
    grads = torch.autograd.grad(loss, leaves)
    jparams = jax.tree.map(jnp.asarray, convert.state_to_numpy(params))
    ref_loss = float(JM.train_loss(jparams, jcfg, {
        k: jnp.asarray(v.numpy()) for k, v in batch.items()}, chunk=8))

    rng = np.random.default_rng(5)
    edges = [0, 1, 127, 128, 129, 130, 255, 256]
    tokens = rng.integers(0, VOCAB, (8, 6))
    tokens[:, :4] = np.reshape(edges * 4, (8, 4))
    labels = rng.integers(0, VOCAB, (8, 6))
    labels[:, 2:] = np.reshape(edges * 4, (8, 4))
    tokens, labels = (torch.from_numpy(x.astype(np.int32))
                      for x in (tokens, labels))
    table = torch.from_numpy(rng.standard_normal(
        (VOCAB, cfg.d_model)).astype(np.float32))
    rows_cot = torch.from_numpy(rng.standard_normal(
        (8, 6, cfg.d_model)).astype(np.float32))
    logits = torch.from_numpy(3 * rng.standard_normal(
        (8, 6, VOCAB)).astype(np.float32))
    t = table.clone().requires_grad_()
    (t[tokens] * rows_cot).sum().backward()
    x = logits.clone().requires_grad_()
    ce = M.cross_entropy(x, labels)
    ce.backward()
    case = {"kind": "vocab", "cfg": cfg, "params": params, "batch": batch,
            "chunk": 8, "table": table, "tokens": tokens,
            "rows_cot": rows_cot, "logits": logits, "labels": labels}
    want = {"loss": float(loss), "grads": grads, "ref_loss": ref_loss,
            "rows": table[tokens], "table_grad": t.grad, "ce": float(ce),
            "ce_grad": x.grad}
    return case, want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    cases, want = {}, {}
    for name in TRAIN:
        cases[f"train/{name}"], want[f"train/{name}"] = _train_case(name)
    for name in DECODE:
        cases[f"decode/{name}"], want[f"decode/{name}"] = _decode_case(name)
    cases["vocab"], want["vocab"] = _vocab_case()
    payload, out = str(tmp / "payload.pt"), str(tmp / "out.pt")
    torch.save(cases, payload)
    ctx = mp.start_processes(
        _gloo_worker.run, args=(WORLD, payload, out, str(tmp / "store")),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo world did not finish in {JOIN_S} s")
    return torch.load(out, weights_only=False), want, cases


def test_cases_take_the_intended_layouts(world):
    got, _, _ = world
    assert got["train/gemma_2b"]["mode"] == "heads_repkv"
    assert got["train/smollm_3heads"]["mode"] == "seq"
    assert got["train/grok1_314b"]["mode"] == "heads"
    assert got["decode/gemma_2b"]["mode"] == "hd"
    assert got["decode/qwen2_15b"]["mode"] == "heads"
    # the caches are sharded as kv_cache_axes picks: head_dim, KV heads
    assert 4 in got["decode/gemma_2b"]["k_shard_dims"]
    assert 3 in got["decode/qwen2_15b"]["k_shard_dims"]


def _update_error(params, want, before) -> float:
    """|params - want| / |want - before| over all leaves, in L2."""
    def flat(leaves):
        return torch.cat([torch.as_tensor(np.asarray(x, np.float32))
                          .reshape(-1) for x in leaves])
    got, want, before = (flat(x) for x in (params, want, before))
    return float((got - want).norm() / (want - before).norm())


@pytest.mark.parametrize("name", list(TRAIN))
def test_mesh_train_step_matches_single_device(world, name):
    got, want, cases = world
    got, (new, metrics) = got[f"train/{name}"], want[f"train/{name}"]["single"]
    assert abs(got["loss"] - float(metrics["loss"])) < 5e-5
    np.testing.assert_allclose(got["grad_norm"], float(metrics["grad_norm"]),
                               rtol=2e-3)
    for (path, a), b in zip(tree.items(got["params"]),
                            tree.leaves(new["params"])):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    before = cases[f"train/{name}"]["state"]["params"]
    assert _update_error(tree.leaves(got["params"]), tree.leaves(
        new["params"]), tree.leaves(before)) < 3e-2


@pytest.mark.parametrize("name", list(TRAIN))
def test_mesh_train_step_matches_reference(world, name):
    got, want, cases = world
    got, want = got[f"train/{name}"], want[f"train/{name}"]
    assert abs(got["loss"] - want["ref_loss"]) < 1e-4
    ref = [np.asarray(jnp.asarray(b, jnp.float32)) for b in want["ref_params"]]
    for (path, a), b in zip(tree.items(got["params"]), ref):
        assert a.shape == b.shape, path
    before = cases[f"train/{name}"]["state"]["params"]
    assert _update_error(tree.leaves(got["params"]), ref,
                         tree.leaves(before)) < 3e-2


@pytest.mark.parametrize("name", DECODE)
def test_mesh_decode_step_matches_single_device(world, name):
    got, want, _ = world
    got, want = got[f"decode/{name}"], want[f"decode/{name}"]
    torch.testing.assert_close(got["logits"], want["logits"], rtol=0,
                               atol=3e-2)
    for key in ("k", "v"):
        torch.testing.assert_close(got[key], want["cache"][key], rtol=0,
                                   atol=1e-5)
    assert torch.equal(got["pos"], want["cache"]["pos"])


def test_reshard_after_shrink_keeps_every_leaf(world):
    got, _, _ = world
    got = got["train/gemma_2b"]
    assert got["shrink"]["ranks"] == [0, 1]       # data row 1 dropped
    before = tree.items(got["before"])
    after = tree.items(got["shrink"]["leaves"])
    assert [p for p, _ in before] == [p for p, _ in after]
    for (path, a), (_, b) in zip(before, after):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_odd_vocab_loss_and_gradients_match_single_device_and_reference(
        world):
    got, want, _ = world
    got, want = got["vocab"], want["vocab"]
    assert got["loss_is_dtensor"]
    assert abs(got["loss"] - want["loss"]) < 5e-5
    assert abs(got["loss"] - want["ref_loss"]) < 1e-4
    assert len(got["grads"]) == len(want["grads"])
    for a, b in zip(got["grads"], want["grads"]):
        assert a.shape == b.shape
        assert float((a - b).norm()) <= 2e-3 * float(b.norm())
        assert float((a - b).abs().max()) <= 3e-3 * float(b.abs().max())


def test_embed_finds_the_last_slice_of_an_uneven_vocabulary(world):
    """A table of 257 rows cut over the 2-way tensor axis holds 129 rows
    on the first rank and 128 on the second, whose slice starts at 129
    (not 1 x 128): every token's row, and the table's gradient."""
    got, want, _ = world
    got, want = got["vocab"], want["vocab"]
    assert got["table_local_rows"] == 129
    assert torch.equal(got["rows"], want["rows"])
    torch.testing.assert_close(got["table_grad"], want["table_grad"],
                               rtol=0, atol=1e-5)


def test_mesh_loss_on_an_uneven_vocabulary(world):
    """The vocab-parallel loss on logits of 257 columns cut 129 / 128
    over the tensor axis and rows over the data axis: the single
    device's loss and gradient."""
    got, want, _ = world
    got, want = got["vocab"], want["vocab"]
    assert got["logits_local_vocab"] == 129
    assert abs(got["ce"] - want["ce"]) < 1e-6
    torch.testing.assert_close(got["ce_grad"], want["ce_grad"], rtol=0,
                               atol=1e-6)
