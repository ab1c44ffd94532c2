"""The port's EC checkpoint, held against repro on the CPU.

`tests/test_checkpoint.py`'s matrix runs on the port's own train state
(`device="cpu"`): round trip, lost domains (3,) and (1, 5), too many
losses, a corrupt domain, async save, `latest_step`. For the same state
(the reference's init, converted: smollm, and the rwkv6 and zamba2
states with their fp32 leaves among bf16) both packages write the same
domain files and checksums and the same manifest fields, `treedef`
excepted;
each loads the other's checkpoint, and the repair is priced to 1e-6 rtol
of the reference (it matches exactly). `tests/test_ft.py`'s end-to-end
failure recovery runs on the port. Bytes are compared exactly.
"""
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ECCheckpointConfig as JConfig
from repro.checkpoint import ECCheckpointer as JCheckpointer
from repro.configs import get_arch as jget_arch
from repro.core import topology as jtopology
from repro.core.bandwidth import BandwidthProcess as JBandwidth
from repro.core.bandwidth import IngressModel as JIngress
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import init_state as jinit_state
from repro_torch import convert, tree
from repro_torch.checkpoint import ECCheckpointConfig, ECCheckpointer
from repro_torch.checkpoint import ec_checkpoint
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import topology
from repro_torch.core.bandwidth import BandwidthProcess, IngressModel
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.ec import stripe as stripe_lib
from repro_torch.ec.rs import RSCode
from repro_torch.kernels import ops, ref
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (TrainConfig, init_state,
                                          make_train_step)

CFG = get_arch("smollm_360m").reduced()


def _checkpointer(d, chunk_bytes=1 << 14, device="cpu"):
    _, bwm = topology.tpu_pod_dcn_matrix(8, 1)
    return ECCheckpointer(
        ECCheckpointConfig(directory=str(d), n=6, k=4,
                           chunk_bytes=chunk_bytes, num_domains=8),
        bw=BandwidthProcess(base=bwm, change_interval=2.0, mode="markov"),
        ingress=IngressModel(), device=device)


def _jcheckpointer(d, chunk_bytes=1 << 14):
    _, bwm = jtopology.tpu_pod_dcn_matrix(8, 1)
    return JCheckpointer(
        JConfig(directory=str(d), n=6, k=4, chunk_bytes=chunk_bytes,
                num_domains=8),
        bw=JBandwidth(base=bwm, change_interval=2.0, mode="markov"),
        ingress=JIngress())


@pytest.fixture
def ckpt_env(tmp_path):
    state = init_state(0, CFG, TrainConfig(adamw=AdamWConfig()), device="cpu")
    return _checkpointer(tmp_path), state, tmp_path


@pytest.fixture(scope="module")
def ref_state():
    jstate = jinit_state(jax.random.PRNGKey(0),
                         jget_arch("smollm_360m").reduced(), JTrainConfig())
    return jstate, convert.state_from_reference(
        jax.tree.map(np.asarray, jstate), "cpu")


def _raw(x: torch.Tensor) -> torch.Tensor:
    return x.detach().reshape(-1).view(torch.uint8)


def _assert_equal(a, b):
    pa, pb = tree.items(a), tree.items(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (_, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and x.shape == y.shape and x.device == y.device
        assert torch.equal(_raw(x), _raw(y))


def test_roundtrip_no_loss(ckpt_env):
    ck, state, _ = ckpt_env
    ck.save(7, state, wait=True)
    restored, report = ck.load(state)
    _assert_equal(state, restored)
    assert report.blocks_repaired == 0 and report.sim is None
    assert ck.latest_step() == 7
    assert set(ck.last_load) == {"read", "h2d", "repair", "assemble"}
    assert set(ck.last_save) == {"snapshot", "layout", "encode", "d2h", "crc",
                                 "write"}


@pytest.mark.parametrize("lost", [(3,), (1, 5)])
def test_repair_lost_domains(ckpt_env, lost):
    ck, state, _ = ckpt_env
    ck.save(1, state, wait=True)
    restored, report = ck.load(state, lost_domains=lost)
    _assert_equal(state, restored)
    assert report.lost_domains == tuple(sorted(lost))
    assert report.blocks_repaired > 0
    assert report.sim is not None and report.sim.total_time > 0


def test_too_many_losses_raises(ckpt_env, ref_state, tmp_path):
    ck, state, _ = ckpt_env
    ck.save(1, state, wait=True)
    with pytest.raises(RuntimeError) as ours:
        ck.load(state, lost_domains=(0, 1, 2))    # > n-k = 2 per stripe
    jstate, _ = ref_state
    jck = _jcheckpointer(tmp_path / "ref")
    jck.save(1, jstate, wait=True)
    with pytest.raises(RuntimeError) as theirs:
        jck.load(jstate, lost_domains=(0, 1, 2))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("lost", [(), (7,), (1, 5), (1, 2), (0, 1)])
def test_load_repairs_every_stripe_in_one_call(ckpt_env, monkeypatch, lost):
    """A load that repairs makes one call of the batched reconstruct (on
    the CPU its plain version) for all its stripes, and none when no data
    block was lost; `rs_reconstruct` a stripe is never called."""
    ck, state, _ = ckpt_env
    ck.save(1, state, wait=True)
    calls = []
    batched = ref.gf256_reconstruct_stripes_ref

    def counted(coeffs, patterns, *args):
        calls.append((len(coeffs), len(patterns)))
        return batched(coeffs, patterns, *args)

    def per_stripe(*args):
        raise AssertionError("the load reconstructed a stripe on its own")

    monkeypatch.setattr(ref, "gf256_reconstruct_stripes_ref", counted)
    monkeypatch.setattr(ops, "rs_reconstruct", per_stripe)
    restored, report = ck.load(state, lost_domains=lost)
    _assert_equal(state, restored)
    if report.stripes_repaired:
        assert calls == [(calls[0][0], report.stripes_repaired)]
        assert 1 <= calls[0][0] <= 3
    else:
        assert calls == [] and report.blocks_repaired == 0


@pytest.mark.parametrize("lost", [(), (1, 5), (0, 1)])
def test_load_across_windows(ckpt_env, monkeypatch, lost):
    """A blob held in many windows of three rows (leaves cross them)
    restores the same bytes, and every window the leaves have passed is
    let go before the load returns."""
    ck, state, _ = ckpt_env
    ck.save(1, state, wait=True)
    monkeypatch.setattr(ec_checkpoint, "WINDOW_BYTES",
                        3 * ck.cfg.chunk_bytes)
    seen = []
    unflatten = ECCheckpointer._unflatten

    def keep(self, windows, meta, template):
        seen.append((windows, windows[0].numel(), meta["total_bytes"]))
        return unflatten(self, windows, meta, template)

    monkeypatch.setattr(ECCheckpointer, "_unflatten", keep)
    restored, report = ck.load(state, lost_domains=lost)
    _assert_equal(state, restored)
    (windows, size, total), = seen
    assert size == 3 * ck.cfg.chunk_bytes and len(windows) > 10
    assert all(w is None for w in windows[: total // size])
    assert (report.blocks_repaired > 0) == bool(lost)


@pytest.mark.parametrize("lost", [(3,), (1, 5), (1, 2), (0, 1), (2, 6)])
def test_spare_rows_are_the_parity_helpers(lost):
    """A stripe that lost f data blocks reads f parity helpers: the spare
    rows beside the blob are exactly as many as the blocks repaired, each
    a surviving parity block of its stripe, in the order the helpers
    read them."""
    code = RSCode(6, 4)
    stripes = stripe_lib.place_stripes(200, code, 8)
    alive = {(s.stripe_id, b) for s in stripes
             for b, node in enumerate(s.node_ids) if node not in lost}
    cb = 64
    plan = ec_checkpoint.plan_repair(code, stripes, alive, cb)
    assert len(plan.spare) == plan.blocks > 0
    assert all(b >= code.k and blk in alive
               for blk in plan.spare for b in blk[1:])
    blob = 200 * code.k * cb
    spare_reads = np.sort(plan.src_off[plan.src_off >= blob])
    assert spare_reads.tolist() == [blob + j * cb
                                    for j in range(len(plan.spare))]


@pytest.mark.parametrize("lost", [(3, 6, 7), (1, 4, 6), (0, 1, 2)])
def test_too_many_losses_name_the_reference_stripe(ref_state, tmp_path,
                                                   monkeypatch, lost):
    """The first stripe that lost more than n-k blocks is named as the
    reference names it, and nothing is reconstructed first."""
    jstate, state = ref_state
    ours, theirs = _checkpointer(tmp_path / "port"), _jcheckpointer(
        tmp_path / "ref")
    ours.save(1, state, wait=True)
    theirs.save(1, jstate, wait=True)
    monkeypatch.setattr(ref, "gf256_reconstruct_stripes_ref", None)
    with pytest.raises(RuntimeError) as got:
        ours.load(state, lost_domains=lost)
    with pytest.raises(RuntimeError) as want:
        theirs.load(jstate, lost_domains=lost)
    assert str(got.value) == str(want.value)
    assert not str(got.value).startswith("stripe 0:") or lost == (0, 1, 2)


def test_corrupt_domain_detected(ckpt_env):
    ck, state, _ = ckpt_env
    ck.save(1, state, wait=True)
    path = os.path.join(ck._step_dir(1), "domain_2.bin")
    buf = bytearray(open(path, "rb").read())
    buf[100] ^= 0xFF
    open(path, "wb").write(bytes(buf))
    restored, report = ck.load(state)
    _assert_equal(state, restored)
    assert 2 in report.lost_domains
    os.remove(os.path.join(ck._step_dir(1), "domain_6.bin"))
    restored, report = ck.load(state)              # missing counts as lost
    _assert_equal(state, restored)
    assert report.lost_domains == (2, 6)


def test_async_save_then_load(ckpt_env):
    ck, state, _ = ckpt_env
    ck.save(3, state)           # async
    ck.wait()
    restored, _ = ck.load(state)
    _assert_equal(state, restored)


def test_save_snapshots_before_returning(ckpt_env):
    """An in-place update after `save` returns never reaches the save."""
    ck, state, _ = ckpt_env
    want = [x.clone() for x in tree.leaves(state)]
    ck.save(5, state)           # async
    for leaf in tree.leaves(state):
        leaf.zero_()
    ck.wait()
    restored, _ = ck.load(state)
    for x, y in zip(want, tree.leaves(restored)):
        assert torch.equal(_raw(x), _raw(y))


def test_latest_step_picks_max(ckpt_env):
    ck, state, _ = ckpt_env
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.load(state)
    ck.save(1, state, wait=True)
    ck.save(9, state, wait=True)
    assert ck.latest_step() == 9


def test_background_save_error_is_raised(ckpt_env):
    ck, state, d = ckpt_env
    (d / "step_00000004.tmp").write_text("a file where a directory goes")
    ck.save(4, state)           # async: the writer fails
    with pytest.raises(RuntimeError, match="background checkpoint save"):
        ck.wait()
    ck.wait()                   # the error is raised once


@pytest.mark.parametrize("chunk_bytes", [1 << 14, 1 << 18])
def test_files_equal_reference(ref_state, tmp_path, chunk_bytes):
    jstate, state = ref_state
    ours = _checkpointer(tmp_path / "port", chunk_bytes)
    theirs = _jcheckpointer(tmp_path / "ref", chunk_bytes)
    ours.save(2, state, wait=True)
    theirs.save(2, jstate, wait=True)
    d_ours, d_theirs = ours._step_dir(2), theirs._step_dir(2)
    names = sorted(os.listdir(d_theirs))
    assert sorted(os.listdir(d_ours)) == names
    for name in names:
        if name.endswith(".bin"):
            assert filecmp.cmp(os.path.join(d_ours, name),
                               os.path.join(d_theirs, name), shallow=False)
    m_ours = json.load(open(os.path.join(d_ours, "manifest.json")))
    m_theirs = json.load(open(os.path.join(d_theirs, "manifest.json")))
    assert m_ours.keys() == m_theirs.keys()
    for key in m_theirs:
        if key != "treedef":
            assert m_ours[key] == m_theirs[key], key
    assert m_ours["dtypes"][-1] == "int32" and "bfloat16" in m_ours["dtypes"]


@pytest.mark.parametrize("lost", [(), (3,), (1, 5), (1, 2), (0, 1)])
def test_checkpoints_cross_load(ref_state, tmp_path, lost):
    jstate, state = ref_state
    ours, theirs = _checkpointer(tmp_path / "port"), _jcheckpointer(
        tmp_path / "ref")
    ours.save(1, state, wait=True)
    theirs.save(1, jstate, wait=True)
    # the port reads the reference's checkpoint ...
    from_ref, report = _checkpointer(tmp_path / "ref").load(
        state, lost_domains=lost)
    _assert_equal(state, from_ref)
    # ... and the reference reads the port's
    from_port, jreport = _jcheckpointer(tmp_path / "port").load(
        jstate, lost_domains=lost)
    for x, y in zip(jax.tree.leaves(from_port), jax.tree.leaves(jstate)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(np.asarray(x).reshape(-1).view(np.uint8),
                              np.asarray(y).reshape(-1).view(np.uint8))
    assert (report.blocks_repaired, report.stripes_repaired,
            report.lost_domains) == (jreport.blocks_repaired,
                                     jreport.stripes_repaired,
                                     jreport.lost_domains)
    if lost:
        np.testing.assert_allclose(report.sim.total_time,
                                   jreport.sim.total_time, rtol=1e-6)
        assert report.sim.num_rounds == jreport.sim.num_rounds


@pytest.mark.parametrize("arch", ["rwkv6_16b", "zamba2_7b"])
def test_recurrent_family_states_equal_reference(tmp_path, arch):
    """A reduced rwkv6 or zamba2 train state (fp32 leaves `w0`, `u` or
    `A_log`, `dt_bias`, `D` among bf16 params, fp32 moments): the same
    domain files, checksums and manifest as the reference's (`treedef`
    excepted), and a load with domains (1, 5) lost restores every leaf
    bit for bit, as the reference's load does."""
    jstate = jinit_state(jax.random.PRNGKey(0), jget_arch(arch).reduced(),
                         JTrainConfig())
    state = convert.state_from_reference(jax.tree.map(np.asarray, jstate),
                                         "cpu")
    dtypes = {str(x.dtype) for x in tree.leaves(state["params"])}
    assert dtypes == {"torch.bfloat16", "torch.float32"}
    ours = _checkpointer(tmp_path / "port")
    theirs = _jcheckpointer(tmp_path / "ref")
    ours.save(3, state, wait=True)
    theirs.save(3, jstate, wait=True)
    d_ours, d_theirs = ours._step_dir(3), theirs._step_dir(3)
    names = sorted(os.listdir(d_theirs))
    assert sorted(os.listdir(d_ours)) == names
    for name in names:
        if name.endswith(".bin"):
            assert filecmp.cmp(os.path.join(d_ours, name),
                               os.path.join(d_theirs, name), shallow=False)
    m_ours = json.load(open(os.path.join(d_ours, "manifest.json")))
    m_theirs = json.load(open(os.path.join(d_theirs, "manifest.json")))
    assert m_ours.keys() == m_theirs.keys()
    for key in m_theirs:
        if key != "treedef":
            assert m_ours[key] == m_theirs[key], key
    restored, report = ours.load(state, lost_domains=(1, 5))
    _assert_equal(state, restored)
    jrestored, jreport = theirs.load(jstate, lost_domains=(1, 5))
    for x, y in zip(tree.leaves(restored), jax.tree.leaves(jrestored)):
        y = np.asarray(y)
        assert np.array_equal(_raw(x).numpy(), y.reshape(-1).view(np.uint8))
    assert (report.blocks_repaired, report.stripes_repaired) == (
        jreport.blocks_repaired, jreport.stripes_repaired)
    assert report.blocks_repaired > 0


def test_end_to_end_failure_recovery(tmp_path):
    """Train, checkpoint, lose 2 domains, repair, resume — losses continue
    from where they left off (tests/test_ft.py's, on the port)."""
    shape = ShapeConfig("t", "train", 32, 8)
    tcfg = TrainConfig(adamw=AdamWConfig(peak_lr=5e-3, warmup_steps=5),
                       attn_chunk=16)
    ck = _checkpointer(tmp_path)
    state = init_state(0, CFG, tcfg, device="cpu")
    step = make_train_step(CFG, tcfg)
    stream = SyntheticStream(CFG, shape)
    for i in range(10):
        state, m = step(state, stream.batch_at(i))
    ck.save(10, state, wait=True)
    restored, report = ck.load(state, lost_domains=(0, 4))
    assert report.blocks_repaired > 0
    assert int(restored["step"]) == 10
    batch = stream.batch_at(10)
    _, m2 = step(restored, batch)
    _, m_direct = step(state, batch)
    assert abs(float(m2["loss"]) - float(m_direct["loss"])) < 1e-5


def test_device_none_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ECCheckpointer(ECCheckpointConfig(directory=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _checkpointer(tmp_path, device="cuda")


def test_jax_arrays_not_needed():
    """bf16 leaves travel as raw bytes: a template of CPU tensors suffices
    and nothing here reads ml_dtypes."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3).bfloat16()
    back = convert.state_from_reference(convert.state_to_numpy(
        {"w": x, "s": torch.tensor(3, dtype=torch.int32)}), "cpu")
    assert back["w"].dtype == torch.uint16    # the caller restores the type
    assert torch.equal(back["w"].view(torch.bfloat16), x)
    assert back["s"].shape == () and int(back["s"]) == 3
    jx = jnp.asarray(np.asarray(x.float()), jnp.bfloat16)
    got = convert.state_from_reference({"w": np.asarray(jx)}, "cpu")["w"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, x)
