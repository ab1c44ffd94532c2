"""Multi-node failure during training: two hosts die at once; MSRepair
schedules the parallel reconstruction (vs m-PPR serialization), training
elastically resumes. Also demos the straggler monitor.

    PYTHONPATH=src python examples/torch_multinode_recovery.py [--device cpu]

The state, the checkpoint's encode and its repair live on the card
(`gf256_matmul_bytes`: one launch a save; `gf256_reconstruct_stripes`:
one launch a load that repairs, for all its stripes) unless `--device cpu` runs the plain PyTorch path; without a card
it raises. The initial params are drawn from a `torch.Generator`, so the
losses differ from the JAX package's example; the control flow, the
saves, the repair and its pricing are the same.
"""
import argparse
import shutil
import tempfile
import time

from repro_torch.checkpoint import ECCheckpointConfig, ECCheckpointer
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import topology
from repro_torch.core.bandwidth import BandwidthProcess, IngressModel
from repro_torch.core.simulator import RepairSimulator, Scenario
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.device import resolve_device
from repro_torch.ft import FailureInjector, StragglerMonitor
from repro_torch.ft.elastic import elastic_data_size
from repro_torch.ft.failures import FailureEvent
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import TrainConfig, init_state, make_train_step

STEPS = 40           # training steps; saves every 10, hosts (2, 9) die at 25


def main(device=None):
    dev = resolve_device(device)
    cfg = get_arch("qwen2_15b").reduced()
    shape = ShapeConfig("demo", "train", 32, 16)
    tcfg = TrainConfig(adamw=AdamWConfig(peak_lr=5e-3, warmup_steps=5),
                       attn_chunk=16)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_multinode_")
    _, bwm = topology.tpu_pod_dcn_matrix(8, 2)          # 16 hosts, 2 pods
    ck = ECCheckpointer(
        ECCheckpointConfig(directory=ckpt_dir, n=7, k=4, chunk_bytes=1 << 15,
                           num_domains=16, scheme="msrepair"),
        bw=BandwidthProcess(base=bwm, change_interval=2.0, mode="markov"),
        ingress=IngressModel(),
        device=dev,
    )
    injector = FailureInjector(
        num_domains=16,
        scheduled=(FailureEvent(step=25, domains=(2, 9)),))
    monitor = StragglerMonitor(num_hosts=16)

    state = init_state(0, cfg, tcfg, device=dev)
    step_fn = make_train_step(cfg, tcfg)
    stream = SyntheticStream(cfg, shape)
    hosts = 16

    step = 0
    handled: set[int] = set()
    while step < STEPS:
        ev = injector.check(step)
        if ev is not None and step in handled:
            ev = None                       # dead hosts were already replaced
        if ev is not None:
            handled.add(step)
            print(f"\n!! step {step}: hosts {ev.domains} died")
            # price the multi-node repair with MSRepair vs m-PPR
            sc = Scenario(num_nodes=16, code=ck.code, failed=(0, 1),
                          bw=ck.bw, ingress=ck.ingress, chunk_mb=32)
            sim = RepairSimulator(sc)
            t_ms = sim.run("msrepair").total_time
            t_mp = sim.run("mppr").total_time
            print(f"   stripe repair schedule: msrepair {t_ms:.2f}s vs "
                  f"m-ppr {t_mp:.2f}s ({100 * (1 - t_ms / t_mp):.0f}% faster)")
            state, report = ck.load(state, lost_domains=ev.domains)
            print(f"   checkpoint repaired: {report.blocks_repaired} blocks, "
                  f"byte-verified")
            hosts -= len(ev.domains)
            new_batch = elastic_data_size(shape.global_batch, 16, hosts)
            print(f"   elastic re-mesh: {hosts} hosts remain, global batch "
                  f"{shape.global_batch} -> {new_batch}")
            step = int(state["step"])
            continue
        t0 = time.time()
        state, m = step_fn(state, stream.batch_at(step))
        monitor.record(step % hosts, time.time() - t0)
        if step % 10 == 0:
            print(f"step {step:3d} loss {float(m['loss']):.4f} "
                  f"({hosts} hosts)")
        if step and step % 10 == 0:
            ck.save(step, state, wait=True)
        step += 1
    stragglers = monitor.stragglers()
    print(f"\nstraggler report: {stragglers or 'none flagged'}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    print("done.")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch path)")
    main(ap.parse_args().device)
