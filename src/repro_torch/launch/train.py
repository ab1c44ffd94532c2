"""End-to-end training launcher with EC-checkpointed fault tolerance.

    python -m repro_torch.launch.train --arch smollm_360m [--full] ...

The JAX package's `launch/train.py` loop, on one device (the card unless
`--device cpu`):

  loop:  data -> train_step -> metrics
         every --ckpt-every steps: async EC-checkpoint save
         failure injected?  -> repair checkpoint shards (BMFRepair/MSRepair)
                            -> resume from the repaired state
         straggler flagged? -> reported

As in the reference, a resume assigns the restored state's step to the
loop variable for that iteration only: the iteration trains on the
restored step's batch and the `for` loop then carries on from its range
(a failure at step 6 after a save at step 4 trains steps 0-5, 5, 7).
`run(argv)` returns the final state and one record per step, save and
repair; `main()` is the command line.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.checkpoint import ECCheckpointConfig, ECCheckpointer
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import topology
from repro_torch.core.bandwidth import BandwidthProcess, IngressModel
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.device import resolve_device
from repro_torch.ft import FailureEvent, FailureInjector, StragglerMonitor
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (TrainConfig, init_state,
                                          make_train_step)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="use the reduced config (the default)")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="use the published config")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a 2-domain failure at this step")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch path)")
    return ap.parse_args(argv)


def _save_record(ck: ECCheckpointer, step: int) -> dict:
    """The record of the save of `step`, once it has landed."""
    return {"event": "save", "step": step, "seconds": dict(ck.last_save)}


def configs(args: argparse.Namespace):
    """(arch config, batch shape, train config) of a command line."""
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig("cli", "train", args.seq_len, args.batch)
    tcfg = TrainConfig(
        adamw=AdamWConfig(peak_lr=args.lr, warmup_steps=10),
        microbatches=args.microbatches,
        attn_chunk=min(1024, args.seq_len),
        compress_grads=args.compress_grads,
    )
    return cfg, shape, tcfg


def checkpointer(args: argparse.Namespace, device) -> ECCheckpointer:
    """RS(6,4) EC checkpoints at 256 KiB chunks over a simulated 8-domain
    host network, in `args.ckpt_dir`."""
    _, bwm = topology.tpu_pod_dcn_matrix(8, 1, seed=args.seed)
    return ECCheckpointer(
        ECCheckpointConfig(directory=args.ckpt_dir, n=6, k=4,
                           chunk_bytes=1 << 18, num_domains=8),
        bw=BandwidthProcess(base=bwm, change_interval=2.0, mode="markov",
                            seed=args.seed),
        ingress=IngressModel(seed=args.seed),
        device=device,
    )


def run(argv=None) -> tuple[dict, list[dict]]:
    """Train as the command line says; returns (final state, records)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg, shape, tcfg = configs(args)

    ck = checkpointer(args, dev)
    injector = FailureInjector(
        num_domains=8,
        scheduled=(() if args.fail_at < 0 else
                   (FailureEvent(step=args.fail_at, domains=(1, 5)),)),
    )
    monitor = StragglerMonitor(num_hosts=8)
    records: list[dict] = []

    state = init_state(args.seed, cfg, tcfg, device=dev)
    start = 0
    if args.resume and ck.latest_step() is not None:
        state, report = ck.load(state)
        start = int(state["step"])
        print(f"[train] resumed from step {start} "
              f"(repaired {report.blocks_repaired} blocks)")

    step_fn = make_train_step(cfg, tcfg)
    stream = SyntheticStream(cfg, shape)
    pending = None                      # step of the save in flight

    for step in range(start, args.steps):
        ev = injector.check(step)
        if ev is not None:
            print(f"[train] FAILURE at step {step}: domains {ev.domains} — "
                  f"repairing checkpoint + restart")
            ck.wait()
            if pending is not None:
                records.append(_save_record(ck, pending))
                pending = None
            state, report = ck.load(state, lost_domains=ev.domains)
            sim_t = None if report.sim is None else report.sim.total_time
            print(f"[train] repaired {report.blocks_repaired} blocks "
                  f"({report.stripes_repaired} stripes), scheme sim time "
                  f"{sim_t}, wall {report.wall_seconds:.2f}s")
            failed_at, step = step, int(state["step"])
            records.append({
                "event": "repair", "step": failed_at, "resumed_at": step,
                "lost_domains": list(report.lost_domains),
                "blocks_repaired": report.blocks_repaired,
                "stripes_repaired": report.stripes_repaired,
                "sim_time": sim_t, "wall_seconds": report.wall_seconds})
        t0 = time.time()
        state, metrics = step_fn(state, stream.batch_at(step))
        loss = float(metrics["loss"])           # waits for the step
        dt = time.time() - t0
        records.append({"event": "step", "step": step, "loss": loss,
                        "lr": float(metrics["lr"]),
                        "grad_norm": float(metrics["grad_norm"]),
                        "seconds": dt})
        monitor.record(step % 8, dt)       # simulated per-host step times
        if step % 10 == 0 or step == args.steps - 1:
            print(f"[train] step {step}: loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} ({dt:.2f}s)")
        if step > 0 and step % args.ckpt_every == 0:
            ck.wait()                   # the previous save must land
            if pending is not None:
                records.append(_save_record(ck, pending))
            ck.save(step, state)
            pending = step
        if monitor.stragglers():
            print(f"[train] stragglers flagged: {monitor.stragglers()}")
    ck.wait()
    if pending is not None:
        records.append(_save_record(ck, pending))
    ck.save(args.steps, state, wait=True)
    records.append(_save_record(ck, args.steps))
    print("[train] done")
    return state, records


def main():
    run()


if __name__ == "__main__":
    main()
