"""Quickstart: train a ~reduced LM for 120 steps with erasure-coded
checkpointing, lose two failure domains mid-run, repair with MSRepair, and
resume — on the card.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The state, the checkpoint's encode and its repair live on the card
(`gf256_matmul_bytes`: one launch for the save; `gf256_reconstruct_stripes`:
one launch for the load's repair of every stripe that lost data) unless `--device cpu` runs the plain PyTorch path; without a
card it raises. The initial params are drawn from a `torch.Generator`, so
the losses differ from the JAX package's quickstart; the steps, the
checkpoint and the repair are the same.
"""
import argparse
import shutil
import tempfile

from repro_torch.checkpoint import ECCheckpointConfig, ECCheckpointer
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import topology
from repro_torch.core.bandwidth import BandwidthProcess, IngressModel
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.device import resolve_device
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import TrainConfig, init_state, make_train_step

STEPS = 120          # training steps; the checkpoint is written at step 60


def main(device=None):
    dev = resolve_device(device)
    cfg = get_arch("smollm_360m").reduced()
    shape = ShapeConfig("quickstart", "train", 64, 8)
    tcfg = TrainConfig(adamw=AdamWConfig(peak_lr=5e-3, warmup_steps=10),
                       microbatches=2, attn_chunk=32)

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_quickstart_")
    _, bwm = topology.tpu_pod_dcn_matrix(8, 1)
    ck = ECCheckpointer(
        ECCheckpointConfig(directory=ckpt_dir, n=6, k=4,
                           chunk_bytes=1 << 16, num_domains=8,
                           scheme="msrepair", single_scheme="bmf"),
        bw=BandwidthProcess(base=bwm, change_interval=2.0, mode="markov"),
        ingress=IngressModel(),
        device=dev,
    )

    state = init_state(0, cfg, tcfg, device=dev)
    step_fn = make_train_step(cfg, tcfg)
    stream = SyntheticStream(cfg, shape)

    print(f"== training {cfg.name} (reduced) for {STEPS} steps ==")
    for step in range(STEPS):
        state, m = step_fn(state, stream.batch_at(step))
        if step % 20 == 0:
            print(f"  step {step:3d}  loss {float(m['loss']):.4f}")
        if step == 60:
            ck.save(60, state, wait=True)
            print("  [ckpt] erasure-coded checkpoint written at step 60 "
                  f"(RS({ck.code.n},{ck.code.k}), 8 failure domains)")

    print("== simulating loss of domains {1, 5} and restoring ==")
    restored, report = ck.load(state, lost_domains=(1, 5))
    print(f"  repaired {report.blocks_repaired} blocks across "
          f"{report.stripes_repaired} stripes")
    if report.sim:
        print(f"  {report.sim.scheme} repair schedule: "
              f"{report.sim.num_rounds} rounds, "
              f"{report.sim.total_time:.3f}s simulated network time")
    restored_step = int(restored["step"])
    print(f"  restored train state at step {restored_step} — resuming")
    _, m = step_fn(restored, stream.batch_at(restored_step))
    print(f"  resumed loss {float(m['loss']):.4f}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    print("done.")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch path)")
    main(ap.parse_args().device)
