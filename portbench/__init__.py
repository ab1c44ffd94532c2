"""Benchmark of the PyTorch and CUDA port (`repro_torch`) on one GPU.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once: a closed loop of
node-loss repair batches, planned by the port's sweep engine and
repaired over real bytes by its batched data plane on the card, then
checked against the plain reference in `portbench/reference.py`.
"""
