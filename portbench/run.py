"""Run one cell of the port's benchmark once; see `portbench/harness.py`.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (JSON); the last lines of
standard error give each number compared beside its limit.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# one process, few threads: the host plans, the card moves the bytes
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
# the CUDA driver's kernel cache lives at a fixed place in the checkout
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

try:
    from portbench import harness  # noqa: E402
except ImportError as err:
    print(f"portbench: cannot import the program or the harness: {err}",
          file=sys.stderr)
    sys.exit(3)

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
