"""The paper's contribution: BMFRepair (Alg. 1) + MSRepair (Alg. 2) and the
baselines they are evaluated against (traditional, PPR, PPT, m-PPR, random
scheduling), plus the dynamic-bandwidth simulator and the byte data-plane
executor. Planning and simulation are scalar numpy code on the host, as in
the reference package; bytes move as torch tensors through the CUDA
kernels (`core/executor.py`)."""

from repro_torch.core.bandwidth import BandwidthProcess, BandwidthTrace, IngressModel  # noqa: F401
from repro_torch.core.plan import Job, RepairPlan, Round, Transfer, validate_plan  # noqa: F401
from repro_torch.core.simulator import (  # noqa: F401
    ALL_SCHEMES,
    MULTI_SCHEMES,
    SINGLE_SCHEMES,
    RepairSimulator,
    Scenario,
    SimResult,
    run_scheme,
)
