"""Planning and lowering (steps 2-3: `run_sweep`, `compile_plan`,
`relabel_plan_nodes`) per stripe, from the benchmark's spans over the
whole window."""
UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "planning and lowering"
MOVES = "repair_p95_ms"


def read(run):
    return (sum(b.plan_s for b in run.batches)
            / sum(b.stripes for b in run.batches) * 1e3)
