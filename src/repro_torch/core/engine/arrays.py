"""Structure-of-arrays IR for repair plans.

`compile_plan` lowers the object IR (`RepairPlan` / `Round` / `Transfer`)
into `PlanArrays`: padded integer arrays (hop endpoints, round offsets,
job ids) plus uint64 *term bitmasks* — one bit per helper node id. The
lowering is lossless: `decompile` reconstructs the exact original plan
(`decompile(compile_plan(p)) == p` for every planner's output, including
BMF-relayed paths), so the array form can sit on the hot path while the
object form stays the human-readable reference.

`validate_plan_arrays` is the array fast path behind
`repro_torch.core.plan.validate_plan`: role conflicts per round become
`np.bincount`s over node ids, and the fragment bookkeeping (which terms
are XOR-folded where) becomes bitwise ops on a `(jobs, nodes)` uint64
holdings table instead of dict-of-set mutation.

Term (helper) node ids must fit a 64-bit mask (id < 64) — path, relay
and requestor ids are plain integers and have no such limit;
`compile_plan` raises `UnsupportedPlanError` otherwise and callers fall
back to the object path.

`PlanArrays` is plan metadata that lives on the host: every field is a
numpy array, as in the JAX package, and term masks are `uint64` (numpy
shifts them without the sign-bit trap an `int64` torch tensor would set
for term id 63). The byte data plane (`core/engine/dataplane.py`) turns
only the row indices it needs into device tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import tracing
from repro_torch.core.plan import Job, RepairPlan, Round, Transfer

_MAX_MASK_NODES = 64


class UnsupportedPlanError(ValueError):
    """The plan cannot be lowered to arrays (helper/term ids >= 64)."""


def _terms_mask(terms) -> int:
    mask = 0
    for t in terms:
        t = int(t)
        if not 0 <= t < _MAX_MASK_NODES:
            raise UnsupportedPlanError(
                f"term node id {t} does not fit a uint64 bitmask"
            )
        mask |= 1 << t
    return mask


def _mask_terms(mask: int) -> frozenset[int]:
    out = []
    m = int(mask)
    while m:
        b = m & -m
        out.append(b.bit_length() - 1)
        m ^= b
    return frozenset(out)


@dataclasses.dataclass
class PlanArrays:
    """Compiled `RepairPlan`: jobs, transfers and rounds as padded arrays.

    Transfers are stored round-major (round r occupies rows
    `round_start[r]:round_start[r + 1]`, original in-round order
    preserved). Paths are padded with -1 to the longest path in the plan;
    `t_path_len` holds each row's true length. `t_job` carries the raw
    `Transfer.job` id for exact round-tripping, `t_job_idx` the position
    of that job in the `jobs` list (what the engine indexes with).
    """

    # jobs (J rows, original order)
    job_id: np.ndarray          # (J,) int32 — raw Job.job_id
    job_failed: np.ndarray      # (J,) int32
    job_requestor: np.ndarray   # (J,) int32
    job_helpers: np.ndarray     # (J, Hmax) int32, -1 padded (order kept)
    job_helpers_len: np.ndarray  # (J,) int32
    job_terms: np.ndarray       # (J,) uint64 — full term bitmask

    # transfers (T rows, round-major)
    t_src: np.ndarray           # (T,) int32
    t_dst: np.ndarray           # (T,) int32
    t_job: np.ndarray           # (T,) int32 — raw job id
    t_job_idx: np.ndarray       # (T,) int32 — row into the job arrays
    t_terms: np.ndarray         # (T,) uint64 — payload term bitmask
    t_path: np.ndarray          # (T, Pmax) int32, -1 padded
    t_path_len: np.ndarray      # (T,) int32

    # rounds
    round_start: np.ndarray     # (R + 1,) int32 offsets into transfer rows

    num_nodes: int              # max node id referenced + 1
    meta: dict

    @property
    def num_jobs(self) -> int:
        return int(self.job_id.shape[0])

    @property
    def num_rounds(self) -> int:
        return int(self.round_start.shape[0]) - 1

    @property
    def num_transfers(self) -> int:
        return int(self.t_src.shape[0])

    def round_rows(self, r: int) -> slice:
        return slice(int(self.round_start[r]), int(self.round_start[r + 1]))

    def round_hops(self, r: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Hop endpoint arrays for round r: (hop_u, hop_v, n_hops).

        hop_u/hop_v are (n, Hmax) with hop h of transfer i being
        `hop_u[i, h] -> hop_v[i, h]`; rows are valid up to `n_hops[i]`.
        """
        sl = self.round_rows(r)
        path = self.t_path[sl]
        return path[:, :-1], path[:, 1:], self.t_path_len[sl] - 1


def _job_fields(jobs: list[Job]) -> dict:
    """The job-side `PlanArrays` fields shared by both constructors."""
    hmax = max(max((len(j.helpers) for j in jobs), default=0), 1)
    ids = np.array(
        [(j.job_id, j.failed_node, j.requestor, len(j.helpers))
         for j in jobs], dtype=np.int32).reshape(len(jobs), 4)
    job_helpers = np.array(
        [(*j.helpers, *(-1,) * (hmax - len(j.helpers))) for j in jobs],
        dtype=np.int32).reshape(len(jobs), hmax)
    return dict(
        job_id=ids[:, 0],
        job_failed=ids[:, 1],
        job_requestor=ids[:, 2],
        job_helpers=job_helpers,
        job_helpers_len=ids[:, 3],
        job_terms=np.array([_terms_mask(j.helpers) for j in jobs],
                           dtype=np.uint64),
    )


@tracing.spanned("plan.convert")
def compile_plan(plan: RepairPlan) -> PlanArrays:
    """Lower a `RepairPlan` to `PlanArrays` (exact, reversible)."""
    jobs = plan.jobs
    job_index = {j.job_id: i for i, j in enumerate(jobs)}

    transfers = [t for rnd in plan.rounds for t in rnd.transfers]
    counts = [len(rnd.transfers) for rnd in plan.rounds]
    pmax = max(max((len(t.path) for t in transfers), default=2), 2)
    t_job_idx = []
    for t in transfers:
        if t.job not in job_index:
            raise UnsupportedPlanError(f"transfer {t} references unknown job")
        t_job_idx.append(job_index[t.job])

    max_node = max(
        [0]
        + [x for j in jobs for x in (j.failed_node, j.requestor, *j.helpers)]
        + [x for t in transfers for x in t.path]
    )
    return PlanArrays(
        **_job_fields(jobs),
        t_src=np.array([t.src for t in transfers], dtype=np.int32),
        t_dst=np.array([t.dst for t in transfers], dtype=np.int32),
        t_job=np.array([t.job for t in transfers], dtype=np.int32),
        t_job_idx=np.array(t_job_idx, dtype=np.int32),
        t_terms=np.array([_terms_mask(t.terms) for t in transfers],
                         dtype=np.uint64),
        t_path=np.array(
            [list(t.path) + [-1] * (pmax - len(t.path)) for t in transfers],
            dtype=np.int32).reshape(len(transfers), pmax),
        t_path_len=np.array([len(t.path) for t in transfers],
                            dtype=np.int32),
        round_start=np.concatenate(
            [[0], np.cumsum(counts, dtype=np.int64)]).astype(np.int32),
        num_nodes=max_node + 1,
        meta=dict(plan.meta),
    )


def _schedule_max_node(jobs: list[Job], flat: list) -> int:
    """Highest node id a schedule references (jobs + transfer endpoints)."""
    return max(
        [0]
        + [x for j in jobs for x in (j.failed_node, j.requestor, *j.helpers)]
        + [x for tr in flat for x in tr[:2]]
    )


def _schedule_t_job_idx(jobs: list[Job], flat: list,
                        job_col: np.ndarray) -> np.ndarray:
    """Row-into-jobs index per transfer (identity fast path included)."""
    if all(j.job_id == i for i, j in enumerate(jobs)):
        return job_col                  # identity mapping, no lookup pass
    index = {j.job_id: i for i, j in enumerate(jobs)}
    return np.array([index[tr[2]] for tr in flat], dtype=np.int32)


def _round_starts(rounds: list[list]) -> np.ndarray:
    starts = [0]
    for rnd in rounds:
        starts.append(starts[-1] + len(rnd))
    return np.array(starts, dtype=np.int32)


def _case_plan_arrays(
    jobs: list[Job],
    rounds: list[list[tuple[int, int, int, int]]],
    flat: list,
    meta: dict,
    job_fields: dict,
    ints: np.ndarray,          # (T, 3) int32 — src, dst, job columns
    terms: np.ndarray,         # (T,) uint64
) -> PlanArrays:
    """Assemble one case's `PlanArrays` from pre-lowered column arrays —
    the single construction path of `plan_arrays_from_schedule` and of
    the batched `lower_schedules_batch` (`planner_arrays.py`), which
    passes slices of its concatenated buffers."""
    return PlanArrays(
        **job_fields,
        t_src=ints[:, 0],
        t_dst=ints[:, 1],
        t_job=ints[:, 2],
        t_job_idx=_schedule_t_job_idx(jobs, flat, ints[:, 2]),
        t_terms=terms,
        t_path=ints[:, :2].copy(),
        t_path_len=np.full(len(flat), 2, dtype=np.int32),
        round_start=_round_starts(rounds),
        num_nodes=_schedule_max_node(jobs, flat) + 1,
        meta=dict(meta),
    )


def plan_arrays_from_schedule(
    jobs: list[Job],
    rounds: list[list[tuple[int, int, int, int]]],
    meta: dict,
) -> PlanArrays:
    """Build `PlanArrays` straight from a tuple schedule — no object plan.

    `rounds[r]` holds `(src, dst, job_id, terms_mask)` tuples (direct
    transfers; BMF relays are spliced in later via `splice_path`). This is
    the array planners' native exit: `decompile` of the result equals the
    object facade's `RepairPlan` exactly, but the hot path never allocates
    `Transfer`/`Round` objects.
    """
    job_index = {j.job_id: i for i, j in enumerate(jobs)}
    flat = [tr for rnd in rounds for tr in rnd]
    for src, dst, job_id, mask in flat:
        if job_id not in job_index:
            raise UnsupportedPlanError(
                f"transfer {src}->{dst} references unknown job {job_id}")
        if mask >> _MAX_MASK_NODES:
            raise UnsupportedPlanError(
                "term node id >= 64 does not fit a uint64 bitmask")
    # one bulk lowering: masks checked < 2**64 above, src/dst/job ids are
    # small non-negative ints, so a single uint64 matrix carries all four
    # columns and the typed views are cheap slices of it
    tarr = np.array(flat, dtype=np.uint64).reshape(len(flat), 4)
    ints = tarr[:, :3].astype(np.int32)
    return _case_plan_arrays(jobs, rounds, flat, meta, _job_fields(jobs),
                             ints, tarr[:, 3])


def splice_path(pa: PlanArrays, row: int, path: tuple[int, ...]) -> None:
    """Splice a (relayed) path into transfer `row`, widening `t_path` as
    needed — the incremental mutation the in-stepper BMF replanner uses.

    Validates the splice locally: the path must keep the transfer's
    endpoints, be acyclic and have length >= 2 (the `Transfer` invariants).
    Cross-transfer invariants (relay role exclusivity etc.) are *not*
    re-checked here — run `validate_plan_arrays` on the mutated plan for
    the full audit.
    """
    path = tuple(int(x) for x in path)
    if len(path) < 2:
        raise ValueError(f"path {path} too short")
    if path[0] != int(pa.t_src[row]) or path[-1] != int(pa.t_dst[row]):
        raise ValueError(
            f"path {path} does not keep endpoints "
            f"{int(pa.t_src[row])}->{int(pa.t_dst[row])}")
    if len(set(path)) != len(path):
        raise ValueError(f"cyclic path {path}")
    pmax = pa.t_path.shape[1]
    if len(path) > pmax:
        pa.t_path = np.concatenate(
            [pa.t_path,
             np.full((pa.t_path.shape[0], len(path) - pmax), -1,
                     dtype=np.int32)], axis=1)
    pa.t_path[row, : len(path)] = path
    pa.t_path[row, len(path):] = -1
    pa.t_path_len[row] = len(path)
    if max(path) >= pa.num_nodes:
        pa.num_nodes = max(path) + 1


@tracing.spanned("plan.convert")
def relabel_plan_nodes(pa: PlanArrays, perm: np.ndarray) -> PlanArrays:
    """A copy of `pa` with every node id mapped through `perm`.

    `perm[old] = new` must be defined for every id the plan references
    and injective over them; term/helper images must stay < 64 (the
    bitmask limit). This is how the byte-verification layer replays one
    logical plan against a *placed* stripe (`repro_torch.ec.stripe`): the
    planner's block-position node ids are relabeled to the failure
    domains the stripe actually occupies, and the relabeled plan is as
    valid as the original (renaming preserves every role/fold invariant).
    """
    perm = np.asarray(perm, dtype=np.int64)
    used = np.concatenate([
        pa.job_failed, pa.job_requestor,
        pa.job_helpers[pa.job_helpers >= 0],
        pa.t_path[pa.t_path >= 0],
    ])
    if used.size and (used.max() >= perm.size or (perm[used] < 0).any()):
        raise ValueError("perm does not cover every node id in the plan")
    imgs = perm[np.unique(used)] if used.size else np.array([], dtype=np.int64)
    if np.unique(imgs).size != imgs.size:
        raise ValueError("perm is not injective over the plan's node ids")

    def _map(a: np.ndarray) -> np.ndarray:
        out = np.where(a >= 0, perm[np.maximum(a, 0)], a)
        return out.astype(a.dtype)

    def _map_masks(masks: np.ndarray) -> np.ndarray:
        out = np.zeros_like(masks)
        for i, m in enumerate(int(x) for x in masks):
            new = 0
            while m:
                b = m & -m
                t = perm[b.bit_length() - 1]
                if not 0 <= t < _MAX_MASK_NODES:
                    raise UnsupportedPlanError(
                        f"relabeled term id {t} does not fit a uint64 bitmask")
                new |= 1 << int(t)
                m ^= b
            out[i] = new
        return out

    return PlanArrays(
        job_id=pa.job_id.copy(),
        job_failed=_map(pa.job_failed),
        job_requestor=_map(pa.job_requestor),
        job_helpers=_map(pa.job_helpers),
        job_helpers_len=pa.job_helpers_len.copy(),
        job_terms=_map_masks(pa.job_terms),
        t_src=_map(pa.t_src),
        t_dst=_map(pa.t_dst),
        t_job=pa.t_job.copy(),
        t_job_idx=pa.t_job_idx.copy(),
        t_terms=_map_masks(pa.t_terms),
        t_path=_map(pa.t_path),
        t_path_len=pa.t_path_len.copy(),
        round_start=pa.round_start.copy(),
        num_nodes=int(perm[used].max()) + 1 if used.size else pa.num_nodes,
        meta=dict(pa.meta),
    )


def decompile(pa: PlanArrays) -> RepairPlan:
    """Reconstruct the exact `RepairPlan` that `compile_plan` lowered."""
    jobs = [
        Job(
            job_id=int(pa.job_id[i]),
            failed_node=int(pa.job_failed[i]),
            requestor=int(pa.job_requestor[i]),
            helpers=tuple(
                int(h) for h in pa.job_helpers[i, : int(pa.job_helpers_len[i])]
            ),
        )
        for i in range(pa.num_jobs)
    ]
    rounds = []
    for r in range(pa.num_rounds):
        sl = pa.round_rows(r)
        rounds.append(Round(transfers=[
            Transfer(
                src=int(pa.t_src[i]),
                dst=int(pa.t_dst[i]),
                job=int(pa.t_job[i]),
                terms=_mask_terms(pa.t_terms[i]),
                path=tuple(int(x) for x in
                           pa.t_path[i, : int(pa.t_path_len[i])]),
            )
            for i in range(sl.start, sl.stop)
        ]))
    return RepairPlan(jobs=jobs, rounds=rounds, meta=dict(pa.meta))


# below this many transfers the bincount machinery costs more numpy-call
# overhead than a plain python scan of the (tiny) id lists saves
_SMALL_VALIDATE_TRANSFERS = 64


def _validate_roles_small(pa: PlanArrays, max_recv_per_round: int,
                          srcs: list, dsts: list) -> None:
    """Per-round role-exclusivity scan for small plans (python counters
    over the id lists — same violations, same messages as the array
    path, reported round by round like the object walk)."""
    lens = pa.t_path_len.tolist()
    paths = pa.t_path.tolist()
    starts = pa.round_start.tolist()
    for r in range(pa.num_rounds):
        send: dict[int, int] = {}
        recv: dict[int, int] = {}
        relay: dict[int, int] = {}
        for i in range(starts[r], starts[r + 1]):
            send[srcs[i]] = send.get(srcs[i], 0) + 1
            recv[dsts[i]] = recv.get(dsts[i], 0) + 1
            for rl in paths[i][1: lens[i] - 1]:
                relay[rl] = relay.get(rl, 0) + 1
        for node, c in send.items():
            if c > 1:
                raise ValueError(
                    f"node {node} sends {c} transfers in one round")
            if relay.get(node):
                raise ValueError(f"node {node} both sends and relays")
            if recv.get(node):
                raise ValueError(
                    f"node {node} both sends and receives in a round")
        for node, c in recv.items():
            if c > max_recv_per_round:
                raise ValueError(
                    f"node {node} receives {c} transfers in one round")
            if relay.get(node):
                raise ValueError(f"node {node} both receives and relays")
        for node, c in relay.items():
            if c > 1:
                raise ValueError(
                    f"relay node {node} used {c} times in one round")


def validate_plan_arrays(pa: PlanArrays, *, max_recv_per_round: int = 1) -> None:
    """Array fast path of `repro_torch.core.plan.validate_plan`.

    Enforces the same invariants (and raises `ValueError` for the same
    violations) as the object-based `FragmentState` walk. Role exclusivity
    is checked for *all rounds at once*: one `np.bincount` per role over
    `round * N + node` keys replaces per-round dict counters (small plans
    take a python scan instead — the bincount setup costs more than it
    saves there). Fragment movement stays a sequential walk, but over
    term *bitmasks* (python ints, no set allocation). When a plan holds
    several violations the first one reported may differ from the object
    path; the accept/reject verdict never does.
    """
    n = max(int(pa.num_nodes), 1)
    num_r = pa.num_rounds
    num_t = pa.num_transfers
    srcs = pa.t_src.tolist()
    dsts = pa.t_dst.tolist()
    if num_t and num_t < _SMALL_VALIDATE_TRANSFERS:
        _validate_roles_small(pa, max_recv_per_round, srcs, dsts)
    elif num_t:
        counts = np.diff(pa.round_start).astype(np.int64)
        round_id = np.repeat(np.arange(num_r, dtype=np.int64), counts)
        size = num_r * n
        send_c = np.bincount(round_id * n + pa.t_src, minlength=size)
        recv_c = np.bincount(round_id * n + pa.t_dst, minlength=size)
        cols = np.arange(pa.t_path.shape[1])
        relay_sel = ((cols[None, :] >= 1)
                     & (cols[None, :] < (pa.t_path_len - 1)[:, None]))
        relay_keys = (round_id[:, None] * n + pa.t_path)[relay_sel]
        relay_c = (np.bincount(relay_keys, minlength=size)
                   if relay_keys.size else np.zeros(size, dtype=np.int64))

        def _first(mask):
            k = int(np.nonzero(mask)[0][0])
            return k % n, k

        if (send_c > 1).any():
            node, k = _first(send_c > 1)
            raise ValueError(
                f"node {node} sends {int(send_c[k])} transfers in one round")
        if ((send_c > 0) & (relay_c > 0)).any():
            node, _ = _first((send_c > 0) & (relay_c > 0))
            raise ValueError(f"node {node} both sends and relays")
        if ((send_c > 0) & (recv_c > 0)).any():
            node, _ = _first((send_c > 0) & (recv_c > 0))
            raise ValueError(f"node {node} both sends and receives in a round")
        if (recv_c > max_recv_per_round).any():
            node, k = _first(recv_c > max_recv_per_round)
            raise ValueError(
                f"node {node} receives {int(recv_c[k])} transfers in one round")
        if ((recv_c > 0) & (relay_c > 0)).any():
            node, _ = _first((recv_c > 0) & (relay_c > 0))
            raise ValueError(f"node {node} both receives and relays")
        if (relay_c > 1).any():
            node, k = _first(relay_c > 1)
            raise ValueError(
                f"relay node {node} used {int(relay_c[k])} times in one round")

    # fragment movement, in transfer order (a source's holding must be
    # forwarded whole — XOR-folds cannot be split); python-int bit ops
    hold = [[0] * n for _ in range(pa.num_jobs)]
    helpers_flat = pa.job_helpers.tolist()
    hlens = pa.job_helpers_len.tolist()
    for j in range(pa.num_jobs):
        for h in helpers_flat[j][: hlens[j]]:
            hold[j][h] = 1 << h
    jidx = pa.t_job_idx.tolist()
    jraw = pa.t_job.tolist()
    terms = pa.t_terms.tolist()
    for i in range(num_t):
        j, s, d, sent = jidx[i], srcs[i], dsts[i], terms[i]
        row = hold[j]
        held = row[s]
        if held == 0 or held != sent:
            raise ValueError(
                f"transfer {s}->{d} (job {jraw[i]}) sends terms not matching "
                f"src holding (held={sorted(_mask_terms(held))}, "
                f"sent={sorted(_mask_terms(sent))})"
            )
        row[s] = 0
        if row[d] & sent:
            raise ValueError(
                f"duplicate terms arriving at node {d}: "
                f"{sorted(_mask_terms(row[d] & sent))}"
            )
        row[d] |= sent

    full = pa.job_terms.tolist()
    req = pa.job_requestor.tolist()
    for j in range(pa.num_jobs):
        if hold[j][req[j]] != full[j]:
            raise ValueError("plan does not complete all jobs")
