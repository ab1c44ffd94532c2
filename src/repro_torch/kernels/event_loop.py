"""The sweep's event loops: the CUDA kernels' wrappers and plain versions.

The device stepper (`repro_torch.core.engine.device_stepper`) simulates a
batch of repair cases event by event: every step finds each active
transfer's contended rate on the case's current bandwidth epoch, moves the
case's clock to its next hop completion or epoch flip, debits every
transfer and retires the completed ones. Two loops exist:

* `round_events`: the transfers of one round of a plan, each walking its
  hops, over R rounds in a row (R = 1 between BMF replans, else the whole
  plan);
* `pipeline_events`: PPT's pipeline, every tree edge streaming at once,
  an edge's rate capped by the slowest edge of the subtree feeding it (a
  min-scan over depth levels, deepest first).

The kernels in `csrc/event_loop.cu` replace the JAX package's jitted
programs in `src/repro/core/engine/jax_stepper.py` (`round_events` :170
and `rounds_scan` :217, `pipeline_events` :241; jitted `lax.while_loop` /
`lax.scan` programs, not Pallas kernels). A case runs from its first step
to its last inside one launch, so the batch makes one launch and one host
read where the plain version makes ~82 launches a step and a host read
every `sync_every` steps. They are bound by the serial chain of event
steps of the slowest case, not by bytes: the epochs a case reaches and its
hop tables are read in microseconds. Each has two routes, picked by shape
here (`pick_route`) and passed to the launch function, which refuses a warp
launch of a case that does not fit it:

* "warp" (`round_events_warp_kernel`, `pipeline_events_warp_kernel`): one
  warp a case, for at most `WARP_LANES` transfers (edges) on at most
  `WARP_LANES` nodes, the steps kept inside the warp by warp intrinsics;
* "block" (`round_events_kernel`, `pipeline_events_kernel`): one block a
  case, for larger cases, within the shared-memory limits below.

The private keyword `_route` forces one of them (for `chip_smoke.py` and
the tests, which hold and time the two on the same batch); each wrapper's
`routes` counts its launches by route.

The kernels and the plain versions return one packed float64 tensor
`(3, R, B)`: row `T_END` the
clock at each round's end, `STEPS` each case's event steps in the round,
`FLAGS` `OVERFLOW` (a live case outran its pre-sampled epochs) or
`STALLED` (a case reached `guard` steps); `check_flags` raises for them.
One copy brings it all to the host.

On a CUDA tensor (the context's epoch stack) a wrapper launches its kernel
or raises; on a CPU tensor, or with `use_kernel=False`, it runs the plain
version (`round_events_ref` / `pipeline_events_ref`). The plain versions
step the whole batch in lockstep, as the reference does, reading the
completion and overflow flags on the host every `sync_every` steps; a
finished case takes dt = 0 and stands still, so steps run past its end
change nothing. Each CUDA launch adds one to its wrapper's `launches`.

The hop, child and parent tables are host arrays (numpy or CPU tensors)
of node indices, checked against [0, N) here and copied to the device as
contiguous int32 without a synchronisation. (The numpy engine pads them
with node 0, although `vectorized.py` calls them "-1 padded".)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import host_to_device
from repro_torch.kernels import build

EPS = 1e-9
T_END, STEPS, FLAGS = 0, 1, 2     # rows of the packed output
OVERFLOW, STALLED = 1, 2          # bits of the FLAGS row (kOverflow, kStalled)
SMEM_LIMIT = 232_448              # shared memory a block can use on sm_90
_THREADS_MAX = 256                # kMaxThreads in csrc/event_loop.cu
WARP_LANES = 32                   # kWarpLanes: the warp route's largest case
ROUTES = {"warp": 1, "block": 2}  # kRouteWarp, kRouteBlock

_F64 = torch.float64
_I64 = torch.int64


class EpochHorizonError(RuntimeError):
    """A live case outran the pre-sampled bandwidth epoch horizon."""


class DeviceUnsupported(RuntimeError):
    """The batch cannot run on the device stepper (caller falls back)."""


@dataclasses.dataclass
class EventCtx:
    """A batch's per-case tensors on one device."""

    stack: torch.Tensor      # (B, E, N, N) float64 epoch matrices
    interval: torch.Tensor   # (B,) float64 epoch length, inf = static network
    num_ep: torch.Tensor     # (B,) int64 valid epochs in the stack
    cycle: torch.Tensor      # (B,) bool: a trace cycles (vs clamps) past its end
    can_ovf: torch.Tensor    # (B,) bool: live case, the horizon can overflow
    chunk: torch.Tensor      # (B,) float64
    degrade: torch.Tensor    # (B,) float64
    floor: torch.Tensor      # (B,) float64
    duplex: torch.Tensor     # (B,) float64
    shares: torch.Tensor     # (B, N, M + 1, M) float64 Dirichlet fan-in splits


# ------------------------------------------------------------- shape limits
def round_smem_bytes(transfers: int, num_nodes: int) -> int:
    """Shared memory of one `round_events_kernel` block (`round_smem`)."""
    warps = _THREADS_MAX // 32
    return 8 * (3 * transfers + num_nodes + warps) + 4 * (2 * transfers
                                                          + num_nodes)


def pipeline_smem_bytes(edges: int, num_nodes: int) -> int:
    """Shared memory of one `pipeline_events_kernel` block."""
    warps = _THREADS_MAX // 32
    return 8 * (4 * edges + 2 * num_nodes + warps) + 4 * (4 * edges
                                                          + 2 * num_nodes)


def check_round_shape(transfers: int, num_nodes: int) -> None:
    """Raise `DeviceUnsupported` unless one case's round fits a block."""
    need = round_smem_bytes(transfers, num_nodes)
    if need > SMEM_LIMIT:
        raise DeviceUnsupported(
            f"{transfers} transfers on {num_nodes} nodes need {need} bytes of "
            f"shared memory a block, above the kernel's {SMEM_LIMIT}")


def check_pipeline_shape(edges: int, num_nodes: int) -> None:
    """Raise `DeviceUnsupported` unless one case's tree fits a block."""
    need = pipeline_smem_bytes(edges, num_nodes)
    if need > SMEM_LIMIT:
        raise DeviceUnsupported(
            f"{edges} tree edges on {num_nodes} nodes need {need} bytes of "
            f"shared memory a block, above the kernel's {SMEM_LIMIT}")


def warp_route_fits(lanes: int, num_nodes: int) -> bool:
    """Whether a case of `lanes` transfers (edges) on `num_nodes` nodes
    runs on the warp route (the launch functions' `warp_fits`)."""
    return lanes <= WARP_LANES and num_nodes <= WARP_LANES


def pick_route(lanes: int, num_nodes: int, forced: str | None) -> str:
    """The route a launch takes: by shape, or `forced`."""
    if forced is None:
        return "warp" if warp_route_fits(lanes, num_nodes) else "block"
    if forced not in ROUTES:
        raise ValueError(f"route must be one of {sorted(ROUTES)}, got "
                         f"{forced!r}")
    if forced == "warp" and not warp_route_fits(lanes, num_nodes):
        raise DeviceUnsupported(
            f"{lanes} transfers or edges on {num_nodes} nodes do not fit "
            f"the warp route's {WARP_LANES} lanes")
    return forced


def check_flags(flags: np.ndarray) -> None:
    """Raise for the first flagged round of a packed output's FLAGS row
    (R, B): `EpochHorizonError` if a case overflowed its epochs there
    (the caller grows the horizon and re-runs), else `RuntimeError` for a
    case that reached the step guard."""
    flags = np.asarray(flags).astype(np.int64).reshape(-1, np.shape(flags)[-1])
    bad = np.nonzero(flags.any(axis=1))[0]
    if not bad.size:
        return
    if (flags[bad[0]] & OVERFLOW).any():
        raise EpochHorizonError("simulation outran the sampled epoch horizon")
    raise RuntimeError("simulator failed to converge")


# ------------------------------------------------------------------ inputs
def node_table(table, num_nodes: int, name: str) -> np.ndarray:
    """A host table of node indices, checked against [0, num_nodes), as
    contiguous int32."""
    if isinstance(table, torch.Tensor):
        if table.device.type != "cpu":
            raise ValueError(f"{name} must be a host table, got a tensor on "
                             f"{table.device}")
        table = table.numpy()
    table = np.asarray(table)
    if table.dtype.kind not in "iu":
        raise TypeError(f"{name} must hold integers, got {table.dtype}")
    if table.size and (table.min() < 0 or table.max() >= num_nodes):
        raise IndexError(f"{name} holds node indices outside "
                         f"[0, {num_nodes})")
    return np.ascontiguousarray(table, dtype=np.int32)


def _int_table(table, shape: tuple, name: str) -> np.ndarray:
    if isinstance(table, torch.Tensor):
        table = table.cpu().numpy()
    table = np.asarray(table)
    if table.shape != shape or table.dtype.kind not in "iub":
        raise ValueError(f"{name} must be an integer {shape} table, got "
                         f"{table.shape} {table.dtype}")
    return np.ascontiguousarray(table, dtype=np.int32)


def _clock(t0, batch: int, device: torch.device) -> torch.Tensor:
    """The (B,) float64 start clocks on `device`."""
    if isinstance(t0, torch.Tensor):
        if t0.dtype != _F64 or t0.shape != (batch,) or t0.device != device:
            raise ValueError(f"t0 must be a ({batch},) float64 tensor on "
                             f"{device}, got {tuple(t0.shape)} {t0.dtype} on "
                             f"{t0.device}")
        return t0.contiguous()
    t0 = np.asarray(t0, dtype=np.float64)
    if t0.shape != (batch,):
        raise ValueError(f"t0 must have shape ({batch},), got {t0.shape}")
    return host_to_device(t0, device)


_CTX_TYPES = dict(stack=_F64, interval=_F64, num_ep=_I64, cycle=torch.bool,
                  can_ovf=torch.bool, chunk=_F64, degrade=_F64, floor=_F64,
                  duplex=_F64, shares=_F64)


def _check_ctx(ctx: EventCtx, batch: int) -> None:
    """What the kernels read: each field on the stack's device, of its
    dtype, contiguous, one row a case."""
    device = ctx.stack.device
    for name, dtype in _CTX_TYPES.items():
        x = getattr(ctx, name)
        if (x.device != device or x.dtype != dtype or not x.is_contiguous()
                or x.shape[0] != batch):
            raise ValueError(f"ctx.{name} must be a contiguous {dtype} tensor "
                             f"on {device} with {batch} rows, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if ctx.stack.dim() != 4 or ctx.stack.shape[2] != ctx.stack.shape[3]:
        raise ValueError(f"ctx.stack must be (B, E, N, N), got "
                         f"{tuple(ctx.stack.shape)}")
    if ctx.shares.dim() != 4 or ctx.shares.shape[1] != ctx.stack.shape[2]:
        raise ValueError(f"ctx.shares must be (B, N, M + 1, M), got "
                         f"{tuple(ctx.shares.shape)}")


def _ctx_args(ctx: EventCtx) -> list:
    return [ctx.stack.data_ptr(), ctx.interval.data_ptr(),
            ctx.num_ep.data_ptr(), ctx.cycle.data_ptr(),
            ctx.can_ovf.data_ptr(), ctx.chunk.data_ptr(),
            ctx.degrade.data_ptr(), ctx.floor.data_ptr()]


def _shape_args(ctx: EventCtx, batch: int) -> list:
    _, epochs, num_nodes, _ = ctx.stack.shape
    _, _, m1, m = ctx.shares.shape
    return [batch, epochs, num_nodes, m1, m]


def _launch_route(lanes: int, num_nodes: int, forced: str | None,
                  check_block) -> str:
    route = pick_route(lanes, num_nodes, forced)
    if route == "block":
        check_block(lanes, num_nodes)
    return route


def _plain_route(ctx: EventCtx, use_kernel: bool) -> bool:
    device = ctx.stack.device
    if device.type == "cpu" or (device.type == "cuda" and not use_kernel):
        return True
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return False


# ---------------------------------------------------------------- wrappers
def round_events(ctx: EventCtx, hop_u, hop_v, n_hops, t0, *, guard: int,
                 sync_every: int = 8, counts=None, use_kernel: bool = True,
                 _route: str | None = None) -> torch.Tensor:
    """R rounds of a batch's transfers, event by event -> (3, R, B).

    `hop_u` / `hop_v` (B, R, T, H) host tables of each transfer's hops
    (u -> v), `n_hops` (B, R, T) its hop count (0 marks padding), `t0`
    (B,) the clocks at the first round's start (a float64 tensor on the
    context's device, or a host array). A round in which a case has no
    transfer passes its clock through. Each case stops at its first
    flagged round. `counts` (the plain version only): an object whose
    integer `steps` and `host_syncs` it adds its steps and host reads to.
    """
    num_nodes = ctx.stack.shape[2]
    hop_u = node_table(hop_u, num_nodes, "hop_u")
    hop_v = node_table(hop_v, num_nodes, "hop_v")
    if hop_u.ndim != 4 or hop_v.shape != hop_u.shape or hop_u.shape[3] < 1:
        raise ValueError(f"hop tables must be (B, R, T, H>=1), got "
                         f"{hop_u.shape} and {hop_v.shape}")
    B, R, T, H = hop_u.shape
    n_hops = _int_table(n_hops, (B, R, T), "n_hops")
    if _plain_route(ctx, use_kernel):
        return round_events_ref(ctx, hop_u, hop_v, n_hops, t0, guard=guard,
                                sync_every=sync_every, counts=counts)
    _check_ctx(ctx, B)
    route = _launch_route(T, num_nodes, _route, check_round_shape)
    device = ctx.stack.device
    out = torch.empty((3, R, B), dtype=_F64, device=device)
    if B == 0:
        return out
    lib = build.load_library().lib
    with torch.cuda.device(device):
        hu, hv, nh = (host_to_device(a, device) for a in (hop_u, hop_v, n_hops))
        t0 = _clock(t0, B, device)
        stream = torch.cuda.current_stream().cuda_stream
        build.check_launch(lib.round_events_launch(
            *_ctx_args(ctx), ctx.shares.data_ptr(), *_shape_args(ctx, B),
            hu.data_ptr(), hv.data_ptr(), nh.data_ptr(), R, T, H,
            t0.data_ptr(), int(guard), out.data_ptr(), ROUTES[route],
            stream), "round_events")
    round_events.launches += 1
    round_events.routes[route] += 1
    return out


round_events.launches = 0
round_events.routes = dict.fromkeys(ROUTES, 0)


def pipeline_events(ctx: EventCtx, child, parent, depth, edge_valid, t0, *,
                    guard: int, sync_every: int = 8, counts=None,
                    use_kernel: bool = True,
                    _route: str | None = None) -> torch.Tensor:
    """PPT's pipeline over each case's tree, event by event -> (3, 1, B).

    `child` / `parent` (B, E) host tables of each edge's end nodes,
    `depth` (B, E) the child's depth (levels 1 and deeper are scanned),
    `edge_valid` (B, E) the edges that exist (each moves one chunk), `t0`
    (B,) the clocks at the start. `counts` as for `round_events`.
    """
    num_nodes = ctx.stack.shape[2]
    child = node_table(child, num_nodes, "child")
    parent = node_table(parent, num_nodes, "parent")
    if child.ndim != 2 or parent.shape != child.shape:
        raise ValueError(f"child and parent must be (B, E), got "
                         f"{child.shape} and {parent.shape}")
    B, E = child.shape
    depth = _int_table(depth, (B, E), "depth")
    valid = _int_table(edge_valid, (B, E), "edge_valid").astype(bool)
    if _plain_route(ctx, use_kernel):
        return pipeline_events_ref(ctx, child, parent, depth, valid, t0,
                                   guard=guard, sync_every=sync_every,
                                   counts=counts)
    _check_ctx(ctx, B)
    route = _launch_route(E, num_nodes, _route, check_pipeline_shape)
    device = ctx.stack.device
    out = torch.empty((3, 1, B), dtype=_F64, device=device)
    if B == 0:
        return out
    lib = build.load_library().lib
    with torch.cuda.device(device):
        c, p, d, v = (host_to_device(a, device)
                      for a in (child, parent, depth, valid))
        t0 = _clock(t0, B, device)
        stream = torch.cuda.current_stream().cuda_stream
        build.check_launch(lib.pipeline_events_launch(
            *_ctx_args(ctx), ctx.duplex.data_ptr(), ctx.shares.data_ptr(),
            *_shape_args(ctx, B), c.data_ptr(), p.data_ptr(), d.data_ptr(),
            v.data_ptr(), E, t0.data_ptr(), int(guard), out.data_ptr(),
            ROUTES[route], stream), "pipeline_events")
    pipeline_events.launches += 1
    pipeline_events.routes[route] += 1
    return out


pipeline_events.launches = 0
pipeline_events.routes = dict.fromkeys(ROUTES, 0)


# ------------------------------------------------------- the plain versions
def _epoch_state(t, ctx: EventCtx):
    """(epoch index into the stack, epoch_end, epoch) for every case at its
    own time `t`: the twin of `_BatchBandwidth.refresh` (recompute instead
    of refresh-on-crossing; epoch matrices are constant per epoch, so the
    values are identical)."""
    e_f = torch.floor(t / ctx.interval)   # floor of true division ==
    e = e_f.to(_I64)                      # BandwidthTrace.epoch_of
    idx = torch.where(ctx.cycle, torch.remainder(e, ctx.num_ep),
                      torch.minimum(e, ctx.num_ep - 1))
    idx = idx.clamp(0, ctx.stack.shape[1] - 1)
    return idx, (e_f + 1.0) * ctx.interval, e


def _fanin_rates(idx, u, v, act, ctx: EventCtx, nodes: torch.Tensor):
    """Contended rates for active (u -> v) pairs: the dense twin of
    `_group_structure` + `_contended_rates_grouped`. Group membership is a
    `(B, T, N)` one-hot match, the in-group position an int64 cumsum (the
    transfer-index order of the numpy stable sort), the group cap a masked
    `amax`; the m == 1 group falls out of the same expression (weight 1,
    factor >= 1)."""
    B = u.shape[0]
    bi = torch.arange(B, device=u.device)[:, None]
    s = ctx.stack[bi, idx[:, None], u, v]                          # (B, T)
    match = act[:, :, None] & (v[:, :, None] == nodes)             # (B, T, N)
    m_recv = match.sum(dim=1, dtype=_I64)                          # (B, N)
    m_t = torch.gather(m_recv, 1, v)                               # (B, T)
    pos = torch.gather(torch.cumsum(match, dim=1, dtype=_I64), 2,
                       v[:, :, None])[:, :, 0] - 1
    smax = torch.amax(torch.where(match, s[:, :, None], -torch.inf), dim=1)
    factor = torch.maximum(ctx.floor[:, None],
                           1.0 - ctx.degrade[:, None] * (m_recv - 1))
    cap = torch.gather(smax * factor, 1, v)
    w = ctx.shares[bi, v, m_t.clamp(max=ctx.shares.shape[2] - 1),
                   pos.clamp(0, ctx.shares.shape[3] - 1)]
    return torch.minimum(s, w * cap), s


def _round_step(st: dict, hop_u, hop_v, n_hops, ctx: EventCtx,
                nodes) -> None:
    """One event step of every case of a round (`execute_round_batch`'s
    loop body: refresh, rates, dt, debit, completion)."""
    H = hop_u.shape[2]
    t, hop_i, left = st["t"], st["hop_i"], st["left"]
    done = (hop_i >= n_hops).all(dim=1)
    idx, epoch_end, e = _epoch_state(t, ctx)
    st["ovf"] = st["ovf"] | (ctx.can_ovf & ~done & (e >= ctx.num_ep))
    st["steps"] = st["steps"] + ~done
    act = hop_i < n_hops
    h = hop_i.clamp(max=H - 1)[:, :, None]
    u = torch.gather(hop_u, 2, h)[:, :, 0]
    v = torch.gather(hop_v, 2, h)[:, :, 0]
    eff, _ = _fanin_rates(idx, u, v, act, ctx, nodes)
    rates = torch.where(act, eff.clamp(min=0.0), 0.0)
    pos = rates > 0
    cand = torch.where(act & pos, left / torch.where(pos, rates, 1.0),
                       torch.inf)
    dt = torch.minimum(epoch_end - t, cand.amin(dim=1))
    dt = torch.where(torch.isfinite(dt) & (dt > 0), dt, EPS)
    dt = torch.where(done, 0.0, dt)
    left = left - rates * dt[:, None]
    compl = act & (left <= EPS * ctx.chunk[:, None])
    st["t"] = t + dt
    st["hop_i"] = hop_i + compl
    st["left"] = torch.where(compl, ctx.chunk[:, None], left)


def _pipeline_step(st: dict, child, parent, depth, dmax: int, ctx: EventCtx,
                   nodes) -> None:
    """One event step of PPT's pipeline (`execute_pipeline_batch`'s loop
    body); the min-scan walks the depth levels deepest first."""
    t, left = st["t"], st["left"]
    chunk_col = ctx.chunk[:, None]
    live = left > EPS * chunk_col
    case_on = live.any(dim=1)
    idx, epoch_end, e = _epoch_state(t, ctx)
    st["ovf"] = st["ovf"] | (ctx.can_ovf & case_on & (e >= ctx.num_ep))
    st["steps"] = st["steps"] + case_on
    rx_eff, s = _fanin_rates(idx, child, parent, live, ctx, nodes)
    has_rx = (live[:, :, None] & (parent[:, :, None] == nodes)).any(dim=1)
    has_tx = (live[:, :, None] & (child[:, :, None] == nodes)).any(dim=1)
    duplex = ctx.duplex[:, None]
    rx_dup = torch.where(torch.gather(has_tx, 1, parent), duplex, 1.0)
    tx_dup = torch.where(torch.gather(has_rx, 1, child), duplex, 1.0)
    raw = torch.minimum((rx_eff * rx_dup).clamp(min=0.0),
                        (s * tx_dup).clamp(min=0.0))
    raw_full = torch.where(live, raw, 0.0)

    # iterative topological min-scan, deepest edges first
    node_supply = torch.full((left.shape[0], nodes.shape[0]), torch.inf,
                             dtype=_F64, device=left.device)
    eff = raw_full
    for d in range(dmax, 0, -1):
        sel = live & (depth == d)
        val = torch.minimum(raw_full, torch.gather(node_supply, 1, child))
        eff = torch.where(sel, val, eff)
        node_supply = node_supply.scatter_reduce(
            1, parent, torch.where(sel, val, torch.inf), reduce="amin",
            include_self=True)
    rates = torch.where(live, eff, 0.0)

    pos = rates > 0
    cand = torch.where(live & pos, left / torch.where(pos, rates, 1.0),
                       torch.inf)
    dt = torch.minimum(epoch_end - t, cand.amin(dim=1))
    dt = torch.where(torch.isfinite(dt) & (dt > 0), dt, EPS)
    dt = torch.where(case_on, dt, 0.0)
    st["left"] = torch.where(live, left - rates * dt[:, None], left)
    st["t"] = t + dt


def _run_loop(step, st: dict, finished, guard: int, sync_every: int,
              counts) -> str:
    """Run `step(st)` until `finished(st)` holds on the device, reading the
    completion and overflow flags on the host every `sync_every` steps and
    never running more than `guard` steps. Returns why it stopped:
    "done", "overflow" or "stalled"."""
    it = 0
    while True:
        n = min(sync_every, guard - it)
        for _ in range(n):
            step(st)
        it += n
        if counts is not None:
            counts.steps += n
            counts.host_syncs += 1
        fin, ovf = torch.stack((finished(st), st["ovf"].any())).tolist()
        if ovf:
            return "overflow"
        if fin:
            return "done"
        if it >= guard:
            return "stalled"


def _flags(reason: str, ovf, unfinished) -> torch.Tensor:
    if reason == "overflow":
        return ovf.to(_F64) * OVERFLOW
    if reason == "stalled":
        return unfinished.to(_F64) * STALLED
    return torch.zeros_like(ovf, dtype=_F64)


def round_events_ref(ctx: EventCtx, hop_u, hop_v, n_hops, t0, *, guard: int,
                     sync_every: int = 8, counts=None) -> torch.Tensor:
    """The plain version of `round_events` (checked host tables): the
    lockstep loop of torch ops, round by round; it stops at the first
    round that overflows or stalls and passes the clocks through the
    rounds after it."""
    device = ctx.stack.device
    B, R, T, H = hop_u.shape
    hu, hv, nh = (host_to_device(np.asarray(a, dtype=np.int64), device)
                  for a in (hop_u, hop_v, n_hops))
    nodes = torch.arange(ctx.stack.shape[2], device=device)
    t = _clock(t0, B, device)
    out = torch.zeros((3, R, B), dtype=_F64, device=device)
    stopped = False
    for r in range(R):
        # a round in which no case has a transfer passes every clock through
        if not stopped and (np.asarray(n_hops)[:, r] > 0).any():
            nh_r = nh[:, r]
            st = dict(t=t, hop_i=torch.zeros((B, T), dtype=_I64,
                                             device=device),
                      left=ctx.chunk[:, None].expand(B, T).clone(),
                      ovf=torch.zeros(B, dtype=torch.bool, device=device),
                      steps=torch.zeros(B, dtype=_I64, device=device))
            reason = _run_loop(
                lambda s: _round_step(s, hu[:, r], hv[:, r], nh_r, ctx,
                                      nodes),
                st, lambda s: (s["hop_i"] >= nh_r).all(), guard, sync_every,
                counts)
            t = st["t"]
            out[STEPS, r] = st["steps"].to(_F64)
            out[FLAGS, r] = _flags(reason, st["ovf"],
                                   ~(st["hop_i"] >= nh_r).all(dim=1))
            stopped = reason != "done"
        out[T_END, r] = t
    return out


def pipeline_events_ref(ctx: EventCtx, child, parent, depth, edge_valid, t0,
                        *, guard: int, sync_every: int = 8,
                        counts=None) -> torch.Tensor:
    """The plain version of `pipeline_events` (checked host tables)."""
    device = ctx.stack.device
    B = child.shape[0]
    c, p, d = (host_to_device(np.asarray(a, dtype=np.int64), device)
               for a in (child, parent, depth))
    valid = host_to_device(np.asarray(edge_valid, dtype=bool), device)
    nodes = torch.arange(ctx.stack.shape[2], device=device)
    dmax = int(np.max(depth)) if np.size(depth) else 0
    chunk_col = ctx.chunk[:, None]
    st = dict(t=_clock(t0, B, device),
              left=torch.where(valid, chunk_col, 0.0),
              ovf=torch.zeros(B, dtype=torch.bool, device=device),
              steps=torch.zeros(B, dtype=_I64, device=device))
    reason = _run_loop(
        lambda s: _pipeline_step(s, c, p, d, dmax, ctx, nodes), st,
        lambda s: ~(s["left"] > EPS * chunk_col).any(), guard, sync_every,
        counts)
    out = torch.zeros((3, 1, B), dtype=_F64, device=device)
    out[T_END, 0] = st["t"]
    out[STEPS, 0] = st["steps"].to(_F64)
    out[FLAGS, 0] = _flags(reason, st["ovf"],
                           (st["left"] > EPS * chunk_col).any(dim=1))
    return out
