"""Device stepper: the batched event loops as torch float64 programs.

This is the counterpart of the JAX package's `core/engine/jax_stepper.py`.
`repro_torch.core.engine.vectorized` keeps the host-side orchestration
(planning, the per-round BMF monitor-and-replan step, result bookkeeping);
this module replaces only its *event loops* with tensor programs on a
torch device (the card; `device="cpu"` runs the same ops on the CPU).
There is no Pallas kernel on this path in the reference, and none here:
the loops are plain torch ops over small `(B, ...)` tensors.

Names, reference -> port:

* `JaxRoundEngine.execute_round` -> `DeviceRoundEngine.execute_round`:
  the masked round stepper (`vectorized.execute_round_batch`'s twin) as a
  host loop of tensor steps, per-case dt / epoch / completion masks, the
  fan-in segment reductions as dense `(B, T, N)` one-hot matches (int64
  cumsum positions, `torch.amax` group caps);
* `JaxRoundEngine.execute_rounds` -> `DeviceRoundEngine.execute_rounds`:
  the `lax.scan` over the round axis becomes a loop over rounds (used
  when no round is replanned); a round in which a case has no transfer
  passes its time through unchanged;
* `JaxPipelineEngine.execute` -> `DevicePipelineEngine.execute`: PPT's
  pipeline stepper, the topological min-scan over depth levels with
  `scatter_reduce_(..., "amin")` in place of `.at[].min`;
* `JaxUnsupported` -> `DeviceUnsupported`, `jax_available` ->
  `device_available`; `EpochHorizonError`, `make_round_engine`,
  `make_pipeline_engine`, `_round_fanin`, `_pipeline_fanin` keep their
  names.

**The loop condition.** `lax.while_loop` tests its condition on the
device; here the host must read it, which is a synchronisation. The host
reads the completion and horizon-overflow flags once every
`_SYNC_EVERY` steps: a finished case takes `dt = 0` and its state stands
still, so the steps run past its end change nothing, and the loop never
runs more than `_GUARD` steps. An overflow raises at the first read that
sees it (the caller re-runs the whole batch, so stopping early changes no
result). `COUNTS.host_syncs` counts the reads.

**Bandwidth epoch stacks.** As in the reference, epochs are pre-sampled
on the host into a `(B, E, N, N)` float64 stack and moved to the device
once (`device.host_to_device`): recorded `BandwidthTrace` epochs as they
are, live processes through `epochs_prefix` (bit-identical to
`matrix_at`), static networks as one eternal epoch. A live case that
outruns the horizon raises `EpochHorizonError`; `grow()` doubles the
horizon and the caller restores the BMF splices and re-runs.

**Fan-in shares** are a `(B, N, M + 1, M)` table of the persistent
Dirichlet splits (`IngressModel.share_weights`, host numpy draws).
Non-persistent shares cannot be pretabulated: the factory declines the
batch and it runs on the numpy steppers.

**Padding.** The reference pads every axis to a power of two so that jit
reuses programs; nothing is compiled here, so no axis is padded. The
memory check keeps the reference's reckoning (`_stack_bytes`), so the
same batches take the device as in the reference.

**Routing is counted and warned of.** `COUNTS` records the batches that
ran on the device, those handed back to the numpy steppers, the horizon
doublings and the host syncs, as the kernels keep launch counts, and the
host wall time spent in the event loops and in building the epoch
stacks. Each batch handed back to the host also raises a
`RuntimeWarning` naming its size and the reason: the caller asked for
the device, and that batch's time is host time.

Every float tensor is `torch.float64`, so the device performs the numpy
engine's float64 ops; `tests/test_torch_device_stepper.py` holds all 8
schemes x 3 volatility regimes to the reference engines at 1e-6
relative tolerance with identical round counts.
"""
from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from repro_torch.device import host_to_device, resolve_device

_EPS = 1e-9
_GUARD = 100_000
# The reference's routing constants (`jax_stepper.py:78-80`): they decide
# which batches take the device, so they stay equal to the reference's.
# They were sized for the reference's accelerator, not measured on an
# H100; raising them is later work.
_MEM_LIMIT_BYTES = 256 * 1024 * 1024
_INITIAL_LIVE_EPOCHS = 64
_MAX_LIVE_EPOCHS = 8192
# event steps between two host reads of the loop's completion flags. On
# an H100 (`scripts/bench_sweep_sync.py`, the sweep suites of
# `chip_smoke.py`) a read every step and every 8 steps agree within the
# host's noise; every 64 steps is slower, as loops run past their ends.
_SYNC_EVERY = 8

_F64 = torch.float64
_I64 = torch.int64


class EpochHorizonError(RuntimeError):
    """A live case outran the pre-sampled bandwidth epoch horizon."""


class DeviceUnsupported(RuntimeError):
    """The batch cannot run on the device stepper (caller falls back)."""


@dataclasses.dataclass
class StepperCounts:
    """Routing and synchronisation counts of the device stepper."""

    device_batches: int = 0     # batches whose event loops ran on the device
    host_batches: int = 0       # batches handed back to the numpy steppers
    horizon_grows: int = 0      # epoch-horizon doublings (a batch re-run)
    host_syncs: int = 0         # host reads of device values in the loops
    steps: int = 0              # event steps launched
    loop_s: float = 0.0         # host wall time inside the event loops
    stack_s: float = 0.0        # host wall time building the epoch stacks

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


COUNTS = StepperCounts()


def record_batch(*, on_device: bool) -> None:
    """Count one execution batch on the route it took."""
    if on_device:
        COUNTS.device_batches += 1
    else:
        COUNTS.host_batches += 1


def _host_route(batch: int, num_nodes: int, reason: str) -> None:
    """Warn that a batch sent to the device runs on the numpy steppers."""
    warnings.warn(
        f"device stepper: a batch of {batch} case(s) on {num_nodes} nodes "
        f"runs on the numpy host steppers ({reason}); its time is host time",
        RuntimeWarning, stacklevel=3)


def device_available() -> bool:
    """True when a CUDA card is visible (the device stepper's target)."""
    return torch.cuda.is_available()


def _pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1): the reference's bucketing unit,
    kept for its memory reckoning."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _stack_bytes(batch: int, epochs: int, num_nodes: int) -> int:
    """The reference's size of a padded `(Bp, Ep, N, N)` float64 stack."""
    return _pow2(batch) * _pow2(epochs) * num_nodes * num_nodes * 8


@dataclasses.dataclass
class _Ctx:
    """Per-batch device tensors."""

    stack: torch.Tensor      # (B, E, N, N) epoch matrices
    interval: torch.Tensor   # (B,) epoch length, inf = static network
    num_ep: torch.Tensor     # (B,) valid epochs in the stack
    cycle: torch.Tensor      # (B,) trace cycles (vs clamps) past the end
    can_ovf: torch.Tensor    # (B,) live case: sampled horizon can overflow
    chunk: torch.Tensor      # (B,)
    degrade: torch.Tensor    # (B,)
    floor: torch.Tensor      # (B,)
    duplex: torch.Tensor     # (B,)
    shares: torch.Tensor     # (B, N, M + 1, M) Dirichlet fan-in splits


# ------------------------------------------------------------- step programs
def _epoch_state(t, ctx: _Ctx):
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


def _fanin_rates(idx, u, v, act, ctx: _Ctx, nodes: torch.Tensor):
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


def _round_step(st: dict, hop_u, hop_v, n_hops, ctx: _Ctx, nodes) -> None:
    """One event step of every case of a round (`execute_round_batch`'s
    loop body: refresh, rates, dt, debit, completion)."""
    H = hop_u.shape[2]
    t, hop_i, left = st["t"], st["hop_i"], st["left"]
    done = (hop_i >= n_hops).all(dim=1)
    idx, epoch_end, e = _epoch_state(t, ctx)
    st["ovf"] = st["ovf"] | (ctx.can_ovf & ~done & (e >= ctx.num_ep)).any()
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
    dt = torch.where(torch.isfinite(dt) & (dt > 0), dt, _EPS)
    dt = torch.where(done, 0.0, dt)
    left = left - rates * dt[:, None]
    compl = act & (left <= _EPS * ctx.chunk[:, None])
    st["t"] = t + dt
    st["hop_i"] = hop_i + compl
    st["left"] = torch.where(compl, ctx.chunk[:, None], left)


def _pipeline_step(st: dict, child, parent, depth, dmax: int, ctx: _Ctx,
                   nodes) -> None:
    """One event step of PPT's pipeline (`execute_pipeline_batch`'s loop
    body); the min-scan walks the depth levels deepest first."""
    t, left = st["t"], st["left"]
    chunk_col = ctx.chunk[:, None]
    live = left > _EPS * chunk_col
    case_on = live.any(dim=1)
    idx, epoch_end, e = _epoch_state(t, ctx)
    st["ovf"] = st["ovf"] | (ctx.can_ovf & case_on & (e >= ctx.num_ep)).any()
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
    dt = torch.where(torch.isfinite(dt) & (dt > 0), dt, _EPS)
    dt = torch.where(case_on, dt, 0.0)
    st["left"] = torch.where(live, left - rates * dt[:, None], left)
    st["t"] = t + dt


def _run_loop(step, st: dict, finished) -> None:
    """Run `step(st)` until `finished(st)` holds on the device, reading the
    completion and overflow flags on the host every `_SYNC_EVERY` steps
    and never running more than `_GUARD` steps."""
    tic = time.perf_counter()
    it = 0
    while True:
        n = min(_SYNC_EVERY, _GUARD - it)
        for _ in range(n):
            step(st)
        it += n
        COUNTS.steps += n
        COUNTS.host_syncs += 1
        fin, ovf = torch.stack((finished(st), st["ovf"])).tolist()
        COUNTS.loop_s += time.perf_counter() - tic
        tic = time.perf_counter()
        if ovf:
            raise EpochHorizonError("simulation outran the sampled epoch "
                                    "horizon")
        if fin:
            return
        if it >= _GUARD:
            raise RuntimeError("simulator failed to converge")


# --------------------------------------------------------------- host engines
class _EngineBase:
    """Shared device context: epoch stacks, ingress params, shares table."""

    def __init__(self, scenarios, num_nodes: int, need: np.ndarray,
                 mmax: int, device):
        if any(not sc.ingress.persistent_shares for sc in scenarios):
            # epoch-keyed share redraws cannot be pretabulated
            raise DeviceUnsupported("non-persistent ingress shares")
        self.device = torch.device(device)
        self.scenarios = list(scenarios)
        self.B = len(self.scenarios)
        self.N = int(num_nodes)
        self.live_epochs = _INITIAL_LIVE_EPOCHS
        self._nodes = torch.arange(self.N, device=self.device)
        self._shares = self._shares_table(need, int(mmax))
        ing = [sc.ingress for sc in self.scenarios]
        self._params = np.array(
            [[float(sc.chunk_mb) for sc in self.scenarios],
             [i.degrade for i in ing], [i.floor for i in ing],
             [i.duplex for i in ing]], dtype=float)
        self._rebuild_ctx()

    def _shares_table(self, need: np.ndarray, mmax: int) -> np.ndarray:
        """(B, N, mmax + 1, mmax) Dirichlet weight table; slot
        [b, v, m, i] is sender i's share of an m-way fan-in at receiver
        v. m <= 1 slots are 1.0 (the degenerate group)."""
        m1 = max(mmax + 1, 2)
        W = np.zeros((self.B, self.N, m1, max(mmax, 1)))
        W[:, :, :, 0] = 1.0
        cache: dict = {}
        for b, sc in enumerate(self.scenarios):
            ing = sc.ingress
            for v in np.nonzero(need[b])[0]:
                for m in range(2, m1):
                    key = (ing.seed, ing.alpha, int(v), m)
                    ww = cache.get(key)
                    if ww is None:
                        ww = ing.share_weights(m, int(v), 0)
                        cache[key] = ww
                    W[b, int(v), m, :m] = ww
        return W

    def _rebuild_ctx(self) -> None:
        """(Re)build the device epoch stack at the current live horizon."""
        from repro_torch.core.bandwidth import BandwidthTrace

        tic = time.perf_counter()
        interval = np.full(self.B, np.inf)
        num_ep = np.ones(self.B, dtype=np.int64)
        cycle = np.zeros(self.B, dtype=bool)
        can = np.zeros(self.B, dtype=bool)
        per: list[np.ndarray] = []
        for b, sc in enumerate(self.scenarios):
            bwp = sc.bw
            if type(bwp) is BandwidthTrace:
                ep = np.asarray(bwp.epochs)
                interval[b] = bwp.change_interval
                cycle[b] = bwp.cycle
                num_ep[b] = ep.shape[0]
            elif bwp.change_interval is None or (
                    bwp.mode == "jitter" and bwp.jitter == 0.0):
                ep = np.asarray(bwp.base)[None]
            else:
                # bit-identical to matrix_at for epochs [0, live_epochs);
                # memoized on the process instance, so every scheme/batch
                # replaying this case shares one sampling pass
                ep = bwp.epochs_prefix(self.live_epochs)
                interval[b] = bwp.change_interval
                num_ep[b] = self.live_epochs
                can[b] = True
            per.append(ep)
        self._can_grow = bool(can.any())
        emax = max((e.shape[0] for e in per), default=1)
        if _stack_bytes(self.B, emax, self.N) > _MEM_LIMIT_BYTES:
            raise DeviceUnsupported("epoch stack exceeds the device budget")
        stack = np.zeros((self.B, emax, self.N, self.N))
        for b, ep in enumerate(per):
            n = ep.shape[1]
            stack[b, : ep.shape[0], :n, :n] = ep
        dev = self.device
        chunk, degrade, floor, duplex = (host_to_device(p, dev)
                                         for p in self._params)
        self.ctx = _Ctx(
            stack=host_to_device(stack, dev),
            interval=host_to_device(interval, dev),
            num_ep=host_to_device(num_ep, dev),
            cycle=host_to_device(cycle, dev),
            can_ovf=host_to_device(can, dev),
            chunk=chunk, degrade=degrade, floor=floor, duplex=duplex,
            shares=host_to_device(self._shares, dev))
        COUNTS.stack_s += time.perf_counter() - tic

    def grow(self):
        """Double the live-epoch horizon after an `EpochHorizonError`.
        Returns self, or None when the horizon/memory cap is hit (the
        caller then falls back to the numpy engine)."""
        if not self._can_grow or self.live_epochs * 2 > _MAX_LIVE_EPOCHS:
            _host_route(self.B, self.N, f"epoch horizon capped at "
                        f"{self.live_epochs} epochs")
            return None
        self.live_epochs *= 2
        try:
            self._rebuild_ctx()
        except DeviceUnsupported as e:
            _host_route(self.B, self.N, f"{e} at {self.live_epochs} epochs")
            return None
        COUNTS.horizon_grows += 1
        return self

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        COUNTS.host_syncs += 1
        return t.cpu().numpy()


class DeviceRoundEngine(_EngineBase):
    """Round-scheme executor: drop-in for `execute_round_batch` (per
    round, between host replan steps) plus a whole-plan loop over rounds."""

    def __init__(self, scenarios, num_nodes: int, arrays, *, device):
        need, mmax = _round_fanin(arrays, num_nodes, len(scenarios))
        super().__init__(scenarios, num_nodes, need, mmax, device)

    def _round(self, hop_u, hop_v, n_hops, t0: torch.Tensor) -> torch.Tensor:
        """One round's event loop on device tensors; returns t_end."""
        B, T, _ = hop_u.shape
        if T == 0:
            return t0
        ctx = self.ctx
        st = dict(t=t0, hop_i=torch.zeros((B, T), dtype=_I64,
                                          device=self.device),
                  left=ctx.chunk[:, None].expand(B, T).clone(),
                  ovf=torch.zeros((), dtype=torch.bool, device=self.device))
        _run_loop(
            lambda s: _round_step(s, hop_u, hop_v, n_hops, ctx, self._nodes),
            st, lambda s: (s["hop_i"] >= n_hops).all())
        return st["t"]

    def execute_round(self, hop_u, hop_v, n_hops, t0) -> np.ndarray:
        dev = self.device
        t = self._round(host_to_device(hop_u, dev), host_to_device(hop_v, dev),
                        host_to_device(n_hops, dev),
                        host_to_device(np.asarray(t0, dtype=float), dev))
        return self._to_host(t)

    def execute_rounds(self, hop_all_u, hop_all_v, n_hops_all,
                       t0) -> tuple[np.ndarray, np.ndarray]:
        """(round_times (R, B), t_end (B,)) for whole plans, round by
        round on the device with one copy back at the end."""
        B, R, _, _ = hop_all_u.shape
        t0 = np.asarray(t0, dtype=float)
        if R == 0:
            return np.zeros((0, B)), t0.copy()
        dev = self.device
        hu, hv, nh = (host_to_device(a, dev)
                      for a in (hop_all_u, hop_all_v, n_hops_all))
        t = host_to_device(t0, dev)
        tends = []
        for r in range(R):
            if n_hops_all[:, r].any():   # else every case's round is padding
                t = self._round(hu[:, r], hv[:, r], nh[:, r], t)
            tends.append(t)
        tends = self._to_host(torch.stack(tends))
        rt = np.diff(np.concatenate([t0[None, :], tends], axis=0), axis=0)
        return rt, tends[R - 1].copy()


class DevicePipelineEngine(_EngineBase):
    """PPT executor: drop-in for `execute_pipeline_batch`."""

    def __init__(self, scenarios, num_nodes: int, parent, edge_valid, *,
                 device):
        need, mmax = _pipeline_fanin(parent, edge_valid, num_nodes)
        super().__init__(scenarios, num_nodes, need, mmax, device)

    def execute(self, child, parent, depth, edge_valid, t0) -> np.ndarray:
        dev = self.device
        ctx = self.ctx
        c, p, d = (host_to_device(a, dev) for a in (child, parent, depth))
        left0 = torch.where(host_to_device(edge_valid, dev),
                            ctx.chunk[:, None], 0.0)
        dmax = int(depth.max()) if depth.size else 0
        st = dict(t=host_to_device(np.asarray(t0, dtype=float), dev),
                  left=left0,
                  ovf=torch.zeros((), dtype=torch.bool, device=dev))
        _run_loop(
            lambda s: _pipeline_step(s, c, p, d, dmax, ctx, self._nodes),
            st, lambda s: ~(s["left"] > _EPS * ctx.chunk[:, None]).any())
        return self._to_host(st["t"])


# ----------------------------------------------------------- fan-in analysis
def _round_fanin(arrays, num_nodes: int,
                 B: int) -> tuple[np.ndarray, int]:
    """(need (B, N) bool, mmax): receivers that can see fan-in >= 2 and
    the batch-wide fan-in bound, read off the compiled plans. Concurrent
    fan-in at a node never exceeds its per-round receiver-hop count, and
    BMF relay splices only add fan-in-1 relay receivers, so counts taken
    before replanning stay a sound bound."""
    need = np.zeros((B, num_nodes), dtype=bool)
    mmax = 1
    for b, pa in enumerate(arrays):
        if not pa.num_transfers:
            continue
        counts = np.diff(pa.round_start).astype(np.int64)
        rid = np.repeat(np.arange(pa.num_rounds), counts)
        cols = np.arange(pa.t_path.shape[1])
        recv_sel = ((cols[None, :] >= 1)
                    & (cols[None, :] < pa.t_path_len[:, None]))
        keys = (rid[:, None] * num_nodes + pa.t_path)[recv_sel]
        cnt = np.bincount(keys, minlength=pa.num_rounds * num_nodes)
        cnt = cnt.reshape(pa.num_rounds, num_nodes)
        need[b] = (cnt >= 2).any(axis=0)
        mmax = max(mmax, int(cnt.max(initial=1)))
    return need, mmax


def _pipeline_fanin(parent, edge_valid,
                    num_nodes: int) -> tuple[np.ndarray, int]:
    B = parent.shape[0]
    need = np.zeros((B, num_nodes), dtype=bool)
    mmax = 1
    for b in range(B):
        cnt = np.bincount(parent[b][edge_valid[b]], minlength=num_nodes)
        need[b] = cnt >= 2
        mmax = max(mmax, int(cnt.max(initial=1)))
    return need, mmax


# ------------------------------------------------------------------ factories
def make_round_engine(scenarios, num_nodes: int, arrays, *, device=None):
    """A `DeviceRoundEngine` for the batch on `device` (`None` = the card,
    raising without one), or None with a `RuntimeWarning` when the batch
    must run on the numpy steppers (non-persistent shares, memory cap)."""
    dev = resolve_device(device)
    try:
        return DeviceRoundEngine(scenarios, num_nodes, arrays, device=dev)
    except DeviceUnsupported as e:
        _host_route(len(scenarios), num_nodes, str(e))
        return None


def make_pipeline_engine(scenarios, num_nodes: int, parent, edge_valid, *,
                         device=None):
    """A `DevicePipelineEngine` for the batch, or None (numpy steppers)."""
    dev = resolve_device(device)
    try:
        return DevicePipelineEngine(scenarios, num_nodes, parent, edge_valid,
                                    device=dev)
    except DeviceUnsupported as e:
        _host_route(len(scenarios), num_nodes, str(e))
        return None
