"""Device stepper: the batched event loops on a torch device.

This is the counterpart of the JAX package's `core/engine/jax_stepper.py`.
`repro_torch.core.engine.vectorized` keeps the host-side orchestration
(planning, the per-round BMF monitor-and-replan step, result bookkeeping);
this module replaces only its *event loops*, which run in
`repro_torch.kernels.event_loop`: on the card as its CUDA kernels (one
launch a call, the whole loop inside the kernel; one warp a case where a
case has at most 32 transfers or edges on at most 32 nodes, else one
block a case), with `device="cpu"` (or
`use_kernel=False`) as their plain versions, float64 torch ops stepping
the batch in lockstep.

Names, reference -> port:

* `JaxRoundEngine.execute_round` -> `DeviceRoundEngine.execute_round`:
  one round's event loop (`vectorized.execute_round_batch`'s twin), per
  case dt / epoch / completion, the fan-in groups by receiver;
* `JaxRoundEngine.execute_rounds` -> `DeviceRoundEngine.execute_rounds`:
  the `lax.scan` over the round axis is one kernel launch over all rounds
  (used when no round is replanned); a round in which a case has no
  transfer passes its time through unchanged;
* `JaxPipelineEngine.execute` -> `DevicePipelineEngine.execute`: PPT's
  pipeline stepper with its topological min-scan over depth levels;
* `JaxUnsupported` -> `DeviceUnsupported`, `jax_available` ->
  `device_available`; `EpochHorizonError`, `make_round_engine`,
  `make_pipeline_engine`, `_round_fanin`, `_pipeline_fanin` keep their
  names.

**The loop condition.** `lax.while_loop` tests its condition on the
device, and so does the kernel: the host reads each call's packed
result (end clocks, per-case steps and flags) once. The plain version
reads the completion and horizon-overflow flags on the host once every
`_SYNC_EVERY` steps: a finished case takes `dt = 0` and its state stands
still, so the steps run past its end change nothing. Neither runs a case
more than `_GUARD` steps a round (a case that reaches it raises
`RuntimeError`). An overflow raises `EpochHorizonError` (the caller
re-runs the whole batch, so stopping early changes no result).

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
reuses programs; nothing is compiled per shape here, so no axis is
padded. The memory check keeps the reference's reckoning
(`_stack_bytes`), so the same batches take the device as in the
reference.

**Routing is counted and warned of.** `COUNTS` records the batches that
ran on the device, those handed back to the numpy steppers, the horizon
doublings, the engine calls, the host syncs and event steps, as the
kernels keep launch counts, and the host wall time spent in the event
loops and in building the epoch stacks. Each batch handed back to the
host also raises a `RuntimeWarning` naming its size and the reason: the
caller asked for the device, and that batch's time is host time. On the
card a batch the kernels cannot take (a case's transfers or tree edges
past a block's shared memory, `event_loop.check_round_shape`) takes that
route too; the sweep suites' shapes are far inside it.

Every float is float64, so the device performs the numpy engine's
float64 ops; `tests/test_torch_device_stepper.py` holds all 8 schemes x
3 volatility regimes to the reference engines at 1e-6 relative tolerance
with identical round counts, and `chip_smoke.py` holds the kernels to
the plain version on the card.
"""
from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from repro_torch.device import host_to_device, resolve_device
from repro_torch.kernels import event_loop
# the engines' exceptions live beside the event loops that raise them
from repro_torch.kernels.event_loop import (DeviceUnsupported,  # noqa: F401
                                            EpochHorizonError, EventCtx)

_GUARD = 100_000
# The reference's routing constants (`jax_stepper.py:78-80`): they decide
# which batches take the device, so they stay equal to the reference's.
# They were sized for the reference's accelerator, not measured on an
# H100; raising them is later work.
_MEM_LIMIT_BYTES = 256 * 1024 * 1024
_INITIAL_LIVE_EPOCHS = 64
_MAX_LIVE_EPOCHS = 8192
# event steps between two host reads of the plain version's completion
# flags (the kernels read none). On an H100 (`scripts/bench_sweep_sync.py`,
# the sweep suites of `chip_smoke.py`) a read every step and every 8
# steps agree within the host's noise; every 64 steps is slower, as loops
# run past their ends.
_SYNC_EVERY = 8


@dataclasses.dataclass
class StepperCounts:
    """Routing and synchronisation counts of the device stepper."""

    device_batches: int = 0     # batches whose event loops ran on the device
    host_batches: int = 0       # batches handed back to the numpy steppers
    horizon_grows: int = 0      # epoch-horizon doublings (a batch re-run)
    round_calls: int = 0        # execute_round / execute_rounds calls
    pipeline_calls: int = 0     # DevicePipelineEngine.execute calls
    host_syncs: int = 0         # host reads of device values in the loops
    steps: int = 0              # event steps (see `_EngineBase._events`)
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


# --------------------------------------------------------------- host engines
class _EngineBase:
    """Shared device context: epoch stacks, ingress params, shares table."""

    def __init__(self, scenarios, num_nodes: int, need: np.ndarray,
                 mmax: int, device, use_kernel: bool):
        if any(not sc.ingress.persistent_shares for sc in scenarios):
            # epoch-keyed share redraws cannot be pretabulated
            raise DeviceUnsupported("non-persistent ingress shares")
        self.device = torch.device(device)
        self.use_kernel = use_kernel
        self.scenarios = list(scenarios)
        self.B = len(self.scenarios)
        self.N = int(num_nodes)
        self.live_epochs = _INITIAL_LIVE_EPOCHS
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
        self.ctx = EventCtx(
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

    @property
    def on_kernel(self) -> bool:
        """True when the event loops launch the CUDA kernels."""
        return self.use_kernel and self.device.type == "cuda"

    def _events(self, loop, *tables, t0) -> np.ndarray:
        """Run one event-loop call, read its packed (3, R, B) result on
        the host (one sync) and raise for a flagged round. `COUNTS.steps`
        gets the plain version's steps as launched (the lockstep loop,
        run to its host reads) or, on the kernel route, for each round
        the most steps any case took: the loop's serial chain."""
        tic = time.perf_counter()
        packed = loop(self.ctx, *tables, np.asarray(t0, dtype=float),
                      guard=_GUARD, sync_every=_SYNC_EVERY, counts=COUNTS,
                      use_kernel=self.use_kernel)
        COUNTS.host_syncs += 1
        out = packed.cpu().numpy()
        COUNTS.loop_s += time.perf_counter() - tic
        if self.on_kernel:
            COUNTS.steps += int(out[event_loop.STEPS].max(axis=1,
                                                          initial=0).sum())
        event_loop.check_flags(out[event_loop.FLAGS])
        return out[event_loop.T_END]


class DeviceRoundEngine(_EngineBase):
    """Round-scheme executor: drop-in for `execute_round_batch` (per
    round, between host replan steps) plus a whole-plan loop over rounds."""

    def __init__(self, scenarios, num_nodes: int, arrays, *, device,
                 use_kernel: bool = True):
        if use_kernel and torch.device(device).type == "cuda":
            event_loop.check_round_shape(_max_transfers(arrays), num_nodes)
        need, mmax = _round_fanin(arrays, num_nodes, len(scenarios))
        super().__init__(scenarios, num_nodes, need, mmax, device,
                         use_kernel)

    def execute_round(self, hop_u, hop_v, n_hops, t0) -> np.ndarray:
        """One round: (B, T, H) hop tables, (B, T) hop counts -> t_end."""
        COUNTS.round_calls += 1
        return self._events(event_loop.round_events, hop_u[:, None],
                            hop_v[:, None], n_hops[:, None], t0=t0)[0]

    def execute_rounds(self, hop_all_u, hop_all_v, n_hops_all,
                       t0) -> tuple[np.ndarray, np.ndarray]:
        """(round_times (R, B), t_end (B,)) for whole plans: every round
        in one call, one copy back at the end."""
        B, R, _, _ = hop_all_u.shape
        t0 = np.asarray(t0, dtype=float)
        if R == 0:
            return np.zeros((0, B)), t0.copy()
        COUNTS.round_calls += 1
        tends = self._events(event_loop.round_events, hop_all_u, hop_all_v,
                             n_hops_all, t0=t0)
        rt = np.diff(np.concatenate([t0[None, :], tends], axis=0), axis=0)
        return rt, tends[R - 1].copy()


class DevicePipelineEngine(_EngineBase):
    """PPT executor: drop-in for `execute_pipeline_batch`."""

    def __init__(self, scenarios, num_nodes: int, parent, edge_valid, *,
                 device, use_kernel: bool = True):
        if use_kernel and torch.device(device).type == "cuda":
            event_loop.check_pipeline_shape(np.shape(parent)[1], num_nodes)
        need, mmax = _pipeline_fanin(parent, edge_valid, num_nodes)
        super().__init__(scenarios, num_nodes, need, mmax, device,
                         use_kernel)

    def execute(self, child, parent, depth, edge_valid, t0) -> np.ndarray:
        COUNTS.pipeline_calls += 1
        return self._events(event_loop.pipeline_events, child, parent, depth,
                            edge_valid, t0=t0)[0]


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


def _max_transfers(arrays) -> int:
    """The most transfers any round of the batch's plans holds."""
    return max((int(np.diff(pa.round_start).max(initial=0))
                for pa in arrays), default=0)


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
def make_round_engine(scenarios, num_nodes: int, arrays, *, device=None,
                      use_kernel: bool = True):
    """A `DeviceRoundEngine` for the batch on `device` (`None` = the card,
    raising without one), or None with a `RuntimeWarning` when the batch
    must run on the numpy steppers (non-persistent shares, memory cap, a
    shape past the kernel's). On the card its event loops launch the CUDA
    kernels; `use_kernel=False` runs their plain torch versions there."""
    dev = resolve_device(device)
    try:
        return DeviceRoundEngine(scenarios, num_nodes, arrays, device=dev,
                                 use_kernel=use_kernel)
    except DeviceUnsupported as e:
        _host_route(len(scenarios), num_nodes, str(e))
        return None


def make_pipeline_engine(scenarios, num_nodes: int, parent, edge_valid, *,
                         device=None, use_kernel: bool = True):
    """A `DevicePipelineEngine` for the batch, or None (numpy steppers);
    `use_kernel` as for `make_round_engine`."""
    dev = resolve_device(device)
    try:
        return DevicePipelineEngine(scenarios, num_nodes, parent, edge_valid,
                                    device=dev, use_kernel=use_kernel)
    except DeviceUnsupported as e:
        _host_route(len(scenarios), num_nodes, str(e))
        return None
