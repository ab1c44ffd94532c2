"""Dynamic bandwidth process + concurrent-ingress degradation model.

Two empirical facts from the paper drive this module:

* Rapid change (hot storage): link bandwidths are re-drawn at a fixed
  interval — 5 s in the paper's "cold" simulation, 2 s in "hot" (Fig. 11).
  `BandwidthProcess` is a seeded piecewise-constant process with O(1)
  random access to any epoch (deterministic across runs and platforms).

* Fan-in degradation (Fig. 2): when m links send to one node concurrently,
  the *total* ingress throughput drops as m grows and the per-link split is
  uneven. `IngressModel` reproduces both effects; it is what penalizes
  star-repair and PPT's multi-sender assumption, exactly the paper's
  criticism.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class BandwidthProcess:
    """Piecewise-constant per-link scaling of a base matrix.

    In epoch e (t in [e*interval, (e+1)*interval)), each directed link's
    bandwidth depends on `mode`:
      * "jitter": base[i, j] * Uniform(1-jitter, 1+jitter) — load wobble
        around a stable mean (the paper's cold-storage regime),
      * "redraw": Uniform(min(base), max(base)) per link — memoryless
        stress case; no scheme can predict anything across epochs.
      * "markov": log-AR(1) around base — bw_e = base * exp(x_e),
        x_e = rho * x_{e-1} + sigma * sqrt(1-rho^2) * N(0,1). The paper's
        hot-storage regime: bandwidth "changes very sharply" yet links keep
        short-term memory, so a plan-once snapshot (PPT) decays over a few
        epochs while per-round monitoring (BMFRepair) stays current.
    Draws come from a counter-based rng keyed on (seed, epoch), so
    `matrix_at(t)` is pure and epoch-addressable without history.
    `change_interval=None` (or jitter=0 in jitter mode) freezes the network.
    """

    base: np.ndarray
    change_interval: float | None = None
    jitter: float = 0.5
    seed: int = 0
    min_bw: float = 0.5
    mode: str = "jitter"
    rho: float = 0.6      # markov: per-epoch correlation
    sigma: float = 0.5    # markov: stationary log-std
    _AR_HORIZON = 32      # markov: truncation (rho^32 ~ 1e-7 at rho=0.6)
    _CACHE_LIMIT = 128    # per-instance epoch-matrix memo bound

    def __post_init__(self):
        # Per-instance epoch -> matrix memo. The event loop queries
        # matrix_at many times per epoch (every hop/epoch event); caching
        # keeps those queries O(1) without changing any returned value.
        # The innovation memo serves the overlapping markov AR windows:
        # consecutive epochs share all but one N(0,1) draw, so caching
        # cuts epoch-matrix generation from O(horizon) to O(1) rng calls.
        # The AR-state memo does the same for the Horner recursion: while
        # the window still starts at epoch 0 (e <= horizon), x_e is exactly
        # x_{e-1} * rho + z_e, so one fused multiply-add replaces the
        # whole window walk — bit-identical by construction.
        object.__setattr__(self, "_epoch_cache", {})
        object.__setattr__(self, "_innov_cache", {})
        object.__setattr__(self, "_ar_cache", {})
        object.__setattr__(self, "_block_cache", {})
        object.__setattr__(self, "_prefix_cache", {})

    def epoch_of(self, t: float) -> int:
        if self.change_interval is None:
            return 0
        # math.floor(t / i) == int(np.floor(t / i)) for finite floats and
        # is an order of magnitude cheaper on the per-event hot path
        return math.floor(t / self.change_interval)

    def epoch_end(self, t: float) -> float:
        if self.change_interval is None:
            return np.inf
        return (self.epoch_of(t) + 1) * self.change_interval

    @property
    def num_nodes(self) -> int:
        return self.base.shape[0]

    def _innovation(self, e: int) -> np.ndarray:
        """Epoch e's N(0,1) draw (markov mode), keyed on (seed, epoch)."""
        z = self._innov_cache.get(e)
        if z is None:
            if len(self._innov_cache) >= 4 * self._CACHE_LIMIT:
                self._innov_cache.clear()
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, e]))
            z = rng.standard_normal(self.base.shape)
            z.setflags(write=False)
            self._innov_cache[e] = z
        return z

    def _ar_state(self, e: int, innovations: dict[int, np.ndarray] | None) -> np.ndarray:
        """Markov AR state x_e, evaluated by the same Horner recursion the
        windowed sum has always used. While the truncation window still
        starts at epoch 0 (e <= horizon) the memoized previous state gives
        x_e = x_{e-1} * rho + z_e in one step — the identical float ops,
        just not recomputed from scratch each epoch."""

        def innov(i: int) -> np.ndarray:
            return innovations[i] if innovations is not None \
                else self._innovation(i)

        start = max(0, e - self._AR_HORIZON)
        if start == 0:
            cached = self._ar_cache.get(e)
            if cached is not None:
                return cached
            prev = self._ar_cache.get(e - 1) if e > 0 else None
            if prev is not None:
                x = prev * self.rho + innov(e)
            else:
                x = innov(0)
                for i in range(1, e + 1):
                    x = x * self.rho + innov(i)
            if len(self._ar_cache) >= 4 * self._CACHE_LIMIT:
                self._ar_cache.clear()
            x.setflags(write=False)
            self._ar_cache[e] = x
            return x
        x = innov(start)
        for i in range(start + 1, e + 1):
            x = x * self.rho + innov(i)
        return x

    def _epoch_matrix(self, e: int, innovations: dict[int, np.ndarray] | None = None) -> np.ndarray:
        """The epoch-e matrix, uncached. `innovations` optionally supplies
        precomputed markov draws (bit-identical to `_innovation`) so batch
        sampling avoids re-deriving the AR window per epoch."""
        if self.mode == "redraw":
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, e]))
            off = ~np.eye(self.base.shape[0], dtype=bool)
            lo = float(self.base[off].min())
            hi = float(self.base[off].max())
            m = rng.uniform(lo, hi, self.base.shape)
        elif self.mode == "jitter":
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, e]))
            scale = rng.uniform(1.0 - self.jitter, 1.0 + self.jitter, self.base.shape)
            m = self.base * scale
        elif self.mode == "markov":
            # exact log-AR(1) via truncated innovation sum (epoch-addressable):
            # x_e = sigma*sqrt(1-rho^2) * sum_{i} rho^(e-i) z_i,  z_i ~ N(0,1)
            x = self._ar_state(e, innovations)
            m = self.base * np.exp(self.sigma * np.sqrt(1 - self.rho**2) * x)
        else:
            raise ValueError(f"unknown bandwidth mode {self.mode!r}")
        m = np.maximum(m, self.min_bw)
        np.fill_diagonal(m, 0.0)
        return m

    def matrix_at(self, t: float) -> np.ndarray:
        """The bandwidth matrix active at time t.

        The return value may be a shared cache entry and is marked
        read-only — `.copy()` before doing in-place what-if math on it.
        """
        if self.change_interval is None:
            return self.base
        if self.mode == "jitter" and self.jitter == 0.0:
            return self.base
        e = self.epoch_of(t)
        cached = self._epoch_cache.get(e)
        if cached is None:
            if len(self._epoch_cache) >= self._CACHE_LIMIT:
                self._epoch_cache.clear()
            cached = self._epoch_matrix(e)
            cached.setflags(write=False)
            self._epoch_cache[e] = cached
        return cached

    def sample_epochs(self, num_epochs: int, *, start_epoch: int = 0) -> np.ndarray:
        """Batched sampling: the (num_epochs, N, N) stack of epoch matrices.

        Bit-identical to ``[matrix_at(e * interval) for e in epochs]`` but
        amortized: markov innovations are drawn once per epoch and shared
        across the overlapping AR windows (O(E) rng draws instead of
        O(E * horizon)), the AR states accumulate by the same one-step
        Horner recursion `_ar_state` uses, and the per-link math (exp,
        scale, clamp, diagonal) runs once over the whole (E, N, N) stack —
        elementwise, so each epoch's floats are exactly `matrix_at`'s.
        This is the bulk-sampling substrate for the sweep engine, the
        batched engine's live-epoch prefetch, and `BandwidthTrace`
        recording.
        """
        if num_epochs < 0 or start_epoch < 0:
            raise ValueError("num_epochs and start_epoch must be >= 0")
        n = self.base.shape[0]
        if self.change_interval is None or (self.mode == "jitter" and self.jitter == 0.0):
            out = np.broadcast_to(self.base, (num_epochs, n, n)).copy()
            return out
        if self.mode == "markov" and num_epochs:
            x = np.empty((num_epochs, n, n))
            for j, e in enumerate(range(start_epoch, start_epoch + num_epochs)):
                x[j] = self._ar_state(e, None)
            out = self.base * np.exp(
                self.sigma * np.sqrt(1 - self.rho**2) * x)
            np.maximum(out, self.min_bw, out=out)
            out[:, np.arange(n), np.arange(n)] = 0.0
            return out
        out = np.empty((num_epochs, n, n), dtype=float)
        for j, e in enumerate(range(start_epoch, start_epoch + num_epochs)):
            out[j] = self._epoch_matrix(e)
        return out

    def epochs_prefix(self, num_epochs: int) -> np.ndarray:
        """Memoized read-only `(num_epochs, N, N)` prefix of the epoch
        sequence (epochs `[0, num_epochs)`), bit-identical to
        `sample_epochs(num_epochs)`.

        This is the bulk substrate for device-resident epoch stacks (the
        reference's `core/engine/jax_stepper.py`): the stack is sampled once per
        process instance and shared across every scheme/batch that
        replays the same case, and a longer request *extends* the cached
        prefix in place of resampling it (`sample_epochs` is
        epoch-addressable, so the extension is the identical tail).
        """
        if num_epochs < 0:
            raise ValueError("num_epochs must be >= 0")
        have, stack = self._prefix_cache.get("prefix", (0, None))
        if stack is None or have < num_epochs:
            tail = self.sample_epochs(num_epochs - have, start_epoch=have)
            stack = tail if stack is None else np.concatenate([stack, tail])
            stack.setflags(write=False)
            self._prefix_cache["prefix"] = (num_epochs, stack)
        return stack[:num_epochs]

    _BLOCK_EPOCHS = 4

    def epochs_block(self, e: int) -> tuple[int, np.ndarray]:
        """The block-aligned `(start, (K, N, N))` stack covering epoch `e`.

        Blocks are `sample_epochs` slices aligned to multiples of
        `_BLOCK_EPOCHS` and memoized per instance, so consumers that walk
        epochs in order (the batched engine's bandwidth stack) amortize
        both the rng and the per-epoch wrapper across the block — and
        across repeated walks, e.g. one per scheme in a sweep.
        """
        start = (e // self._BLOCK_EPOCHS) * self._BLOCK_EPOCHS
        blk = self._block_cache.get(start)
        if blk is None:
            if len(self._block_cache) >= self._CACHE_LIMIT:
                self._block_cache.clear()
            blk = self.sample_epochs(self._BLOCK_EPOCHS, start_epoch=start)
            blk.setflags(write=False)
            self._block_cache[start] = blk
        return start, blk


@dataclasses.dataclass(frozen=True)
class BandwidthTrace:
    """Replay of recorded bandwidth epochs (same interface as
    `BandwidthProcess`: `epoch_of` / `epoch_end` / `matrix_at`).

    `epochs[e]` is the bandwidth matrix active during
    [e * interval, (e+1) * interval). Past the end of the recording the
    trace either cycles (default — stationary background churn) or holds
    the final epoch. Traces come from real measurements or from
    `record()`-ing a synthetic `BandwidthProcess`, which lets a sweep
    replay the *exact same* bandwidth sample path under every scheme and
    planner variant.
    """

    epochs: np.ndarray            # (E, N, N) recorded per-epoch matrices
    change_interval: float
    cycle: bool = True

    def __post_init__(self):
        ep = np.array(self.epochs, dtype=float)      # own + freeze: views of
        ep.setflags(write=False)                     # it are handed out below
        if ep.ndim != 3 or ep.shape[1] != ep.shape[2] or ep.shape[0] == 0:
            raise ValueError(f"epochs must be (E, N, N) with E >= 1, got {ep.shape}")
        if not self.change_interval or self.change_interval <= 0:
            raise ValueError("change_interval must be > 0")
        object.__setattr__(self, "epochs", ep)

    @classmethod
    def record(
        cls,
        process: BandwidthProcess,
        num_epochs: int,
        *,
        start_epoch: int = 0,
        cycle: bool = True,
        change_interval: float | None = None,
    ) -> "BandwidthTrace":
        """Snapshot `num_epochs` of a BandwidthProcess into a replayable trace."""
        interval = change_interval or process.change_interval
        if interval is None:
            interval = np.inf  # static process: one eternal epoch
            num_epochs = 1
        return cls(
            epochs=process.sample_epochs(num_epochs, start_epoch=start_epoch),
            change_interval=float(interval) if np.isfinite(interval) else 1e30,
            cycle=cycle,
        )

    @property
    def num_nodes(self) -> int:
        return self.epochs.shape[1]

    @property
    def num_epochs(self) -> int:
        return self.epochs.shape[0]

    def epoch_of(self, t: float) -> int:
        return math.floor(t / self.change_interval)

    def epoch_end(self, t: float) -> float:
        return (self.epoch_of(t) + 1) * self.change_interval

    def matrix_at(self, t: float) -> np.ndarray:
        e = self.epoch_of(t)
        if self.cycle:
            e = e % self.num_epochs
        else:
            e = min(e, self.num_epochs - 1)
        return self.epochs[e]


@dataclasses.dataclass(frozen=True)
class IngressModel:
    """Effective per-link rates when m senders target one receiver.

    Total usable ingress = (best single in-link bw) * g(m) with
    g(m) = max(floor, 1 - degrade*(m-1))  (Fig. 2: total trends *down*,
    ~-8%/link in the measurement), split unevenly by Dirichlet(alpha)
    weights (Fig. 2: shares are skewed). The split is *persistent* for the
    whole concurrent episode (keyed on receiver and fan-in, not time):
    Fig. 2 shows a slow flow staying slow, and the paper observes the
    resulting "wide fluctuation" of multi-sender schemes. Each link is
    additionally capped by its own standalone bandwidth; m=1 degenerates
    to the standalone rate.
    """

    degrade: float = 0.10
    floor: float = 0.40
    alpha: float = 1.0
    seed: int = 0
    persistent_shares: bool = True

    def total_factor(self, m: int) -> float:
        return max(self.floor, 1.0 - self.degrade * (m - 1))

    def share_weights(self, m: int, receiver: int, epoch: int) -> np.ndarray:
        """The Dirichlet split of `m` concurrent in-links at `receiver`.

        Keyed on (seed, receiver, m) — plus epoch when shares are not
        persistent — so the split is a pure function of the episode, not of
        when or how often it is queried. This is the single source of truth
        for both the per-event object engine (`effective_rates`) and the
        batched vectorized engine, which memoizes these vectors per batch.
        """
        if m <= 1:
            return np.ones(m)
        key = [self.seed, int(receiver), int(m)]
        if not self.persistent_shares:
            key.append(int(epoch))
        rng = np.random.default_rng(np.random.SeedSequence(key))
        return rng.dirichlet(np.full(m, self.alpha))

    def effective_rates(
        self,
        link_bws: np.ndarray,
        receiver: int,
        epoch: int,
    ) -> np.ndarray:
        """link_bws: standalone rates of the m concurrent in-links."""
        link_bws = np.asarray(link_bws, dtype=float)
        m = link_bws.size
        if m == 0:
            return link_bws
        if m == 1:
            return link_bws.copy()
        cap = float(link_bws.max()) * self.total_factor(m)
        w = self.share_weights(m, receiver, epoch)
        return np.minimum(link_bws, w * cap)

    # fraction of a link's rate retained when the node simultaneously moves
    # data in the other direction (pipelining rx+tx on one host; measured
    # "single node accessing multiple links" effect on ~2-vCPU cloud VMs)
    duplex: float = 0.65

    def node_allocations(
        self,
        link_bws: np.ndarray,
        directions: tuple[str, ...],
        node: int,
        epoch: int,
    ) -> np.ndarray:
        """Capacity split when one node drives m concurrent links.

        Links of the *same* direction contend like receiver fan-in
        (degraded total, persistent skewed split). If the node is active in
        *both* directions at once (a pipelined relay receiving from a child
        while sending to its parent — something BMF's store-and-forward
        relays never do), every allocation is further scaled by `duplex`.
        """
        link_bws = np.asarray(link_bws, dtype=float)
        out = np.zeros_like(link_bws)
        dirs = np.asarray(directions)
        for d in ("rx", "tx"):
            sel = dirs == d
            if sel.any():
                out[sel] = self.effective_rates(link_bws[sel], node, epoch)
        if (dirs == "rx").any() and (dirs == "tx").any():
            out = out * self.duplex
        return out
