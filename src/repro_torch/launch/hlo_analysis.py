"""Per-device cost analysis of an eager step, by the ops each rank runs.

The JAX package's `launch/hlo_analysis.py` parses the compiled,
SPMD-partitioned HLO module. PyTorch has no HLO: this module keeps the
name so a reader finds the counterpart, and reads the same totals from a
`TorchDispatchMode` that sees every op the step runs on each rank's local
tensors. A mode over DTensors would see global shapes (a matmul whose
contraction is sharded two ways would count twice its per-device
FLOPs), so `Analyzer` declines DTensor ops (returns `NotImplemented`)
and counts the local ops DTensor dispatches beneath them.

Accounting rules (all numbers per device):
  * flops: matmul-family ops only (`mm`, `addmm`, `bmm`, `baddbmm`, the
    scaled-dot-product-attention ops and their backward), as the
    reference counts `dot`s only; by `torch.utils.flop_counter`'s
    formulas (2 x m x k x n for a product).
  * bytes: operand + result bytes of every local op that is not a view.
    Eager execution fuses nothing, so each intermediate is written and
    read back: an upper estimate of HBM traffic (the reference skips
    the ops inside XLA fusions).
  * collectives: operand bytes of the `c10d_functional` all_reduce /
    all_gather_into_tensor / reduce_scatter_tensor / all_to_all_single
    ops, under the reference's kind names.
  * peak: the largest sum of the bytes of live local storages the
    step's ops made, sampled every few ops (an eager peak, with nothing
    freed early by a compiler; not XLA's `temp_size`).

There are no loop trip counts to multiply: eager execution runs, and
the mode sees, every iteration of every loop (layers, microbatches, KV
chunks). So the reference's HLO parser (`parse_module`, `_trip_count`)
has no counterpart here.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

COLLECTIVE_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_MATMUL_OPS = {
    aten.mm, aten.addmm, aten.bmm, aten.baddbmm,
    aten._scaled_dot_product_flash_attention,
    aten._scaled_dot_product_flash_attention_backward,
    aten._scaled_dot_product_efficient_attention,
    aten._scaled_dot_product_efficient_attention_backward,
    aten._scaled_dot_product_cudnn_attention,
    aten._scaled_dot_product_cudnn_attention_backward,
}

_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_SWEEP_EVERY = 32


def _collective_kind(func) -> str | None:
    if func.namespace not in ("_c10d_functional",
                              "_c10d_functional_autograd"):
        return None
    return _COLLECTIVES.get(func._opname)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Analyzer(TorchDispatchMode):
    """Counts the local ops run under it; `result()` gives the totals."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collective_by_kind: dict[str, float] = {}
        self.collective_counts: dict[str, float] = {}
        self.ops = 0
        self._live: list[tuple[StorageWeakRef, int]] = []
        self._live_bytes = 0
        self.peak_bytes = 0
        self._paused = 0

    def __enter__(self):
        # DTensor derives an op's global output shape by running the op
        # on global-shape fake tensors: that run is not a device's work
        prop = ShardingPropagator._propagate_tensor_meta_non_cached

        def shape_only(propagator, *args, **kwargs):
            self._paused += 1
            try:
                return prop(propagator, *args, **kwargs)
            finally:
                self._paused -= 1

        self._prop = prop
        ShardingPropagator._propagate_tensor_meta_non_cached = shape_only
        return super().__enter__()

    def __exit__(self, *exc):
        ShardingPropagator._propagate_tensor_meta_non_cached = self._prop
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        self.ops += 1
        packet = func.overloadpacket
        if packet in _MATMUL_OPS and packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        kind = _collective_kind(func)
        if kind is not None:
            nbytes = float(sum(_nbytes(a) for a in ins))
            self.collective_by_kind[kind] = (
                self.collective_by_kind.get(kind, 0.0) + nbytes)
            self.collective_counts[kind] = (
                self.collective_counts.get(kind, 0.0) + 1)
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
            self._track(outs, ins)
        return out

    def _track(self, outs, ins) -> None:
        """Add the storages `outs` made (those no input shares)."""
        known = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            storage = t.untyped_storage()
            if storage._cdata in known:
                continue
            known.add(storage._cdata)
            self._live.append((StorageWeakRef(storage), storage.nbytes()))
            self._live_bytes += storage.nbytes()
        self.peak_bytes = max(self.peak_bytes, self._live_bytes)
        if self.ops % _SWEEP_EVERY == 0:
            self._sweep()

    def _sweep(self) -> None:
        kept = [(ref, n) for ref, n in self._live if not ref.expired()]
        self._live = kept
        self._live_bytes = sum(n for _, n in kept)

    def result(self) -> dict:
        coll = float(sum(self.collective_by_kind.values()))
        return {
            "flops_per_device": float(self.flops),
            "bytes_per_device": float(self.bytes),
            "collective_bytes_per_device": coll,
            "collective_by_kind": dict(self.collective_by_kind),
            "collective_counts": dict(self.collective_counts),
            "peak_live_bytes": int(self.peak_bytes),
            "ops": self.ops,
        }


def analyze(fn, *args, **kwargs) -> tuple[object, dict]:
    """Run `fn(*args, **kwargs)` under an `Analyzer`; returns (its
    result, the totals: the reference's keys, `peak_live_bytes`, `ops`).
    """
    with Analyzer() as mode:
        out = fn(*args, **kwargs)
    return out, mode.result()
