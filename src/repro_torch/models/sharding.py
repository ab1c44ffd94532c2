"""Logical-axis sharding rules over a `torch.distributed` device mesh.

Every parameter/activation dimension carries a *logical* axis name; the
MeshRules translate logical names to mesh axes, silently replicating any
dimension the mesh cannot divide evenly (e.g. smollm's 15 heads on a
16-way tensor axis fall back to the sequence layout).

Logical names:
  "d"      — model width (FSDP-sharded over the data/pod axes)
  "tp"     — tensor-parallel dim (heads / ffn / vocab / experts / head_dim)
  "batch"  — activation batch (data/pod axes)
  "seq"    — activation sequence (tensor axis; long-context decode caches)
  None     — replicated

`spec` gives the JAX package's PartitionSpec structure as a tuple (an
axis name, a tuple of names, or None per dimension); `sharding` turns it
into DTensor placements, one per dimension of `dmesh`, the mesh the
DTensors live on. `dmesh` is `mesh` itself, except that FSDP axes that
are adjacent mesh dimensions ("pod", "data") are merged into one
dimension, pod-major, the order in which JAX lays out a dimension
sharded over ("pod", "data"): every shard sits on the rank it would
have on the unmerged mesh. The merge is for DTensor's sharding
propagation, which searches every combination of per-dimension
strategies: a reduced grok-1 train step on a (2, 2, 2) mesh spent 284 s
there and 6.8 s on its (4, 2) view (CPU, fake process group). Off-mesh
(`NO_MESH`) every constraint is the identity.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                  local_map)


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: DeviceMesh | None = None
    fsdp: tuple[str, ...] = ("data",)
    tensor: str = "model"
    dmesh: DeviceMesh | None = dataclasses.field(
        default=None, init=False, compare=False, repr=False)

    def __post_init__(self):
        if self.mesh is not None:
            object.__setattr__(self, "dmesh", _merged(self.mesh, self.fsdp))

    @property
    def axis_sizes(self) -> dict[str, int]:
        """Mesh axis name -> size (the reference's `mesh.shape`)."""
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))

    def _axes_for(self, logical: str | None):
        if logical in ("d", "batch"):
            return self.fsdp
        if logical in ("tp", "seq"):
            return (self.tensor,)
        if logical is None:
            return None
        raise ValueError(f"unknown logical axis {logical!r}")

    def _axis_size(self, axes: tuple[str, ...]) -> int:
        sizes = self.axis_sizes
        size = 1
        for a in axes:
            size *= sizes[a]
        return size

    def spec(self, logical: tuple, shape: tuple) -> tuple:
        """The PartitionSpec of `shape` as a tuple, dropping non-divisible
        dims and using each mesh axis once; () off-mesh."""
        if self.mesh is None:
            return ()
        parts = []
        used: set[str] = set()
        for name, dim in zip(logical, shape):
            axes = self._axes_for(name)
            if (
                axes is None
                or any(a in used for a in axes)
                or dim % self._axis_size(axes) != 0
            ):
                parts.append(None)
            else:
                parts.append(axes if len(axes) > 1 else axes[0])
                used.update(axes)
        return tuple(parts)

    def placements(self, spec: tuple) -> tuple:
        """DTensor placements of a spec, one per dimension of `dmesh`."""
        out = [Replicate()] * self.dmesh.ndim
        names = self.dmesh.mesh_dim_names
        for dim, part in enumerate(spec):
            if part is None:
                continue
            axes = (part,) if isinstance(part, str) else tuple(part)
            name = _MERGE.join(axes) if _MERGE.join(axes) in names else None
            for axis in (name,) if name else axes:
                out[names.index(axis)] = Shard(dim)
        return tuple(out)

    def sharding(self, logical: tuple, shape: tuple):
        """The placements of `shape` by logical names, or None off-mesh."""
        if self.mesh is None:
            return None
        return self.placements(self.spec(logical, shape))

    def context(self):
        """The context a model runs in: on a mesh, plain tensors the code
        makes (positions, masks, zeros) meet DTensors as replicated
        values; off-mesh, nothing."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return implicit_replication()

    def constrain(self, x: torch.Tensor, logical: tuple) -> torch.Tensor:
        """A sharding constraint by logical names (the identity off-mesh):
        a DTensor is redistributed; a plain tensor, which every rank holds
        whole, becomes a DTensor sharded so (no communication, and
        differentiable)."""
        if self.mesh is None:
            return x
        want = self.sharding(tuple(logical), tuple(x.shape))
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, self.dmesh,
                                   [Replicate()] * self.dmesh.ndim,
                                   run_check=False)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(self.dmesh, want)


_MERGE = "+"


def _merged(mesh: DeviceMesh, fsdp: tuple) -> DeviceMesh:
    """`mesh` with the FSDP axes merged into one dimension named
    "pod+data" when there are several and they are adjacent and in
    order; else `mesh` itself. The new mesh holds the same ranks (its
    process groups are made on every rank, as a mesh's are)."""
    names = tuple(mesh.mesh_dim_names)
    if len(fsdp) < 2 or not all(a in names for a in fsdp):
        return mesh
    first = names.index(fsdp[0])
    if names[first:first + len(fsdp)] != tuple(fsdp):
        return mesh
    ranks = mesh.mesh
    shape = (*ranks.shape[:first], -1, *ranks.shape[first + len(fsdp):])
    new_names = (*names[:first], _MERGE.join(fsdp),
                 *names[first + len(fsdp):])
    return DeviceMesh(mesh.device_type, ranks.reshape(shape),
                      mesh_dim_names=new_names)


# Default rules: no mesh, everything replicated, constraints no-op.
NO_MESH = MeshRules(mesh=None)


@contextlib.contextmanager
def inference(rules: MeshRules):
    """`torch.inference_mode()` off-mesh; on a mesh `torch.no_grad()`
    (a DTensor view of a tensor made outside inference mode raises under
    it) in `rules.context()`."""
    if rules.mesh is None:
        with torch.inference_mode():
            yield
    else:
        with torch.no_grad(), rules.context():
            yield


def serving(fn):
    """Run `fn` (which takes its rules as the keyword `rules`) under
    `inference(rules)`."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with inference(kwargs.get("rules", NO_MESH)):
            return fn(*args, **kwargs)
    return wrapper


def _is_logical_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _map(fn, logical_tree, tree):
    """`fn(logical, leaf)` over a logical tree and a tree of one structure
    (nested dicts; logical leaves are tuples of axis names)."""
    if _is_logical_leaf(logical_tree):
        return fn(logical_tree, tree)
    return {k: _map(fn, logical_tree[k], tree[k]) for k in logical_tree}


def tree_specs(rules: MeshRules, params, logical_tree):
    """A params tree + matching logical tree -> a tree of spec tuples.
    Leaves of `params` need only a `.shape`."""
    return _map(lambda lg, arr: rules.spec(tuple(lg), tuple(arr.shape)),
                logical_tree, params)


def tree_shardings(rules: MeshRules, params, logical_tree):
    """A tree of DTensor placements, or None off-mesh."""
    if rules.mesh is None:
        return None
    return _map(lambda lg, arr: rules.sharding(tuple(lg), tuple(arr.shape)),
                logical_tree, params)


def tree_constrain(rules: MeshRules, tree, logical_tree):
    """`constrain` over a whole tree by logical names."""
    if rules.mesh is None:
        return tree
    return _map(lambda lg, arr: rules.constrain(arr, tuple(lg)),
                logical_tree, tree)


def stack_logical(logical_tree: dict) -> dict:
    """A per-layer logical tree with a leading (replicated) layer axis on
    every leaf, as stacked layer params carry."""
    if isinstance(logical_tree, dict):
        return {k: stack_logical(v) for k, v in logical_tree.items()}
    return (None, *logical_tree)


def kv_cache_axes(num_kv_heads: int, head_dim: int, rules: MeshRules):
    """Pick the tensor-sharded dim of a (L, B, S, kv, hd) KV cache.

    Prefer kv heads, then head_dim, then sequence. kv/hd sharding keeps the
    S axis unsharded so window slices and cache writes never gather (the
    seq fallback is only ever hit off-mesh)."""
    if rules.mesh is None:
        return (None, "batch", None, None, None)
    ts = rules.axis_sizes[rules.tensor]
    if num_kv_heads % ts == 0:
        return (None, "batch", None, "tp", None)
    if head_dim % ts == 0:
        return (None, "batch", None, None, "tp")
    return (None, "batch", "seq", None, None)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: a gradient that
    leaves a `local_map` region goes on through DTensor ops, whose views
    assume the local layout their global strides describe."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def local_region(rules: MeshRules, fn, args, out_like):
    """`fn` run by every rank on its own shards (a `local_map` region):
    each of `args`, pairs of a tensor and its logical axes, is
    constrained to its axes and `fn` gets the local tensors; the outputs
    become DTensors placed like the args at `out_like` (an index, or a
    tuple of indices for a tuple of outputs). For code that DTensor has
    no sharding rule for; `fn` writes out any collective it needs."""
    tensors = [rules.constrain(t, lg) for t, lg in args]
    placements = tuple(tuple(t.placements) for t in tensors)
    if isinstance(out_like, int):
        out = placements[out_like]
    else:
        out = tuple(placements[i] for i in out_like)
    return local_apply(fn, rules.dmesh, tensors, placements, out)


def local_apply(fn, mesh: DeviceMesh, tensors, placements, out):
    """`fn` on every rank's shards of DTensors `tensors`, redistributed
    to `placements` (one per tensor) first; the outputs are placed by
    `out` (placements, or a tuple of them for a tuple of outputs).

    Gradients: on a mesh dim where some input is sharded, the ranks
    split the work, so an input replicated there gets a partial sum of
    its gradient from each rank (`Partial`); elsewhere an input's
    gradient is placed as the input is."""
    placements = tuple(tuple(p) for p in placements)
    split = [any(p[i].is_shard() for p in placements)
             for i in range(mesh.ndim)]
    grads = tuple(tuple(Partial() if split[i] and p[i].is_replicate()
                        else p[i] for i in range(mesh.ndim))
                  for p in placements)

    def run(*local):
        return fn(*(_ContiguousGrad.apply(t) if t.requires_grad else t
                    for t in local))

    single = not isinstance(out, tuple) or not isinstance(out[0], (tuple,
                                                                   list))
    out = list(out) if single else tuple(tuple(p) for p in out)
    return local_map(run, out_placements=out, in_placements=placements,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*tensors)


def local_extent(shape, mesh: DeviceMesh, placements, dim: int) -> tuple:
    """(local size, global offset) of tensor dim `dim` on this rank, for a
    DTensor of global `shape` placed by `placements` on `mesh`."""
    return shard_extent(int(shape[dim]), tuple(mesh.shape),
                        mesh.get_coordinate(), placements, dim)


def shard_extent(size: int, mesh_shape, coordinate, placements,
                 dim: int) -> tuple:
    """(local size, global offset) of a dim of `size` at mesh `coordinate`
    under `placements`, by DTensor's own reckoning, mesh dim by mesh dim
    as `compute_local_shape_and_global_offset` goes: each `Shard` of the
    dim splits it as `torch.chunk` does (chunks of ceil(size / n), the
    last ranks' shorter or empty), so an uneven slice's offset is not
    rank x local size. Plain ints: no tensor is read, so it serves on
    fake tensors (where that function reads its offsets from tensors)."""
    offset = 0
    for n, r, p in zip(mesh_shape, coordinate, placements):
        if p.is_shard(dim):
            chunk = -(-size // n)
            start = min(size, chunk * r)
            size = min(size, start + chunk) - start
            offset += start
    return size, offset


def host_int(t: torch.Tensor) -> int:
    """The value of a 0-d host tensor (a cache's write position), read
    outside any fake-tensor mode (the dry run keeps it real)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return int(t)


def assign(dst: torch.Tensor, index: tuple, src) -> None:
    """`dst[index] = src` in place. A DTensor `dst` (DTensor has no rule
    for an in-place write into a slice) is written shard by shard: the
    dims `index` picks or slices must be whole on every rank (the others
    take `slice(None)`), `src` is placed as `dst[index]` would be, and
    each rank copies its own shard into its local tensor."""
    if not isinstance(dst, DTensor):
        dst[index] = src
        return
    full = _expand(index, dst.ndim)
    local = dst.to_local()[full]
    if not isinstance(src, torch.Tensor):
        local.fill_(src)
        return
    kept = [d for d, ix in enumerate(full) if not isinstance(ix, int)]
    placements = []
    for p in dst.placements:
        if p.is_shard():
            if full[p.dim] != slice(None):
                raise ValueError(f"cannot write into a slice of sharded "
                                 f"dim {p.dim}")
            p = Shard(kept.index(p.dim))
        placements.append(p)
    mesh = dst.device_mesh
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    local.copy_(src.redistribute(mesh, placements).to_local())


def _expand(index: tuple, ndim: int) -> tuple:
    """`index` with its Ellipsis (or its missing trailing dims) as
    `slice(None)`s, one entry per dim."""
    if Ellipsis in index:
        at = index.index(Ellipsis)
        fill = ndim - (len(index) - 1)
        return index[:at] + (slice(None),) * fill + index[at + 1:]
    return index + (slice(None),) * (ndim - len(index))


class AllReduce(torch.autograd.Function):
    """Sum over a process group; the output is used whole by every rank,
    so the gradient passes through unchanged (Megatron's "g")."""

    @staticmethod
    def forward(ctx, x, group):
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def mesh_matmul(x: DTensor, w: DTensor) -> DTensor:
    """x (..., k) @ w (k, n) on a mesh, shard by shard (`local_apply`):
    DTensor's matmul flattens x's leading dims, and where two of them
    are sharded the flat layout is a strided one it cannot then contract
    on fake tensors. Per mesh dim: where x shards a leading dim, w is
    whole there (its FSDP shard gathered) and the output keeps x's
    shard; where x shards k, w is cut the same way and the partial
    products are all-reduced; elsewhere w keeps an n shard, which the
    output takes."""
    mesh = x.device_mesh
    last = x.ndim - 1
    xp, wp, out, groups = [], [], [], []
    for i, (p, q) in enumerate(zip(x.placements, w.placements)):
        if p.is_shard() and p.dim < last:
            xp.append(p), wp.append(Replicate()), out.append(p)
        elif p.is_shard(last):
            xp.append(p), wp.append(Shard(0)), out.append(Replicate())
            groups.append(mesh.get_group(i))
        elif q.is_shard(1):
            xp.append(Replicate()), wp.append(q), out.append(Shard(last))
        else:
            xp.append(Replicate()), wp.append(Replicate())
            out.append(Replicate())

    def product(a, b):
        y = a @ b
        for group in groups:
            y = AllReduce.apply(y, group)
        return y

    return local_apply(product, mesh, (x, w), (xp, wp), out)
