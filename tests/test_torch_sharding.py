"""The port's mesh rules held to the reference's, exactly.

The reference's `MeshRules.spec` / `tree_specs` run on `AbstractMesh`es
of the production shapes (16, 16) and (2, 16, 16) (no devices needed);
the port's run on `DeviceMesh`es of the same shapes over a "fake"
process group of 256 / 512 ranks in this process. Both give, for every
arch, the same PartitionSpec structure for the params (train and decode
layouts), the train state, the serve cache, the input batch, and the
KV-cache axes. The port's trees are taken over its own shapes (its
params, state and cache made on fake tensors). The local shards a
placement gives hold the bytes the spec implies, and `shrink_mesh` /
`drop_pod` keep the ranks the reference keeps (its device ids, from a
subprocess with 8 forced host devices). No tolerance: every comparison
is exact.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, PartitionSpec
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_arch as jget_arch
from repro.ft import elastic as jelastic
from repro.launch.cells import plan_for as jplan_for
from repro.launch.mesh import rules_for as jrules_for
from repro.models import model as JM
from repro.models import sharding as JS
from repro.train import train_step as jts
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, SHAPES, get_arch
from repro_torch.ft import elastic
from repro_torch.ft.elastic import reshard_state
from repro_torch.launch.cells import plan_for
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.launch.mesh import rules_for
from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.train import train_step as T

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module", params=list(MESHES))
def rules(request):
    """(port rules, reference rules) on one production mesh shape."""
    shape, names = MESHES[request.param]
    fake_world(int(np.prod(shape)))
    mesh = make_production_mesh(multi_pod=request.param == "multi",
                                device="cpu")
    yield rules_for(mesh), jrules_for(AbstractMesh(shape, names))
    dist.destroy_process_group()


def _jspecs(tree_):
    """A reference spec tree with each PartitionSpec as a tuple."""
    return jax.tree.map(lambda p: tuple(p), tree_,
                        is_leaf=lambda x: isinstance(x, PartitionSpec))


def _port_params(cfg):
    with FakeTensorMode():
        return M.init_params(torch.Generator().manual_seed(0), cfg)


def _jparams(jcfg):
    return jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                 jcfg))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_state_specs_match_reference(rules, arch):
    prules, jrules = rules
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    params, jparams = _port_params(cfg), _jparams(jcfg)
    for decode in (False, True):
        got = S.tree_specs(prules, params,
                           M.logical_params(cfg, prules, decode=decode))
        want = JS.tree_specs(jrules, jparams,
                             JM.logical_params(jcfg, jrules, decode=decode))
        assert got == _jspecs(want), (arch, decode)
    tcfg = plan_for(cfg, SHAPES["train_4k"]).train
    jtcfg = jplan_for(jcfg, JSHAPES["train_4k"]).train
    state = {"params": params, "opt": {"m": params, "v": params},
             "step": torch.zeros(())}
    jstate = jax.eval_shape(lambda: jts.init_state(jax.random.PRNGKey(0),
                                                   jcfg, jtcfg))
    got = S.tree_specs(prules, state, T.state_logical(cfg, tcfg, prules))
    want = JS.tree_specs(jrules, jstate,
                         jts.state_logical(jcfg, jtcfg, jrules))
    assert got == _jspecs(want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_match_reference(rules, arch):
    prules, jrules = rules
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape, jshape = SHAPES[name], JSHAPES[name]
        batch = M.input_specs(cfg, shape)
        got = S.tree_specs(prules, batch, M.batch_logical(cfg, shape))
        want = JS.tree_specs(jrules, JM.input_specs(jcfg, jshape),
                             JM.batch_logical(jcfg, jshape))
        assert got == _jspecs(want), name
    if cfg.is_encoder_decoder:
        return
    shape = SHAPES["decode_32k"]
    kv_dtype = plan_for(cfg, shape).kv_dtype
    b, s = shape.global_batch, shape.seq_len
    with FakeTensorMode():
        cache = M.init_cache(cfg, b, s, kv_dtype=kv_dtype, device="cpu")
    jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, b, s,
                                                  kv_dtype=kv_dtype))
    got = S.tree_specs(prules, cache,
                       M.cache_logical(cfg, prules, kv_dtype=kv_dtype))
    want = JS.tree_specs(jrules, jcache,
                         JM.cache_logical(jcfg, jrules, kv_dtype=kv_dtype))
    assert got == _jspecs(want)


def test_kv_cache_axes_and_modes_match_reference(rules):
    prules, jrules = rules
    for kv in (1, 2, 8, 16, 32, 48):
        for hd in (16, 64, 80, 128, 256):
            assert S.kv_cache_axes(kv, hd, prules) == \
                JS.kv_cache_axes(kv, hd, jrules), (kv, hd)
    from repro.models import layers as JL
    from repro_torch.models import layers as L
    for arch in ARCH_IDS:
        for decode in (False, True):
            assert L.attn_shard_mode(get_arch(arch), prules, decode=decode) \
                == JL.attn_shard_mode(jget_arch(arch), jrules,
                                      decode=decode), (arch, decode)


@pytest.mark.parametrize("arch", ["smollm_360m", "grok1_314b",
                                  "zamba2_7b"])
def test_local_shard_bytes_are_what_the_specs_imply(rules, arch):
    """Placing the params by `tree_shardings` leaves rank 0 with exactly
    the bytes the specs give: each dim divided by the sizes of its mesh
    axes."""
    prules, _ = rules
    cfg = get_arch(arch)
    logical = M.logical_params(cfg, prules)
    with FakeTensorMode():
        params = M.init_params(torch.Generator().manual_seed(0), cfg)
        placed = reshard_state(params, prules.dmesh,
                               S.tree_shardings(prules, params, logical))
    specs = S.tree_specs(prules, params, logical)
    sizes = prules.axis_sizes
    total = 0
    for (path, p), x, spec in zip(tree.items(params), tree.leaves(placed),
                                  _spec_leaves(specs)):
        want = list(p.shape)
        for i, part in enumerate(spec):
            for axis in () if part is None else (
                    (part,) if isinstance(part, str) else part):
                want[i] //= sizes[axis]
        local = x.to_local()
        assert list(local.shape) == want, path
        total += int(np.prod(want)) * p.element_size()
    assert total == sum(x.to_local().numel() * x.to_local().element_size()
                        for x in tree.leaves(placed))


@pytest.mark.parametrize("size", [1, 3, 7, 16, 63, 257, 51865])
def test_shard_extent_is_dtensor_split(size):
    """`shard_extent` gives every rank the slice `torch.chunk` (DTensor's
    split) gives it, and DTensor's own local shapes and offsets for a dim
    cut over two mesh dims at once, at every coordinate of a (2, 3, 4)
    mesh, the uneven and empty slices included."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset)
    rows = torch.arange(size)
    for n in (2, 3, 4, 16):
        for r, part in enumerate(torch.chunk(rows, n)):
            want = (len(part), int(part[0]) if len(part) else None)
            got = S.shard_extent(size, (n,), (r,), (Shard(0),), 0)
            assert got[0] == want[0] and (not got[0] or got[1] == want[1])
        assert sum(S.shard_extent(size, (n,), (r,), (Shard(0),), 0)[0]
                   for r in range(n)) == size
    mesh_shape = (2, 3, 4)
    for placements in [(Shard(1), Replicate(), Shard(1)),
                       (Shard(1), Shard(0), Replicate()),
                       (Replicate(), Shard(1), Shard(1))]:
        for coord in np.ndindex(*mesh_shape):
            shape, offset = _compute_local_shape_and_global_offset(
                (5, size), mesh_shape, list(coord), placements)
            for dim in (0, 1):
                got = S.shard_extent((5, size)[dim], mesh_shape, coord,
                                     placements, dim)
                assert got[0] == shape[dim], (placements, coord, dim)
                assert not got[0] or got[1] == offset[dim]


def _spec_leaves(specs):
    """The spec tuples of a spec tree in `tree.items` order."""
    if isinstance(specs, dict):
        return [leaf for key in sorted(specs)
                for leaf in _spec_leaves(specs[key])]
    return [specs]


_REF_MESHES = """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import sys
sys.path.insert(0, "src")
from repro.ft.elastic import drop_pod, shrink_mesh
from repro.launch.mesh import make_test_mesh
ids = lambda m: np.vectorize(lambda d: d.id)(m.devices).tolist()
multi = make_test_mesh(multi_pod=True, data=2, model=2)
flat = make_test_mesh(multi_pod=False, data=4, model=2)
print(json.dumps({"multi": ids(multi), "shrink1": ids(shrink_mesh(multi, 1)),
                  "drop0": ids(drop_pod(multi, 0)),
                  "drop1": ids(drop_pod(multi, 1)),
                  "flat": ids(flat), "flat_shrink3": ids(shrink_mesh(flat, 3)),
                  "flat_shrink1": ids(shrink_mesh(flat, 1))}))
"""


_PORT_MESHES = """
import json, sys
sys.path.insert(0, "src")
from repro_torch.ft.elastic import drop_pod, shrink_mesh
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_test_mesh
fake_world(8)
multi = make_test_mesh(multi_pod=True, data=2, model=2, device="cpu")
flat = make_test_mesh(multi_pod=False, data=4, model=2, device="cpu")
ids = lambda m: m.mesh.tolist()
assert shrink_mesh(multi, 1).mesh_dim_names == ("pod", "data", "model")
for bad, match in ((lambda: shrink_mesh(flat, 4), "below 1"),
                   (lambda: drop_pod(flat, 0), "no pod axis")):
    try:
        bad()
        raise SystemExit("no error")
    except ValueError as e:
        assert match in str(e), e
print(json.dumps({"multi": ids(multi), "shrink1": ids(shrink_mesh(multi, 1)),
                  "drop0": ids(drop_pod(multi, 0)),
                  "drop1": ids(drop_pod(multi, 1)),
                  "flat": ids(flat), "flat_shrink3": ids(shrink_mesh(flat, 3)),
                  "flat_shrink1": ids(shrink_mesh(flat, 1))}))
"""


def _run(code: str) -> dict:
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_shrink_and_drop_keep_the_reference_ranks():
    """Rank arrays on a (2, 2, 2) and a (4, 2) mesh, each side in its own
    process (the reference's needs 8 forced host devices, the port's a
    world of 8 ranks)."""
    assert _run(_PORT_MESHES) == _run(_REF_MESHES)


def test_elastic_data_size_matches_reference():
    for gb in (1, 7, 64, 256, 1000):
        for old in (1, 2, 16, 32):
            for new in (1, 3, 8, 16, 31):
                assert elastic.elastic_data_size(gb, old, new) == \
                    jelastic.elastic_data_size(gb, old, new)


def test_ft_exports_match_reference():
    from repro import ft as jft
    from repro_torch import ft
    assert ft.shrink_mesh is elastic.shrink_mesh
    assert ft.elastic_data_size is elastic.elastic_data_size
    assert {"shrink_mesh", "elastic_data_size"} <= set(dir(jft))


def test_meshes_default_to_the_card(monkeypatch):
    """With no device the meshes are the card's, and without a card they
    raise before touching a process group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_production_mesh, make_test_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
