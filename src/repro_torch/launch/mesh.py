"""Production and test meshes over `torch.distributed`.

Functions, never module-level constants: importing this module touches
no process group. The caller owns the world: it starts the process
group (NCCL or gloo on real ranks, or the "fake" backend for a dry run
in one process) before it asks for a mesh, and these functions start
none of their own. `device=None` means the card and raises without one.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device
from repro_torch.models.sharding import MeshRules


def _mesh(shape: tuple, names: tuple, device) -> DeviceMesh:
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=names)


def make_production_mesh(multi_pod: bool = False, device=None) -> DeviceMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with `multi_pod`: the shapes `launch/cells.py`'s plans were sized
    for. Needs a world of 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device)


def rules_for(mesh: DeviceMesh) -> MeshRules:
    """FSDP over (pod,)data; tensor over model."""
    fsdp = ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
    return MeshRules(mesh=mesh, fsdp=fsdp, tensor="model")


def make_test_mesh(multi_pod: bool = False, data: int = 2, model: int = 2,
                   device=None) -> DeviceMesh:
    """A small mesh: (data, model), or (2, data, model) with `multi_pod`."""
    if multi_pod:
        return _mesh((2, data, model), ("pod", "data", "model"), device)
    return _mesh((data, model), ("data", "model"), device)
