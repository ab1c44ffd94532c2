"""Elastic re-meshing after host/pod loss.

Policy: the tensor axis is sacred (intra-node links); capacity loss
shrinks the data axis (drop whole data-rows of the mesh) or drops a pod.
Training resumes from the latest EC checkpoint with the global batch
either kept (more grad accumulation) or scaled down proportionally.

A mesh here is a `DeviceMesh`; the shrunk one holds the kept ranks in
the reference's order and is a sub-mesh of the same world (every rank of
the world calls these functions; a rank outside the new mesh holds no
shard of it).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import tree


def _ranks(mesh: DeviceMesh) -> np.ndarray:
    return mesh.mesh.cpu().numpy()


def _new_mesh(mesh: DeviceMesh, ranks: np.ndarray) -> DeviceMesh:
    return DeviceMesh(mesh.device_type, torch.from_numpy(ranks.copy()),
                      mesh_dim_names=mesh.mesh_dim_names)


def shrink_mesh(mesh: DeviceMesh, lost_data_rows: int) -> DeviceMesh:
    """Drop `lost_data_rows` rows of the data axis, keep other axes."""
    names = tuple(mesh.mesh_dim_names)
    if "data" not in names:
        raise ValueError("mesh has no data axis")
    ranks = _ranks(mesh)
    data_dim = names.index("data")
    new_data = ranks.shape[data_dim] - lost_data_rows
    if new_data < 1:
        raise ValueError("cannot shrink data axis below 1")
    idx = [slice(None)] * ranks.ndim
    idx[data_dim] = slice(0, new_data)
    return _new_mesh(mesh, ranks[tuple(idx)])


def drop_pod(mesh: DeviceMesh, pod: int) -> DeviceMesh:
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        raise ValueError("mesh has no pod axis")
    pod_dim = names.index("pod")
    ranks = np.delete(_ranks(mesh), pod, axis=pod_dim)
    if ranks.shape[pod_dim] == 0:
        raise ValueError("cannot drop the last pod")
    return _new_mesh(mesh, ranks)


def elastic_data_size(global_batch: int, old_hosts: int,
                      new_hosts: int) -> int:
    """Keep per-host batch constant; shrink global batch proportionally
    (rounded to a multiple of new_hosts)."""
    per = global_batch // old_hosts
    return max(per * new_hosts, new_hosts)


def reshard_state(state, mesh: DeviceMesh, shardings):
    """Re-place a (host-local) state tree onto a new mesh: each leaf
    becomes a DTensor with the placements of `shardings` (a tree of one
    structure, e.g. `tree_shardings` of the new mesh's rules), cut from
    the whole value every rank holds, with no communication. A DTensor
    leaf is gathered whole first (on its old mesh). `shardings=None`
    returns the state as it is."""
    if shardings is None:
        return state

    def place(leaf, placements):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        return distribute_tensor(leaf, mesh, placements, src_data_rank=None)

    return tree.map(place, state, shardings)
