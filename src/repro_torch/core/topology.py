"""Cluster topology and bandwidth matrices.

The repair algorithms consume a directed bandwidth matrix BW[i, j] in MB/s
(paper notation "M/s"): the standalone rate of a single transfer i -> j.
Generators cover the paper's measured settings (Table I 4-node LAN, Table
III Aliyun 6-region WAN) plus synthetic heterogeneous clusters and a
TPU-pod-shaped ICI/DCN model for the checkpoint-repair deployment.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Cluster:
    """A set of storage nodes with named failure domains."""

    num_nodes: int
    names: tuple[str, ...] = ()

    def __post_init__(self):
        if self.names and len(self.names) != self.num_nodes:
            raise ValueError("names/num_nodes mismatch")

    def name(self, i: int) -> str:
        return self.names[i] if self.names else f"n{i + 1}"


# Paper Table I: measured LAN bandwidths (M/s) across nodes D3, P1, P2, P3.
TABLE1_NODES = ("D3", "P1", "P2", "P3")
TABLE1_BW = np.array(
    [
        # to:  D3   P1   P2   P3        from:
        [0.0, 4.0, 10.0, 7.0],        # D3
        [3.0, 0.0, 6.0, 8.0],         # P1
        [3.0, 10.0, 0.0, 5.0],        # P2
        [5.0, 5.0, 20.0, 0.0],        # P3
    ]
)

# Paper Table III: Aliyun ECS inter-region bandwidths (M/s).
ALIYUN_REGIONS = (
    "Beijing", "Zhangjiakou", "Shanghai", "Shenzhen", "HongKong", "Singapore"
)
ALIYUN_BW = np.array(
    [
        [0.0, 59.669, 39.587, 37.851, 32.156, 35.213],
        [67.321, 0.0, 44.126, 37.964, 22.315, 25.614],
        [35.123, 46.358, 0.0, 32.195, 36.665, 32.314],
        [25.674, 31.265, 34.321, 0.0, 59.362, 41.987],
        [26.646, 37.315, 32.158, 56.328, 0.0, 50.589],
        [20.347, 19.634, 21.365, 46.894, 38.234, 0.0],
    ]
)


def aliyun_matrix() -> tuple[Cluster, np.ndarray]:
    return Cluster(6, ALIYUN_REGIONS), ALIYUN_BW.copy()


def table1_matrix() -> tuple[Cluster, np.ndarray]:
    return Cluster(4, TABLE1_NODES), TABLE1_BW.copy()


def uniform_matrix(n: int, bw: float = 50.0) -> np.ndarray:
    m = np.full((n, n), float(bw))
    np.fill_diagonal(m, 0.0)
    return m


def heterogeneous_matrix(
    n: int, *, low: float = 5.0, high: float = 100.0, seed: int = 0
) -> np.ndarray:
    """Asymmetric uniform-random bandwidths, the paper's Mininet regime."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(low, high, size=(n, n))
    np.fill_diagonal(m, 0.0)
    return m


def tpu_pod_dcn_matrix(
    hosts_per_pod: int,
    num_pods: int,
    *,
    intra_bw: float = 400.0,
    inter_bw: float = 25.0,
    seed: int = 0,
    jitter: float = 0.3,
) -> tuple[Cluster, np.ndarray]:
    """Host-level network for EC-checkpoint repair on a multi-pod TPU cluster.

    Intra-pod host links ride the pod's data-center fabric (fast, stable-ish);
    inter-pod links ride shared DCN (slow, contended -> the paper's rapidly-
    changing regime). Bandwidths are per-host-pair effective rates in MB/s.
    """
    n = hosts_per_pod * num_pods
    rng = np.random.default_rng(seed)
    m = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            base = intra_bw if (i // hosts_per_pod == j // hosts_per_pod) else inter_bw
            m[i, j] = base * (1.0 + jitter * rng.uniform(-1.0, 1.0))
    names = tuple(
        f"pod{p}/host{h}" for p in range(num_pods) for h in range(hosts_per_pod)
    )
    return Cluster(n, names), m
