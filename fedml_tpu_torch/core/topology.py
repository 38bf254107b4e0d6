"""Topology managers (port of ``fedml_tpu/core/topology.py``).

Numpy copies, bitwise the JAX package's: the base class,
``EdgeTreeTopology`` (the two-tier aggregation tree the registry path's
edge tier folds through, ``scale/tree.py``), and the decentralized
topologies DSGD and PushSum gossip over: ``SymmetricTopologyManager``
(a Watts-Strogatz ring, row-stochastic) and ``AsymmetricTopologyManager``
(a directed ring with random extra out-links, column-stochastic).
``mixing_matrix(device=...)`` hands the weights to the card as float32,
as the JAX package casts them, so a gossip round is one product over the
stacked node axis.
"""

from __future__ import annotations

import abc
from typing import List

import numpy as np
import torch

from ..device import DeviceLike, get_device


class BaseTopologyManager(abc.ABC):
    """(base_topology_manager.py:1-23)"""

    @abc.abstractmethod
    def generate_topology(self) -> None:
        ...

    @abc.abstractmethod
    def get_in_neighbor_idx_list(self, node_index: int) -> List[int]:
        ...

    @abc.abstractmethod
    def get_out_neighbor_idx_list(self, node_index: int) -> List[int]:
        ...

    def get_in_neighbor_weights(self, node_index: int):
        return self.topology[node_index]

    def get_out_neighbor_weights(self, node_index: int):
        return self.topology[:, node_index]


def _watts_strogatz_ring(n: int, k: int, beta: float, rng: np.random.RandomState):
    """Undirected Watts-Strogatz adjacency: a ring lattice with k
    nearest neighbors, each edge rewired with probability beta (the
    JAX package's draw order, so the same seed rewires the same
    edges)."""
    adj = np.zeros((n, n), dtype=bool)
    for i in range(n):
        for j in range(1, k // 2 + 1):
            adj[i, (i + j) % n] = adj[(i + j) % n, i] = True
    for i in range(n):
        for j in range(1, k // 2 + 1):
            if rng.rand() < beta:
                old = (i + j) % n
                candidates = [c for c in range(n) if c != i and not adj[i, c]]
                if candidates:
                    new = candidates[rng.randint(len(candidates))]
                    adj[i, old] = adj[old, i] = False
                    adj[i, new] = adj[new, i] = True
    return adj


def _mixing(topology: np.ndarray, device: DeviceLike) -> torch.Tensor:
    return torch.as_tensor(topology, dtype=torch.float32, device=get_device(device))


class SymmetricTopologyManager(BaseTopologyManager):
    """(symmetric_topology_manager.py:7-82) ``neighbor_num`` undirected
    neighbors per node, uniform row-normalized weights."""

    def __init__(self, n: int, neighbor_num: int = 2, beta: float = 0.0, seed: int = 0):
        self.n = int(n)
        self.neighbor_num = int(neighbor_num)
        self.beta = float(beta)
        self.seed = int(seed)
        self.topology: np.ndarray = np.zeros((n, n))

    def generate_topology(self) -> None:
        rng = np.random.RandomState(self.seed)
        adj = _watts_strogatz_ring(self.n, self.neighbor_num, self.beta, rng)
        np.fill_diagonal(adj, True)
        w = adj.astype(np.float64)
        self.topology = w / w.sum(axis=1, keepdims=True)

    def get_in_neighbor_idx_list(self, node_index: int) -> List[int]:
        return [j for j in range(self.n) if self.topology[node_index, j] > 0]

    def get_out_neighbor_idx_list(self, node_index: int) -> List[int]:
        return [j for j in range(self.n) if self.topology[j, node_index] > 0]

    def mixing_matrix(self, device: DeviceLike = "cuda") -> torch.Tensor:
        return _mixing(self.topology, device)


class EdgeTreeTopology(BaseTopologyManager):
    """Two-tier aggregation tree: node 0 is the root (global server),
    nodes ``1..edge_num`` are edge aggregators; every edge's single
    out-neighbor is the root and the root's in-neighbors are all edges.

    This is the hierarchical (edge-aggregator) topology the planet-
    scale population plane (``fedml_tpu/scale/tree.py``) folds through:
    clients are leaves attached to edges (leaf assignment lives with
    the tree, which balances it by client load via
    ``core/scheduler.balance_clients_across_shards``), edges reduce
    their subtree, the root reduces the edges. The mixing matrix is the
    root's weighted gather row (uniform over edges) — a star, the
    2-level special case of the reference's hierarchical scenario.
    """

    def __init__(self, edge_num: int):
        if edge_num < 1:
            raise ValueError(f"edge_num={edge_num}: must be >= 1")
        self.edge_num = int(edge_num)
        self.n = self.edge_num + 1  # root + edges
        self.topology: np.ndarray = np.zeros((self.n, self.n))

    def generate_topology(self) -> None:
        w = np.zeros((self.n, self.n))
        w[0, 1:] = 1.0 / self.edge_num  # root gathers every edge
        for e in range(1, self.n):
            w[e, e] = 1.0  # an edge's in-flow is its own subtree fold
        self.topology = w

    def get_in_neighbor_idx_list(self, node_index: int) -> List[int]:
        if node_index == 0:
            return list(range(1, self.n))
        return []

    def get_out_neighbor_idx_list(self, node_index: int) -> List[int]:
        return [0] if node_index != 0 else []


class AsymmetricTopologyManager(BaseTopologyManager):
    """(asymmetric_topology_manager.py) a directed ring + random extra
    out-links, out-degree normalized (column-stochastic, for PushSum)."""

    def __init__(self, n: int, neighbor_num: int = 2, seed: int = 0):
        self.n = int(n)
        self.neighbor_num = int(neighbor_num)
        self.seed = int(seed)
        self.topology: np.ndarray = np.zeros((n, n))

    def generate_topology(self) -> None:
        """``topology[i, j]`` weights the directed edge j -> i (a row is
        the receiver's in-weights, as the mixing product
        ``theta_i <- sum_j W[i, j] theta_j`` reads it). Node i sends to
        i + 1 and to ``neighbor_num`` random extras; each sender splits
        its mass over its out-neighbors, so the columns sum to 1 and
        ``sum(W @ mass) == sum(mass)``."""
        rng = np.random.RandomState(self.seed)
        adj = np.eye(self.n, dtype=bool)
        for i in range(self.n):
            adj[(i + 1) % self.n, i] = True
            extra = rng.choice(self.n, self.neighbor_num, replace=False)
            for e in extra:
                adj[e, i] = True
        w = adj.astype(np.float64)
        self.topology = w / w.sum(axis=0, keepdims=True)

    def get_in_neighbor_idx_list(self, node_index: int) -> List[int]:
        return [j for j in range(self.n) if self.topology[node_index, j] > 0]

    def get_out_neighbor_idx_list(self, node_index: int) -> List[int]:
        return [j for j in range(self.n) if self.topology[j, node_index] > 0]

    def mixing_matrix(self, device: DeviceLike = "cuda") -> torch.Tensor:
        return _mixing(self.topology, device)
