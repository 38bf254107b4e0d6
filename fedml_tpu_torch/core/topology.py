"""Topology managers (port subset of ``fedml_tpu/core/topology.py``).

A numpy copy of the base class and ``EdgeTreeTopology``, the two-tier
aggregation tree the registry path's edge tier folds through
(``scale/tree.py``); the decentralized topologies (symmetric and
asymmetric rings with their mixing matrices) come with the
decentralized simulators (ROADMAP.md, queue A item 8).
"""

from __future__ import annotations

import abc
from typing import List

import numpy as np


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
