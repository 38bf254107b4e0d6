"""Hierarchical server plane: topology planning + fabric addressing (port
of ``fedml_tpu/cross_silo/hierarchical/plane.py``; bitwise its plans).

``scale/tree.py`` folds through edge accumulators bitwise the flat fold
but **in one process**: the server stays a single-process ingestion
bottleneck at heavy traffic (the Smart-NIC diagnosis, PAPERS.md
2307.06561; FedML Parrot's hierarchical training, 2303.01778). This
plane promotes the edges to REAL ranks over the comm layer:

- the **root** is rank 0 of the *root fabric*; the E edges are ranks
  1..E of that fabric (they look like clients to the root's comm
  stack — ReliableChannel, FaultInjector, instrumentation all stack
  exactly as for a flat world);
- each **edge** is additionally rank 0 (the "server") of its own
  *edge fabric*, where its assigned clients connect as their GLOBAL
  ranks — clients run the stock ``FedMLClientManager`` completely
  unchanged, which is what routes their heartbeats client→edge;
- fabric identity per hop: LOCAL fabrics are named
  ``run_{run_id}`` (root) / ``run_{run_id}_edge{E}`` (edge E); gRPC
  fabrics take disjoint port blocks ``grpc_port_base + E *
  hier_port_stride``.

The client→edge **partition** is planned once per run with
``EdgeAggregationTree.assign_by_load`` (the boustrophedon deal
over per-client sample counts), so every process — launcher, root,
edges — derives the identical assignment from the same inputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

__all__ = [
    "edge_clients",
    "edge_fabric_run_id",
    "edge_port_base",
    "plan_edge_partition",
]


def plan_edge_partition(
    n_clients: int,
    edge_num: int,
    sizes: Optional[Sequence[float]] = None,
) -> Dict[int, int]:
    """Global client rank (1..N) -> edge rank (1..E), load-balanced.

    ``sizes`` are per-client workloads (sample counts) indexed by
    client rank - 1; without them every client weighs 1 and the deal
    degrades to the stable boustrophedon round-robin. Deterministic:
    every process in the world derives the same partition."""
    from ...scale.tree import EdgeAggregationTree

    n, e = int(n_clients), int(edge_num)
    if e < 1:
        raise ValueError(f"edge_num={e}: the edge plane needs >= 1 edge")
    if n < 1:
        raise ValueError(f"n_clients={n}: nothing to partition")
    load = list(sizes) if sizes is not None else [1] * n
    if len(load) != n:
        raise ValueError(
            f"sizes has {len(load)} entries for {n} clients"
        )
    by_index = EdgeAggregationTree.assign_by_load(load, e)
    return {idx + 1: edge + 1 for idx, edge in by_index.items()}


def edge_clients(partition: Dict[int, int]) -> Dict[int, List[int]]:
    """Invert a partition: edge rank -> sorted client ranks."""
    out: Dict[int, List[int]] = {}
    for rank, edge in partition.items():
        out.setdefault(int(edge), []).append(int(rank))
    return {e: sorted(rs) for e, rs in out.items()}


def edge_fabric_run_id(run_id, edge_rank: int) -> str:
    """The LOCAL fabric name / gRPC world id of edge ``edge_rank``'s
    client-facing hop."""
    return f"{run_id}_edge{int(edge_rank)}"


def edge_port_base(args, edge_rank: int) -> int:
    """gRPC port block for edge ``edge_rank``'s client fabric: each
    fabric binds ``port_base + rank``, so blocks are strided by
    ``hier_port_stride`` (which must exceed the largest global client
    rank — validated here, loudly, instead of colliding at bind)."""
    base = int(getattr(args, "grpc_port_base", 8890))
    stride = int(getattr(args, "hier_port_stride", 64) or 64)
    n_clients = int(getattr(args, "client_num_per_round", 0) or 0)
    if n_clients and stride <= n_clients:
        raise ValueError(
            f"hier_port_stride={stride} must exceed the client count "
            f"{n_clients}: edge fabrics bind port_base + global rank"
        )
    return base + int(edge_rank) * stride
