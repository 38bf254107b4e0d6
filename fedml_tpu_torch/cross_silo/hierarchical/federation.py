"""Hierarchical server plane facades + local world launcher (port of
``fedml_tpu/cross_silo/hierarchical/federation.py``).

The three-tier federation (clients → edge aggregators → root) as
user-facing objects mirroring the flat ``cross_silo.Server`` /
``Client`` facades:

- :class:`HierRoot` — rank 0 of the root fabric (the global model,
  selection, merge-and-finalize, quarantine/death decisions);
- :class:`HierEdge` — one edge aggregator process (rank E of the root
  fabric, server of its own client fabric);
- clients are the UNCHANGED flat ``cross_silo.Client`` — point them at
  their edge's fabric with :func:`prepare_client_args` and they never
  know an edge tier exists.

Enabled by ``edge_plane: ranks`` + ``edge_num: E`` (arguments.py). The
client→edge partition is planned identically in every process from the
same inputs (:func:`hier_partition`); pass an explicit ``partition``
to any facade to override.

``run_local_hier_world`` wires a whole LOCAL world as threads in one
process — the test and chip-smoke harness, mirroring the thread worlds the flat
scenario tests use.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from ... import constants
from .. import check_device
from ..horizontal.fedml_aggregator import FedMLAggregator
from .edge_server_manager import EdgeServerManager
from .plane import (
    edge_clients,
    edge_fabric_run_id,
    edge_port_base,
    plan_edge_partition,
)
from .root_server_manager import RootServerManager

__all__ = [
    "HierEdge",
    "HierRoot",
    "hier_partition",
    "prepare_client_args",
    "run_local_hier_world",
]


def _partition_sizes(args, dataset):
    """Per-client load for ``assign_by_load``: the silo sample counts,
    when every client maps 1:1 onto a silo (the cross-silo common
    case); otherwise uniform. Must be a deterministic function of
    (args, dataset) — every process derives the same partition."""
    n = int(args.client_num_per_round)
    if (
        dataset is not None
        and getattr(dataset, "packed_num_samples", None) is not None
        and int(args.client_num_in_total) == n
        and len(dataset.packed_num_samples) >= n
    ):
        return [float(s) for s in dataset.packed_num_samples[:n]]
    return None


def hier_partition(args, dataset=None) -> Dict[int, int]:
    """Global client rank (1..N) -> edge rank (1..E) for this run."""
    return plan_edge_partition(
        int(args.client_num_per_round),
        int(args.edge_num),
        sizes=_partition_sizes(args, dataset),
    )


def prepare_client_args(args, partition: Dict[int, int]):
    """Point a CLIENT's args at its edge's fabric (in place): the stock
    flat ``Client`` then connects to the edge as if it were the server.
    Returns the args for chaining."""
    rank = int(getattr(args, "rank", 0))
    edge = partition.get(rank)
    if edge is None:
        raise ValueError(
            f"client rank {rank} is not in the edge partition "
            f"(clients 1..{len(partition)})"
        )
    if str(getattr(args, "backend", "LOCAL")).upper() == (
        constants.COMM_BACKEND_GRPC
    ):
        args.grpc_port_base = edge_port_base(args, edge)
    args.run_id = edge_fabric_run_id(getattr(args, "run_id", "0"), edge)
    return args


class HierRoot:
    def __init__(
        self,
        args,
        device,
        dataset,
        model,
        server_aggregator=None,
        partition: Optional[Dict[int, int]] = None,
    ) -> None:
        check_device(device, model)
        self.args = args
        self.partition = partition or hier_partition(args, dataset)
        aggregator = FedMLAggregator(
            args,
            model,
            test_data=dataset.test_data_global if dataset else None,
            server_aggregator=server_aggregator,
        )
        self.aggregator = aggregator
        self.manager = RootServerManager(
            args,
            aggregator,
            self.partition,
            backend=getattr(args, "backend", constants.COMM_BACKEND_LOCAL),
        )

    def run(self) -> None:
        self.manager.run()
        com = self.manager.com_manager
        if hasattr(com, "destroy_fabric"):
            com.destroy_fabric()


class HierEdge:
    def __init__(
        self,
        args,
        device,
        dataset,
        model,
        partition: Optional[Dict[int, int]] = None,
    ) -> None:
        check_device(device, model)
        self.args = args
        edge_rank = int(getattr(args, "rank", 1))
        if edge_rank < 1:
            raise ValueError("edge rank must be >= 1 (0 is the root)")
        self.partition = partition or hier_partition(args, dataset)
        my_clients = edge_clients(self.partition).get(edge_rank, [])
        # the edge's aggregator is the stock streaming FedMLAggregator
        # (fold + defenses + screen); it never builds the in-process
        # tree (edge_plane=ranks suppresses it) and never evaluates
        aggregator = FedMLAggregator(args, model, test_data=None)
        self.aggregator = aggregator
        self.manager = EdgeServerManager(
            args,
            aggregator,
            edge_rank,
            my_clients,
            backend=getattr(args, "backend", constants.COMM_BACKEND_LOCAL),
        )

    def run(self) -> None:
        self.manager.run()
        com = self.manager.com_manager
        if hasattr(com, "destroy_fabric"):
            com.destroy_fabric()


def run_local_hier_world(
    mk: Callable,
    n_clients: int,
    edge_num: int,
    join_timeout_s: float = 180.0,
    client_wrapper: Optional[Callable] = None,
    edge_wrapper: Optional[Callable] = None,
    on_world: Optional[Callable] = None,
):
    """Run a full LOCAL three-tier world as threads in one process.

    ``mk(role, rank)`` -> ``(args, dataset, model)`` with ``args.rank``
    already set — role is ``"root"`` (rank 0), ``"edge"`` (1..E) or
    ``"client"`` (1..N). Client args are re-pointed at their edge's
    fabric here. ``client_wrapper(rank, client)`` / ``edge_wrapper(
    rank, edge)`` may decorate the thread targets (kill/restart
    choreography); ``on_world(world)`` runs after construction, before
    any thread starts. Returns the dict world: root/edges/clients/
    partition/threads (joined)."""
    from .. import Client

    a0, ds0, m0 = mk("root", 0)
    root = HierRoot(a0, m0.device, ds0, m0)
    partition = root.partition
    edges = {}
    for e in sorted(edge_clients(partition)):
        ae, dse, me = mk("edge", e)
        edges[e] = HierEdge(ae, me.device, dse, me, partition=partition)
    clients = {}
    for r in range(1, int(n_clients) + 1):
        ac, dsc, mc = mk("client", r)
        prepare_client_args(ac, partition)
        clients[r] = Client(ac, mc.device, dsc, mc)
    world = {
        "root": root,
        "edges": edges,
        "clients": clients,
        "partition": partition,
        "threads": [],
    }
    if on_world is not None:
        on_world(world)
    threads = []
    for e, edge in edges.items():
        target = edge.run if edge_wrapper is None else edge_wrapper(e, edge)
        threads.append(
            threading.Thread(target=target, daemon=True, name=f"hier-edge{e}")
        )
    for r, c in clients.items():
        target = c.run if client_wrapper is None else client_wrapper(r, c)
        threads.append(
            threading.Thread(target=target, daemon=True, name=f"hier-c{r}")
        )
    for t in threads:
        t.start()
    world["threads"] = threads
    root.run()  # blocks until the final round
    for t in threads:
        t.join(timeout=join_timeout_s)
    hung = [t.name for t in threads if t.is_alive()]
    if hung:
        raise RuntimeError(f"hier world: threads hung: {hung}")
    return world
