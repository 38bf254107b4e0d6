"""Hierarchical cross-silo ("Octopus", SURVEY.md §2.10 hierarchical): port
of ``fedml_tpu/cross_silo/hierarchical/``.

Two hierarchies live here:

- **silos that are process groups** (the reference's scenario): each FL
  client is itself a data-parallel training group. The reference nests a
  PyTorch-DDP process group inside every silo
  (``cross_silo/hierarchical/trainer_dist_adapter.py:40-141`` wraps the
  model in DDP, ``process_group_manager.py:6-43`` builds NCCL/GLOO
  groups, ``client_master_manager.py:48-269`` speaks the FL protocol
  outward and broadcasts inward, ``client_slave_manager.py:5-54`` blocks
  on the broadcast). Here the silo's compute group is a
  ``torch.distributed`` group (gloo on the CPU, NCCL on the card) whose
  ranks split each batch's examples and all-reduce the gradient sums
  (``TrainerDistAdapter``); the master speaks the horizontal protocol to
  the server and ships ``[round_idx, params, client_index]`` to the
  slaves over the silo's control fabric, and the slaves join the same
  steps. A one-rank silo takes no group and is the plain trainer.
- **the edge tier over ranks** (``edge_plane: ranks``): edge aggregators
  as real ranks between the clients and the root (``EdgeServerManager``,
  ``RootServerManager``, ``HierRoot`` / ``HierEdge``), bitwise the flat
  server.
"""

from __future__ import annotations

from .client_master_manager import ClientMasterManager
from .client_slave_manager import ClientSlaveManager
from .edge_server_manager import EdgeServerManager
from .federation import (
    HierEdge,
    HierRoot,
    hier_partition,
    prepare_client_args,
    run_local_hier_world,
)
from .launcher import launch_silo_processes
from .plane import (
    edge_clients,
    edge_fabric_run_id,
    edge_port_base,
    plan_edge_partition,
)
from .process_group_manager import (
    ProcessGroupManager,
    build_silo_fabric,
    ensure_distributed_initialized,
    silo_fabric_name,
)
from .root_server_manager import RootServerManager
from .trainer_dist_adapter import TrainerDistAdapter

__all__ = [
    "ClientMasterManager",
    "ClientSlaveManager",
    "EdgeServerManager",
    "HierEdge",
    "HierRoot",
    "ProcessGroupManager",
    "RootServerManager",
    "TrainerDistAdapter",
    "HierarchicalClient",
    "build_silo_fabric",
    "edge_clients",
    "edge_fabric_run_id",
    "edge_port_base",
    "ensure_distributed_initialized",
    "hier_partition",
    "launch_silo_processes",
    "plan_edge_partition",
    "prepare_client_args",
    "run_local_hier_world",
    "silo_fabric_name",
]


class HierarchicalClient:
    """Facade: one process of one silo. Role (master/slave) follows
    ``proc_rank_in_silo`` exactly as the reference forks on
    ``process_id`` (``fedml_hierarchical_api.py``). ``model`` lives on
    the process's device (the group's backend follows it)."""

    def __init__(self, args, device, dataset, model, client_trainer=None) -> None:
        from .. import check_device

        check_device(device, model)
        self.args = args
        pg = ProcessGroupManager(args, device=model.device)
        trainer = TrainerDistAdapter(args, dataset, model, pg, client_trainer=client_trainer)
        self.trainer = trainer
        if pg.is_master():
            from ... import constants
            from .. import _world_size

            rank = int(getattr(args, "rank", 1))
            if rank < 1:
                raise ValueError("silo FL rank must be >= 1 (0 is the server)")
            self.manager = ClientMasterManager(
                args,
                trainer,
                pg,
                rank=rank,
                size=_world_size(args),
                backend=getattr(args, "backend", constants.COMM_BACKEND_LOCAL),
            )
        else:
            self.manager = ClientSlaveManager(args, trainer, pg)

    def run(self) -> None:
        self.manager.run()
