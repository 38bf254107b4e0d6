"""Cross-silo scenario ("Octopus", SURVEY.md §2.10): port of
``fedml_tpu/cross_silo/``.

Facades mirroring ``python/fedml/cross_silo/client.py:4-22`` /
``server.py``: a ``Server`` (rank 0) and N silo ``Client``s (ranks
1..N) speaking the 3-message FedAvg protocol over the port's comm layer
(in-process queues, TRPC, gRPC or MQTT). The presence handshake,
silo-index indirection and round loop live in ``horizontal/``; silos
that are process groups (``HierarchicalClient``) and the edge tier over
ranks in ``hierarchical/``.

Each facade takes the model it runs: ``FedModel.apply`` loads the
params into the module for the call, so two ranks that are threads of
one process must never share one module. Each runs where its model lies,
and its ``device`` must name that place: a facade given another refuses
to start rather than move tensors between the host and the card.
"""

from __future__ import annotations

import torch

from .. import constants
from .horizontal.fedml_aggregator import FedMLAggregator
from .horizontal.fedml_client_manager import FedMLClientManager, FedMLTrainer
from .horizontal.fedml_server_manager import FedMLServerManager

__all__ = ["Client", "Server", "HierarchicalClient"]


def __getattr__(name):
    # lazy: the hierarchical package pulls in torch.distributed; keep the
    # horizontal import path light
    if name == "HierarchicalClient":
        from .hierarchical import HierarchicalClient

        return HierarchicalClient
    raise AttributeError(name)


def _world_size(args) -> int:
    return int(args.client_num_per_round) + 1


def check_device(device, model) -> None:
    """Raise unless ``device`` names where ``model`` lies (``"cuda"``
    matches any card)."""
    have = model.device
    want = torch.device(device) if device is not None else None
    if want is None or want.type != have.type or want.index not in (None, have.index):
        raise ValueError(f"the model lies on {have}; the facade was given device {device!r}")


class Server:
    def __init__(self, args, device, dataset, model, server_aggregator=None) -> None:
        check_device(device, model)
        self.args = args
        self.aggregator = FedMLAggregator(
            args,
            model,
            test_data=dataset.test_data_global if dataset else None,
            server_aggregator=server_aggregator,
        )
        self.manager = FedMLServerManager(
            args,
            self.aggregator,
            rank=0,
            size=_world_size(args),
            backend=getattr(args, "backend", constants.COMM_BACKEND_LOCAL),
        )

    def run(self):
        """Serve the federation to its end; the last evaluated round's
        stats (None without test data)."""
        self.manager.run()
        com = self.manager.com_manager
        if hasattr(com, "destroy_fabric"):
            com.destroy_fabric()
        return getattr(self.aggregator, "last_stats", None)


class Client:
    def __init__(self, args, device, dataset, model, client_trainer=None) -> None:
        check_device(device, model)
        self.args = args
        rank = int(getattr(args, "rank", 1))
        if rank < 1:
            raise ValueError("cross-silo client rank must be >= 1 (0 is the server)")
        self.trainer = FedMLTrainer(args, dataset, model, client_trainer=client_trainer)
        self.manager = FedMLClientManager(
            args,
            self.trainer,
            rank=rank,
            size=_world_size(args),
            backend=getattr(args, "backend", constants.COMM_BACKEND_LOCAL),
        )

    def run(self) -> None:
        self.manager.run()
