"""Simulator dispatchers (port of ``fedml_tpu/simulation/simulator.py``).

``SimulatorSingleProcess``: one process, one card, every algorithm of
the JAX package's registry (the FedAvg family, HierFedAvg, DSGD and
PushSum, the defenses, FedGAN, TurboAggregate, SplitNN, FedGKT, VFL and
FedNAS), with the custom operators of ``core/frame.py`` passed through
to the FedAvg-family engines.

``SimulatorMesh``: the same algorithms over a mesh of ranks (one process
a rank, in the caller's process group), both of the JAX package's
vocabularies, picked by ``args.mesh_shape``:

- fed ``{data[, fsdp]}`` (``parallel/layout.py``): the cohort over
  ``data``, the params fsdp-sharded at rest, the plain FedAvg/FedProx
  aggregation through the exact fold, bitwise the same for every mesh
  shape; an explicit shape smaller than the world runs on the prefix of
  its ranks, and the ranks past it train nothing and return the same
  final stats;
- legacy ``{clients[, data]}``: the cohort over ``clients``, the params
  whole on every rank, the weighted average; a ``data`` axis splits each
  batch's examples over its ranks, a client's gradient summed over them
  (``core/local_trainer.py``).

The FedAvg family runs on the mesh (``FedAvgAPI.attach_mesh``); DSGD and
PushSum refuse it, as in the JAX package; the algorithms with loops of
their own (FedGAN, FedNAS, SplitNN, FedGKT, VFL) take no mesh there
either and run whole on every rank.
"""

from __future__ import annotations

import torch.distributed as dist

from .decentralized import DecentralizedDSGDAPI, DecentralizedPushSumAPI
from .defenses import HSFedAvgAPI, SFedAvgAPI
from .fedavg_api import FedAvgAPI, FedNovaAPI, FedOptAPI, FedProxAPI
from .fedgan import FedGANAPI
from .fednas import FedNASAPI
from .hierarchical_fl import HierarchicalFLAPI
from .split_learning import FedGKTAPI, SplitNNAPI, VFLAPI
from .turboaggregate import TurboAggregateAPI

_ALGORITHMS = {
    "FedAvg": FedAvgAPI, "FedProx": FedProxAPI, "FedOpt": FedOptAPI, "FedNova": FedNovaAPI,
    "HierFedAvg": HierarchicalFLAPI, "DSGD": DecentralizedDSGDAPI,
    "PushSum": DecentralizedPushSumAPI, "SFedAvg": SFedAvgAPI, "HSFedAvg": HSFedAvgAPI,
    "FedGAN": FedGANAPI, "TurboAggregate": TurboAggregateAPI, "SplitNN": SplitNNAPI,
    "FedGKT": FedGKTAPI, "VFL": VFLAPI, "FedNAS": FedNASAPI,
}

# the algorithms whose engines take custom operators, in the JAX package
_OPERATOR_FAMILY = ("FedAvg", "FedProx", "FedOpt", "FedNova", "HierFedAvg")


def _operator_kwargs(name: str, client_trainer, server_aggregator) -> dict:
    """The operator seam's passthrough. An algorithm outside the FedAvg
    family has another operator boundary and refuses custom operators,
    as in the JAX package (its message names the API class), rather than
    ignoring them."""
    if client_trainer is None and server_aggregator is None:
        return {}
    if name not in _OPERATOR_FAMILY:
        cls = _ALGORITHMS[name].__name__ if name in _ALGORITHMS else name
        raise ValueError(
            f"custom client_trainer/server_aggregator is not supported by {cls}; "
            "supported by the FedAvg family (FedAvg/FedProx/FedOpt/FedNova/HierFedAvg)"
        )
    return {"client_trainer": client_trainer, "server_aggregator": server_aggregator}


def _select_algorithm(name: str):
    if name not in _ALGORITHMS:
        raise ValueError(
            f"federated_optimizer {name!r} not supported; have {sorted(_ALGORITHMS)}"
        )
    return _ALGORITHMS[name]


class SimulatorSingleProcess:
    def __init__(self, args, device, dataset, model, client_trainer=None,
                 server_aggregator=None) -> None:
        self.args = args
        name = getattr(args, "federated_optimizer", "FedAvg")
        operators = _operator_kwargs(name, client_trainer, server_aggregator)
        cls = _select_algorithm(name)
        self.device = device
        self.fl_trainer = cls(args, device, dataset, model, **operators)

    def run(self):
        from ..core.tracking import device_trace

        with device_trace(self.args, self.device):
            return self.fl_trainer.train()


class SimulatorMesh:
    """Client-parallel FL over a mesh of the process group's ranks
    (``mesh``, or one built from ``args.mesh_shape``: the fed vocabulary
    when it names ``fsdp``, or ``data`` without ``clients``)."""

    def __init__(self, args, device, dataset, model, mesh=None, client_trainer=None,
                 server_aggregator=None) -> None:
        from ..device import get_device
        from ..parallel.layout import build_fed_mesh, cohort_axis_size, fed_mesh_shape, is_fed_mesh
        from ..parallel.mesh import build_sim_mesh

        self.args = args
        dev = get_device(device)
        if mesh is None:
            shape = getattr(args, "mesh_shape", None)
            world = dist.get_world_size()
            mesh = (build_fed_mesh(shape, world, dev.type) if fed_mesh_shape(shape)
                    else build_sim_mesh(shape, world, dev.type))
        self.mesh = mesh
        fed = is_fed_mesh(mesh)
        n_client_shards = cohort_axis_size(mesh)
        if int(args.client_num_per_round) % n_client_shards != 0:
            axis = "data" if fed else "clients"
            raise ValueError(
                f"client_num_per_round={args.client_num_per_round} must be a "
                f"multiple of the mesh {axis!r} axis ({n_client_shards})"
            )
        name = getattr(args, "federated_optimizer", "FedAvg")
        operators = _operator_kwargs(name, client_trainer, server_aggregator)
        cls = _select_algorithm(name)
        if not getattr(cls, "supports_mesh", True):
            raise ValueError(
                f"{cls.__name__} does not support the MESH backend yet; "
                "run it under the single-process simulator"
            )
        self.device = dev
        self.fl_trainer = cls(args, device, dataset, model, **operators)
        if isinstance(self.fl_trainer, FedAvgAPI) and mesh.member:
            self.fl_trainer.attach_mesh(mesh)

    def run(self):
        """Train on the mesh's ranks. A rank outside a prefix sub-mesh
        trains nothing and returns the stats of the mesh's first rank,
        broadcast once at the end of the run."""
        from ..core.tracking import device_trace

        stats = None
        if self.mesh.member:
            with device_trace(self.args, self.device):
                stats = self.fl_trainer.train()
        if self.mesh.group is None:
            return stats
        box = [stats]
        dist.broadcast_object_list(box, src=self.mesh.ranks[0])
        return box[0]
