"""Simulator dispatchers (port of ``fedml_tpu/simulation/simulator.py``).

``SimulatorSingleProcess``: one process, one card, every algorithm of
the JAX package's registry (the FedAvg family, HierFedAvg, DSGD and
PushSum, the defenses, FedGAN, TurboAggregate, SplitNN, FedGKT, VFL and
FedNAS), with the custom operators of ``core/frame.py`` passed through
to the FedAvg-family engines. The mesh simulator arrives with the
multi-card slice.
"""

from __future__ import annotations

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
        self.fl_trainer = cls(args, device, dataset, model, **operators)

    def run(self):
        return self.fl_trainer.train()
