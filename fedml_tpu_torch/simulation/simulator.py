"""Simulator dispatchers (port of ``fedml_tpu/simulation/simulator.py``).

``SimulatorSingleProcess``: one process, one card, the cohort trained
as one vmapped batch of clients, with the custom operators of
``core/frame.py`` passed through to the FedAvg-family engines. The mesh
simulator arrives with the multi-card slice.
"""

from __future__ import annotations

from .defenses import HSFedAvgAPI, SFedAvgAPI
from .fedavg_api import FedAvgAPI, FedNovaAPI, FedOptAPI, FedProxAPI

_ALGORITHMS = {"FedAvg": FedAvgAPI, "FedProx": FedProxAPI, "FedOpt": FedOptAPI,
               "FedNova": FedNovaAPI, "SFedAvg": SFedAvgAPI, "HSFedAvg": HSFedAvgAPI}

# the JAX package's other algorithms, by the slice that brings them
_LATER = dict.fromkeys(
    ("HierFedAvg", "DSGD", "PushSum", "TurboAggregate", "FedGAN", "SplitNN", "FedGKT",
     "VFL", "FedNAS"),
    "the other simulation algorithms (queue A item 8)",
)

# the algorithms whose engines take custom operators, in the JAX package
_OPERATOR_FAMILY = ("FedAvg", "FedProx", "FedOpt", "FedNova", "HierFedAvg")


def _operator_kwargs(name: str, client_trainer, server_aggregator) -> dict:
    """The operator seam's passthrough. An algorithm outside the FedAvg
    family has another operator boundary and refuses custom operators,
    as in the JAX package, rather than ignoring them."""
    if client_trainer is None and server_aggregator is None:
        return {}
    if name not in _OPERATOR_FAMILY:
        raise ValueError(
            f"custom client_trainer/server_aggregator is not supported by {name}; "
            "supported by the FedAvg family (FedAvg/FedProx/FedOpt/FedNova/HierFedAvg)"
        )
    return {"client_trainer": client_trainer, "server_aggregator": server_aggregator}


def _select_algorithm(name: str):
    if name in _LATER:
        raise NotImplementedError(
            f"federated_optimizer {name!r} is not ported to PyTorch yet; it "
            f"arrives with {_LATER[name]} (ROADMAP.md, queue A)"
        )
    if name not in _ALGORITHMS:
        raise ValueError(
            f"federated_optimizer {name!r} not supported; have "
            f"{sorted(_ALGORITHMS) + sorted(_LATER)}"
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
