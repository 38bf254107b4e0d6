"""Simulator dispatchers (port of ``fedml_tpu/simulation/simulator.py``).

``SimulatorSingleProcess``: one process, one card, the cohort trained
as one vmapped batch of clients. The mesh simulator arrives with the
multi-card slice.
"""

from __future__ import annotations

from .fedavg_api import FedAvgAPI, FedNovaAPI, FedOptAPI, FedProxAPI

_ALGORITHMS = {"FedAvg": FedAvgAPI, "FedProx": FedProxAPI, "FedOpt": FedOptAPI,
               "FedNova": FedNovaAPI}

# the JAX package's other algorithms, by the slice that brings them
_LATER = {
    **dict.fromkeys(
        ("HierFedAvg", "DSGD", "PushSum", "SFedAvg", "HSFedAvg", "FedGAN",
         "TurboAggregate", "SplitNN", "FedGKT", "VFL", "FedNAS"),
        "the remaining planes (queue A item 5)",
    ),
}


def _select_algorithm(args):
    name = getattr(args, "federated_optimizer", "FedAvg")
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
    def __init__(self, args, device, dataset, model) -> None:
        self.args = args
        cls = _select_algorithm(args)
        self.fl_trainer = cls(args, device, dataset, model)

    def run(self):
        return self.fl_trainer.train()
