"""Simulation scenario: the FedAvg-family APIs, the fork's defenses and their dispatcher."""

from .defenses import HSFedAvgAPI, SFedAvgAPI  # noqa: F401
from .fedavg_api import FedAvgAPI, FedNovaAPI, FedOptAPI, FedProxAPI  # noqa: F401
from .simulator import SimulatorSingleProcess  # noqa: F401
