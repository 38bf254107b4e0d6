"""Simulation scenario: the FedAvg-family APIs and their dispatcher."""

from .fedavg_api import FedAvgAPI, FedNovaAPI, FedOptAPI, FedProxAPI  # noqa: F401
from .simulator import SimulatorSingleProcess  # noqa: F401
