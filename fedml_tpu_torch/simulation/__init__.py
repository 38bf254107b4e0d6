"""Simulation scenario: every algorithm of the JAX package's registry and their dispatcher."""

from .decentralized import DecentralizedDSGDAPI, DecentralizedPushSumAPI  # noqa: F401
from .defenses import HSFedAvgAPI, SFedAvgAPI  # noqa: F401
from .fedavg_api import FedAvgAPI, FedNovaAPI, FedOptAPI, FedProxAPI  # noqa: F401
from .fedgan import FedGANAPI  # noqa: F401
from .fednas import FedNASAPI  # noqa: F401
from .hierarchical_fl import HierarchicalFLAPI  # noqa: F401
from .simulator import SimulatorMesh, SimulatorSingleProcess  # noqa: F401
from .split_learning import FedGKTAPI, SplitNNAPI, VFLAPI  # noqa: F401
from .turboaggregate import TurboAggregateAPI  # noqa: F401
