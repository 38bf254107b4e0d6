"""Horizontal cross-silo FL (reference: ``python/fedml/cross_silo/horizontal/``)."""

from .fedml_aggregator import FedMLAggregator  # noqa: F401
from .fedml_client_manager import FedMLClientManager, FedMLTrainer  # noqa: F401
from .fedml_server_manager import FedMLServerManager  # noqa: F401
