"""Cross-device scenario ("Beehive", SURVEY.md §2.11): port of
``fedml_tpu/cross_device/``.

Two planes. The legacy file-shipping plane (``server.py``,
``client_sim.py``, ``model_file.py``) mirrors the reference's .mnn round
trip: a server-side round loop over edge clients that exchange model
files. The connectionless check-in plane (``gateway.py``, ``device.py``,
``protocol.py``, ``driver.py``) is the churn-is-normal federation of a
registry-scale device population: devices check in, pull a round offer,
push one pairwise-masked delta and disappear; no heartbeats, no failure
detector, no per-device server state beyond a bounded round ledger.
"""

from .client_sim import EdgeClientSim  # noqa: F401
from .device import DeviceHost  # noqa: F401
from .driver import run_beehive_world  # noqa: F401
from .gateway import DeviceGateway  # noqa: F401
from .model_file import (  # noqa: F401
    model_bytes_to_params,
    params_to_model_bytes,
    read_model_file,
    write_model_file,
)
from .protocol import flat_dim, linear_template  # noqa: F401
from .server import (  # noqa: F401
    CrossDeviceAggregator,
    CrossDeviceServerManager,
    ServerEdge,
)


def fedavg_cross_device(args, device, dataset, model) -> "ServerEdge":
    """``server_mnn_api.fedavg_cross_device``'s analog: build and return
    the edge server (the caller calls ``.run()``)."""
    return ServerEdge(args, device, dataset, model)
