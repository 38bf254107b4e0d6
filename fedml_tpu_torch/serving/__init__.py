"""Serving plane of the port (of ``fedml_tpu/serving``).

- ``ModelEndpoint`` — versioned params on the device; hot swaps are
  atomic and reject params of another shape, dtype or device;
- ``MeshModelEndpoint`` — the same endpoint over the named (data, fsdp)
  mesh of the process group: params at rest in their fsdp shards, rank
  0 serving and the other ranks following its ordered channel;
- ``ServingEngine`` — bounded queue, continuous micro-batching into
  pow2 buckets, deadline/queue-full load shedding;
- ``ServingFleet`` / ``FleetFrontend`` — N endpoints behind one
  load-aware, SLO-shedding frontend (``core/scheduler.assign_by_load``
  routing, counted failover);
- ``ServingFrontend`` / ``ServingClient`` — the request/response pair
  over the LOCAL, TRPC or gRPC comm backends
  (``python -m fedml_tpu_torch.cli serve``).
"""

from .admission import (  # noqa: F401
    AdmissionController,
    DeadlineExceededError,
    QueueFullError,
    ServingShedError,
)
from .batcher import MicroBatcher  # noqa: F401
from .endpoint import ModelEndpoint  # noqa: F401
from .engine import LATENCY_BUCKETS_S, InferenceRequest, ServingEngine  # noqa: F401
from .fleet import (  # noqa: F401
    FleetFrontend,
    FleetSloError,
    ServingFleet,
    SloController,
)
from .frontends import (  # noqa: F401
    ServingClient,
    ServingFrontend,
    ServingUnavailableError,
    build_serving_com,
)
from .mesh_endpoint import MeshModelEndpoint, build_mesh_forward  # noqa: F401

__all__ = [
    "AdmissionController",
    "DeadlineExceededError",
    "FleetFrontend",
    "FleetSloError",
    "InferenceRequest",
    "LATENCY_BUCKETS_S",
    "MeshModelEndpoint",
    "MicroBatcher",
    "ModelEndpoint",
    "QueueFullError",
    "ServingClient",
    "ServingEngine",
    "ServingFleet",
    "ServingFrontend",
    "ServingShedError",
    "ServingUnavailableError",
    "SloController",
    "build_mesh_forward",
    "build_serving_com",
]
