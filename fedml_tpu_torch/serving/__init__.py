"""Serving plane of the port (of ``fedml_tpu/serving``).

- ``ModelEndpoint`` — versioned params on the device; hot swaps are
  atomic and reject params of another shape, dtype or device;
- ``ServingEngine`` — bounded queue, continuous micro-batching into
  pow2 buckets, deadline/queue-full load shedding.

The fleet, the mesh endpoint, the frontends and ``cli serve`` come with
a later slice (ROADMAP.md, queue A).
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

__all__ = [
    "AdmissionController",
    "DeadlineExceededError",
    "InferenceRequest",
    "LATENCY_BUCKETS_S",
    "MicroBatcher",
    "ModelEndpoint",
    "QueueFullError",
    "ServingEngine",
    "ServingShedError",
]
