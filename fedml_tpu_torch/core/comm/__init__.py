"""Communication backends (port of ``fedml_tpu/core/comm``).

LOCAL (in-process queues), TRPC (persistent pipes, raw tensor buffers),
gRPC (msgpack over unary calls; imports ``grpc`` only when chosen) and
the pub/sub MQTT backend over the repo's own TCP broker, plus the
wrappers every backend composes with: telemetry counting, fault
injection and the reliable channel.
"""

from .base import BaseCommunicationManager, Observer  # noqa: F401
from .instrument import wrap_instrumented  # noqa: F401
from .local import LocalCommunicationManager  # noqa: F401
