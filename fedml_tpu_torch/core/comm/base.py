"""Abstract communication manager + observer (port of
``fedml_tpu/core/comm/base.py``).

Parity with ``python/fedml/core/distributed/communication/
base_com_manager.py:7-26`` and ``observer.py:4-7``: the contract that
keeps every algorithm transport-agnostic.
"""

from __future__ import annotations

import abc

from ..message import Message


class CommSendError(RuntimeError):
    """A send exhausted its transport-level retry budget.

    Raised by networked backends (grpc_backend.py) instead of leaking
    whatever the transport surfaces (grpc.RpcError, socket errors), so
    callers can catch one typed failure across transports. Counted in
    Telemetry as ``comm_send_errors_total``.
    """

    def __init__(self, receiver: int, attempts: int, cause: Exception) -> None:
        super().__init__(
            f"send to rank {receiver} failed after {attempts} attempt(s): "
            f"{type(cause).__name__}: {cause}"
        )
        self.receiver = int(receiver)
        self.attempts = int(attempts)
        self.cause = cause


def backoff_delay_s(attempt: int, base_s: float, rand=None) -> float:
    """Jittered exponential backoff: ``base_s * 2^attempt`` stretched
    by up to +50%. ONE implementation for every comm retry loop
    (reliable channel retransmits, gRPC per-RPC retries) so a future
    change — capping the exponent, reshaping the jitter — cannot
    silently miss one of them. ``rand`` is a 0..1 callable (a seeded
    stream for rank-decorrelated determinism); default is the module
    ``random``."""
    if rand is None:
        import random

        rand = random.random
    return float(base_s) * (2.0 ** int(attempt)) * (1.0 + 0.5 * float(rand()))


class Observer(abc.ABC):
    @abc.abstractmethod
    def receive_message(self, msg_type: int, msg_params: Message) -> None:
        ...


class BaseCommunicationManager(abc.ABC):
    @abc.abstractmethod
    def send_message(self, msg: Message) -> None:
        ...

    @abc.abstractmethod
    def add_observer(self, observer: Observer) -> None:
        ...

    @abc.abstractmethod
    def remove_observer(self, observer: Observer) -> None:
        ...

    @abc.abstractmethod
    def handle_receive_message(self) -> None:
        """Block, delivering inbound messages to observers, until
        ``stop_receive_message`` is called."""
        ...

    @abc.abstractmethod
    def stop_receive_message(self) -> None:
        ...
