"""Serving frontends over the comm seam (port of
``fedml_tpu/serving/frontends.py``).

The engine is transport-agnostic; these frontends adapt it onto any
``BaseCommunicationManager`` — the zero-copy in-process ``LOCAL``
fabric, the persistent-pipe ``TRPC`` backend and the msgpack-over-gRPC
unary backend (the transports the FL control plane uses), so a model can
be served in-process for tests/benches and over the network with ONE
flag flip. The wire bytes are the JAX package's, so a client of either
package talks to a frontend of the other.

The comm stack composes exactly like the training managers': telemetry
counting inside, fault injection outside (``build_serving_com``), so
``fault_injection`` YAML applies to inference traffic unchanged — a
dropped request surfaces as a client retry, an injected delay lands
the request past its carried deadline and sheds server-side. Both are
counted (``comm_faults_injected_total``, ``serving_shed_total``,
``serving_client_retries_total``): a forced-fault run leaves telemetry
evidence of every injection.

Wire protocol (one request/response message pair, msgpack envelopes):

- ``MSG_TYPE_C2S_INFER_REQUEST``: ``request_id``, ``x`` (one example),
  optional ``deadline_ts`` (client's absolute ``time.monotonic`` stamp
  — meaningful on the same host; cross-host deployments should rely on
  the server-side ``serve_deadline_ms`` instead);
- ``MSG_TYPE_S2C_INFER_RESPONSE``: ``request_id``, ``status``
  (``ok`` | ``shed:<reason>`` | ``error:<type>``), ``y`` on success.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

import torch

from .. import constants
from ..core.comm.base import BaseCommunicationManager, Observer
from ..core.comm.faults import maybe_wrap_faulty
from ..core.comm.instrument import wrap_instrumented
from ..core.managers import _build_com_manager
from ..core.message import Message
from .admission import DeadlineExceededError, QueueFullError, ServingShedError
from .engine import ServingEngine

__all__ = [
    "ServingFrontend",
    "ServingClient",
    "ServingUnavailableError",
    "build_serving_com",
]


class ServingUnavailableError(RuntimeError):
    """Every attempt timed out or was shed; the caller's retry budget
    is spent."""


def build_serving_com(
    args, rank: int, size: int, backend: Optional[str] = None
) -> BaseCommunicationManager:
    """Backend dispatch + the managers' standard wrap order (counting
    records wire traffic, faults inject outside it)."""
    backend = backend or getattr(args, "backend", constants.COMM_BACKEND_LOCAL)
    if str(backend).upper() in (
        constants.COMM_BACKEND_SP.upper(),
        constants.FEDML_SIMULATION_TYPE_SP.upper(),
        constants.COMM_BACKEND_MESH,
    ):
        # a simulation config's engine name is not a transport; serve
        # in-process (the same mapping Arguments applies cross-silo)
        backend = constants.COMM_BACKEND_LOCAL
    com = _build_com_manager(args, rank, size, backend)
    return maybe_wrap_faulty(wrap_instrumented(com, args), args)


def _status_for(exc: BaseException) -> str:
    if isinstance(exc, QueueFullError):
        return "shed:queue_full"
    if isinstance(exc, DeadlineExceededError):
        return "shed:deadline"
    if isinstance(exc, ServingShedError):
        return "shed:other"
    return f"error:{type(exc).__name__}"


class ServingFrontend(Observer):
    """Server side: one engine behind one comm endpoint (rank 0 by
    convention). Each request message becomes an engine submission; the
    response is sent from the engine worker via the future callback —
    the receive loop never blocks on inference."""

    def __init__(self, engine: ServingEngine, com, args, rank: int = 0) -> None:
        self.engine = engine
        self.com = com
        self.args = args
        self.rank = int(rank)
        com.add_observer(self)

    def receive_message(self, msg_type: int, msg: Message) -> None:
        if int(msg_type) != constants.MSG_TYPE_C2S_INFER_REQUEST:
            return
        rid = msg.get("request_id")
        sender = int(msg.get_sender_id())
        try:
            x = msg.get("x")
            x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            fut = self.engine.submit(x, deadline_ts=msg.get("deadline_ts"))
        except Exception as e:  # noqa: BLE001 — a bad request must not kill the loop
            self._respond(sender, rid, _status_for(e))
            return
        fut.add_done_callback(
            lambda f, sender=sender, rid=rid: self._on_done(f, sender, rid)
        )

    def _on_done(self, fut, sender: int, rid) -> None:
        exc = fut.exception()
        if exc is None:
            self._respond(sender, rid, "ok", y=fut.result())
        else:
            self._respond(sender, rid, _status_for(exc))

    def _respond(self, receiver: int, rid, status: str, y=None) -> None:
        msg = Message(
            constants.MSG_TYPE_S2C_INFER_RESPONSE, self.rank, receiver
        )
        msg.add("request_id", rid)
        msg.add("status", status)
        if y is not None:
            msg.add("y", np.asarray(y))
        try:
            self.com.send_message(msg)
        except Exception:  # noqa: BLE001 — a dead client must not kill the server
            logging.exception("serving response to rank %d failed", receiver)

    def serve_forever(self) -> None:
        self.com.handle_receive_message()

    def stop(self) -> None:
        self.com.stop_receive_message()


class ServingClient(Observer):
    """Client side: synchronous ``request`` with timeout + retry.

    A timed-out attempt (dropped/delayed by the network or a fault
    injector) and a shed response both consume one retry; every retry
    is counted (``serving_client_retries_total``). Exhausting the
    budget raises ``ServingUnavailableError`` — overload stays an
    explicit, typed failure at the edge."""

    def __init__(
        self, com, rank: int, server_rank: int = 0, args: Any = None
    ) -> None:
        self.com = com
        self.rank = int(rank)
        self.server_rank = int(server_rank)
        from ..core.telemetry import Telemetry

        self.telemetry = Telemetry.get_instance(args)
        self._ids = itertools.count()
        self._pending: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        com.add_observer(self)
        self._recv_thread = threading.Thread(
            target=com.handle_receive_message, daemon=True,
            name=f"serving-client-{rank}",
        )
        self._recv_thread.start()

    def receive_message(self, msg_type: int, msg: Message) -> None:
        if int(msg_type) != constants.MSG_TYPE_S2C_INFER_RESPONSE:
            return
        rid = msg.get("request_id")
        with self._lock:
            slot = self._pending.get(rid)
        if slot is None:
            return  # a late duplicate / response to an abandoned attempt
        slot["status"] = msg.get("status")
        slot["y"] = msg.get("y")
        slot["event"].set()

    def request(
        self,
        x,
        timeout_s: float = 2.0,
        retries: int = 2,
        deadline_s: Optional[float] = None,
        carry_deadline: bool = True,
    ) -> np.ndarray:
        """One inference round-trip; retries on timeout and on shed."""
        x = np.asarray(x)
        last = "no attempt made"
        for attempt in range(int(retries) + 1):
            if attempt and self.telemetry.enabled:
                self.telemetry.inc("serving_client_retries_total")
            rid = f"{self.rank}-{next(self._ids)}"
            slot = {"event": threading.Event(), "status": None, "y": None}
            with self._lock:
                self._pending[rid] = slot
            try:
                msg = Message(
                    constants.MSG_TYPE_C2S_INFER_REQUEST,
                    self.rank, self.server_rank,
                )
                msg.add("request_id", rid)
                msg.add("x", x)
                if carry_deadline and deadline_s is not None:
                    msg.add("deadline_ts", time.monotonic() + float(deadline_s))
                self.com.send_message(msg)
                if not slot["event"].wait(timeout_s):
                    last = f"timeout after {timeout_s}s"
                    continue
                status = slot["status"]
                if status == "ok":
                    return np.asarray(slot["y"])
                if isinstance(status, str) and status.startswith("shed:"):
                    last = status
                    continue  # server shed — retry is the designed path
                raise RuntimeError(f"serving request failed: {status}")
            finally:
                with self._lock:
                    self._pending.pop(rid, None)
        raise ServingUnavailableError(
            f"request not served after {retries + 1} attempt(s); last: {last}"
        )

    def close(self) -> None:
        self.com.stop_receive_message()
        self._recv_thread.join(timeout=2.0)
