"""gRPC transport (port of ``fedml_tpu/core/comm/grpc_backend.py``).

Parity with ``python/fedml/core/distributed/communication/grpc/
grpc_comm_manager.py``: every node runs a gRPC server on
``port_base + rank`` (reference: ``8888 + rank``, grpc_comm_manager.py:72-75),
send = one unary RPC carrying the serialized Message, receiver enqueues
and a dispatch loop notifies observers (grpc_server.py:36-39 /
grpc_comm_manager.py:101-113). Static IP table maps ranks to hosts
(``ip_config_utils.py`` CSV).

Differences by design, as in the JAX package: (a) no generated protobuf
stubs — the wire format is the Message's msgpack blob (``core/wire.py``,
the JAX package's bytes) over a generic bytes/bytes unary method, so
there is no protoc step and no pickle; (b) the dispatch loop blocks on a
queue instead of busy-wait polling.

``grpc`` (the ``grpcio`` package) is imported when a manager is built,
never when this module is imported, so nothing else of the port needs
it; where it is absent, building one raises an ``ImportError`` that
names the package. There is no fallback to another transport.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent import futures
from typing import Any, Dict, List, Optional

from ..message import Message
from .base import (
    BaseCommunicationManager,
    CommSendError,
    Observer,
    backoff_delay_s,
)

_SERVICE = "fedml_tpu.Comm"
_METHOD = "Send"
_MAX_MSG = 1000 * 1024 * 1024  # 1000 MB, matching grpc_comm_manager.py:41-45
_STOP = object()



def import_grpc():
    """The ``grpc`` module, or an ``ImportError`` naming the package."""
    try:
        import grpc
    except ImportError as e:
        raise ImportError(
            "the GRPC comm backend needs the grpcio package, which is not "
            f"installed ({e}); pick LOCAL, TRPC or MQTT, which need nothing "
            "beyond the standard library"
        ) from e
    return grpc


def _transient_codes(grpc) -> frozenset:
    """Status codes a second attempt can plausibly fix; everything else
    (INVALID_ARGUMENT, UNIMPLEMENTED, RESOURCE_EXHAUSTED from an
    oversized payload, ...) fails identically every time and surfaces as
    CommSendError immediately."""
    return frozenset(
        (
            grpc.StatusCode.UNAVAILABLE,
            grpc.StatusCode.DEADLINE_EXCEEDED,
            grpc.StatusCode.ABORTED,
            grpc.StatusCode.INTERNAL,
            grpc.StatusCode.UNKNOWN,
            grpc.StatusCode.CANCELLED,
        )
    )


def _ident(b: bytes) -> bytes:
    return b


class GrpcCommunicationManager(BaseCommunicationManager):
    def __init__(
        self,
        rank: int,
        size: int,
        ip_config: Optional[Dict[int, str]] = None,
        port_base: int = 8890,
        host: str = "0.0.0.0",
        send_timeout_s: float = 300.0,
        send_retries: int = 2,
        retry_base_s: float = 0.2,
    ) -> None:
        self._grpc = grpc = import_grpc()
        self._transient = _transient_codes(grpc)
        self.rank = int(rank)
        self.size = int(size)
        self.port_base = int(port_base)
        self.send_timeout_s = float(send_timeout_s)
        self.send_retries = int(send_retries)
        self.retry_base_s = float(retry_base_s)
        self.ip_config = ip_config or {r: "127.0.0.1" for r in range(size)}
        self._observers: List[Observer] = []
        self._q: "queue.Queue" = queue.Queue()
        self._running = False
        self._channels: Dict[int, Any] = {}
        self._stubs: Dict[int, object] = {}
        self._lock = threading.Lock()

        opts = [
            ("grpc.max_send_message_length", _MAX_MSG),
            ("grpc.max_receive_message_length", _MAX_MSG),
        ]
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8), options=opts
        )
        handler = grpc.method_handlers_generic_handler(
            _SERVICE,
            {
                _METHOD: grpc.unary_unary_rpc_method_handler(
                    self._on_rpc,
                    request_deserializer=_ident,
                    response_serializer=_ident,
                )
            },
        )
        self._server.add_generic_rpc_handlers((handler,))
        self.port = self.port_base + self.rank
        bound = self._server.add_insecure_port(f"{host}:{self.port}")
        if bound == 0:
            raise RuntimeError(f"could not bind gRPC port {self.port}")
        self._server.start()
        logging.info("grpc comm manager rank %d listening on %d", rank, self.port)

    # -- server side ---------------------------------------------------
    def _on_rpc(self, request: bytes, context) -> bytes:
        self._q.put(Message.from_bytes(request))
        return b"ok"

    # -- client side ---------------------------------------------------
    def _stub(self, rank: int):
        with self._lock:
            if rank not in self._stubs:
                addr = f"{self.ip_config[rank]}:{self.port_base + rank}"
                channel = self._grpc.insecure_channel(
                    addr,
                    options=[
                        ("grpc.max_send_message_length", _MAX_MSG),
                        ("grpc.max_receive_message_length", _MAX_MSG),
                    ],
                )
                self._channels[rank] = channel
                self._stubs[rank] = channel.unary_unary(
                    f"/{_SERVICE}/{_METHOD}",
                    request_serializer=_ident,
                    response_deserializer=_ident,
                )
            return self._stubs[rank]

    def send_message(self, msg: Message) -> None:
        """One unary RPC, retried with jittered exponential backoff.

        The seed's single ``timeout=300`` blocking call made any
        transient gRPC error (peer restarting, LB blip, deadline on a
        slow link) fatal to the round loop. Each attempt gets
        ``send_timeout_s`` (``grpc_send_timeout_s`` knob); after
        ``send_retries`` retries the typed :class:`CommSendError` is
        raised — and counted — instead of whatever grpc surfaces.
        """
        receiver = int(msg.get_receiver_id())
        data = msg.to_bytes()  # serialize once across attempts
        attempts = self.send_retries + 1
        last_err: Optional[Exception] = None
        attempts_made = 0
        for attempt in range(attempts):
            try:
                attempts_made += 1
                self._stub(receiver)(
                    data, wait_for_ready=True, timeout=self.send_timeout_s
                )
                return
            except self._grpc.RpcError as e:
                last_err = e
                code = e.code() if hasattr(e, "code") else None
                if code not in self._transient:
                    break  # permanent: retrying burns time, not errors
                if attempt + 1 < attempts:
                    delay = backoff_delay_s(attempt, self.retry_base_s)
                    logging.warning(
                        "grpc send to rank %d failed (%s, attempt %d/%d); "
                        "retrying in %.2fs",
                        receiver,
                        getattr(e, "code", lambda: e)(),
                        attempt + 1, attempts, delay,
                    )
                    self._count_send_event("comm_transport_retries_total", msg)
                    time.sleep(delay)
        self._count_send_event("comm_send_errors_total", msg)
        raise CommSendError(receiver, attempts_made, last_err)

    @staticmethod
    def _count_send_event(counter: str, msg: Message) -> None:
        from ..telemetry import Telemetry

        Telemetry.get_instance().inc(counter, msg_type=int(msg.get_type()))

    # -- observer loop -------------------------------------------------
    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        if observer in self._observers:
            self._observers.remove(observer)

    def handle_receive_message(self) -> None:
        self._running = True
        while self._running:
            item = self._q.get()
            if item is _STOP:
                break
            for obs in list(self._observers):
                obs.receive_message(item.get_type(), item)

    def stop_receive_message(self) -> None:
        self._running = False
        self._q.put(_STOP)
        for ch in self._channels.values():
            ch.close()
        self._server.stop(grace=1.0)
