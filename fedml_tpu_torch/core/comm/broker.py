"""Minimal self-hosted topic broker, the MQTT stand-in (port of
``fedml_tpu/core/comm/broker.py``).

The reference's production backends ride an external MQTT broker
(``mqtt/mqtt_comm_manager.py``, broker defaults at
``client_manager.py:31-37``; production config fetched from the MLOps
platform, ``core/mlops/mlops_configs.py:29-70``). This environment has
no egress and no external broker, so the pub/sub CONTROL PLANE is
implemented here directly: a tiny TCP broker speaking length-prefixed
frames with SUBSCRIBE / PUBLISH / DELIVER verbs, plus a client with a
background reader thread and per-topic callbacks — the same surface
paho-mqtt gives the reference (connect / subscribe(topic, cb) /
publish(topic, payload) / loop).

Wire format (no pickle — a reachable broker port must not be a
code-execution vector; payloads are opaque bytes the APPLICATION layer
decodes with msgpack, ``core/message.py``):

  u32 frame_len | u8 verb (0=sub 1=pub 2=msg) | u16 topic_len | topic utf8 | payload

Every subscriber socket has a send lock — concurrent publishers fan
out through ``sendall`` and interleaved frames would corrupt the
stream.

With ``FEDML_TPU_NATIVE_BROKER=1``, :func:`ensure_broker` starts the
native C++ broker instead (``core/comm/native_broker.py``, the same wire
protocol), and falls back to this Python broker when it cannot be built.
"""

from __future__ import annotations

import errno
import logging
import os
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .sockutil import recv_exact

_HDR = struct.Struct(">I")
_VERB_SUB, _VERB_PUB, _VERB_MSG = 0, 1, 2


def _encode_frame(verb: int, topic: str, payload: bytes = b"") -> bytes:
    t = topic.encode("utf-8")
    body = struct.pack(">BH", verb, len(t)) + t + payload
    return _HDR.pack(len(body)) + body


def _decode_body(body: bytes) -> Tuple[int, str, bytes]:
    verb, tlen = struct.unpack_from(">BH", body, 0)
    topic = body[3 : 3 + tlen].decode("utf-8")
    return verb, topic, body[3 + tlen :]


def _recv_frame(sock: socket.socket) -> Optional[Tuple[int, str, bytes]]:
    hdr = recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    (length,) = _HDR.unpack(hdr)
    body = recv_exact(sock, length)
    if body is None:
        return None
    return _decode_body(bytes(body))


class _LockedSock:
    """Socket + send lock: fan-out writers must not interleave frames."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.lock = threading.Lock()

    def send_frame(self, frame: bytes) -> None:
        with self.lock:
            self.sock.sendall(frame)


class Broker:
    """Topic broker: fan-out of published frames to topic subscribers."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen(64)
        self.host, self.port = self._server.getsockname()
        self._subs: Dict[str, List[_LockedSock]] = {}
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._server.accept()
            except OSError:
                break
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        locked = _LockedSock(conn)
        try:
            while True:
                frame = _recv_frame(conn)
                if frame is None:
                    break
                verb, topic, payload = frame
                if verb == _VERB_SUB:
                    with self._lock:
                        self._subs.setdefault(topic, []).append(locked)
                elif verb == _VERB_PUB:
                    out = _encode_frame(_VERB_MSG, topic, payload)
                    with self._lock:
                        targets = list(self._subs.get(topic, ()))
                    for t in targets:
                        try:
                            t.send_frame(out)
                        except OSError:
                            with self._lock:
                                if t in self._subs.get(topic, ()):
                                    self._subs[topic].remove(t)
        except Exception:  # pragma: no cover - malformed peer
            logging.exception("broker connection handler failed")
        finally:
            with self._lock:
                for subs in self._subs.values():
                    if locked in subs:
                        subs.remove(locked)
            conn.close()

    def stop(self) -> None:
        self._stopping.set()
        try:
            self._server.close()
        except OSError:
            logging.debug("broker: server close failed", exc_info=True)


class BrokerClient:
    """paho-style client: subscribe(topic, cb) + publish(topic, bytes)."""

    def __init__(self, host: str, port: int) -> None:
        self._sock = socket.create_connection((host, port), timeout=30)
        self._sock.settimeout(None)
        self._send_lock = threading.Lock()
        self._callbacks: Dict[str, Callable[[str, bytes], None]] = {}
        self._stopping = threading.Event()
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def subscribe(self, topic: str, callback: Callable[[str, bytes], None]) -> None:
        self._callbacks[topic] = callback
        with self._send_lock:
            self._sock.sendall(_encode_frame(_VERB_SUB, topic))

    def publish(self, topic: str, payload: bytes) -> None:
        with self._send_lock:
            self._sock.sendall(_encode_frame(_VERB_PUB, topic, payload))

    def _read_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                frame = _recv_frame(self._sock)
            except OSError:
                break
            except Exception:  # pragma: no cover - corrupt stream
                logging.exception("broker client: corrupt frame, closing")
                break
            if frame is None:
                break
            _, topic, payload = frame
            cb = self._callbacks.get(topic)
            if cb is not None:
                try:
                    cb(topic, payload)
                except Exception:  # pragma: no cover - observer bug
                    logging.exception("broker callback failed for %s", topic)

    def close(self) -> None:
        self._stopping.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            logging.debug("broker client: shutdown failed", exc_info=True)
        self._sock.close()


_shared_brokers: Dict[Tuple[str, int], Broker] = {}
_shared_lock = threading.Lock()


def _is_local_host(host: str) -> bool:
    if host in ("127.0.0.1", "localhost", "0.0.0.0", ""):
        return True
    try:
        return host in {
            info[4][0]
            for info in socket.getaddrinfo(socket.gethostname(), None)
        }
    except OSError:
        return False


def ensure_broker(
    host: str = "127.0.0.1", port: int = 0, connect_timeout: float = 10.0
) -> Tuple[str, int]:
    """Start (or reach) a broker. With ``port=0`` a fresh ephemeral
    in-process broker is created. With a fixed port: reuse an existing
    listener (retrying while the hosting process starts up); only bind
    a new broker when the address is local and free — a lost same-host
    bind race falls back to connecting to the winner.
    ``FEDML_TPU_NATIVE_BROKER=1`` makes both branches start the native
    broker, when it builds, instead of binding a Python one."""
    use_native = os.environ.get("FEDML_TPU_NATIVE_BROKER", "") == "1"
    if port == 0:
        if use_native:
            from .native_broker import spawn_native_broker

            spawned = spawn_native_broker(0)
            if spawned is not None:
                h, p, _proc = spawned
                return (h, p)
        with _shared_lock:
            broker = Broker(host, 0)
            _shared_brokers[(broker.host, broker.port)] = broker
            return (broker.host, broker.port)
    local = _is_local_host(host)
    loopback = host in ("127.0.0.1", "localhost", "")
    with _shared_lock:
        # reuse an in-process broker only for the exact bound address,
        # or same-port loopback aliases; a non-loopback alias of this
        # machine still gets probed (the broker may be loopback-only
        # and unreachable at that address)
        if (host, port) in _shared_brokers or (
            loopback and any(p == port for (_, p) in _shared_brokers)
        ):
            return (host, port)
    deadline = time.monotonic() + connect_timeout
    while True:
        try:
            probe = socket.create_connection((host, port), timeout=0.5)
            probe.close()
            return (host, port)
        except OSError:  # lint: except-ok — probe loop: refusal IS the
            pass  # signal "not up yet"; the deadline below reports failure
        if local:
            if use_native:
                from .native_broker import spawn_native_broker

                spawned = spawn_native_broker(port)
                if spawned is not None:
                    _h, p, _proc = spawned
                    return (host, p)
                # native bind lost a race or toolchain missing -> fall
                # through to the Python broker / reconnect path
            try:
                with _shared_lock:
                    broker = Broker(host, port)
                    _shared_brokers[(broker.host, broker.port)] = broker
                return (broker.host, broker.port)
            except OSError as e:
                if e.errno != errno.EADDRINUSE:
                    raise
                # lost the bind race -> retry connecting to the winner,
                # still bounded by the deadline below
        if time.monotonic() >= deadline:
            raise TimeoutError(f"no broker reachable at {host}:{port}")
        time.sleep(0.2)


_run_brokers: Dict[str, Tuple[str, int]] = {}


def broker_for_run(run_id: str) -> Tuple[str, int]:
    """One in-process ephemeral broker per run id — all same-process
    ranks share it (the single-host test topology). Multi-process
    deployments set a fixed ``broker_port`` and rank 0 hosts it via
    :func:`ensure_broker`."""
    with _shared_lock:
        if run_id not in _run_brokers:
            broker = Broker()
            _shared_brokers[(broker.host, broker.port)] = broker
            _run_brokers[run_id] = (broker.host, broker.port)
        return _run_brokers[run_id]
