"""TRPC-analog transport: persistent-pipe RPC with a raw-tensor fast path
(port of ``fedml_tpu/core/comm/tensor_rpc.py``).

Parity target: ``python/fedml/core/distributed/communication/trpc/
trpc_comm_manager.py:91-129`` — the reference's fastest Python backend
(torch.distributed.rpc over TensorPipe: persistent pipes per peer,
``rpc_sync(..., sendMessage, ...)``).

- **persistent pipes**: one long-lived TCP connection per (sender ->
  receiver) pair instead of gRPC's unary round trips — connection setup
  is paid once, like TensorPipe;
- **raw-tensor framing**: array leaves of any param are NOT
  msgpack-encoded; the wire format is a msgpack header (envelope +
  tree structure + dtype/shape table) followed by each leaf's raw
  buffer. Sending writes views of the host arrays (a CUDA tensor is
  copied to the host once, here, and nowhere else); receiving wraps
  zero-copy ``np.frombuffer`` views, so the only host-side copy on the
  receive path is the socket read itself.
- **device residency** is a property of the process topology, not the
  transport: in-process actors use the LOCAL fabric (tensors pass by
  reference); TRPC is the boundary between separate processes, where
  one host copy per side is the whole cost.

Wire frame: ``[u64 header_len][header msgpack][u64 body_len][buf 0]
[buf 1]...`` (all length prefixes little-endian u64); header =
{envelope (non-array params), arrays: [(dtype, shape, nbytes)...]};
buffers follow in table order. The header is written by the port's
codec (``core/wire.py``), byte for byte the JAX package's; a dtype is
numpy's ``dtype.str`` (``"<f4"``), a bf16 tensor's ``"bfloat16"`` over
its 16-bit words, read back as a CPU ``torch.bfloat16`` tensor.
"""

from __future__ import annotations

import logging
import queue
import socket
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import wire
from ..message import Message
from .base import BaseCommunicationManager, Observer

_STOP = object()
_LEN = struct.Struct("<Q")

# placeholder / escape markers for the header tree. A user dict that
# happens to carry one of these keys is wrapped in an escape node so it
# round-trips verbatim instead of being misread as a marker.
_TENSOR = "__fedml_tensor__"
_TUPLE = "__fedml_tuple__"
_ESCAPE = "__fedml_escape__"
_MARKERS = (_TENSOR, _TUPLE, _ESCAPE)
_BF16 = "bfloat16"


def _flatten_arrays(params: Dict[str, Any]):
    """Split a msg_params dict into (plain tree, array buffers).

    Array leaves anywhere in the params tree — including 0-d arrays,
    which must survive as arrays for LOCAL/GRPC/TRPC payload parity —
    are replaced by the placeholder index of their buffer; everything
    else stays for the msgpack header."""
    arrays: List[Tuple[np.ndarray, str]] = []

    def walk(obj):
        if isinstance(obj, (np.ndarray, torch.Tensor)):
            host, name = wire.host_array(obj)
            # ascontiguousarray promotes 0-d to 1-d; restore the shape
            host = np.ascontiguousarray(host).reshape(host.shape)
            arrays.append((host, _BF16 if name == _BF16 else host.dtype.str))
            return {_TENSOR: len(arrays) - 1}
        if isinstance(obj, dict):
            walked = {k: walk(v) for k, v in obj.items()}
            if any(k in obj for k in _MARKERS):
                return {_ESCAPE: walked}
            return walked
        if isinstance(obj, list):
            return [walk(v) for v in obj]
        if isinstance(obj, tuple):
            return {_TUPLE: [walk(v) for v in obj]}
        return obj

    return walk(params), arrays


def _rebuild(plain, buffers: List[Any]):
    if isinstance(plain, dict):
        if len(plain) == 1:
            if _TENSOR in plain:
                return buffers[plain[_TENSOR]]
            if _TUPLE in plain:
                return tuple(_rebuild(v, buffers) for v in plain[_TUPLE])
            if _ESCAPE in plain:
                return {k: _rebuild(v, buffers) for k, v in plain[_ESCAPE].items()}
        return {k: _rebuild(v, buffers) for k, v in plain.items()}
    if isinstance(plain, list):
        return [_rebuild(v, buffers) for v in plain]
    return plain


def encode_frame(msg: Message) -> List[bytes]:
    """Message -> [length-prefix + header, raw buffer views...].

    Array payloads are never re-encoded or concatenated — the buffer
    parts are memoryviews onto the (host) arrays themselves."""
    plain, arrays = _flatten_arrays(msg.get_params())
    header = wire.msgpack_serialize(
        {
            "plain": plain,
            "arrays": [
                {"dtype": dt, "shape": list(a.shape), "nbytes": a.nbytes}
                for a, dt in arrays
            ],
        }
    )
    parts: List[bytes] = [_LEN.pack(len(header)) + header]
    parts.extend(memoryview(a).cast("B") for a, _ in arrays)
    return parts


def decode_frame(header: bytes, body: memoryview) -> Message:
    """Inverse of :func:`encode_frame`; array views are zero-copy."""
    meta = wire.msgpack_restore(header)
    buffers: List[Any] = []
    off = 0
    for spec in meta["arrays"]:
        n = int(spec["nbytes"])
        shape = [int(s) for s in spec["shape"]]
        if spec["dtype"] == _BF16:
            words = np.frombuffer(body[off : off + n], dtype=np.uint16).copy()
            buffers.append(torch.from_numpy(words).view(torch.bfloat16).reshape(shape))
        else:
            arr = np.frombuffer(body[off : off + n], dtype=np.dtype(spec["dtype"]))
            buffers.append(arr.reshape(shape))
        off += n
    m = Message()
    m.msg_params = _rebuild(meta["plain"], buffers)
    return m


from .sockutil import recv_exact as _recv_exact  # shared exact-read helper


class TensorRpcCommunicationManager(BaseCommunicationManager):
    """Rank-addressed persistent-pipe RPC world.

    Every rank listens on ``port_base + rank`` (the reference's
    ``8888 + rank`` convention); ``send_message`` lazily opens one
    persistent pipe per receiver and reuses it for the run's lifetime.
    """

    def __init__(
        self,
        rank: int,
        size: int,
        ip_config: Optional[Dict[int, str]] = None,
        port_base: int = 8890,
        host: str = "0.0.0.0",
    ) -> None:
        self.rank = int(rank)
        self.size = int(size)
        self.port_base = int(port_base)
        self.ip_config = ip_config or {r: "127.0.0.1" for r in range(size)}
        self._observers: List[Observer] = []
        self._q: "queue.Queue" = queue.Queue()
        self._pipes: Dict[int, socket.socket] = {}
        # _pipe_lock guards only the pipe table; each pipe has its own
        # send lock so sends to distinct receivers run concurrently and
        # one slow receiver can't wedge shutdown (cf. grpc_backend which
        # likewise locks stub creation only)
        self._pipe_lock = threading.Lock()
        self._send_locks: Dict[int, threading.Lock] = {}
        self._running = False

        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.port = self.port_base + self.rank
        self._server.bind((host, self.port))
        self._server.listen(size + 4)
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()
        logging.info("tensor-rpc rank %d listening on %d", rank, self.port)

    # -- server side ---------------------------------------------------
    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return  # listener closed
            threading.Thread(
                target=self._pipe_reader, args=(conn,), daemon=True
            ).start()

    def _pipe_reader(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                head = _recv_exact(conn, _LEN.size)
                if head is None:
                    return  # clean EOF between frames
                header = _recv_exact(conn, _LEN.unpack(head)[0])
                if header is None:
                    return  # peer died mid-frame; drop the partial
                blen = _recv_exact(conn, _LEN.size)
                if blen is None:
                    return
                body_len = _LEN.unpack(blen)[0]
                body = _recv_exact(conn, body_len) if body_len else memoryview(b"")
                if body is None:
                    return
                self._q.put(decode_frame(bytes(header), body))
        except Exception:
            logging.exception("tensor-rpc reader died")
        finally:
            conn.close()

    # -- client side ---------------------------------------------------
    def _pipe(self, receiver: int) -> Tuple[socket.socket, threading.Lock]:
        with self._pipe_lock:
            s = self._pipes.get(receiver)
            if s is not None:
                return s, self._send_locks[receiver]
        # connect OUTSIDE the table lock: a slow/unreachable receiver
        # must not wedge sends to other ranks or shutdown
        addr = (self.ip_config[receiver], self.port_base + receiver)
        s = socket.create_connection(addr, timeout=300)
        s.settimeout(None)  # connect timeout only; sends are blocking
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._pipe_lock:
            # lost the race? keep the first pipe, drop ours
            existing = self._pipes.get(receiver)
            if existing is not None:
                s.close()
                return existing, self._send_locks[receiver]
            self._pipes[receiver] = s
            self._send_locks[receiver] = threading.Lock()
            return s, self._send_locks[receiver]

    def _evict_pipe(self, receiver: int, pipe: socket.socket) -> None:
        with self._pipe_lock:
            if self._pipes.get(receiver) is pipe:
                del self._pipes[receiver]
        try:
            pipe.close()
        except OSError:
            logging.debug(
                "tensor rpc: evicted pipe to %d close failed", receiver,
                exc_info=True,
            )

    def send_message(self, msg: Message) -> None:
        receiver = int(msg.get_receiver_id())
        parts = encode_frame(msg)
        body_len = sum(len(p) for p in parts[1:])
        pipe, send_lock = self._pipe(receiver)
        try:
            with send_lock:  # frame atomicity per pipe only
                pipe.sendall(parts[0] + _LEN.pack(body_len))
                for p in parts[1:]:
                    pipe.sendall(p)
        except OSError:
            # a partially-written frame desyncs the pipe; never reuse it
            self._evict_pipe(receiver, pipe)
            raise

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
        with self._pipe_lock:
            for s in self._pipes.values():
                try:
                    s.close()
                except OSError:
                    logging.debug("tensor rpc: pipe close failed", exc_info=True)
            self._pipes.clear()
        try:
            self._server.close()
        except OSError:
            logging.debug("tensor rpc: server close failed", exc_info=True)
