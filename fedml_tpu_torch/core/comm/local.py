"""In-process transport: per-rank queues inside one Python process
(port of ``fedml_tpu/core/comm/local.py``).

The stand-in for the reference's MPI backend (``mpi/com_manager.py``):
where the reference runs N+1 OS processes under ``mpirun`` and pickles
messages between them (``mpi_send_thread.py:27``), single-host
multi-actor runs here are threads of one process, and messages are
enqueued directly: zero serialization, so a CUDA tensor crosses the
fabric by reference, without a copy (the seam the reference's
``enable_cuda_rpc`` only approximates). Event-driven via
``queue.Queue`` blocking gets, no 0.3 s poll loop
(cf. ``com_manager.py:77-84``).

Also the test "fake backend": every scenario can run single-host with
this transport and must produce the numbers of the networked ones.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Dict, List

from ..message import Message
from .base import BaseCommunicationManager, Observer

_STOP = object()


class _Fabric:
    """A named in-process fabric: one inbox per rank."""

    _fabrics: Dict[str, "_Fabric"] = {}
    _lock = threading.Lock()

    def __init__(self) -> None:
        # plain dict + locked creation: defaultdict.__missing__ is not
        # atomic, and a lost first-touch race would orphan a rank's
        # inbox (messages enqueued to the overwritten queue vanish)
        self.inboxes: Dict[int, "queue.Queue"] = {}

    def inbox(self, rank: int) -> "queue.Queue":
        with _Fabric._lock:
            if rank not in self.inboxes:
                self.inboxes[rank] = queue.Queue()
            return self.inboxes[rank]

    @classmethod
    def get(cls, name: str) -> "_Fabric":
        with cls._lock:
            if name not in cls._fabrics:
                cls._fabrics[name] = _Fabric()
            return cls._fabrics[name]

    @classmethod
    def destroy(cls, name: str) -> None:
        with cls._lock:
            cls._fabrics.pop(name, None)


class LocalCommunicationManager(BaseCommunicationManager):
    def __init__(self, fabric_name: str, rank: int, size: int) -> None:
        self.fabric = _Fabric.get(fabric_name)
        self.fabric_name = fabric_name
        self.rank = int(rank)
        self.size = int(size)
        self._observers: List[Observer] = []
        self._running = False

    def send_message(self, msg: Message) -> None:
        receiver = int(msg.get_receiver_id())
        self.fabric.inbox(receiver).put(msg)

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        if observer in self._observers:
            self._observers.remove(observer)

    def handle_receive_message(self) -> None:
        self._running = True
        inbox = self.fabric.inbox(self.rank)
        while self._running:
            item = inbox.get()
            if item is _STOP:
                break
            for obs in list(self._observers):
                try:
                    obs.receive_message(item.get_type(), item)
                except Exception:
                    logging.exception("observer failed on %s", item)
                    raise

    def stop_receive_message(self) -> None:
        self._running = False
        self.fabric.inbox(self.rank).put(_STOP)

    def destroy_fabric(self) -> None:
        """Drop the fabric from the process-global registry so a later
        run reusing this run_id starts with fresh inboxes. Existing
        managers keep their direct queue references, so this is safe to
        call from the rank that finishes first (the server)."""
        _Fabric.destroy(self.fabric_name)
