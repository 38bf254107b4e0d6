"""Pub/sub communication backend over the topic broker (port of
``fedml_tpu/core/comm/mqtt_backend.py``).

Parity with ``mqtt/mqtt_comm_manager.py`` (149 LoC) and the control
plane of ``mqtt_s3/mqtt_s3_multi_clients_comm_manager.py``: every node
subscribes to its own topic ``fedml_{run_id}_{rank}`` (the reference's
scheme is ``fedml_{run_id}_{server_id}_{client_id}``,
mqtt_s3_multi_clients_comm_manager.py:108-149) and sending is a publish
to the receiver's topic. Delivery to observers is event-driven through
a blocking queue — no poll loop.
"""

from __future__ import annotations

import logging
import queue
from typing import List

from ..message import Message
from .base import BaseCommunicationManager, Observer
from .broker import BrokerClient

_STOP = object()


class MqttCommunicationManager(BaseCommunicationManager):
    def __init__(
        self,
        rank: int,
        size: int,
        broker_host: str = "127.0.0.1",
        broker_port: int = 1883,
        run_id: str = "0",
    ) -> None:
        self.rank = int(rank)
        self.size = int(size)
        self.run_id = str(run_id)
        self._observers: List[Observer] = []
        self._inbox: "queue.Queue" = queue.Queue()
        self._client = BrokerClient(broker_host, broker_port)
        self._client.subscribe(self._topic(self.rank), self._on_payload)

    def _topic(self, rank: int) -> str:
        return f"fedml_{self.run_id}_{rank}"

    def _on_payload(self, topic: str, payload: bytes) -> None:
        self._inbox.put(payload)

    def send_message(self, msg: Message) -> None:
        self._client.publish(self._topic(msg.get_receiver_id()), msg.to_bytes())

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        if observer in self._observers:
            self._observers.remove(observer)

    def handle_receive_message(self) -> None:
        while True:
            item = self._inbox.get()
            if item is _STOP:
                break
            msg = Message.from_bytes(item)
            for obs in list(self._observers):
                obs.receive_message(msg.get_type(), msg)
        logging.debug("mqtt backend rank %d stopped", self.rank)

    def stop_receive_message(self) -> None:
        self._inbox.put(_STOP)
        self._client.close()
