"""Control-plane / data-plane split, the MQTT+S3 pattern (port of
``fedml_tpu/core/comm/payload_store.py``).

Parity with ``mqtt_s3/mqtt_s3_multi_clients_comm_manager.py`` (391 LoC)
+ ``mqtt_s3/remote_storage.py``: the reference keeps model payloads OUT
of the broker — weights are serialized to S3 and the MQTT message
carries only a URL (remote_storage.py:39-70; receiver re-inflates at
mqtt_s3_multi_clients_comm_manager.py:203-224).

Here the same seam is an abstract :class:`PayloadStore` —
``put(bytes) -> url`` / ``get(url) -> bytes`` — with a shared-filesystem
implementation standing in for S3 (swap in an object-store client
without touching the comm manager). :class:`HybridCommunicationManager`
wraps ANY control-plane backend and transparently swaps the
MODEL_PARAMS field out to the store on send and back in on receive, so
algorithms never know which plane carried their tensors.
"""

from __future__ import annotations

import logging
import os
import tempfile
import uuid
from typing import Any, List, Optional

import numpy as np
import torch

from ... import constants
from .. import wire
from ..message import Message
from ..telemetry import Telemetry
from .base import BaseCommunicationManager, Observer

_URL_SUFFIX = "_url"


class PayloadStore:
    """put/get of opaque payload bytes addressed by URL."""

    def put(self, data: bytes) -> str:
        raise NotImplementedError

    def get(self, url: str) -> bytes:
        raise NotImplementedError

    def exists(self, url: str) -> bool:
        """Whether a previously returned URL is still fetchable (stores
        with TTL expiry return False after GC)."""
        return True

    def touch(self, url: str) -> bool:
        """Refresh a blob's expiry clock so a reused URL outlives the
        next GC sweep. Returns False if the blob is already gone."""
        return self.exists(url)


class FilePayloadStore(PayloadStore):
    """Shared-directory store; URLs are ``file://`` paths (the S3
    stand-in). Blobs expire after ``ttl_s`` — the analog of the
    reference's 5-day presigned-URL lifetime (remote_storage.py:39-57)
    — and expired blobs are garbage-collected lazily on ``put``."""

    def __init__(self, root: Optional[str] = None, ttl_s: float = 3600.0) -> None:
        self.root = root or os.path.join(tempfile.gettempdir(), "fedml_tpu_store")
        self.ttl_s = float(ttl_s)
        os.makedirs(self.root, exist_ok=True)

    def put(self, data: bytes) -> str:
        self._gc()
        name = uuid.uuid4().hex
        path = os.path.join(self.root, name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic publish
        return "file://" + path

    def get(self, url: str) -> bytes:
        assert url.startswith("file://"), url
        with open(url[len("file://") :], "rb") as f:
            return f.read()

    def delete(self, url: str) -> None:
        try:
            os.remove(url[len("file://") :])
        except OSError:
            # a leaked payload file is disk pressure, not correctness —
            # but it must be visible, not silent
            logging.debug("payload store: delete(%s) failed", url, exc_info=True)
            Telemetry.get_instance().inc(
                "comm_internal_errors_total", site="payload_delete"
            )

    def exists(self, url: str) -> bool:
        return os.path.exists(url[len("file://") :])

    def touch(self, url: str) -> bool:
        try:
            os.utime(url[len("file://") :])
            return True
        except OSError:
            return False

    def _gc(self) -> None:
        import time

        cutoff = time.time() - self.ttl_s
        try:
            for name in os.listdir(self.root):
                path = os.path.join(self.root, name)
                try:
                    if os.path.getmtime(path) < cutoff:
                        os.remove(path)
                except OSError:
                    continue
        except OSError:
            logging.debug(
                "payload store: gc sweep of %s failed", self.root,
                exc_info=True,
            )
            Telemetry.get_instance().inc(
                "comm_internal_errors_total", site="payload_gc"
            )


def _leaves_as_arrays(tree: Any) -> Any:
    """Every leaf as an array, as the JAX package's ``tree.map(np.asarray)``
    makes it (a Python scalar becomes a 0-d array); tensors stay tensors,
    for the codec to copy to the host."""
    if tree is None or isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        return {k: _leaves_as_arrays(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaves_as_arrays(v) for v in tree)
    return np.asarray(tree)


def params_to_bytes(params: Any) -> bytes:
    """The JAX package's bytes for the same tree (``core/wire.py``); a
    tensor leaf is copied to the host here."""
    return wire.msgpack_serialize(_leaves_as_arrays(params))


def params_from_bytes(data: bytes) -> Any:
    return wire.msgpack_restore(data)


class HybridCommunicationManager(BaseCommunicationManager, Observer):
    """control-plane transport + payload store = MQTT+S3 analog.

    Fields listed in ``payload_keys`` (default: the model payload) are
    moved to the store before the control message is sent; on receive
    they are fetched back before observers see the message.
    """

    def __init__(
        self,
        control: BaseCommunicationManager,
        store: PayloadStore,
        payload_keys=(
            constants.MSG_ARG_KEY_MODEL_PARAMS,
            constants.MSG_ARG_KEY_MODEL_DELTA,
        ),
    ) -> None:
        self.control = control
        self.store = store
        self.payload_keys = tuple(payload_keys)
        self._observers: List[Observer] = []
        # broadcast dedup: the server sends the SAME global model to N
        # receivers as N messages — upload once, reuse the URL
        self._last_upload: Optional[tuple] = None  # (digest, url)
        self.control.add_observer(self)

    # -- send path: swap payloads out ---------------------------------
    def send_message(self, msg: Message) -> None:
        import hashlib

        for key in self.payload_keys:
            value = msg.get(key)
            if value is not None:
                data = params_to_bytes(value)
                digest = hashlib.sha256(data).digest()
                if (
                    self._last_upload is not None
                    and self._last_upload[0] == digest
                    and self.store.touch(self._last_upload[1])
                ):
                    url = self._last_upload[1]
                else:
                    url = self.store.put(data)
                    self._last_upload = (digest, url)
                del msg.msg_params[key]
                msg.add(key + _URL_SUFFIX, url)
        self.control.send_message(msg)

    # -- receive path: swap payloads back in --------------------------
    def receive_message(self, msg_type: int, msg: Message) -> None:
        for key in self.payload_keys:
            url = msg.get(key + _URL_SUFFIX)
            if url is not None:
                msg.add(key, params_from_bytes(self.store.get(url)))
                del msg.msg_params[key + _URL_SUFFIX]
        for obs in list(self._observers):
            obs.receive_message(msg_type, msg)

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        if observer in self._observers:
            self._observers.remove(observer)

    def handle_receive_message(self) -> None:
        self.control.handle_receive_message()

    def stop_receive_message(self) -> None:
        self.control.stop_receive_message()
