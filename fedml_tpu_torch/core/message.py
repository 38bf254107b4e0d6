"""Transport-agnostic message envelope (port of ``fedml_tpu/core/message.py``).

Parity with the reference's ``core/distributed/communication/message.py``:
a dict envelope carrying ``msg_type`` / ``sender`` / ``receiver`` plus
arbitrary params; ``MSG_ARG_KEY_MODEL_PARAMS`` carries the model payload.

The wire format is the JAX package's: msgpack as
``flax.serialization.msgpack_serialize`` writes it, here written by the
port's own codec (``core/wire.py``), so the two packages read each
other's frames. Tensors become host bytes at the transport boundary
only (a CUDA tensor is copied to the host there); the in-process LOCAL
fabric passes the message itself, tensors and all, by reference.
"""

from __future__ import annotations

from typing import Any, Dict

from .. import constants
from . import wire


class Message:
    MSG_ARG_KEY_TYPE = constants.MSG_ARG_KEY_TYPE
    MSG_ARG_KEY_SENDER = constants.MSG_ARG_KEY_SENDER
    MSG_ARG_KEY_RECEIVER = constants.MSG_ARG_KEY_RECEIVER
    MSG_ARG_KEY_MODEL_PARAMS = constants.MSG_ARG_KEY_MODEL_PARAMS
    MSG_ARG_KEY_NUM_SAMPLES = constants.MSG_ARG_KEY_NUM_SAMPLES
    MSG_ARG_KEY_CLIENT_INDEX = constants.MSG_ARG_KEY_CLIENT_INDEX
    MSG_ARG_KEY_CLIENT_STATUS = constants.MSG_ARG_KEY_CLIENT_STATUS
    MSG_ARG_KEY_ROUND_INDEX = constants.MSG_ARG_KEY_ROUND_INDEX

    def __init__(self, msg_type: int = 0, sender_id: int = 0, receiver_id: int = 0):
        self.msg_params: Dict[str, Any] = {
            self.MSG_ARG_KEY_TYPE: int(msg_type),
            self.MSG_ARG_KEY_SENDER: int(sender_id),
            self.MSG_ARG_KEY_RECEIVER: int(receiver_id),
        }

    # -- accessors (the reference's message.py:24-66) ------------------
    def get_sender_id(self) -> int:
        return self.msg_params[self.MSG_ARG_KEY_SENDER]

    def get_receiver_id(self) -> int:
        return self.msg_params[self.MSG_ARG_KEY_RECEIVER]

    def get_type(self) -> int:
        return self.msg_params[self.MSG_ARG_KEY_TYPE]

    def add_params(self, key: str, value: Any) -> None:
        self.msg_params[key] = value

    def add(self, key: str, value: Any) -> None:
        self.msg_params[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        return self.msg_params.get(key, default)

    def get_params(self) -> Dict[str, Any]:
        return self.msg_params

    # -- wire format ---------------------------------------------------
    def to_bytes(self) -> bytes:
        """msgpack bytes, byte for byte what the JAX package writes for
        the same params (tensor leaves go out as host arrays)."""
        return wire.msgpack_serialize(self.msg_params)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Message":
        m = cls()
        m.msg_params = wire.msgpack_restore(data)
        return m

    def __repr__(self) -> str:  # pragma: no cover
        keys = {k: type(v).__name__ for k, v in self.msg_params.items()}
        return f"Message(type={self.get_type()}, {keys})"
