"""Simulated edge device of the legacy model-file plane (port of
``fedml_tpu/cross_device/client_sim.py``).

The reference's cross-device clients are Android apps driven over MQTT.
This simulator speaks the same server protocol: announce ONLINE,
download the model file, train locally, upload a model file and the
sample count, so the whole round loop runs on one host. Its local update
is the port's ``local_train`` (``core/local_trainer.py``) on its own
batches as a cohort of one, on the device its batches lie on.
"""

from __future__ import annotations

import logging
import threading

import torch

from .. import constants
from ..core.comm.payload_store import PayloadStore
from ..core.managers import ClientManager
from ..core.message import Message
from ..core.types import Batches
from .model_file import model_bytes_to_params, params_to_model_bytes

__all__ = ["EdgeClientSim"]

# re-announce period until the server answers
_ANNOUNCE_S = 0.5


class EdgeClientSim(ClientManager):
    """One edge client. ``trainer`` is a ``make_local_train_fn`` result
    (``local_train(params, batches, rng)``); ``local_data`` its
    ``Batches`` ``[nb, bs, ...]``. Each round's shuffle draws its
    uniforms from a generator seeded by ``random_seed + rank``
    (``uniforms``)."""

    def __init__(self, args, trainer, local_data: Batches, store: PayloadStore,
                 comm=None, rank=0, size=0,
                 backend=constants.COMM_BACKEND_MQTT) -> None:
        super().__init__(args, comm, rank, size, backend)
        self.trainer = trainer
        self.local_data = Batches(x=local_data.x[None], y=local_data.y[None],
                                  mask=local_data.mask[None])
        self.device = local_data.mask.device
        self.store = store
        self.epochs = int(getattr(args, "epochs", 1))
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(getattr(args, "random_seed", 0)) + int(rank))
        self.num_samples = float(local_data.mask.sum())
        self._synced = threading.Event()
        self.round_idx = 0

    def uniforms(self, round_idx: int) -> torch.Tensor:
        """The shuffle's uniforms of a round: ``[1, epochs, nb*bs]``."""
        n = self.local_data.mask[0].numel()
        return torch.rand((1, self.epochs, n), generator=self.generator, device=self.device)

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            constants.MSG_TYPE_CONNECTION_IS_READY, self.handle_connection_ready
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_S2C_INIT_CONFIG, self.handle_sync_model
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, self.handle_sync_model
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_S2C_FINISH, self.handle_finish
        )

    def handle_connection_ready(self, msg: Message) -> None:
        """Announce ONLINE, and again every 0.5 s until the server answers:
        the broker drops publishes made before the server subscribed, so
        a single announcement can deadlock the presence handshake."""

        def send_online() -> None:
            status = Message(constants.MSG_TYPE_C2S_CLIENT_STATUS, self.rank, 0)
            status.add_params(constants.MSG_ARG_KEY_CLIENT_STATUS,
                              constants.CLIENT_STATUS_ONLINE)
            self.send_message(status)

        def announce() -> None:
            while not self._synced.wait(_ANNOUNCE_S):
                try:
                    send_online()
                except Exception:  # the transport is gone: stop announcing
                    logging.exception("edge client %d: announce failed", self.rank)
                    return

        send_online()
        threading.Thread(target=announce, daemon=True).start()

    def handle_sync_model(self, msg: Message) -> None:
        self._synced.set()
        self.round_idx = int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX, 0))
        url = msg.get(constants.MSG_ARG_KEY_MODEL_FILE_URL)
        params = {
            k: torch.as_tensor(v, device=self.device)
            for k, v in model_bytes_to_params(self.store.get(url), flat=True).items()
        }
        stacked, _ = self.trainer(params, self.local_data, self.uniforms(self.round_idx))
        out_url = self.store.put(params_to_model_bytes({k: v[0] for k, v in stacked.items()}))
        reply = Message(constants.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.rank, 0)
        reply.add_params(constants.MSG_ARG_KEY_MODEL_FILE_URL, out_url)
        reply.add_params(constants.MSG_ARG_KEY_NUM_SAMPLES, self.num_samples)
        self.send_message(reply)

    def handle_finish(self, msg: Message) -> None:
        self._synced.set()
        self.send_message(Message(constants.MSG_TYPE_C2S_FINISH_ACK, self.rank, 0))
        logging.info("edge client %d: finish", self.rank)
        self.finish()
