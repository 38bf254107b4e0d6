"""Cross-device scenario, the legacy model-file plane: the server side
(port of ``fedml_tpu/cross_device/server.py``).

Reference: ``cross_device/mnn_server.py:6-28`` -> ``server_mnn/
server_mnn_api.py:10-66`` -> ``server_mnn/fedml_server_manager.py`` +
``server_mnn/fedml_aggregator.py:15-120``. Edge clients (Android/MNN in
the reference; any npz reader here) upload model files through the
payload store; the server turns files into tensors around a weighted
average (``server_mnn/utils.py:11-51``) and redistributes a file URL.
The average and the evaluation run on the server's device, plain torch
as the JAX package's are plain XLA; the files touch only the edges.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

import torch

from .. import constants
from ..core.aggregation import normalize_weights, stack_pytrees, weighted_average
from ..core.comm.payload_store import FilePayloadStore, PayloadStore
from ..core.local_trainer import compute_dtype_from_args, make_eval_fn
from ..core.managers import ServerManager
from ..core.message import Message
from .model_file import model_bytes_to_params, params_to_model_bytes

__all__ = ["CrossDeviceAggregator", "CrossDeviceServerManager", "ServerEdge"]

# how long the server waits for every client's FINISH ack before it stops
_FINISH_WATCHDOG_S = 15.0


class CrossDeviceAggregator:
    """The file-boundary aggregator (``server_mnn/fedml_aggregator.py``)."""

    def __init__(self, args, global_params, store: PayloadStore, model=None,
                 test_data=None) -> None:
        self.args = args
        self.store = store
        self.model = model
        self.test_data = test_data
        self.global_params = global_params
        self.device = next(iter(global_params.values())).device
        self.client_num = int(args.client_num_per_round)
        self._results: Dict[int, str] = {}
        self._sample_nums: Dict[int, float] = {}
        self.history: List[Dict[str, float]] = []
        self._eval = None
        if model is not None and test_data is not None:
            self._eval = make_eval_fn(
                model.apply, model.loss_fn, compute_dtype=compute_dtype_from_args(args)
            )

    # -- round bookkeeping (fedml_aggregator.py:40-70) ----------------
    def add_local_trained_result(self, index: int, model_file_url: str,
                                 sample_num: float) -> None:
        self._results[index] = model_file_url
        self._sample_nums[index] = float(sample_num)

    def check_whether_all_receive(self) -> bool:
        return len(self._results) >= self.client_num

    def get_global_model_file_url(self) -> str:
        return self.store.put(params_to_model_bytes(self.global_params))

    def aggregate(self) -> None:
        """Download the files -> tensors on the device -> weighted average
        -> the new global model (fedml_aggregator.py:~70, utils.py:11-51)."""
        idxs = sorted(self._results)
        trees = [
            {k: torch.as_tensor(v, device=self.device)
             for k, v in model_bytes_to_params(self.store.get(self._results[i]),
                                               flat=True).items()}
            for i in idxs
        ]
        ns = torch.tensor([self._sample_nums[i] for i in idxs], device=self.device)
        self.global_params = weighted_average(stack_pytrees(trees), normalize_weights(ns))
        self._results.clear()
        self._sample_nums.clear()

    def test_on_server_for_all_clients(self, round_idx: int) -> None:
        """Evaluate the global model on the test split every
        ``frequency_of_the_test`` rounds and after the last, as the
        simulator does (the JAX server evaluates every round)."""
        freq = max(1, int(getattr(self.args, "frequency_of_the_test", 5)))
        last = round_idx == int(self.args.comm_round) - 1
        if self._eval is None or self.test_data is None or not (round_idx % freq == 0 or last):
            return
        sums = self._eval(self.global_params, self.test_data)
        stats = self.model.metrics_from_sums(sums)
        stats["round"] = round_idx
        self.history.append(stats)
        logging.info("cross-device round %d: %s", round_idx, stats)


class CrossDeviceServerManager(ServerManager):
    """The round loop over the file-shipping protocol
    (``server_mnn/fedml_server_manager.py:15+``)."""

    def __init__(self, args, aggregator: CrossDeviceAggregator, comm=None,
                 rank=0, size=0, backend=constants.COMM_BACKEND_MQTT) -> None:
        super().__init__(args, comm, rank, size, backend)
        self.aggregator = aggregator
        self.round_num = int(args.comm_round)
        self.round_idx = 0
        self.client_ranks = list(range(1, size))
        self.client_online_status: Dict[int, bool] = {}
        self.is_initialized = False
        self.finish_acks: Dict[int, bool] = {}
        self._finish_watchdog: Optional[threading.Timer] = None

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            constants.MSG_TYPE_C2S_CLIENT_STATUS, self.handle_message_client_status
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
            self.handle_message_receive_model_from_client,
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_C2S_FINISH_ACK, self.handle_finish_ack
        )

    def handle_message_client_status(self, msg: Message) -> None:
        if msg.get(constants.MSG_ARG_KEY_CLIENT_STATUS) == constants.CLIENT_STATUS_ONLINE:
            self.client_online_status[msg.get_sender_id()] = True
        if (
            all(self.client_online_status.get(r, False) for r in self.client_ranks)
            and not self.is_initialized
        ):
            self.is_initialized = True
            self._broadcast_model_file(constants.MSG_TYPE_S2C_INIT_CONFIG)

    def _broadcast_model_file(self, msg_type: int) -> None:
        url = self.aggregator.get_global_model_file_url()
        for rank in self.client_ranks:
            msg = Message(msg_type, self.rank, rank)
            msg.add_params(constants.MSG_ARG_KEY_MODEL_FILE_URL, url)
            msg.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, self.round_idx)
            # the device-side dataset assignment (client_real_ids analog)
            msg.add_params(constants.MSG_ARG_KEY_CLIENT_INDEX, rank - 1)
            self.send_message(msg)

    def handle_message_receive_model_from_client(self, msg: Message) -> None:
        self.aggregator.add_local_trained_result(
            msg.get_sender_id(),
            msg.get(constants.MSG_ARG_KEY_MODEL_FILE_URL),
            msg.get(constants.MSG_ARG_KEY_NUM_SAMPLES),
        )
        if not self.aggregator.check_whether_all_receive():
            return
        self.aggregator.aggregate()
        self.aggregator.test_on_server_for_all_clients(self.round_idx)
        self.round_idx += 1
        if self.round_idx >= self.round_num:
            # drain: wait for the FINISH acks, so that the broker (often
            # a child of this process) is not torn down with messages in
            # flight
            self._finish_watchdog = threading.Timer(_FINISH_WATCHDOG_S, self.finish)
            self._finish_watchdog.daemon = True
            self._finish_watchdog.start()
            for rank in self.client_ranks:
                self.send_message(Message(constants.MSG_TYPE_S2C_FINISH, self.rank, rank))
            logging.info("cross-device server: finished %d rounds", self.round_idx)
            return
        self._broadcast_model_file(constants.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT)

    def handle_finish_ack(self, msg: Message) -> None:
        self.finish_acks[msg.get_sender_id()] = True
        if all(self.finish_acks.get(r) for r in self.client_ranks):
            self._finish_watchdog.cancel()
            self.finish()


class ServerEdge:
    """The one-line facade (``ServerMNN``, cross_device/mnn_server.py:6-28).
    Like the cross-silo facades, it runs where its model lies, and its
    ``device`` must name that place."""

    def __init__(self, args, device, dataset, model, store: Optional[PayloadStore] = None):
        from ..cross_silo import check_device

        check_device(device, model)
        self.args = args
        store = store or FilePayloadStore(getattr(args, "payload_store_dir", None))
        global_params = model.init(
            torch.Generator().manual_seed(int(getattr(args, "random_seed", 0)))
        )
        size = int(getattr(args, "client_num_per_round", 0)) + 1
        self.aggregator = CrossDeviceAggregator(
            args, global_params, store, model=model,
            test_data=dataset.test_data_global if dataset is not None else None,
        )
        self.manager = CrossDeviceServerManager(
            args,
            self.aggregator,
            rank=0,
            size=size,
            backend=getattr(args, "cross_device_backend", constants.COMM_BACKEND_MQTT),
        )

    def run(self) -> List[Dict[str, float]]:
        """Serve ``comm_round`` rounds; returns the evaluation history."""
        self.manager.run()
        return self.aggregator.history
