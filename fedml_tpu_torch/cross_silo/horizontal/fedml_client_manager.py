"""Cross-silo client manager + trainer wrapper (port of
``fedml_tpu/cross_silo/horizontal/fedml_client_manager.py``).

Parity with ``python/fedml/cross_silo/horizontal/fedml_client_manager.py:14-171``
and ``fedml_trainer.py:4-60``: on CONNECTION_IS_READY announce ONLINE;
on init/sync set the global params, train the assigned silo, send the
result. Training is the port's ``local_train`` (a cohort of one), or a
custom ``ClientTrainer``'s per-client function (the L3 operator seam);
params stay on the device between receive and send on the LOCAL fabric.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from ... import constants
from ...core.aggregation import reconcile_to_device
from ...core.frame import bind_operator
from ...core.local_trainer import compute_dtype_from_args, make_local_train_fn
from ...core.managers import ClientManager
from ...core.message import Message
from ...core.optimizers import create_client_optimizer, resolve_round_lr_schedule
from ...core.types import Batches


def shuffle_generator(args, round_idx: int, client_index: int, device) -> torch.Generator:
    """The per-(round, silo) shuffle generator: seeded by the run seed
    and ``(round_idx * 100003 + i) % 2**31``, the JAX package's fold-in
    value (async dispatch seqs exceed 2**32, so the value is reduced
    into range). Every rank of a silo draws the same uniforms."""
    mix = (int(round_idx) * 100003 + int(client_index)) % (2**31)
    seed = np.random.SeedSequence(
        [int(getattr(args, "random_seed", 0) or 0), mix]
    ).generate_state(1, np.uint64)[0] >> 1
    return torch.Generator(device=device).manual_seed(int(seed))


class FedMLTrainer:
    """(fedml_trainer.py:4-60): holds the packed federation and the local
    update; ``update_dataset(index)`` switches silo. ``data_group`` (a
    hierarchical silo's process group) splits each batch's examples over
    the group's ranks, the gradient sums all-reduced
    (``make_local_train_fn``)."""

    def __init__(self, args, dataset, model, client_trainer=None, data_group=None) -> None:
        self.args = args
        self.dataset = dataset
        self.model = model
        self.device = model.device
        self.client_index: Optional[int] = None
        self.shuffle = bool(getattr(args, "shuffle", True))
        self.epochs = int(args.epochs)
        # round-indexed LR (decay across the federation)
        self._round_lr = resolve_round_lr_schedule(args)
        self._custom = None
        self._fn = None
        if client_trainer is not None:
            if self._round_lr is not None:
                raise ValueError(
                    "lr_schedule with a custom client_trainer: the "
                    "trainer owns its optimizer — implement the "
                    "schedule inside it or use lr_schedule=constant"
                )
            if data_group is not None:
                raise ValueError(
                    "a custom client_trainer trains its client whole; it "
                    "cannot split batches over a silo's process group"
                )
            # the L3 operator seam (core/frame.py): the same per-client
            # function the simulators consume
            self._custom = bind_operator(client_trainer, model, args).make_train_fn(args)
        else:
            self._fn = make_local_train_fn(
                model.apply,
                model.loss_fn,
                create_client_optimizer(
                    args,
                    lr=float(args.learning_rate) if self._round_lr is not None else None,
                ),
                epochs=self.epochs,
                prox_mu=float(getattr(args, "fedprox_mu", 0.0) or 0.0),
                shuffle=self.shuffle,
                compute_dtype=compute_dtype_from_args(args),
                data_group=data_group,
            )

    def update_dataset(self, client_index: int) -> None:
        self.client_index = int(client_index)

    def _uniforms(self, round_idx: int, client: Batches) -> Optional[torch.Tensor]:
        if not self.shuffle:
            return None
        dev = client.mask.device
        n = client.num_batches * client.batch_size
        gen = shuffle_generator(self.args, round_idx, self.client_index, dev)
        return torch.rand((1, self.epochs, n), generator=gen, device=dev)

    def train(self, params, round_idx: int):
        i = self.client_index
        params = reconcile_to_device(params, self.device)
        packed = self.dataset.packed_train
        client = Batches(x=packed.x[i:i + 1], y=packed.y[i:i + 1], mask=packed.mask[i:i + 1])
        rng = self._uniforms(round_idx, client)
        if self._custom is not None:
            one = Batches(x=client.x[0], y=client.y[0], mask=client.mask[0])
            new_params, _ = self._custom(params, one, None if rng is None else rng[0])
        else:
            mult = None
            if self._round_lr is not None:
                mult = float(np.float32(
                    self._round_lr(round_idx) / float(self.args.learning_rate)))
            stacked, _ = self._fn(params, client, rng, mult)
            new_params = {k: v[0] for k, v in stacked.items()}
        n = float(self.dataset.packed_num_samples[i])
        return new_params, n


class FedMLClientManager(ClientManager):
    def __init__(self, args, trainer: FedMLTrainer, comm=None, rank=0, size=0,
                 backend=constants.COMM_BACKEND_LOCAL) -> None:
        super().__init__(args, comm, rank, size, backend)
        self.trainer = trainer
        self.server_rank = 0
        from ...core.compression import EncoderState, make_codec
        from ...core.tracking import ProfilerEvent

        codec = make_codec(args)
        self._encoder = EncoderState(codec) if codec is not None else None
        # async mode: uploads ship update DELTAS (the FedBuff currency),
        # encoded when a codec is configured
        self._async = str(getattr(args, "agg_mode", "stream")) == "async"
        # spans at the reference's instrumentation points
        # (client_master_manager.py:117-121: train / comm_c2s)
        self.profiler = ProfilerEvent(args)
        self.telemetry.attach_profiler(self.profiler)
        # liveness beats (core/comm/heartbeat.py): started once the
        # connection is up; they feed the server's failure detector and
        # double as the reconnect probe after a server restart
        self._heartbeat = None
        self._heartbeat_interval_s = float(getattr(args, "heartbeat_interval_s", 0.0) or 0.0)

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            constants.MSG_TYPE_CONNECTION_IS_READY, self.handle_connection_ready
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_S2C_INIT_CONFIG, self.handle_message_init
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
            self.handle_message_receive_model_from_server,
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_S2C_RESYNC, self.handle_message_resync
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_S2C_FINISH, self.handle_message_finish
        )

    # -- handlers (fedml_client_manager.py:49-130) --------------------
    def handle_connection_ready(self, msg: Message) -> None:
        self.send_client_status(self.server_rank)
        if self._heartbeat_interval_s > 0 and self._heartbeat is None:
            from ...core.comm.heartbeat import HeartbeatEmitter

            self._heartbeat = HeartbeatEmitter(
                self._send_heartbeat, self._heartbeat_interval_s
            ).start()

    def _send_heartbeat(self) -> None:
        # a fresh Message per beat: the LOCAL fabric passes objects by
        # reference, so a reused envelope would alias in-flight beats
        self.send_message(
            Message(constants.MSG_TYPE_C2S_HEARTBEAT, self.rank, self.server_rank)
        )

    def send_client_status(self, receiver_id: int) -> None:
        msg = Message(constants.MSG_TYPE_C2S_CLIENT_STATUS, self.rank, receiver_id)
        msg.add_params(constants.MSG_ARG_KEY_CLIENT_STATUS, constants.CLIENT_STATUS_ONLINE)
        self.send_message(msg)

    def leave(self) -> None:
        """Graceful exit from an elastic federation: announce OFFLINE and
        stop the receive loop."""
        msg = Message(constants.MSG_TYPE_C2S_CLIENT_STATUS, self.rank, self.server_rank)
        msg.add_params(constants.MSG_ARG_KEY_CLIENT_STATUS, constants.CLIENT_STATUS_OFFLINE)
        self.send_message(msg)
        self.finish()

    def handle_message_init(self, msg: Message) -> None:
        self._train_and_send(msg)

    def handle_message_receive_model_from_server(self, msg: Message) -> None:
        self._train_and_send(msg)

    def handle_message_resync(self, msg: Message) -> None:
        """Crash-recovery downlink: the server ships the CURRENT round +
        params instead of a stale init; train it like any sync."""
        logging.info(
            "client rank %d: RESYNC to round %s",
            self.rank, msg.get(constants.MSG_ARG_KEY_ROUND_INDEX),
        )
        self.telemetry.inc("cross_silo_client_resyncs_total")
        self._train_and_send(msg)

    def handle_message_finish(self, msg: Message) -> None:
        logging.info("client rank %d: finish", self.rank)
        self.finish()

    def finish(self) -> None:
        self._stop_heartbeat()
        super().finish()

    def _stop_heartbeat(self) -> None:
        if self._heartbeat is not None:
            self._heartbeat.stop()
            self._heartbeat = None

    def _train_and_send(self, msg: Message) -> None:
        from ...core.chaos import ProcessKilled, chaos_barrier

        try:
            # named chaos barrier: a scheduled kill_client here is the
            # kill -9 analog; the beat thread dies with the "process" (a
            # corpse that kept beating would defeat the failure detector)
            chaos_barrier(
                "client.train",
                round=int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX, 0)),
                rank=self.rank,
            )
        except ProcessKilled:
            self._stop_heartbeat()
            raise
        params = reconcile_to_device(
            msg.get(constants.MSG_ARG_KEY_MODEL_PARAMS), self.trainer.device
        )
        client_index = msg.get(constants.MSG_ARG_KEY_CLIENT_INDEX)
        round_idx = int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX, 0))
        self.trainer.update_dataset(client_index)
        t_train = time.perf_counter()
        with self.profiler.span("train", round=round_idx, rank=self.rank):
            new_params, n = self.trainer.train(params, round_idx)
        train_s = time.perf_counter() - t_train
        self.telemetry.heartbeat(f"client{self.rank}.train", round_idx)
        out = Message(constants.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.rank, self.server_rank)
        # causal link: the upload names the broadcast that caused it
        from ...core.tracing import continue_context

        continue_context(msg, out)
        # how long local training ran, for the server's live attribution
        out.add_params(constants.MSG_ARG_KEY_TRAIN_SECONDS, float(train_s))
        # async staleness bookkeeping: echo the publish version this
        # model came from
        base_version = msg.get(constants.MSG_ARG_KEY_MODEL_VERSION)
        if base_version is not None:
            out.add_params(constants.MSG_ARG_KEY_MODEL_VERSION, base_version)
        if self._encoder is not None or self._async:
            # compressed uplink (core/compression.py) or async: the update
            # delta against the broadcast global
            delta = {k: new_params[k] - params[k] for k in new_params}
            out.add_params(
                constants.MSG_ARG_KEY_MODEL_DELTA,
                self._encoder.encode(delta) if self._encoder is not None else delta,
            )
        else:
            out.add_params(constants.MSG_ARG_KEY_MODEL_PARAMS, new_params)
        out.add_params(constants.MSG_ARG_KEY_NUM_SAMPLES, n)
        # round tag: lets a deadline-cohort server discard stale uploads
        out.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, round_idx)
        with self.profiler.span("comm_c2s"):
            self.send_message(out)
