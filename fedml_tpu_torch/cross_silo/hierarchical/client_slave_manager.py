"""Silo slave: block on the round broadcast, join the silo's step (port
of ``fedml_tpu/cross_silo/hierarchical/client_slave_manager.py``).

Parity with ``cross_silo/hierarchical/client_slave_manager.py:5-54``
(``await_sync_process_group`` :39-50 blocks on the rank-0 broadcast,
then trains). The slave never talks to the FL server: its whole world
is the silo-private control fabric plus the silo's process group, whose
collectives it joins by taking the master's steps on its own share.
"""

from __future__ import annotations

import logging

from ... import constants
from ...core.comm.base import Observer
from ...core.message import Message


class ClientSlaveManager(Observer):
    def __init__(self, args, trainer, process_group) -> None:
        self.args = args
        self.trainer = trainer
        self.pg = process_group
        self._com = self.pg.build_fabric()
        self._com.add_observer(self)
        self.rounds_joined = 0

    def receive_message(self, msg_type, msg: Message) -> None:
        """(client_slave_manager.py:39-50 await_sync_process_group)"""
        if msg_type == constants.MSG_TYPE_SILO_SYNC_PROCESS_GROUP:
            round_idx = int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX, 0))
            params = msg.get(constants.MSG_ARG_KEY_MODEL_PARAMS)
            client_index = msg.get(constants.MSG_ARG_KEY_CLIENT_INDEX)
            self.trainer.update_dataset(int(client_index))
            self.trainer.participate(params, round_idx)
            self.rounds_joined += 1
        elif msg_type == constants.MSG_TYPE_SILO_FINISH:
            self._com.stop_receive_message()
        else:
            logging.warning("silo slave: unexpected msg_type %s", msg_type)

    def run(self) -> None:
        self._com.handle_receive_message()  # blocks until SILO_FINISH
        if hasattr(self._com, "destroy_fabric"):
            self._com.destroy_fabric()
        logging.info(
            "silo slave %d/%d: finish", self.pg.proc_rank_in_silo, self.pg.n_proc_in_silo,
        )
        self.pg.cleanup()
