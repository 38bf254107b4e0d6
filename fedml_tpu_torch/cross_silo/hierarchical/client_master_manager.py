"""Silo master: FL protocol outward, silo broadcast inward (port of
``fedml_tpu/cross_silo/hierarchical/client_master_manager.py``).

Parity with ``cross_silo/hierarchical/client_master_manager.py:48-269``:
the rank-0 process of a silo speaks the horizontal 3-message FedAvg
protocol to the server, and before every local round ships
``[round_idx, params, client_index]`` to the silo's slave processes
(``sync_process_group`` :239-249 uses ``dist.broadcast_object_list``;
here the triple is a message on the silo-private control fabric, see
``process_group_manager.build_silo_fabric``). Then the master and the
slaves take the same steps, each on its share of every batch. On FINISH
the master relays a silo-finish so slaves exit their loops.
"""

from __future__ import annotations

import logging

from ... import constants
from ...core.message import Message
from ..horizontal.fedml_client_manager import FedMLClientManager


class ClientMasterManager(FedMLClientManager):
    def __init__(self, args, trainer, process_group, **kw) -> None:
        super().__init__(args, trainer, **kw)
        self.pg = process_group
        # control fabric: master is silo-rank 0, slaves 1..n-1
        self._silo_com = self.pg.build_fabric()

    def sync_process_group(self, round_idx, params, client_index) -> None:
        """(client_master_manager.py:239-249)"""
        for slave in self.pg.slave_ranks():
            msg = Message(constants.MSG_TYPE_SILO_SYNC_PROCESS_GROUP, 0, slave)
            msg.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, round_idx)
            msg.add_params(constants.MSG_ARG_KEY_MODEL_PARAMS, params)
            msg.add_params(constants.MSG_ARG_KEY_CLIENT_INDEX, client_index)
            self._silo_com.send_message(msg)

    def _train_and_send(self, msg: Message) -> None:
        params = msg.get(constants.MSG_ARG_KEY_MODEL_PARAMS)
        client_index = msg.get(constants.MSG_ARG_KEY_CLIENT_INDEX)
        round_idx = int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX, 0))
        self.sync_process_group(round_idx, params, client_index)
        super()._train_and_send(msg)

    def handle_message_finish(self, msg: Message) -> None:
        for slave in self.pg.slave_ranks():
            self._silo_com.send_message(Message(constants.MSG_TYPE_SILO_FINISH, 0, slave))
        logging.info("silo master rank %d: finish", self.rank)
        # release the fabric (gRPC server/channels; a LOCAL fabric is
        # dropped so a later run reusing this run_id starts fresh)
        self._silo_com.stop_receive_message()
        if hasattr(self._silo_com, "destroy_fabric"):
            self._silo_com.destroy_fabric()
        super().handle_message_finish(msg)
        self.pg.cleanup()
