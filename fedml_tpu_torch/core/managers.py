"""L2 distributed managers: backend dispatch + handler registry + run loop
(port of ``fedml_tpu/core/managers.py``).

Parity with ``python/fedml/core/distributed/client/client_manager.py:20-148``
and ``server/server_manager.py:19-143``: constructor is a backend
dispatch table, ``run()`` registers handlers then blocks in
``com_manager.handle_receive_message()``, handlers keyed by message
type via ``register_message_receive_handler``.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

from .. import constants
from .comm.base import BaseCommunicationManager, Observer
from .comm.local import LocalCommunicationManager
from .message import Message


def _build_com_manager(
    args, rank: int, size: int, backend: str
) -> BaseCommunicationManager:
    """Backend dispatch (client_manager.py:27-94)."""
    backend = (backend or constants.COMM_BACKEND_LOCAL).upper()
    if backend in (constants.COMM_BACKEND_LOCAL, constants.COMM_BACKEND_MPI):
        # MPI maps onto the in-process fabric, as in the JAX package
        fabric = f"run_{getattr(args, 'run_id', '0')}"
        return LocalCommunicationManager(fabric, rank, size)
    if backend == constants.COMM_BACKEND_GRPC:
        # NOTE: the transport's per-RPC retry budget deliberately stays
        # the class default (small, fixed) rather than comm_retry_max —
        # with reliable_comm the channel's retransmits call back into
        # this send, and wiring the same knob into both layers would
        # multiply the budgets (retry_max^2 RPCs per give-up)
        return build_grpc_manager(
            rank,
            size,
            ipconfig_path=getattr(args, "grpc_ipconfig_path", None),
            port_base=int(getattr(args, "grpc_port_base", 8890)),
            send_timeout_s=float(getattr(args, "grpc_send_timeout_s", 300.0)),
        )
    if backend == constants.COMM_BACKEND_TRPC:
        from .comm.tensor_rpc import TensorRpcCommunicationManager

        # fall back to the grpc_* keys symmetrically (path AND port) so
        # flipping backend GRPC->TRPC on an existing config just works
        path = getattr(args, "trpc_ipconfig_path", None) or getattr(
            args, "grpc_ipconfig_path", None
        )
        port_base = getattr(args, "trpc_port_base", None) or getattr(
            args, "grpc_port_base", 8890
        )
        return TensorRpcCommunicationManager(
            rank=rank,
            size=size,
            ip_config=_load_ip_config(path) if path else None,
            port_base=int(port_base),
        )
    if backend in (constants.COMM_BACKEND_MQTT, constants.COMM_BACKEND_MQTT_S3):
        from .comm.broker import broker_for_run, ensure_broker
        from .comm.mqtt_backend import MqttCommunicationManager

        run_id = str(getattr(args, "run_id", "0"))
        port = int(getattr(args, "broker_port", 0))
        if port:
            host, port = ensure_broker(getattr(args, "broker_host", "127.0.0.1"), port)
        else:
            host, port = broker_for_run(run_id)
        control = MqttCommunicationManager(
            rank=rank, size=size, broker_host=host, broker_port=port, run_id=run_id
        )
        if backend == constants.COMM_BACKEND_MQTT:
            return control
        from .comm.payload_store import FilePayloadStore, HybridCommunicationManager

        store = FilePayloadStore(getattr(args, "payload_store_dir", None))
        return HybridCommunicationManager(control, store)
    raise ValueError(f"unsupported comm backend {backend!r}")


def _wrap_comm_stack(com: BaseCommunicationManager, args):
    """THE wrap pyramid, one copy (``_ManagerBase`` and
    ``build_comm_stack`` both route through it): telemetry/tracing
    instrumentation innermost (wire-traffic semantics — a dropped
    message never left, a duplicated one left twice), fault injection
    above it, the ReliableChannel OUTERMOST so retransmits re-traverse
    the injector. The chaos plane (``core/chaos.py``) is installed
    first, so the injector's scheduled send faults see this world's
    schedule."""
    from .chaos import maybe_install_chaos
    from .comm.faults import maybe_wrap_faulty

    maybe_install_chaos(args)
    from .comm.instrument import wrap_instrumented
    from .comm.reliable import maybe_wrap_reliable

    return maybe_wrap_reliable(
        maybe_wrap_faulty(wrap_instrumented(com, args), args), args
    )


def build_comm_stack(
    args,
    rank: int,
    size: int,
    backend: str,
    run_id=None,
    port_base=None,
):
    """Build a FULLY WRAPPED communication manager outside a manager
    class — the hierarchical server plane's second hop (an edge process
    is rank 0 of its client fabric AND a client-side rank of the root
    fabric, so it needs two stacks). Wrapping is ``_wrap_comm_stack``
    — identical to every manager's. ``run_id``/``port_base`` override
    the fabric identity without mutating the caller's args (LOCAL
    fabric name / gRPC port block per hop)."""
    import copy

    hop_args = copy.copy(args)
    hop_args.rank = int(rank)
    if run_id is not None:
        hop_args.run_id = run_id
    if port_base is not None:
        hop_args.grpc_port_base = int(port_base)
    return _wrap_comm_stack(
        _build_com_manager(hop_args, rank, size, backend), hop_args
    )


def build_grpc_manager(
    rank: int,
    size: int,
    ipconfig_path: Optional[str],
    port_base: int,
    send_timeout_s: float = 300.0,
    send_retries: int = 2,
    retry_base_s: float = 0.2,
):
    """Shared gRPC endpoint builder — used for the FL world and for
    silo control fabrics (cross_silo/hierarchical)."""
    from .comm.grpc_backend import GrpcCommunicationManager

    ip_config = _load_ip_config(ipconfig_path) if ipconfig_path else None
    return GrpcCommunicationManager(
        rank=rank,
        size=size,
        ip_config=ip_config,
        port_base=port_base,
        send_timeout_s=send_timeout_s,
        send_retries=send_retries,
        retry_base_s=retry_base_s,
    )


def _load_ip_config(path: str) -> Dict[int, str]:
    """CSV rank,ip table (reference ip_config_utils.py)."""
    table: Dict[int, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("receiver_id"):
                continue
            rank_s, ip = line.split(",")[:2]
            table[int(rank_s)] = ip.strip()
    return table


class _ManagerBase(Observer):
    def __init__(
        self,
        args,
        comm: Optional[BaseCommunicationManager] = None,
        rank: int = 0,
        size: int = 0,
        backend: str = constants.COMM_BACKEND_LOCAL,
    ) -> None:
        self.args = args
        self.rank = int(rank)
        self.size = int(size)
        self.backend = backend
        self.com_manager = comm if comm is not None else _build_com_manager(
            args, rank, size, backend
        )
        from .telemetry import Telemetry

        self.telemetry = Telemetry.get_instance(args)
        # ONE wrap pyramid (see _wrap_comm_stack): instrumentation
        # innermost, fault injection above it, the reliable channel
        # outermost
        self.com_manager = _wrap_comm_stack(self.com_manager, args)
        self.com_manager.add_observer(self)
        self.message_handler_dict: Dict[int, Callable[[Message], None]] = {}

    def run(self) -> None:
        self.register_message_receive_handlers()
        self.on_ready()
        self.com_manager.handle_receive_message()
        logging.info("rank %d manager loop exited", self.rank)

    def on_ready(self) -> None:
        """Called once before the receive loop; transports with no
        connection phase use it to synthesize CONNECTION_IS_READY
        (the reference's MQTT on_connect analog)."""
        handler = self.message_handler_dict.get(constants.MSG_TYPE_CONNECTION_IS_READY)
        if handler is not None:
            msg = Message(constants.MSG_TYPE_CONNECTION_IS_READY, self.rank, self.rank)
            handler(msg)

    def register_message_receive_handlers(self) -> None:
        """Subclasses register their handlers here."""

    def register_message_receive_handler(
        self, msg_type: int, handler: Callable[[Message], None]
    ) -> None:
        self.message_handler_dict[int(msg_type)] = handler

    def receive_message(self, msg_type: int, msg_params: Message) -> None:
        handler = self.message_handler_dict.get(int(msg_type))
        if handler is None:
            logging.warning(
                "rank %d: no handler for msg_type %s", self.rank, msg_type
            )
            return
        handler(msg_params)

    def send_message(self, message: Message) -> None:
        self.com_manager.send_message(message)

    def finish(self) -> None:
        """Teardown (client_manager.py:135-148)."""
        self.com_manager.stop_receive_message()


class ClientManager(_ManagerBase):
    """(client_manager.py:20-148)"""


class ServerManager(_ManagerBase):
    """(server_manager.py:19-143)"""
