"""Comm-layer telemetry instrumentation for any transport (port of
``fedml_tpu/core/comm/instrument.py``).

Same decorator pattern as ``faults.maybe_wrap_faulty``: wrap any
``BaseCommunicationManager`` (local / grpc / mqtt / tensor_rpc) and
count messages, payload bytes and send latency per message type into
the process-wide ``Telemetry`` registry (``core/telemetry.py``), plus
flight-recorder spans so comm activity lands on the same perfetto
timeline as compute spans.

Distributed tracing (``core/tracing.py``): every outbound message is
stamped with trace context (``trace_id`` + a per-send unique flow id)
and every wire send/receive becomes a ``comm.send``/``comm.recv`` span
carrying a Chrome-trace flow event (``ph:"s"`` inside the send span,
``ph:"f"`` inside the receive span) — the cross-process edges the
trace stitcher matches across shards. A message re-entering this layer
with context already stamped (a ``ReliableChannel`` retransmit or an
injected duplicate) keeps its original flow id, so whichever copy
arrives first completes the SAME flow, and its send span is tagged
``retry``.

Counting semantics (see tests/test_telemetry.py):

- sent counters record what THIS layer handed to its inner transport —
  one count per wire send, never per wrapper layer, so stacking the
  instrumented wrapper with ``FaultInjector`` in either order cannot
  double-count bytes;
- injected faults are counted by ``FaultInjector`` itself
  (``comm_faults_injected_total``), so drops/delays are visible no
  matter which wrapper is outermost;
- received messages are counted by wrapping registered observers.

Payload bytes are estimated from array/bytes leaf sizes (a tensor's
``numel * element_size`` is metadata — reading it never serializes the
payload or touches the device), so instrumentation adds no host syncs
and no double serialization on the zero-copy LOCAL fabric. Trace-context params are
excluded from the estimate — they are comm metadata, and their
inclusion would make a retransmit's byte count differ from its
original's.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import torch

from .base import BaseCommunicationManager, Observer
from ..message import Message
from ..tracing import TRACE_CTX_KEYS, stamp_context
from ... import constants


def _leaves(tree):
    """Leaves in the JAX package's tree order: dict values by sorted key,
    list and tuple items in order, ``None`` dropped (it has no leaves)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def payload_nbytes(msg: Message) -> int:
    """Approximate wire size of a message from leaf metadata only: a
    tensor's ``numel * element_size``, an array's or numpy scalar's
    ``nbytes``, a str's or bytes' length, 8 for any other scalar."""
    params = {
        k: v for k, v in msg.get_params().items() if k not in TRACE_CTX_KEYS
    }
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, torch.Tensor):
            total += int(leaf.numel() * leaf.element_size())
            continue
        nb = getattr(leaf, "nbytes", None)
        if nb is not None:
            total += int(nb)
        elif isinstance(leaf, (bytes, bytearray, str)):
            total += len(leaf)
        else:
            total += 8  # scalar / small python object
    return total


class _CountingObserver(Observer):
    def __init__(self, inner: Observer, telemetry) -> None:
        self.inner = inner
        self.telemetry = telemetry

    def receive_message(self, msg_type: int, msg_params: Message) -> None:
        t = int(msg_type)
        tel = self.telemetry
        tel.inc("comm_messages_received_total", msg_type=t)
        tel.heartbeat("comm.receive", t)
        get = getattr(msg_params, "get", None)
        flow = get(constants.MSG_ARG_KEY_TRACE_FLOW) if get else None
        span_args: Dict[str, Any] = {"msg_type": t}
        if get:
            sender = msg_params.get_sender_id()
            span_args["sender"] = int(sender)
            rnd = get(constants.MSG_ARG_KEY_ROUND_INDEX)
            if rnd is not None:
                span_args["round"] = int(rnd)
        if flow is not None:
            span_args["flow"] = int(flow)
        rec = tel.recorder
        # the receive span wraps handler dispatch, so on the LOCAL
        # fabric it encloses the work the message triggered; the flow
        # finish sits inside it (chrome binds "f"/bp:"e" to the
        # enclosing slice)
        rec.begin("comm.recv", cat="comm", **span_args)
        if flow is not None:
            rec.flow_end(int(flow), name="comm.msg", cat="comm", msg_type=t)
        try:
            self.inner.receive_message(msg_type, msg_params)
        finally:
            rec.end("comm.recv", cat="comm")


class InstrumentedCommunicationManager(BaseCommunicationManager):
    """Counts every send the inner transport performs; composes with
    ``FaultInjector`` on either side (a delayed send fired from the
    injector's timer thread is counted when it actually goes out —
    the registry is thread-safe)."""

    def __init__(
        self, inner: BaseCommunicationManager, telemetry, rank: int = 0
    ) -> None:
        self.inner = inner
        self.telemetry = telemetry
        self.rank = int(rank)
        self._observer_wrappers: Dict[Any, _CountingObserver] = {}

    def send_message(self, msg: Message) -> None:
        t = int(msg.get_type())
        # nbytes BEFORE stamping: the estimate must be identical for an
        # original and its retransmit (and match a caller's pre-send
        # estimate)
        nbytes = payload_nbytes(msg)
        flow_id, is_resend = stamp_context(msg, self.telemetry, self.rank)
        span_args: Dict[str, Any] = {
            "msg_type": t,
            "nbytes": nbytes,
            "sender": int(msg.get_sender_id()),
            "receiver": int(msg.get_receiver_id()),
        }
        rnd = msg.get(constants.MSG_ARG_KEY_ROUND_INDEX)
        if rnd is not None:
            span_args["round"] = int(rnd)
        if flow_id is not None:
            span_args["flow"] = int(flow_id)
        parent = msg.get(constants.MSG_ARG_KEY_TRACE_SPAN)
        if parent is not None:
            # causal parent (continue_context): the flow id of the
            # message that triggered this send — renders the
            # broadcast->upload ancestry in the merged trace
            span_args["parent"] = int(parent)
        if is_resend:
            span_args["retry"] = True
        rec = self.telemetry.recorder
        rec.begin("comm.send", cat="comm", **span_args)
        if flow_id is not None:
            rec.flow_start(int(flow_id), name="comm.msg", cat="comm", msg_type=t)
        t0 = time.perf_counter()
        try:
            self.inner.send_message(msg)
        finally:
            rec.end("comm.send", cat="comm")
        dt = time.perf_counter() - t0
        tel = self.telemetry
        tel.inc("comm_messages_sent_total", msg_type=t)
        tel.inc("comm_bytes_sent_total", nbytes, msg_type=t)
        tel.observe("comm_send_latency_s", dt, msg_type=t)
        tel.heartbeat("comm.send", t)

    # -- observers (receive-side counting) ----------------------------
    def add_observer(self, observer: Observer) -> None:
        wrapper = _CountingObserver(observer, self.telemetry)
        self._observer_wrappers[observer] = wrapper
        self.inner.add_observer(wrapper)

    def remove_observer(self, observer: Observer) -> None:
        self.inner.remove_observer(
            self._observer_wrappers.pop(observer, observer)
        )

    # -- delegation ----------------------------------------------------
    def handle_receive_message(self) -> None:
        self.inner.handle_receive_message()

    def stop_receive_message(self) -> None:
        self.inner.stop_receive_message()

    def queue_depth(self):
        """Inbox depth of the wrapped transport when it exposes one
        (the LOCAL fabric's per-rank queue); None otherwise — sampled
        into stall bundles via a telemetry probe."""
        inner = self.inner
        # unwrap other decorators (FaultInjector) down to the transport
        for _ in range(4):
            fabric = getattr(inner, "fabric", None)
            if fabric is not None:
                try:
                    return fabric.inbox(int(inner.rank)).qsize()
                except Exception:  # noqa: BLE001 — depth is best-effort
                    return None
            nxt = getattr(inner, "inner", None)
            if nxt is None:
                return None
            inner = nxt
        return None

    def __getattr__(self, name):
        # transports expose extras (destroy_fabric, ...); pass through
        return getattr(self.inner, name)


def wrap_instrumented(com: BaseCommunicationManager, args) -> BaseCommunicationManager:
    """Wrap ``com`` with telemetry counting unless ``args.telemetry``
    disables it. Also registers a queue-depth probe so the stall
    watchdog's bundle can report comm backlog."""
    from ..telemetry import Telemetry

    import weakref

    tel = Telemetry.get_instance(args)
    if not tel.enabled or not bool(getattr(args, "telemetry", True)):
        return com
    rank = int(getattr(args, "rank", 0) or 0)
    inst = InstrumentedCommunicationManager(com, tel, rank=rank)
    # weakref: the probe lives in the process-wide registry and must
    # not pin a torn-down comm stack (fabric queues, observers) alive
    ref = weakref.ref(inst)

    def _queue_probe():
        i = ref()
        return {"queue_depth": i.queue_depth() if i is not None else None}

    tel.add_probe(f"comm_rank{rank}", _queue_probe)
    return inst
