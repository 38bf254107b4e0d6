"""Reliable delivery over any transport: ack / retransmit / dedup (port
of ``fedml_tpu/core/comm/reliable.py``).

Beyond the reference (SURVEY.md §5 "no failure detection / elastic
recovery"): the reference's transports are fire-and-forget — a dropped
uplink is simply gone, and the federation's only recourse is to drop
the client at the aggregation deadline. This wrapper decorates any
``BaseCommunicationManager`` (same pattern as ``FaultInjector`` /
``wrap_instrumented``; composable with both in any order) and turns it
into an at-least-once channel with receive-side dedup, i.e.
effectively exactly-once delivery to the application:

- **send side**: every tracked message gets a monotonic sequence id
  plus a per-incarnation channel id (random, so a restarted process
  can never collide with its previous incarnation's sequence space).
  Unacknowledged messages are retransmitted on a timer with jittered
  exponential backoff (``comm_retry_base_s * 2^n``, up to
  ``comm_retry_max`` retransmits); a send that exhausts the budget is
  given up loudly (``comm_giveups_total``) — the overall budget is the
  channel's send timeout.
- **receive side**: every tracked message is ACKed back to its sender
  (ACKs are comm-layer messages, ``MSG_TYPE_COMM_ACK``; the channel
  consumes them before application handlers ever see them) and deduped
  by (sender, channel, seq) — a retransmission whose original DID
  arrive, or a network-duplicated frame, is dropped with
  ``comm_dup_dropped_total`` instead of relying solely on idempotent
  aggregation.

Untracked (pass straight through, no seq/ack): self-addressed loopback
messages (deadline / failure-detector timer signals that never cross a
wire), ACKs themselves, and heartbeats (``MSG_TYPE_C2S_HEARTBEAT`` is
periodic by construction — retransmitting a stale one is noise; the
next beat supersedes it).

Wrap order in the managers: the reliable channel sits OUTERMOST
(``reliable(faults(instrumented(transport)))``) so its retransmissions
re-traverse the fault injector — an injected drop is recovered by the
retry, which is exactly the lossy-network scenario the channel exists
for. ACKs flow through the same lossy stack; a lost ACK just means one
more retransmit and one more dedup.

Enable with ``args.reliable_comm: true``. Every endpoint of a world
must enable it together: a reliable sender talking to a bare receiver
retransmits until give-up (the receiver never ACKs), and the bare
receiver sees duplicates.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from collections import OrderedDict, deque
from typing import Dict, Optional, Set, Tuple

import numpy as np

from ... import constants
from ..message import Message
from .base import BaseCommunicationManager, Observer, backoff_delay_s

# per-(sender, channel) dedup memory: enough to cover any realistic
# retransmit window (a federation round is a handful of messages per
# peer), bounded so a long-running server cannot grow without limit
_DEDUP_WINDOW = 4096
# per-sender incarnation (channel-id) memory: every peer restart mints
# a fresh channel id, and a weeks-long server facing crash-looping
# clients must not accumulate dead incarnations' dedup state — keep
# the newest few (older ones can only matter for a dead process's
# last in-flight retransmits)
_MAX_INCARNATIONS = 4

# message types the channel never tracks (see module docstring)
_UNTRACKED_TYPES = {
    constants.MSG_TYPE_COMM_ACK,
    constants.MSG_TYPE_C2S_HEARTBEAT,
}


class _Pending:
    __slots__ = ("msg", "retries", "timer")

    def __init__(self, msg: Message) -> None:
        self.msg = msg
        self.retries = 0
        self.timer = None


class _ReliableObserver(Observer):
    """Receive-side half: consume ACKs, ACK + dedup tracked messages."""

    def __init__(self, inner: Observer, channel: "ReliableChannel") -> None:
        self.inner = inner
        self.channel = channel

    def receive_message(self, msg_type: int, msg_params: Message) -> None:
        t = int(msg_type)
        if t == constants.MSG_TYPE_COMM_ACK:
            self.channel._handle_ack(msg_params)
            return  # comm-layer message; never reaches the application
        seq = msg_params.get(constants.MSG_ARG_KEY_COMM_SEQ)
        if seq is None:
            # untracked (heartbeat, loopback, or a bare-sender peer)
            self.inner.receive_message(msg_type, msg_params)
            return
        sender = int(msg_params.get_sender_id())
        chan = int(msg_params.get(constants.MSG_ARG_KEY_COMM_CHAN, 0))
        # ACK before dedup: the duplicate usually means our previous
        # ACK was lost — the sender needs another one either way
        self.channel._send_ack(sender, chan, int(seq))
        if self.channel._is_duplicate(sender, chan, int(seq)):
            self.channel._note("dup_dropped", t)
            logging.info(
                "reliable: dropped duplicate msg type %d seq %d from rank %d",
                t, int(seq), sender,
            )
            return
        self.inner.receive_message(msg_type, msg_params)


class ReliableChannel(BaseCommunicationManager):
    def __init__(
        self,
        inner: BaseCommunicationManager,
        rank: int = 0,
        retry_max: int = 5,
        retry_base_s: float = 0.2,
        seed: int = 0,
    ) -> None:
        self.inner = inner
        self.rank = int(rank)
        self.retry_max = int(retry_max)
        self.retry_base_s = float(retry_base_s)
        # incarnation id: distinguishes this process's sequence space
        # from a previous (crashed) incarnation reusing the same rank
        self.channel_id = int.from_bytes(os.urandom(4), "big")
        self._rng = np.random.RandomState(int(seed))
        self._lock = threading.Lock()
        self._next_seq = 0
        self._pending: Dict[int, _Pending] = {}
        # sender -> chan -> (set for O(1) lookup, deque for FIFO
        # evict); chans per sender LRU-bounded at _MAX_INCARNATIONS
        self._seen: Dict[int, "OrderedDict[int, Tuple[Set[int], deque]]"] = {}
        self._observer_wrappers: Dict[object, _ReliableObserver] = {}
        self.closed = False
        self.stats = {"retries": 0, "dup_dropped": 0, "giveups": 0, "acked": 0}
        # ACKs go out on a dedicated worker, never the receive/dispatch
        # thread: on a networked transport a send can BLOCK (dead peer,
        # wait_for_ready), and a blocked dispatch thread would freeze
        # every handler — including the failure-detector and deadline
        # paths that exist to handle exactly that dead peer
        self._ack_q: "queue.Queue" = queue.Queue()
        self._ack_thread: Optional[threading.Thread] = None

    # -- telemetry ----------------------------------------------------
    _COUNTER_NAMES = {
        "retries": "comm_retries_total",
        "dup_dropped": "comm_dup_dropped_total",
        "giveups": "comm_giveups_total",
    }

    def _note(self, kind: str, msg_type: int) -> None:
        with self._lock:
            self.stats[kind] += 1
        from ..telemetry import Telemetry

        Telemetry.get_instance().inc(
            self._COUNTER_NAMES[kind], msg_type=int(msg_type)
        )

    def _note_internal_error(self, site: str, exc: BaseException) -> None:
        """An exception the channel absorbs by design (the retransmit
        timer / dedup+re-ack path IS the recovery) — but never
        silently: counted per site so a chaos run cannot hide a channel
        bug behind its injected faults, and debug-logged with the
        traceback."""
        from ..telemetry import Telemetry

        Telemetry.get_instance().inc("comm_internal_errors_total", site=site)
        logging.debug(
            "reliable: internal error at %s: %s: %s",
            site, type(exc).__name__, exc, exc_info=True,
        )

    def pending_unacked(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- send side ----------------------------------------------------
    def _tracked(self, msg: Message) -> bool:
        if int(msg.get_type()) in _UNTRACKED_TYPES:
            return False
        if msg.get_sender_id() == msg.get_receiver_id():
            return False  # loopback timer signal; never crosses a wire
        return True

    def send_message(self, msg: Message) -> None:
        if not self._tracked(msg):
            self.inner.send_message(msg)
            return
        with self._lock:
            if self.closed:
                return  # world torn down; nothing to deliver into
            self._next_seq += 1
            seq = self._next_seq
            entry = _Pending(msg)
            self._pending[seq] = entry
        msg.add_params(constants.MSG_ARG_KEY_COMM_SEQ, seq)
        msg.add_params(constants.MSG_ARG_KEY_COMM_CHAN, self.channel_id)
        try:
            self.inner.send_message(msg)
        except Exception as e:  # noqa: BLE001 — retransmit timer is the retry
            # transient transport failure: the retransmit timer IS the
            # retry path — count + log and let backoff take it from here
            self._note_internal_error("initial_send", e)
            logging.warning(
                "reliable: initial send of seq %d failed; will retransmit",
                seq, exc_info=True,
            )
        self._schedule(seq)

    def _schedule(self, seq: int) -> None:
        with self._lock:
            entry = self._pending.get(seq)
            if entry is None or self.closed:
                return
            delay = backoff_delay_s(
                entry.retries, self.retry_base_s, rand=self._rng.random_sample
            )
            t = threading.Timer(delay, self._retransmit, args=(seq,))
            t.daemon = True
            entry.timer = t
        t.start()

    def _retransmit(self, seq: int) -> None:
        with self._lock:
            entry = self._pending.get(seq)
            if entry is None or self.closed:
                return
            if entry.retries >= self.retry_max:
                # send timeout: the full backoff budget elapsed unacked
                del self._pending[seq]
                msg = entry.msg
                giveup = True
            else:
                entry.retries += 1
                msg = entry.msg
                giveup = False
        if giveup:
            self._note("giveups", msg.get_type())
            logging.error(
                "reliable: GIVING UP on msg type %s %d->%d (seq %d) after "
                "%d retransmit(s) — receiver dead or network partitioned",
                msg.get_type(), msg.get_sender_id(), msg.get_receiver_id(),
                seq, self.retry_max,
            )
            return
        self._note("retries", msg.get_type())
        logging.info(
            "reliable: retransmit #%d of msg type %s %d->%d (seq %d)",
            entry.retries, msg.get_type(),
            msg.get_sender_id(), msg.get_receiver_id(), seq,
        )
        # retransmits are first-class trace spans: the re-send
        # re-traverses the instrumented layer (which keeps the original
        # flow id and tags its comm.send span `retry`), and this outer
        # comm.retry span makes the retransmit attempt itself visible
        # on the stitched timeline with its attempt number
        from ..telemetry import Telemetry

        rec = Telemetry.get_instance().recorder
        rec.begin(
            "comm.retry", cat="comm",
            msg_type=int(msg.get_type()), seq=int(seq), attempt=entry.retries,
        )
        try:
            self.inner.send_message(msg)
        except Exception as e:  # noqa: BLE001 — backoff re-schedules below
            self._note_internal_error("retransmit", e)
            logging.warning(
                "reliable: retransmit of seq %d failed; backing off",
                seq, exc_info=True,
            )
        finally:
            rec.end("comm.retry", cat="comm")
        self._schedule(seq)

    # -- receive side (driven by _ReliableObserver) --------------------
    def _handle_ack(self, msg: Message) -> None:
        if int(msg.get(constants.MSG_ARG_KEY_COMM_ACK_CHAN, -1)) != self.channel_id:
            return  # ACK for a previous incarnation of this rank
        seq = int(msg.get(constants.MSG_ARG_KEY_COMM_ACK_SEQ, -1))
        with self._lock:
            entry = self._pending.pop(seq, None)
            self.stats["acked"] += 1 if entry is not None else 0
        if entry is not None and entry.timer is not None:
            entry.timer.cancel()

    def _send_ack(self, sender: int, chan: int, seq: int) -> None:
        with self._lock:
            if self.closed:
                return
            if self._ack_thread is None:
                self._ack_thread = threading.Thread(
                    target=self._ack_worker, daemon=True, name="reliable-ack"
                )
                self._ack_thread.start()
        self._ack_q.put((sender, chan, seq))

    def _ack_worker(self) -> None:
        while True:
            item = self._ack_q.get()
            if item is None:
                return
            if self.closed:
                continue  # drain to the sentinel without sending
            sender, chan, seq = item
            ack = Message(constants.MSG_TYPE_COMM_ACK, self.rank, sender)
            ack.add_params(constants.MSG_ARG_KEY_COMM_ACK_SEQ, seq)
            ack.add_params(constants.MSG_ARG_KEY_COMM_ACK_CHAN, chan)
            try:
                self.inner.send_message(ack)
            except Exception as e:  # noqa: BLE001 — sender retransmits, we re-ack
                # a lost ACK is recoverable by design: the sender
                # retransmits and we dedup + re-ACK — but count it, so
                # an ack path that fails every time is visible
                self._note_internal_error("ack_send", e)

    def _is_duplicate(self, sender: int, chan: int, seq: int) -> bool:
        with self._lock:
            chans = self._seen.get(sender)
            if chans is None:
                chans = OrderedDict()
                self._seen[sender] = chans
            entry = chans.get(chan)
            if entry is None:
                entry = (set(), deque())
                chans[chan] = entry
                if len(chans) > _MAX_INCARNATIONS:
                    chans.popitem(last=False)  # evict the oldest incarnation
            else:
                chans.move_to_end(chan)  # LRU: active incarnation stays
            seen_set, order = entry
            if seq in seen_set:
                return True
            seen_set.add(seq)
            order.append(seq)
            if len(order) > _DEDUP_WINDOW:
                seen_set.discard(order.popleft())
            return False

    # -- observers ------------------------------------------------------
    def add_observer(self, observer: Observer) -> None:
        wrapper = _ReliableObserver(observer, self)
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
        """Close the channel. The at-least-once guarantee holds while
        the channel is OPEN; close abandons still-unacked sends —
        loudly. On the LOCAL fabric an unacked-at-close message was
        almost always delivered (its ACK just sits unprocessed behind
        the stop sentinel); on a networked transport it may be genuinely
        lost, so each abandonment is logged with its type/receiver and
        counted (``comm_abandoned_on_close_total``) for post-mortems —
        retransmitting past close would only spam peers that can no
        longer be distinguished from dead ones."""
        with self._lock:
            self.closed = True
            abandoned = list(self._pending.items())
            timers = [
                e.timer for _, e in abandoned if e.timer is not None
            ]
            self._pending.clear()
            ack_thread = self._ack_thread
        for t in timers:
            t.cancel()
        for seq, entry in abandoned:
            m = entry.msg
            logging.warning(
                "reliable: closing with msg type %s %d->%d (seq %d) "
                "unacked — delivery not confirmed",
                m.get_type(), m.get_sender_id(), m.get_receiver_id(), seq,
            )
            from ..telemetry import Telemetry

            Telemetry.get_instance().inc(
                "comm_abandoned_on_close_total", msg_type=int(m.get_type())
            )
        if ack_thread is not None:
            self._ack_q.put(None)  # sentinel: worker drains and exits
        self.inner.stop_receive_message()

    def __getattr__(self, name):
        # transports expose extras (destroy_fabric, ...); pass through
        return getattr(self.inner, name)


def maybe_wrap_reliable(com: BaseCommunicationManager, args) -> BaseCommunicationManager:
    """Wrap ``com`` when ``args.reliable_comm`` is set.

    The backoff-jitter seed mixes in ``args.rank`` (same rationale as
    ``maybe_wrap_faulty``): identical jitter streams across a world
    would synchronize every process's retransmit storms.
    """
    if not bool(getattr(args, "reliable_comm", False)):
        return com
    rank = int(getattr(args, "rank", 0) or 0)
    seed = (int(getattr(args, "random_seed", 0)) + 0x85EBCA6B * (rank + 1)) % (
        2**32
    )
    ch = ReliableChannel(
        com,
        rank=rank,
        retry_max=int(getattr(args, "comm_retry_max", 5)),
        retry_base_s=float(getattr(args, "comm_retry_base_s", 0.2)),
        seed=seed,
    )
    # stall-bundle probe: how many sends are waiting on an ACK (weakref
    # so the process-wide registry never pins a torn-down comm stack)
    import weakref

    from ..telemetry import Telemetry

    ref = weakref.ref(ch)

    def _pending_probe():
        c = ref()
        return {"pending_unacked": c.pending_unacked() if c is not None else None}

    Telemetry.get_instance(args).add_probe(f"reliable_rank{rank}", _pending_probe)
    return ch
