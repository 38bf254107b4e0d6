"""Message-level fault injection for any transport (port of
``fedml_tpu/core/comm/faults.py``).

Beyond the reference: Cossack9989/FedML has no fault-injection tooling
(SURVEY.md §5 "Failure detection / elastic recovery / fault injection:
minimal ... no fault injection"), so its straggler/failure behavior is
untestable without real broken networks. This wrapper decorates any
``BaseCommunicationManager`` and injects deterministic, seeded faults
on the SEND side:

- **drop**: the message never leaves this process;
- **duplicate**: the message is sent twice (at-least-once delivery —
  receivers must be idempotent);
- **delay**: the send is deferred by ``delay_s`` on a timer thread
  (reordering — a delayed round-r upload can arrive in round r+1,
  which the server's round-tag discard must handle).

Enabled via ``args.fault_injection`` (a mapping, e.g. from YAML
``attack_args``)::

    fault_injection:
      drop_prob: 0.3        # per-message drop probability
      duplicate_prob: 0.0
      delay_s: 0.0          # fixed delay applied with delay_prob
      delay_prob: 0.0
      seed: 0               # deterministic per-process stream
      msg_types: [3]        # restrict to these types (default: all
                            # except FINISH/deadline control signals)
      max_faults: 2         # stop injecting after N faults (default: inf)

Faults pair with the failure-handling features they exercise: dropped
uploads -> ``aggregation_deadline_s`` (straggler cohort); duplicated
uploads -> idempotent aggregation; delayed uploads -> stale-round
discard (``fedml_server_manager.handle_message_receive_model_from_client``).
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

import numpy as np

from .base import BaseCommunicationManager, Observer
from ..message import Message
from ...constants import MSG_TYPE_S2C_FINISH, MSG_TYPE_S2S_AGG_DEADLINE

# Exempt from injection unless the user names them in ``msg_types``:
# these carry control signals with no retry/recovery path, so dropping
# them models a broken *process*, not a lossy *network* — the deadline
# loopback is a timer signal that never crosses a wire, and a silently
# dropped FINISH strands the receiver in its receive loop forever.
_DEFAULT_EXEMPT_TYPES = {MSG_TYPE_S2S_AGG_DEADLINE, MSG_TYPE_S2C_FINISH}


class FaultInjector(BaseCommunicationManager):
    def __init__(
        self,
        inner: BaseCommunicationManager,
        drop_prob: float = 0.0,
        duplicate_prob: float = 0.0,
        delay_s: float = 0.0,
        delay_prob: float = 0.0,
        seed: int = 0,
        msg_types=None,
        max_faults: Optional[int] = None,
        plan=None,
    ) -> None:
        self.inner = inner
        # deterministic plan seam (core/chaos.py comm_plan): consulted
        # BEFORE the probability rolls — a ChaosSchedule step names the
        # exact Nth matching message to drop/duplicate/delay, so chaos
        # worlds reproduce the identical fault trace per (schedule,
        # seed). Scheduled faults ignore msg_types/max_faults (they are
        # explicit, one-shot decisions, not a rate) and compose with
        # the probabilistic knobs for unmatched messages.
        self.plan = plan
        self.drop_prob = float(drop_prob)
        self.duplicate_prob = float(duplicate_prob)
        self.delay_s = float(delay_s)
        self.delay_prob = float(delay_prob)
        self._rng = np.random.RandomState(int(seed))
        self.msg_types = set(int(t) for t in msg_types) if msg_types else None
        self.max_faults = max_faults if max_faults is None else int(max_faults)
        self.injected = {"drop": 0, "duplicate": 0, "delay": 0}
        self._timers = []
        # set by stop_receive_message(): Timer.cancel() only stops
        # timers that have not FIRED yet — a delay timer already past
        # cancel() when the world tears down would deliver into a
        # stopped transport (late sends after FINISH racing teardown)
        self.closed = False

    def _note_fault(self, kind: str, msg_type: int) -> None:
        """Count the injection locally AND in the process-wide telemetry
        registry (core/telemetry.py), so injected drops/delays stay
        visible no matter how this wrapper is composed with the comm
        instrumentation layer (core/comm/instrument.py)."""
        self.injected[kind] += 1
        from ..telemetry import Telemetry

        Telemetry.get_instance().inc(
            "comm_faults_injected_total", fault=kind, msg_type=int(msg_type)
        )

    # -- fault decisions ----------------------------------------------
    def _armed(self, msg: Message) -> bool:
        if msg.get_sender_id() == msg.get_receiver_id():
            return False  # self-addressed loopback (timer signals), not a link
        t = int(msg.get_type())
        if self.msg_types is not None:
            if t not in self.msg_types:
                return False
        elif t in _DEFAULT_EXEMPT_TYPES:
            return False
        if self.max_faults is not None and sum(self.injected.values()) >= self.max_faults:
            return False
        return True

    def _apply_scheduled(self, msg: Message, fault: dict) -> bool:
        """One scheduled (exact-message) fault; True when the send was
        consumed here. Counted ONLY by the schedule
        (chaos_faults_injected_total) — never via ``_note_fault``: the
        probabilistic ``injected`` tally feeds ``_armed``'s max_faults
        budget and ``comm_faults_injected_total``, and a scheduled
        one-shot must neither spend that budget nor inflate the series
        existing worlds assert against."""
        kind = fault.get("kind")
        if kind == "drop":
            logging.warning(
                "chaos: scheduled DROP msg type %s %d->%d",
                msg.get_type(), msg.get_sender_id(), msg.get_receiver_id(),
            )
            return True
        if kind == "duplicate":
            logging.warning(
                "chaos: scheduled DUPLICATE msg type %s %d->%d",
                msg.get_type(), msg.get_sender_id(), msg.get_receiver_id(),
            )
            self.inner.send_message(msg)
            self.inner.send_message(msg)
            return True
        if kind == "delay":
            # an EXPLICIT delay_s (including 0 — a pure timer-hop
            # reorder probe) is honored verbatim; only an absent key
            # falls back to the injector's knob, then to 50ms
            if "delay_s" in fault:
                delay_s = float(fault["delay_s"])
            else:
                delay_s = float(self.delay_s or 0.05)
            logging.warning(
                "chaos: scheduled DELAY %.2fs msg type %s %d->%d",
                delay_s, msg.get_type(),
                msg.get_sender_id(), msg.get_receiver_id(),
            )
            self._deliver_delayed(msg, delay_s)
            return True
        return False

    def _deliver_delayed(self, msg: Message, delay_s: float) -> None:
        t_ref = []

        def fire() -> None:
            # drop our own reference when done: each Timer holds its
            # Message (full model params), so an append-only list grows
            # by one payload per injected delay
            try:
                if not self.closed:
                    self.inner.send_message(msg)
            finally:
                try:
                    self._timers.remove(t_ref[0])
                except ValueError:  # lint: except-ok — benign race: stop()
                    pass  # drained the list while this timer was firing

        t = threading.Timer(delay_s, fire)
        t_ref.append(t)
        t.daemon = True
        self._timers.append(t)
        t.start()

    def send_message(self, msg: Message) -> None:
        if self.plan is not None:
            fault = self.plan(msg)
            if fault and self._apply_scheduled(msg, fault):
                return
        if self._armed(msg):
            roll = self._rng.random_sample()
            if roll < self.drop_prob:
                self._note_fault("drop", msg.get_type())
                logging.warning(
                    "fault injection: DROP msg type %s %d->%d",
                    msg.get_type(), msg.get_sender_id(), msg.get_receiver_id(),
                )
                return
            if roll < self.drop_prob + self.duplicate_prob:
                self._note_fault("duplicate", msg.get_type())
                logging.warning(
                    "fault injection: DUPLICATE msg type %s %d->%d",
                    msg.get_type(), msg.get_sender_id(), msg.get_receiver_id(),
                )
                self.inner.send_message(msg)
                self.inner.send_message(msg)
                return
            if roll < self.drop_prob + self.duplicate_prob + self.delay_prob:
                self._note_fault("delay", msg.get_type())
                logging.warning(
                    "fault injection: DELAY %.2fs msg type %s %d->%d",
                    self.delay_s, msg.get_type(),
                    msg.get_sender_id(), msg.get_receiver_id(),
                )
                self._deliver_delayed(msg, self.delay_s)
                return
        self.inner.send_message(msg)

    # -- pure delegation ----------------------------------------------
    def add_observer(self, observer: Observer) -> None:
        self.inner.add_observer(observer)

    def remove_observer(self, observer: Observer) -> None:
        self.inner.remove_observer(observer)

    def handle_receive_message(self) -> None:
        self.inner.handle_receive_message()

    def stop_receive_message(self) -> None:
        self.closed = True  # a fired-but-not-delivered timer must no-op
        # snapshot: firing timers remove themselves from self._timers,
        # and mutating the list mid-iteration can skip a cancel
        for t in list(self._timers):
            t.cancel()
        self.inner.stop_receive_message()

    def __getattr__(self, name):
        # transports expose extras (destroy_fabric, ...); pass through
        return getattr(self.inner, name)


def maybe_wrap_faulty(com: BaseCommunicationManager, args) -> BaseCommunicationManager:
    """Wrap ``com`` when ``args.fault_injection`` is configured.

    The configured ``seed`` is mixed with ``args.rank`` before use: the
    same YAML is loaded by every process in the federation, and an
    unmixed seed gives every client an IDENTICAL fault pattern —
    lockstep FL then loses the same message from everyone at once
    (e.g. every round-0 uplink), which is a correlated-failure scenario
    the user did not ask for. Rank mixing keeps each process's stream
    deterministic while decorrelating streams across the world.
    """
    spec = getattr(args, "fault_injection", None)
    rank = int(getattr(args, "rank", 0))
    # the deterministic chaos plan (core/chaos.py): an installed
    # ChaosSchedule with send steps wraps the injector even with no
    # probabilistic knobs, so scheduled exact-message faults work alone
    from ..chaos import comm_plan

    plan = comm_plan(rank)
    if not spec and plan is None:
        return com
    if spec and not isinstance(spec, dict):
        raise ValueError(
            f"fault_injection must be a mapping of knobs, got {type(spec).__name__}"
        )
    allowed = {
        "drop_prob", "duplicate_prob", "delay_s", "delay_prob",
        "seed", "msg_types", "max_faults",
    }
    spec = dict(spec or {})
    unknown = set(spec) - allowed
    if unknown:
        raise ValueError(f"unknown fault_injection keys: {sorted(unknown)}")
    spec["seed"] = (int(spec.get("seed", 0)) + 0x9E3779B1 * (rank + 1)) % (2**32)
    return FaultInjector(com, plan=plan, **spec)
