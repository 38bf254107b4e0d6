"""Deterministic chaos plane: scheduled multi-layer fault injection (port
of ``fedml_tpu/core/chaos.py``; numpy only, as there, and the same
schedules fire the same fault traces in both packages).

The comm layer's probabilistic faults are per-message coin flips; this
module makes faults *schedulable and exact* across every layer that
holds the server's durable state:

- **wire**: ``FaultInjector`` (``core/comm/faults.py``) consults a
  deterministic plan (``comm_plan``) before its probability rolls: a
  ``ChaosSchedule`` step like ``{at: {event: send, msg_type: 3, rank: 2,
  occurrence: 2}, fault: drop}`` drops exactly rank 2's second upload;
- **disk**: ``FaultyIO`` implements the ``DurableIO`` seam
  (``core/checkpoint.py``) under round-WAL creation/appends and
  checkpoint publishes: torn write at byte K, failed fsync, ENOSPC,
  latency, a corrupted (partially-written) published step, or a
  process kill at the exact write boundary;
- **process**: ``chaos_barrier(name, ...)`` calls in the cross-silo
  managers (``server.round_close`` / ``server.broadcast`` /
  ``server.publish`` / ``client.train`` / ``edge.fold`` /
  ``edge.merge_upload``) let a step kill the client/server at a named
  point in the round protocol (``ProcessKilled`` propagates out of the
  manager's dispatch loop: the in-process analog of kill -9);
- **clock**: a ``clock_skew`` fault steps the process's trace
  wall-clock anchor (an NTP-step analog; monotonic-clock consumers,
  heartbeats and staleness, are unaffected by design).

Everything is occurrence-counted, so an identical ``(schedule, seed)``
pair reproduces the identical fault trace: the fired record
(``ChaosSchedule.fired``), the telemetry counters
(``chaos_faults_injected_total{fault,event}``) and the ``chaos.fault``
trace instants.

On top of the IO seam, ``enumerate_crash_points`` + ``RecordingIO``
make a CrashMonkey-style **crash-point sweep** possible: run a world
once recording every WAL/checkpoint write boundary, then re-run it
killing the server at *each* boundary (before / torn / after) and
check the recovery, exhaustively rather than sampled.

Configured via ``args.chaos_schedule`` (list of steps), ``chaos_seed``
and ``io_faults`` (IO-only steps, same shape); installed process-wide
by the managers' comm stack (one schedule shared by a LOCAL world's
ranks: steps pin ``rank`` where it matters).
"""

from __future__ import annotations

import errno
import glob
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

__all__ = [
    "ChaosError",
    "ProcessKilled",
    "ChaosSchedule",
    "FaultyIO",
    "RecordingIO",
    "validate_schedule",
    "install_chaos",
    "active_chaos",
    "reset_chaos",
    "maybe_install_chaos",
    "chaos_barrier",
    "device_event",
    "elastic_event",
    "comm_plan",
    "enumerate_crash_points",
    "crash_point_schedule",
]


class ChaosError(OSError):
    """An injected IO failure (ENOSPC / failed fsync). Subclasses
    ``OSError`` ON PURPOSE: the degraded-durability paths the
    federation already has for real disk errors (``_wal_append``'s
    catch, the async skip-checkpoint-on-WAL-failure rule) must engage
    exactly as they would for the real thing."""


class ProcessKilled(Exception):
    """An injected process death (kill -9 analog). Deliberately NOT an
    ``OSError``: no degraded-IO path may swallow it — it must propagate
    out of the manager's dispatch loop and take the 'process' down,
    leaving whatever durable state the crash point implies."""

    def __init__(self, where: str) -> None:
        super().__init__(f"chaos: process killed at {where}")
        self.where = where


# the event vocabulary a schedule step may name; "barrier" matches the
# named chaos_barrier() calls in the managers via its `name` ctx key;
# the "device.*" events are the cross-device churn plane's protocol
# steps (docs/cross_device.md) — churn there is scheduled state, not a
# detected fault
EVENTS = (
    "send", "wal_create", "wal_append", "ckpt_publish", "barrier",
    "device.checkin", "device.upload", "elastic.check",
)

# fault kinds by the exact event they apply to — a (kind, event) pair
# outside this map would fire (count + trace) but apply NOTHING, so
# validation rejects it outright rather than record phantom faults
_EVENT_FAULTS = {
    "send": ("drop", "duplicate", "delay"),
    "barrier": ("kill_server", "kill_client", "clock_skew", "latency"),
    # wal_create has no byte stream to tear and no lone fsync to refuse
    # (create IS the dirent fsync): kill / no-space / slow only
    "wal_create": ("kill_server", "enospc", "latency"),
    "wal_append": (
        "kill_server", "torn_write", "fsync_fail", "enospc", "latency",
    ),
    # a checkpoint publish is torn as a whole step (garbage content on
    # disk), not at a byte offset
    "ckpt_publish": ("kill_server", "torn_publish", "enospc", "latency"),
    # cross-device churn: "vanish" makes the device silently skip the
    # step (a no-show at check-in costs nothing; at upload it leaves a
    # dangling pairwise mask for dropout recovery); "bad_share" poisons
    # the Shamir share this device later reveals for a vanished masker
    "device.checkin": ("vanish",),
    "device.upload": ("vanish", "bad_share"),
    # elastic preemption: the round-boundary signal poll
    # (parallel/elastic.ChaosPreemption). "preempt" is a scheduled
    # maintenance eviction, "device.loss" a chip dying — both drain the
    # round and force a durable exit; ONLY this event's adapter can
    # apply them (a preempt scheduled on a barrier would fire-and-apply
    # nothing, so validation rejects the pair)
    "elastic.check": ("preempt", "device.loss"),
}
_ALL_FAULTS = tuple(sorted({k for ks in _EVENT_FAULTS.values() for k in ks}))

# extra `at` matchers (beyond event/occurrence) a step may constrain
# on, per event — only keys the event's adapter actually supplies in
# ctx: a matcher the layer never provides would silently never fire
# (_matches fails on missing ctx), a fault-free run masquerading as a
# chaos world
_EVENT_MATCHERS = {
    "send": ("msg_type", "rank", "round"),
    "wal_append": ("round", "kind"),
    "wal_create": (),
    "ckpt_publish": ("round",),
    "barrier": ("name", "round", "rank"),
    "device.checkin": ("device", "round"),
    "device.upload": ("device", "round"),
    "elastic.check": ("round",),
}
_MATCH_KEYS = ("round", "rank", "msg_type", "name", "kind", "device")


def validate_schedule(spec, knob: str = "chaos_schedule") -> List[dict]:
    """Validate a schedule spec (the ``chaos_schedule`` / ``io_faults``
    knobs) into a normalized list of steps; raises ``ValueError``
    naming the knob and the offending step."""
    if spec is None:
        return []
    if not isinstance(spec, (list, tuple)):
        raise ValueError(
            f"{knob} must be a list of steps "
            "({at: {...}, fault: ...}), got "
            f"{type(spec).__name__}"
        )
    out = []
    for i, step in enumerate(spec):
        where = f"{knob}[{i}]"
        if not isinstance(step, dict) or "at" not in step or "fault" not in step:
            raise ValueError(
                f"{where}: each step is a mapping with 'at' and 'fault' keys"
            )
        at = step["at"]
        if not isinstance(at, dict) or "event" not in at:
            raise ValueError(f"{where}: 'at' must be a mapping with 'event'")
        event = str(at["event"])
        if event not in EVENTS:
            raise ValueError(
                f"{where}: unknown event {event!r}; pick one of {EVENTS}"
            )
        allowed_match = _EVENT_MATCHERS[event]
        unknown = set(at) - {"event", "occurrence"} - set(allowed_match)
        if unknown:
            raise ValueError(
                f"{where}: 'at' keys {sorted(unknown)} do not apply to "
                f"event {event!r} (allowed: event, occurrence"
                + (", " + ", ".join(allowed_match) if allowed_match else "")
                + ")"
            )
        occurrence = int(at.get("occurrence", 1))
        if occurrence < 1:
            raise ValueError(f"{where}: occurrence must be >= 1")
        fault = step["fault"]
        if isinstance(fault, str):
            fault = {"kind": fault}
        if not isinstance(fault, dict) or "kind" not in fault:
            raise ValueError(
                f"{where}: 'fault' is a kind string or a mapping with 'kind'"
            )
        # normalize a COPY: the caller's spec (args.chaos_schedule,
        # possibly shared across Arguments objects) must not be
        # type-coerced as a validation side effect
        fault = dict(fault)
        kind = str(fault["kind"])
        if kind not in _ALL_FAULTS:
            raise ValueError(
                f"{where}: unknown fault kind {kind!r}; pick one of "
                f"{_ALL_FAULTS}"
            )
        allowed = _EVENT_FAULTS[event]
        if kind not in allowed:
            raise ValueError(
                f"{where}: fault {kind!r} does not apply to event "
                f"{event!r} (allowed: {allowed})"
            )
        for num_key in ("delay_s", "skew_s"):
            if num_key in fault:
                fault[num_key] = float(fault[num_key])
        if "at_byte" in fault:
            fault["at_byte"] = int(fault["at_byte"])
            if fault["at_byte"] < 0:
                raise ValueError(f"{where}: at_byte must be >= 0")
        if "when" in fault:
            if fault["when"] not in ("before", "after"):
                raise ValueError(
                    f"{where}: when must be 'before' or 'after'"
                )
        norm_at = {"event": event, "occurrence": occurrence}
        for k in _MATCH_KEYS:
            if k in at:
                norm_at[k] = (
                    str(at[k]) if k in ("name", "kind") else int(at[k])
                )
        out.append({"at": norm_at, "fault": dict(fault, kind=kind)})
    return out


class ChaosSchedule:
    """An ordered, seeded list of one-shot fault steps.

    ``on_event(event, **ctx)`` is the single choke point every layer
    calls: it counts the event against each still-armed step whose
    matchers all equal the ctx, fires the step exactly once when its
    occurrence is reached, records the firing (``self.fired``), bumps
    ``chaos_faults_injected_total{fault,event}`` and emits a
    ``chaos.fault`` trace instant — the two artifacts the determinism
    acceptance gate compares across runs. Thread-safe; the firing
    record is keyed by step index, so two runs of the same (schedule,
    seed) produce the identical fired set regardless of which thread
    observed each event.
    """

    def __init__(self, steps, seed: int = 0) -> None:
        self.steps = validate_schedule(steps)
        self.seed = int(seed)
        self._rng = np.random.RandomState(self.seed)
        self._lock = threading.Lock()
        # per-step count of MATCHING events seen so far
        self._counts = [0] * len(self.steps)
        self._armed = [True] * len(self.steps)
        # armed SEND steps remaining — read lock-free (GIL-atomic int)
        # by comm_plan's hot path so a long run stops paying the
        # schedule lock once every send step has fired
        self.send_armed = sum(
            1 for s in self.steps if s["at"]["event"] == "send"
        )
        self.fired: List[dict] = []

    def _matches(self, step: dict, event: str, ctx: Dict[str, Any]) -> bool:
        at = step["at"]
        if at["event"] != event:
            return False
        for k in _MATCH_KEYS:
            if k in at:
                v = ctx.get(k)
                if v is None:
                    return False
                want = at[k]
                if isinstance(want, str):
                    if str(v) != want:
                        return False
                elif int(v) != int(want):
                    return False
        return True

    def on_event(self, event: str, **ctx: Any) -> List[dict]:
        """Note one event; return the fault fired at it (0 or 1).

        At most ONE step fires per event: the layer adapters can apply
        only one fault to a single message/write boundary, so a second
        step whose occurrence is also reached here keeps counting and
        fires on its NEXT matching event instead (the ``>=`` check) —
        it never burns as a counted-but-unapplied phantom."""
        hits: List[dict] = []
        with self._lock:
            for i, step in enumerate(self.steps):
                if not self._armed[i] or not self._matches(step, event, ctx):
                    continue
                self._counts[i] += 1
                if hits:
                    continue
                if self._counts[i] >= step["at"]["occurrence"]:
                    self._armed[i] = False
                    if step["at"]["event"] == "send":
                        self.send_armed -= 1
                    fault = dict(step["fault"])
                    rec = {
                        "step": i,
                        "event": event,
                        "fault": fault["kind"],
                        "at": dict(step["at"]),
                    }
                    self.fired.append(rec)
                    hits.append(fault)
        for fault in hits:
            self._note(event, fault["kind"])
        return hits

    def _note(self, event: str, kind: str) -> None:
        from .telemetry import Telemetry

        tel = Telemetry.get_instance()
        tel.inc("chaos_faults_injected_total", fault=kind, event=event)
        tel.recorder.instant(
            "chaos.fault", cat="chaos", fault=kind, event=event
        )
        logging.warning("chaos: injecting %s at %s", kind, event)

    def pending(self) -> int:
        with self._lock:
            return sum(self._armed)

    def jitter(self, scale_s: float) -> float:
        """Seeded jitter for latency faults that ask for it."""
        with self._lock:
            return float(self._rng.random_sample()) * float(scale_s)


# -- process-global installation --------------------------------------

_ACTIVE: Optional[ChaosSchedule] = None
_ACTIVE_KEY = None  # the (normalized steps, seed) the schedule was built from


def install_chaos(schedule: ChaosSchedule) -> ChaosSchedule:
    """Install the process-wide schedule and its IO seam."""
    global _ACTIVE, _ACTIVE_KEY
    from .checkpoint import install_io_seam

    _ACTIVE = schedule
    _ACTIVE_KEY = None
    install_io_seam(FaultyIO(schedule))
    return schedule


def active_chaos() -> Optional[ChaosSchedule]:
    return _ACTIVE


def reset_chaos() -> None:
    global _ACTIVE, _ACTIVE_KEY
    from .checkpoint import reset_io_seam

    _ACTIVE = None
    _ACTIVE_KEY = None
    reset_io_seam()


def maybe_install_chaos(args) -> Optional[ChaosSchedule]:
    """Build + install a schedule from ``args.chaos_schedule`` /
    ``args.io_faults`` / ``args.chaos_seed`` (no-op when unset).

    A LOCAL world constructs several managers in one process off the
    same config; they must SHARE one schedule (occurrence counters span
    the world), so an identical spec reuses the installed instance —
    steps pin ``rank`` where per-process targeting matters. A
    different spec replaces it (a new world started in the same
    process, e.g. consecutive worlds of a benchmark).

    A config with NO chaos knobs deliberately does not uninstall: a
    rank whose args carry no steps must join the world's installed
    schedule, not tear it down. The flip side: a still-armed schedule
    outlives its world, so anything that runs consecutive worlds in
    one process (benchmarks, test fixtures) must call ``reset_chaos()``
    between them."""
    global _ACTIVE_KEY
    steps = validate_schedule(
        getattr(args, "chaos_schedule", None), "chaos_schedule"
    ) + validate_schedule(getattr(args, "io_faults", None), "io_faults")
    if not steps:
        return _ACTIVE
    seed = int(getattr(args, "chaos_seed", 0) or 0)
    key = (repr(steps), seed)
    if _ACTIVE is not None and _ACTIVE_KEY == key:
        return _ACTIVE
    schedule = install_chaos(ChaosSchedule(steps, seed=seed))
    _ACTIVE_KEY = key
    return schedule


# -- layer adapters ---------------------------------------------------

def chaos_barrier(name: str, round: Optional[int] = None,  # noqa: A002
                  rank: Optional[int] = None) -> None:
    """A named point in the round protocol where a scheduled process
    fault may fire. No-op (one dict lookup) when no schedule is
    installed. ``kill_server`` / ``kill_client`` raise
    ``ProcessKilled``; ``clock_skew`` steps the trace wall anchor;
    ``latency`` sleeps."""
    sched = _ACTIVE
    if sched is None:
        return
    ctx: Dict[str, Any] = {"name": name}
    if round is not None:
        ctx["round"] = int(round)
    if rank is not None:
        ctx["rank"] = int(rank)
    for fault in sched.on_event("barrier", **ctx):
        kind = fault["kind"]
        if kind in ("kill_server", "kill_client"):
            raise ProcessKilled(f"barrier {name}")
        if kind == "clock_skew":
            _apply_clock_skew(float(fault.get("skew_s", 1.0)))
        elif kind == "latency":
            time.sleep(
                float(fault.get("delay_s", 0.1))
                + sched.jitter(float(fault.get("jitter_s", 0.0)))
            )


def device_event(
    event: str, device: int, round: Optional[int] = None,  # noqa: A002
) -> Optional[dict]:
    """Consult the schedule at a cross-device protocol step
    (``device.checkin`` / ``device.upload``) for one device. Returns
    the fired fault mapping (``kind`` is ``"vanish"`` / ``"bad_share"``;
    a vanish may carry ``after_close: true`` to arrive late instead of
    never) or None; the DEVICE PLANE interprets it — a vanish is
    scheduled churn the device simulator enacts by skipping the step,
    never an exception (churn is the normal case there, not a failure).
    No-op (one dict lookup) when no schedule is installed."""
    sched = _ACTIVE
    if sched is None:
        return None
    ctx: Dict[str, Any] = {"device": int(device)}
    if round is not None:
        ctx["round"] = int(round)
    hits = sched.on_event(event, **ctx)
    return hits[0] if hits else None


def elastic_event(round: Optional[int] = None) -> Optional[dict]:  # noqa: A002
    """Consult the schedule at the round-boundary preemption poll
    (``elastic.check``). Returns the fired fault mapping (``kind`` is
    ``"preempt"`` / ``"device.loss"``) or None; the ELASTIC PLANE
    interprets it — the signal seam turns it into a drained round, a
    WAL preempt record and a forced checkpoint, never an exception at
    the poll site (``parallel/elastic.ChaosPreemption``). No-op (one
    dict lookup) when no schedule is installed."""
    sched = _ACTIVE
    if sched is None:
        return None
    ctx: Dict[str, Any] = {}
    if round is not None:
        ctx["round"] = int(round)
    hits = sched.on_event("elastic.check", **ctx)
    return hits[0] if hits else None


def _apply_clock_skew(skew_s: float) -> None:
    """Step this process's WALL clock anchor (an NTP-step analog): the
    flight recorder's cross-shard alignment anchor moves, so the trace
    stitcher must recover the offset from flow pairs — which is exactly
    what it exists to do. Monotonic-clock consumers (heartbeats,
    staleness ages, stall watchdog) are untouched, by design."""
    from .telemetry import Telemetry

    rec = Telemetry.get_instance().recorder
    rec.wall_t0 += float(skew_s)
    logging.warning("chaos: clock skewed by %+.3fs (wall anchor)", skew_s)


def comm_plan(rank: int) -> Optional[Callable]:
    """A deterministic send-fault plan for ``FaultInjector`` (consulted
    BEFORE its probability rolls): returns the scheduled fault for this
    exact message, or None. Built per-process so ``rank`` matchers
    resolve against the SENDING process. None when no schedule is
    installed or it has no send steps — the injector then isn't
    wrapped at all.

    "The Nth matching message" counts DISTINCT messages: the reliable
    channel stacks OUTSIDE the injector, so its retransmits re-traverse
    this plan carrying the original (chan, seq) id — counting those
    would make occurrence timing-dependent (how many retries a drop
    provoked before the ack won the race) and break the
    identical-fault-trace guarantee. A message's first traversal
    counts; re-traversals of the same id are invisible to the schedule.
    """
    sched = _ACTIVE
    if sched is None or not any(
        s["at"]["event"] == "send" for s in sched.steps
    ):
        return None
    rank = int(rank)
    seen_ids = set()
    seen_lock = threading.Lock()

    def plan(msg) -> Optional[dict]:
        if sched.send_armed <= 0:
            # every send step has fired: stop counting, stop recording
            # wire ids, never touch the schedule lock again (a
            # long-running world must not pay for a spent schedule)
            if seen_ids:
                seen_ids.clear()
            return None
        if msg.get_sender_id() == msg.get_receiver_id():
            return None  # loopback timer signals never cross a wire
        from .. import constants

        seq = msg.get(constants.MSG_ARG_KEY_COMM_SEQ)
        if seq is not None:
            wire_id = (
                msg.get_sender_id(),
                msg.get_receiver_id(),
                msg.get(constants.MSG_ARG_KEY_COMM_CHAN),
                seq,
            )
            with seen_lock:
                if wire_id in seen_ids:
                    return None  # a retransmit, not a new Nth message
                seen_ids.add(wire_id)
        ctx = {
            "msg_type": int(msg.get_type()),
            "rank": rank,
        }
        rnd = msg.get(constants.MSG_ARG_KEY_ROUND_INDEX)
        if rnd is not None:
            ctx["round"] = int(rnd)
        hits = sched.on_event("send", **ctx)
        return hits[0] if hits else None

    return plan


class FaultyIO:
    """``DurableIO`` implementation driven by the schedule: consults
    ``on_event`` at every WAL/checkpoint write boundary and applies the
    fired fault — delegating to the default seam for the physical IO it
    still performs."""

    def __init__(self, schedule: ChaosSchedule) -> None:
        from .checkpoint import DurableIO

        self.schedule = schedule
        self._real = DurableIO()

    # -- shared fault application -------------------------------------
    def _io_fault(self, faults: List[dict], where: str) -> Optional[dict]:
        """Apply pre-write faults; return a fault dict that modifies
        the write itself (torn/after-kill), or None."""
        carry = None
        for fault in faults:
            kind = fault["kind"]
            if kind == "kill_server" and fault.get("when", "before") == "before":
                raise ProcessKilled(where)
            if kind == "enospc":
                raise ChaosError(
                    errno.ENOSPC, f"chaos: injected ENOSPC at {where}"
                )
            if kind == "latency":
                time.sleep(
                    float(fault.get("delay_s", 0.1))
                    + self.schedule.jitter(float(fault.get("jitter_s", 0.0)))
                )
            elif kind in ("torn_write", "fsync_fail", "torn_publish") or (
                kind == "kill_server" and fault.get("when") == "after"
            ):
                carry = fault
        return carry

    # -- seam methods --------------------------------------------------
    def wal_create(self, dir_path: str, path: str) -> None:
        carry = self._io_fault(
            self.schedule.on_event("wal_create"), "wal_create"
        )
        self._real.wal_create(dir_path, path)
        if carry is not None and carry["kind"] == "kill_server":
            raise ProcessKilled("wal_create (after)")

    def wal_append(self, path: str, data: bytes, **ctx) -> None:
        carry = self._io_fault(
            self.schedule.on_event(
                "wal_append",
                round=ctx.get("round_idx"),
                kind=ctx.get("kind"),
            ),
            f"wal_append round {ctx.get('round_idx')}",
        )
        if carry is not None and carry["kind"] == "torn_write":
            # crash mid-append: only the first K bytes reach the disk,
            # then the process dies — the torn-tail tolerance and the
            # next incarnation's fresh-line probe must both hold
            k = int(carry.get("at_byte", max(len(data) // 2, 1)))
            self._real.wal_append(path, data[:k], **ctx)
            raise ProcessKilled(f"torn wal_append at byte {k}")
        if carry is not None and carry["kind"] == "fsync_fail":
            # data written, fsync refused: surfaces as the OSError the
            # WAL's degraded-durability paths already handle
            with open(path, "ab") as f:
                f.write(data)
                f.flush()
            raise ChaosError(errno.EIO, "chaos: injected fsync failure")
        self._real.wal_append(path, data, **ctx)
        if carry is not None and carry["kind"] == "kill_server":
            raise ProcessKilled("wal_append (after)")

    def ckpt_publish(self, save_fn, step: int, dir_path: str) -> None:
        carry = self._io_fault(
            self.schedule.on_event("ckpt_publish", round=step),
            f"ckpt_publish step {step}",
        )
        if carry is not None and carry["kind"] == "torn_publish":
            # a trainer killed mid-publish: the step appears on disk
            # but its content is garbage — exactly what a watcher must
            # fall back from (CheckpointWatcher's fault contract)
            save_fn()
            self._corrupt_step(dir_path, step)
            return
        save_fn()
        if carry is not None and carry["kind"] == "kill_server":
            raise ProcessKilled("ckpt_publish (after)")

    @staticmethod
    def _corrupt_step(dir_path: str, step: int) -> None:
        """Garbage every file of the just-published step, keeping it
        listed on disk (the torn-publish shape the serving tests used
        to synthesize by hand)."""
        n = 0
        for p in glob.glob(
            os.path.join(dir_path, str(step), "**", "*"), recursive=True
        ):
            if os.path.isfile(p):
                with open(p, "wb") as fh:
                    fh.write(b"CHAOS TORN PUBLISH")
                n += 1
        logging.warning(
            "chaos: torn publish — corrupted %d file(s) of step %d", n, step
        )


class RecordingIO:
    """``DurableIO`` seam that records every write boundary (and still
    performs the real IO) — the enumeration half of the crash-point
    sweep. ``events`` is an ordered list of ``(event, ctx)`` tuples."""

    def __init__(self) -> None:
        from .checkpoint import DurableIO

        self._real = DurableIO()
        self._lock = threading.Lock()
        self.events: List[tuple] = []

    def _note(self, event: str, **ctx) -> None:
        with self._lock:
            self.events.append((event, ctx))

    def wal_create(self, dir_path: str, path: str) -> None:
        self._note("wal_create")
        self._real.wal_create(dir_path, path)

    def wal_append(self, path: str, data: bytes, **ctx) -> None:
        self._note(
            "wal_append", round=ctx.get("round_idx"),
            kind=ctx.get("kind"), nbytes=len(data),
        )
        self._real.wal_append(path, data, **ctx)

    def ckpt_publish(self, save_fn, step: int, dir_path: str) -> None:
        self._note("ckpt_publish", step=step)
        self._real.ckpt_publish(save_fn, step, dir_path)


def enumerate_crash_points(events: List[tuple]) -> List[dict]:
    """Every durable-write boundary of a recorded run, as crash points
    a sweep must kill the server at — CrashMonkey-style exhaustive,
    not sampled:

    - for the WAL creation: kill before (the log never exists);
    - for EVERY wal_append occurrence: kill before (record lost), torn
      (half the record's bytes land), kill after (record durable,
      everything later lost);
    - for EVERY ckpt_publish occurrence: kill before (params lost,
      WAL behind) and kill after (params durable, WAL record lost).

    Returns ``[{event, occurrence, mode, nbytes?}]``; feed each to
    ``crash_point_schedule`` to build the kill schedule for one re-run.
    """
    points: List[dict] = []
    counts: Dict[str, int] = {}
    for event, ctx in events:
        counts[event] = counts.get(event, 0) + 1
        occ = counts[event]
        if event == "wal_create":
            points.append({"event": event, "occurrence": occ, "mode": "before"})
        elif event == "wal_append":
            points.append({"event": event, "occurrence": occ, "mode": "before"})
            points.append({
                "event": event, "occurrence": occ, "mode": "torn",
                "nbytes": int(ctx.get("nbytes", 2) or 2),
            })
            points.append({"event": event, "occurrence": occ, "mode": "after"})
        elif event == "ckpt_publish":
            points.append({"event": event, "occurrence": occ, "mode": "before"})
            points.append({"event": event, "occurrence": occ, "mode": "after"})
    return points


def crash_point_schedule(point: dict) -> List[dict]:
    """The one-step schedule that kills the server at ``point``."""
    if point["mode"] == "torn":
        fault = {
            "kind": "torn_write",
            "at_byte": max(int(point.get("nbytes", 2)) // 2, 1),
        }
    else:
        fault = {"kind": "kill_server", "when": point["mode"]}
    return [{
        "at": {"event": point["event"], "occurrence": point["occurrence"]},
        "fault": fault,
    }]
