"""Liveness heartbeats + failure detection, crash-stop model (port of
``fedml_tpu/core/comm/heartbeat.py``).

Beyond the reference (SURVEY.md §5 "no failure detection"): a client
killed without sending OFFLINE (kill -9, OOM, network partition) left
the reference's server waiting forever. Here clients emit periodic
``MSG_TYPE_C2S_HEARTBEAT`` beats (:class:`HeartbeatEmitter`, enabled by
``heartbeat_interval_s``) and the cross-silo server runs a
:class:`FailureDetector` (``heartbeat_timeout_s``): ANY message from a
rank counts as liveness (uploads and status changes prove liveness as
well as beats — heartbeats only carry the idle periods), and a rank
silent past the timeout is declared dead exactly once.

The detector never mutates federation state itself: its ``on_dead``
callback (the server posts a ``MSG_TYPE_S2S_CLIENT_DEAD`` message to
its own inbox) keeps all membership mutation on the single dispatch
thread — the same pattern as the aggregation-deadline timer.

Sizing: ``heartbeat_timeout_s`` should be several multiples of
``heartbeat_interval_s`` (3-5x) so a few beats lost to a lossy network
(heartbeats are deliberately NOT retransmitted by the reliable
channel — the next beat supersedes a lost one) never read as a death.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional


class HeartbeatEmitter:
    """Client-side beat loop: calls ``send_fn()`` every ``interval_s``
    on a daemon thread. ``send_fn`` builds and sends a FRESH message
    per beat (the LOCAL fabric passes objects by reference — reusing
    one envelope would alias in-flight beats). Send failures are
    logged at debug and the loop keeps beating: a down server is
    exactly when persistence matters (the beats double as the
    reconnect probe after a server restart)."""

    def __init__(self, send_fn: Callable[[], None], interval_s: float) -> None:
        self.send_fn = send_fn
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HeartbeatEmitter":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="heartbeat-emitter"
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.send_fn()
            except Exception:  # noqa: BLE001 — transport may be down
                logging.debug("heartbeat send failed; will retry", exc_info=True)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 1.0)
            self._thread = None


class FailureDetector:
    """Monotonic-clock deadline detector over a watched rank set.

    - ``watch(rank)`` arms monitoring (called when a rank goes ONLINE;
      re-called on reconnect);
    - ``note_alive(rank)`` records traffic (always, watched or not, so
      a race between a declaration and a late message is observable);
    - a watched rank silent for ``timeout_s`` fires ``on_dead(rank)``
      ONCE and is unwatched until explicitly re-watched.
    """

    def __init__(
        self,
        timeout_s: float,
        on_dead: Callable[[int], None],
    ) -> None:
        self.timeout_s = float(timeout_s)
        self.on_dead = on_dead
        self._last: Dict[int, float] = {}
        self._watched: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # check often enough that a death is declared within ~1.25x the
        # timeout, without spinning on very short (test) timeouts
        self._check_s = min(max(self.timeout_s / 4.0, 0.02), 1.0)

    def start(self) -> "FailureDetector":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="failure-detector"
        )
        self._thread.start()
        return self

    def watch(self, rank: int) -> None:
        with self._lock:
            self._watched.add(int(rank))
            self._last[int(rank)] = time.monotonic()

    def unwatch(self, rank: int) -> None:
        with self._lock:
            self._watched.discard(int(rank))

    def note_alive(self, rank: int) -> None:
        with self._lock:
            self._last[int(rank)] = time.monotonic()

    def last_seen_age_s(self, rank: int) -> Optional[float]:
        """Seconds since the last traffic from ``rank`` (None = never
        seen). The quorum close logs this per missing rank so an
        operator can tell a slow-but-alive straggler (small age) from a
        rank the detector is about to declare dead (age near the
        timeout) without waiting for the declaration."""
        with self._lock:
            last = self._last.get(int(rank))
        return None if last is None else max(time.monotonic() - last, 0.0)

    def seen_recently(self, rank: int) -> bool:
        """True when ``rank`` produced traffic within the timeout —
        the declaration handler's race check (a message may already
        have been queued behind the death notice)."""
        with self._lock:
            last = self._last.get(int(rank))
        return last is not None and (time.monotonic() - last) < self.timeout_s

    def _loop(self) -> None:
        while not self._stop.wait(self._check_s):
            now = time.monotonic()
            with self._lock:
                expired = [
                    r
                    for r in self._watched
                    if now - self._last.get(r, now) > self.timeout_s
                ]
                for r in expired:
                    self._watched.discard(r)
            for r in expired:
                logging.warning(
                    "failure detector: rank %d silent for > %.1fs; "
                    "declaring dead", r, self.timeout_s,
                )
                try:
                    self.on_dead(r)
                except Exception:  # noqa: BLE001 — detector must survive
                    logging.exception("failure detector on_dead(%d) failed", r)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._check_s + 1.0)
            self._thread = None
