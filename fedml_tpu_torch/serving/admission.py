"""Admission control: bounded queue, backpressure, deadline shedding.

Port of ``fedml_tpu/serving/admission.py``; the logic is unchanged.

A serving plane that queues without bound converts overload into
unbounded latency for EVERY request (and eventually OOM); this one
converts it into fast, counted rejections:

- **Queue-full shed (submit side).** The request queue is bounded by
  ``serve_queue_size``. When it is full, ``offer`` fails the request
  immediately with ``QueueFullError`` — backpressure the caller can
  act on (retry against another replica, degrade, drop) instead of
  silent queue growth.
- **Deadline shed (drain side).** Each request carries an absolute
  deadline (default ``serve_deadline_ms`` from submission; frontends
  may pass the client-stamped deadline through, so injected network
  delays surface here). Requests already expired when a micro-batch is
  assembled are shed with ``DeadlineExceededError`` — the forward pass
  never burns device time on an answer nobody is waiting for.

Every shed increments ``serving_shed_total{reason=...}`` in the
process-wide telemetry registry and lands on the flight-recorder
timeline, so load shedding is an observable event stream, not a
silent failure mode.
"""

from __future__ import annotations

import queue
import time
from typing import List, Optional

__all__ = [
    "AdmissionController",
    "ServingShedError",
    "QueueFullError",
    "DeadlineExceededError",
]


class ServingShedError(RuntimeError):
    """Base: the request was shed by admission control (not a bug —
    retry, route elsewhere, or degrade)."""


class QueueFullError(ServingShedError):
    """The bounded request queue was full at submit time."""


class DeadlineExceededError(ServingShedError):
    """The request's deadline expired before its batch was formed."""


class AdmissionController:
    """Bounded queue + shed accounting for one serving engine."""

    def __init__(self, queue_size: int, telemetry=None) -> None:
        self.queue: "queue.Queue" = queue.Queue(maxsize=max(1, int(queue_size)))
        self._telemetry = telemetry

    @property
    def telemetry(self):
        if self._telemetry is None:
            from ..core.telemetry import Telemetry

            self._telemetry = Telemetry.get_instance()
        return self._telemetry

    def depth(self) -> int:
        return self.queue.qsize()

    # -- submit side ---------------------------------------------------
    def offer(self, req) -> bool:
        """Enqueue or shed. Returns False (and fails the request's
        future with ``QueueFullError``) when the queue is full."""
        try:
            self.queue.put_nowait(req)
            return True
        except queue.Full:
            self.shed(
                req,
                "queue_full",
                QueueFullError(
                    f"serving queue full ({self.queue.maxsize} pending); "
                    "request shed"
                ),
            )
            return False

    # -- drain side ----------------------------------------------------
    def admit_batch(self, batch: List, now: Optional[float] = None) -> List:
        """Split an assembled batch into live requests (returned) and
        expired ones (shed in place)."""
        now = time.monotonic() if now is None else now
        live = []
        for req in batch:
            if req.deadline is not None and now > req.deadline:
                self.shed(
                    req,
                    "deadline",
                    DeadlineExceededError(
                        f"deadline exceeded before batching "
                        f"(late by {now - req.deadline:.3f}s)"
                    ),
                )
            else:
                live.append(req)
        return live

    def shed(self, req, reason: str, exc: ServingShedError) -> None:
        tel = self.telemetry
        if tel.enabled:
            tel.inc("serving_shed_total", reason=reason)
            tel.recorder.instant("serve.shed", cat="serving", reason=reason)
        req.fail(exc)
