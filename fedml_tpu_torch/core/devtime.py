"""Per-executable wall-time accounting (port of ``core/devtime.py``).

:func:`measure` brackets one call three ways at once:

* a ``torch.profiler.record_function("exec.<name>")`` range, the
  counterpart of the JAX package's ``named_scope``, so a profiler trace
  carries the executable's name;
* a flight-recorder B/E span (``cat="exec"``);
* an ``exec_device_seconds{executable,bucket}`` histogram observation
  plus an entry in a bounded wall-clock ring.

The serving block keeps its meaning: ``serving.forward`` wraps the
forward *and* the one host fetch of its result, and the fetch waits for
the card, so its wall time is device plus transfer time.

Like the JAX module, this adds no device synchronisation of its own:
``perf_counter`` reads and in-memory updates only.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

import torch

from .telemetry import Telemetry

# ring default; runs override it through the ``devtime_ring_size`` knob
# (adopted lazily at the next ``measure``)
DEFAULT_RING_SIZE = 4096

# histogram bounds: sub-ms dispatches through multi-second batches
_BUCKETS = (1e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0)

_lock = threading.Lock()
_ring: deque = deque(maxlen=DEFAULT_RING_SIZE)
_adopted_ring_size: Optional[int] = None
# monotonic origin so ring timestamps order without wall-clock reads
_T0 = time.perf_counter()


def configure(args) -> None:
    """Adopt ``devtime_ring_size`` (idempotent; existing entries are kept
    up to the new capacity, newest first)."""
    global _ring, _adopted_ring_size
    size = getattr(args, "devtime_ring_size", None)
    if not size:
        return
    size = int(size)
    with _lock:
        if size == _adopted_ring_size:
            return
        _ring = deque(_ring, maxlen=max(1, size))
        _adopted_ring_size = size


def reset() -> None:
    """Drop accumulated state (tests)."""
    global _ring, _adopted_ring_size
    with _lock:
        _ring = deque(maxlen=DEFAULT_RING_SIZE)
        _adopted_ring_size = None


def ring_snapshot() -> List[Dict[str, Any]]:
    """The wall-clock ring, oldest first. Each entry:
    ``{executable, bucket, seconds, t_rel}``."""
    with _lock:
        return list(_ring)


@contextmanager
def measure(executable: str, bucket: Optional[str] = None) -> Iterator[None]:
    """Bracket one call of a named executable. The ring records even
    with telemetry disabled; histogram and trace emission are
    telemetry-gated."""
    tel = Telemetry.get_instance()
    if tel.args is not None:
        configure(tel.args)
    enabled = tel.enabled
    tags: Dict[str, str] = {"executable": executable}
    if bucket is not None:
        tags["bucket"] = str(bucket)
    name = f"exec.{executable}"
    if enabled:
        tel.recorder.begin(name, cat="exec", **tags)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        if enabled:
            tel.recorder.end(name, cat="exec", **tags)
            tel.observe("exec_device_seconds", dt, buckets=_BUCKETS, **tags)
        with _lock:
            _ring.append(
                {
                    "executable": executable,
                    "bucket": None if bucket is None else str(bucket),
                    "seconds": dt,
                    "t_rel": t0 - _T0,
                }
            )


def measured_executables() -> List[str]:
    """Distinct executable names the ring holds."""
    with _lock:
        return sorted({e["executable"] for e in _ring})
