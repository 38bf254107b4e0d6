"""Flight-recorder telemetry: metrics registry + trace ring (port subset).

The port of ``fedml_tpu/core/telemetry.py``, cut to what serving and the
comm layer call: the process-wide ``Telemetry`` registry (counters,
gauges, histograms with explicit buckets, heartbeats, status probes,
``snapshot``) with its base labels (``run_id``, ``rank``, ``role``) and its
``FlightRecorder`` ring of Chrome-trace events (``begin``/``end``/
``instant`` and the cross-process flow edges ``flow_start``/``flow_end``).
Names, tags and semantics match the JAX package, so a dashboard reads
either. Exporters, the stall watchdog and the metrics server arrive with
a later slice.

Hot-loop contract, as in the JAX package: every instrument is
host-side only (counter bumps, deque appends, ``perf_counter`` reads)
and never reads a device value.
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["Telemetry", "FlightRecorder"]


class FlightRecorder:
    """Bounded, thread-safe ring of Chrome-trace events: B/E duration
    pairs and thread-scoped instants."""

    def __init__(self, capacity: int = 65536) -> None:
        self.enabled = True
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=self.capacity)
        self._t0 = time.perf_counter()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._events)

    def _emit(self, ph: str, name: str, cat: str, args: Optional[dict],
              extra: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ev: Dict[str, Any] = {
            "name": name,
            "cat": cat,
            "ph": ph,
            "ts": round((time.perf_counter() - self._t0) * 1e6, 1),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if ph == "i":
            ev["s"] = "t"  # thread-scoped instant
        if extra:
            ev.update(extra)
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)

    def begin(self, name: str, cat: str = "span", **args: Any) -> None:
        self._emit("B", name, cat, args or None)

    def end(self, name: str, cat: str = "span", **args: Any) -> None:
        self._emit("E", name, cat, args or None)

    def instant(self, name: str, cat: str = "event", **args: Any) -> None:
        self._emit("i", name, cat, args or None)

    def flow_start(self, flow_id: int, name: str = "msg", cat: str = "flow",
                   **args: Any) -> None:
        """Flow-start ("s") edge of a cross-thread/process arrow, emitted
        inside an open B/E span (the slice it binds to)."""
        self._emit("s", name, cat, args or None, extra={"id": int(flow_id)})

    def flow_end(self, flow_id: int, name: str = "msg", cat: str = "flow",
                 **args: Any) -> None:
        """Flow-finish ("f", binding point "e": the enclosing slice)."""
        self._emit("f", name, cat, args or None, extra={"id": int(flow_id), "bp": "e"})

    def tail(self, n: int = 200) -> List[Dict[str, Any]]:
        """Last ``n`` events."""
        with self._lock:
            evs = list(self._events)
        return evs[-n:]


class Telemetry:
    """Process-wide registry of tagged counters / gauges / histograms
    plus the flight recorder; base labels (run_id / rank / role) come
    from ``args``."""

    _instance: Optional["Telemetry"] = None

    def __init__(self, args=None) -> None:
        self.args = args
        self.run_id = str(getattr(args, "run_id", "0")) if args else "0"
        self.rank = int(getattr(args, "rank", 0) or 0) if args else 0
        self.role = (
            getattr(args, "role", None) or ("server" if self.rank == 0 else "client")
        )
        self._probes: Dict[str, Callable[[], Any]] = {}
        self._enabled = bool(getattr(args, "telemetry", True)) if args else True
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple], float] = defaultdict(float)
        self._gauges: Dict[Tuple[str, Tuple], float] = {}
        self._hists: Dict[Tuple[str, Tuple], Dict[str, Any]] = {}
        self._heartbeats: Dict[str, Tuple[Any, float]] = {}
        self.recorder = FlightRecorder(
            capacity=int(getattr(args, "trace_ring_size", 65536) or 65536)
            if args else 65536
        )
        self.recorder.enabled = self._enabled

    # -- singleton -----------------------------------------------------
    @classmethod
    def get_instance(cls, args=None) -> "Telemetry":
        if cls._instance is None:
            cls._instance = cls(args)
        elif args is not None and cls._instance.args is None:
            # a later caller finally supplied args: adopt its identity
            cls._instance.rebind(args)
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        """Drop the singleton (tests)."""
        cls._instance = None

    def rebind(self, args) -> None:
        """Adopt base labels and the enable flag from ``args`` without
        dropping accumulated state."""
        self.args = args
        self.run_id = str(getattr(args, "run_id", self.run_id))
        self.rank = int(getattr(args, "rank", self.rank) or 0)
        self.role = getattr(args, "role", None) or (
            "server" if self.rank == 0 else "client"
        )
        self.enabled = bool(getattr(args, "telemetry", self._enabled))

    # -- enable switch -------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    @enabled.setter
    def enabled(self, v: bool) -> None:
        self._enabled = bool(v)
        self.recorder.enabled = self._enabled

    # -- metric primitives ---------------------------------------------
    @staticmethod
    def _key(name: str, tags: dict) -> Tuple[str, Tuple]:
        return name, tuple(sorted((str(k), str(v)) for k, v in tags.items()))

    def inc(self, name: str, value: float = 1.0, **tags: Any) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._counters[self._key(name, tags)] += float(value)

    def set_gauge(self, name: str, value: float, **tags: Any) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._gauges[self._key(name, tags)] = float(value)

    def observe(self, name: str, value: float, buckets=None, **tags: Any) -> None:
        """Histogram observation (count / sum / min / max). With
        ``buckets`` (upper bounds, fixed by the series' first
        observation) the series also keeps cumulative ``le`` counts."""
        if not self._enabled:
            return
        v = float(value)
        with self._lock:
            key = self._key(name, tags)
            h = self._hists.get(key)
            if h is None:
                h = {"count": 0.0, "sum": 0.0, "min": v, "max": v}
                if buckets is not None:
                    # bounds attach only at series creation, so every
                    # observation lands in the cumulative counts
                    h["le"] = tuple(sorted(float(b) for b in buckets))
                    h["le_counts"] = [0] * len(h["le"])
                self._hists[key] = h
            h["count"] += 1
            h["sum"] += v
            h["min"] = min(h["min"], v)
            h["max"] = max(h["max"], v)
            for i, bound in enumerate(h.get("le", ())):
                if v <= bound:
                    h["le_counts"][i] += 1

    def get_counter(self, name: str, **tags: Any) -> float:
        with self._lock:
            return self._counters.get(self._key(name, tags), 0.0)

    def counters_matching(self, name: str) -> Dict[str, float]:
        """All tag-series of one counter, rendered ``name{k=v,...}``."""
        with self._lock:
            return {self._fmt(n, t): v for (n, t), v in self._counters.items() if n == name}

    def add_probe(self, name: str, fn: Callable[[], Any]) -> None:
        """Register a status callable (e.g. a comm wrapper's queue depth)."""
        with self._lock:
            self._probes[name] = fn

    def probes(self) -> Dict[str, Callable[[], Any]]:
        with self._lock:
            return dict(self._probes)

    @staticmethod
    def _fmt(name: str, tags: Tuple) -> str:
        if not tags:
            return name
        return name + "{" + ",".join(f"{k}={v}" for k, v in tags) + "}"

    def snapshot(self) -> Dict[str, Any]:
        """Every series, rendered ``name{k=v,...}``, with the base labels."""
        with self._lock:
            counters = {self._fmt(n, t): v for (n, t), v in self._counters.items()}
            gauges = {self._fmt(n, t): v for (n, t), v in self._gauges.items()}
            hists = {
                self._fmt(n, t): {k: (list(v) if isinstance(v, list) else v)
                                  for k, v in h.items()}
                for (n, t), h in self._hists.items()
            }
            heartbeats = {
                n: {"value": v, "age_s": round(time.monotonic() - ts, 3)}
                for n, (v, ts) in self._heartbeats.items()
            }
        return {
            "kind": "telemetry_snapshot",
            "run_id": self.run_id,
            "rank": self.rank,
            "role": self.role,
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
            "heartbeats": heartbeats,
            "trace_events_buffered": len(self.recorder),
        }

    def heartbeat(self, name: str, value: Any = None) -> None:
        """Mark progress, stamped on the monotonic clock."""
        if not self._enabled:
            return
        with self._lock:
            self._heartbeats[name] = (value, time.monotonic())
