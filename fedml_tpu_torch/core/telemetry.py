"""Flight-recorder telemetry: metrics registry, trace export, stall
watchdog and the ``/metrics`` server (port of ``fedml_tpu/core/telemetry.py``).

- ``Telemetry``: a process-wide registry of counters / gauges /
  histograms, tagged with run_id / rank / role. Exposition goes through
  the ``MetricsReporter`` sink seam (JSONL snapshots through pluggable
  sinks) and the Prometheus text format (``prometheus_text``).
- ``FlightRecorder``: a bounded ring of Chrome-trace events
  (perfetto-loadable ``trace.json``). ``ProfilerEvent`` spans, the round
  pipeline's events and the comm layer's spans and flows land in one
  timeline, ordered and B/E-matched at export.
- ``StallWatchdog``: a heartbeat observer. Components mark progress with
  ``telemetry.heartbeat(name, value)``; when every heartbeat is older
  than ``args.stall_timeout_s`` the watchdog dumps a debug bundle (open
  spans, pending ``DeferredMetrics``, the last events, host and device
  ``sys_stats``, the registered probes) to ``args.telemetry_dir``.
- ``MetricsServer``: ``GET /metrics`` on ``args.metrics_port``
  (loopback unless ``metrics_host`` says otherwise).

Names, tags, the snapshot record, the trace events and the Prometheus
text are the JAX package's, so each package's trace stitcher and
invariant checker read the other's artifacts.

Hot-loop contract, as in the JAX package: every instrument is host-side
only (counter bumps, deque appends, ``perf_counter`` reads) and never
reads a device value. The card's memory gauges are read at export
(``export_run_artifacts``), never inside a round.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from collections import defaultdict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["Telemetry", "FlightRecorder", "StallWatchdog", "MetricsServer"]

# Chrome trace event phases this recorder emits: duration begin/end,
# instant, counter, flow start/finish (https://docs.google.com/document/
# d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU — the perfetto-
# supported legacy JSON). "s"/"f" are the cross-process send→receive
# edges the trace stitcher (core/tracing.py) matches across shards.
_TRACE_PHASES = ("B", "E", "i", "C", "s", "f")


def _sanitize_metric(name: str) -> str:
    """Prometheus metric-name charset ([a-zA-Z_:][a-zA-Z0-9_:]*)."""
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _guarded(fn):
    """A failing collector must not abort a debug-bundle dump — the
    bundle is the stall episode's only artifact."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001
        return f"collector failed: {type(e).__name__}: {e}"


def _escape_label_value(v) -> str:
    """Prometheus label-value escaping (\\, \", newline) — a run_id
    containing a quote must not corrupt the whole exposition."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


class FlightRecorder:
    """Bounded, thread-safe ring of Chrome-trace events.

    ``begin``/``end`` emit B/E duration pairs keyed by (thread, name);
    ``instant`` emits thread-scoped instants; ``counter`` emits "C"
    samples. ``export`` sorts by timestamp, drops orphaned E events
    (their B fell off the ring) and force-closes still-open spans so
    the written ``trace.json`` always carries matched B/E pairs and a
    monotonic timeline — loadable in chrome://tracing and perfetto as
    is.
    """

    def __init__(self, capacity: int = 65536) -> None:
        self.enabled = True
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=self.capacity)
        # one instant: the wall clock at ring-relative ts 0. Shards from
        # different processes are first aligned on this anchor by the
        # trace stitcher (core/tracing.py), then skew-corrected from
        # matched flow pairs — perf_counter epochs are per-process.
        self._t0 = time.perf_counter()
        self.wall_t0 = time.time() - (time.perf_counter() - self._t0)
        self.dropped = 0

    def resize(self, capacity: int) -> None:
        """Re-bound the ring (``trace_ring_size`` adopted after the
        argless singleton was created first); keeps buffered events up
        to the new bound. Events evicted by a SHRINK are counted as
        dropped — the ring's contract is that missing events are
        visible, however they went missing."""
        capacity = int(capacity)
        if capacity == self.capacity or capacity < 1:
            return
        with self._lock:
            self.dropped += max(len(self._events) - capacity, 0)
            self.capacity = capacity
            self._events = deque(self._events, maxlen=capacity)

    def __len__(self) -> int:
        return len(self._events)

    def _ts_us(self) -> float:
        return round((time.perf_counter() - self._t0) * 1e6, 1)

    def _emit(
        self,
        ph: str,
        name: str,
        cat: str,
        args: Optional[dict],
        extra: Optional[dict] = None,
    ) -> None:
        if not self.enabled:
            return
        ev: Dict[str, Any] = {
            "name": name,
            "cat": cat,
            "ph": ph,
            "ts": self._ts_us(),
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

    def flow_start(
        self, flow_id: int, name: str = "msg", cat: str = "flow", **args: Any
    ) -> None:
        """Flow-start ("s") edge of a cross-thread/process arrow. Emit
        it INSIDE an open B/E span — chrome/perfetto bind a flow to the
        slice enclosing its timestamp on that track."""
        self._emit("s", name, cat, args or None, extra={"id": int(flow_id)})

    def flow_end(
        self, flow_id: int, name: str = "msg", cat: str = "flow", **args: Any
    ) -> None:
        """Flow-finish ("f", binding-point "e": enclosing slice)."""
        self._emit(
            "f", name, cat, args or None,
            extra={"id": int(flow_id), "bp": "e"},
        )

    def counter(self, name: str, value: float, cat: str = "counter") -> None:
        self._emit("C", name, cat, {name: value})

    def tail(self, n: int = 200) -> List[Dict[str, Any]]:
        """Last ``n`` events (the debug-bundle view)."""
        with self._lock:
            evs = list(self._events)
        return evs[-n:]

    def export(self, path: str, meta: Optional[dict] = None) -> str:
        """Write a Chrome-trace/perfetto ``trace.json`` (atomic)."""
        with self._lock:
            events = sorted(self._events, key=lambda e: e["ts"])
            dropped = self.dropped
        out: List[Dict[str, Any]] = []
        depth: Dict[Tuple[int, str], int] = defaultdict(int)
        for ev in events:
            key = (ev["tid"], ev["name"])
            if ev["ph"] == "E":
                if depth[key] <= 0:
                    continue  # orphan: its B fell off the ring
                depth[key] -= 1
            elif ev["ph"] == "B":
                depth[key] += 1
            out.append(ev)
        end_ts = out[-1]["ts"] if out else 0.0
        for (tid, name), d in sorted(depth.items(), key=lambda kv: str(kv[0])):
            for _ in range(d):  # force-close spans still open at export
                out.append({
                    "name": name, "cat": "span", "ph": "E", "ts": end_ts,
                    "pid": os.getpid(), "tid": tid,
                    "args": {"forced_close": True},
                })
        payload = {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {
                "events_dropped": dropped,
                "ring_capacity": self.capacity,
                # the stitcher's cross-shard alignment anchor: wall
                # clock (µs) at this shard's ts 0
                "wall_t0_us": round(self.wall_t0 * 1e6, 1),
                **(meta or {}),
            },
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, path)
        return path


class Telemetry:
    """Process-wide metrics registry + flight recorder + probe board.

    Counters/gauges/histograms are tagged; base labels (run_id / rank /
    role) come from ``args``. Snapshots go out through the same
    pluggable-sink seam as ``MetricsReporter`` (``add_sink`` /
    ``add_jsonl_sink``), and ``prometheus_text`` renders the standard
    text exposition for scrape-style collection.
    """

    _instance: Optional["Telemetry"] = None

    def __init__(self, args=None) -> None:
        self.args = args
        self.run_id = str(getattr(args, "run_id", "0")) if args else "0"
        self.rank = int(getattr(args, "rank", 0) or 0) if args else 0
        self.role = (
            getattr(args, "role", None) or ("server" if self.rank == 0 else "client")
        )
        self._enabled = bool(getattr(args, "telemetry", True)) if args else True
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple], float] = defaultdict(float)
        self._gauges: Dict[Tuple[str, Tuple], float] = {}
        self._hists: Dict[Tuple[str, Tuple], Dict[str, float]] = {}
        self._heartbeats: Dict[str, Tuple[Any, float]] = {}
        self._probes: Dict[str, Callable[[], Any]] = {}
        self._profilers: List[Any] = []
        self._deferred: List[Any] = []
        self._watchdog: Optional["StallWatchdog"] = None
        self._metrics_server: Optional["MetricsServer"] = None
        # serializes export_run_artifacts: in a single-process LOCAL
        # world every manager's finish() exports through this one
        # registry, and two concurrent exports would race on the same
        # trace.json.tmp (the loser's os.replace finds it gone)
        self._export_lock = threading.Lock()
        self._reporter = None  # lazy MetricsReporter (sink seam)
        # the card whose memory the sys_* gauges report (bind_device);
        # None = the current CUDA device when CUDA is initialised
        self.device = None
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
            # instead of silently ignoring it (the old singleton bug)
            cls._instance.rebind(args)
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        """Drop the singleton (tests; autouse fixture in conftest)."""
        if cls._instance is not None:
            if cls._instance._watchdog is not None:
                cls._instance._watchdog.stop()
            cls._instance.stop_metrics_server()
        cls._instance = None

    def rebind(self, args) -> None:
        """Adopt base labels/enable flag from ``args`` without dropping
        accumulated state (used when the argless default instance was
        created first)."""
        self.args = args
        self.run_id = str(getattr(args, "run_id", self.run_id))
        self.rank = int(getattr(args, "rank", self.rank) or 0)
        self.role = getattr(args, "role", None) or (
            "server" if self.rank == 0 else "client"
        )
        self.enabled = bool(getattr(args, "telemetry", self._enabled))
        ring = getattr(args, "trace_ring_size", None)
        if ring:
            self.recorder.resize(int(ring))

    def bind_device(self, device) -> None:
        """Name the card whose memory the export's ``sys_*`` gauges read
        (an entry point's explicit device)."""
        self.device = device

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

    def observe(
        self, name: str, value: float, buckets=None, **tags: Any
    ) -> None:
        """Histogram-style observation (count / sum / min / max).

        With ``buckets`` (a sequence of upper bounds, fixed by the
        series' first observation), the series also keeps cumulative
        ``le`` bucket counts and exposes as a full Prometheus
        *histogram* (``_bucket{le=...}`` lines + ``_sum``/``_count``)
        instead of the bare summary — the serving plane's latency
        series need quantile-estimable exports, not just a mean."""
        if not self._enabled:
            return
        v = float(value)
        with self._lock:
            key = self._key(name, tags)
            h = self._hists.get(key)
            if h is None:
                h = {"count": 0.0, "sum": 0.0, "min": v, "max": v}
                if buckets is not None:
                    # bounds attach ONLY at series creation: adopting
                    # them later would leave earlier observations out
                    # of every finite bucket while +Inf uses the full
                    # count — a non-cumulative (invalid) histogram
                    h["le"] = tuple(sorted(float(b) for b in buckets))
                    h["le_counts"] = [0] * len(h["le"])
                self._hists[key] = h
            h["count"] += 1
            h["sum"] += v
            h["min"] = min(h["min"], v)
            h["max"] = max(h["max"], v)
            for i, bound in enumerate(h.get("le", ())):
                if v <= bound:  # cumulative: every bound >= v counts
                    h["le_counts"][i] += 1

    def get_counter(self, name: str, **tags: Any) -> float:
        with self._lock:
            return self._counters.get(self._key(name, tags), 0.0)

    def counters_matching(self, name: str) -> Dict[str, float]:
        """All tag-series of one counter, rendered ``name{k=v,...}``."""
        with self._lock:
            return {
                self._fmt(n, t): v
                for (n, t), v in self._counters.items()
                if n == name
            }

    # -- progress / stall surface --------------------------------------
    def heartbeat(self, name: str, value: Any = None) -> None:
        """Mark progress; the watchdog calls a run stalled when EVERY
        heartbeat is older than ``stall_timeout_s``. Ages are measured
        on the monotonic clock — an NTP step must neither fake a stall
        nor hide one."""
        if not self._enabled:
            return
        with self._lock:
            self._heartbeats[name] = (value, time.monotonic())

    def heartbeats(self) -> Dict[str, Tuple[Any, float]]:
        with self._lock:
            return dict(self._heartbeats)

    def add_probe(self, name: str, fn: Callable[[], Any]) -> None:
        """Register a status callable sampled into stall bundles (e.g.
        a comm wrapper's queue depth)."""
        with self._lock:
            self._probes[name] = fn

    def attach_profiler(self, profiler) -> None:
        """Forward a ``ProfilerEvent``'s spans into the flight recorder
        and expose its open spans to the debug bundle."""
        profiler.recorder = self.recorder
        with self._lock:
            if profiler not in self._profilers:
                self._profilers.append(profiler)

    def attach_deferred(self, deferred) -> None:
        """Track a ``DeferredMetrics`` ring so stall bundles can report
        the pending (un-flushed) record count."""
        with self._lock:
            if deferred not in self._deferred:
                self._deferred.append(deferred)
                del self._deferred[:-8]  # only live rings matter

    def open_spans(self) -> List[Dict[str, Any]]:
        now = time.perf_counter()
        out = []
        with self._lock:
            profilers = list(self._profilers)
        for p in profilers:
            try:
                items = list(getattr(p, "_open", {}).items())
            except RuntimeError:
                # ProfilerEvent._open has no lock; a span opening on
                # another thread mid-copy must not abort the bundle
                items = []
            for name, t0 in items:
                out.append({"name": name, "open_for_s": round(now - t0, 3)})
        return out

    def pending_deferred(self) -> int:
        with self._lock:
            return sum(len(d) for d in self._deferred)

    def probes(self) -> Dict[str, Callable[[], Any]]:
        with self._lock:
            return dict(self._probes)

    # -- exposition (MetricsReporter sink seam + Prometheus text) ------
    def _ensure_reporter(self):
        if self._reporter is None:
            from types import SimpleNamespace

            from .tracking import MetricsReporter

            # quiet reporter: sinks only, no logging fan-out by default
            self._reporter = MetricsReporter(
                SimpleNamespace(log_metrics=False), keep_history=False
            )
        return self._reporter

    def add_sink(self, sink) -> None:
        self._ensure_reporter().add_sink(sink)

    def add_jsonl_sink(self, path: str) -> None:
        self._ensure_reporter().add_jsonl_sink(path)

    @staticmethod
    def _fmt(name: str, tags: Tuple) -> str:
        if not tags:
            return name
        return name + "{" + ",".join(f"{k}={v}" for k, v in tags) + "}"

    def _sync_trace_drops(self) -> None:
        """Mirror the flight-recorder's ring-overflow count into
        ``telemetry_trace_dropped_total`` so a silently-wrapped ring is
        visible in every exposition (``dropped`` is monotonic, so the
        absolute assignment keeps counter semantics)."""
        if not self._enabled:
            return
        dropped = self.recorder.dropped
        if dropped:
            with self._lock:
                self._counters[
                    self._key("telemetry_trace_dropped_total", {})
                ] = float(dropped)

    def snapshot(self) -> Dict[str, Any]:
        self._sync_trace_drops()
        with self._lock:
            counters = {self._fmt(n, t): v for (n, t), v in self._counters.items()}
            gauges = {self._fmt(n, t): v for (n, t), v in self._gauges.items()}
            hists = {
                # copy le_counts too: the snapshot must not alias the
                # live (still-mutating) cumulative bucket list
                self._fmt(n, t): {
                    k: (list(v) if isinstance(v, list) else v)
                    for k, v in h.items()
                }
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

    def publish_snapshot(self) -> Dict[str, Any]:
        """Push one snapshot record through the configured sinks."""
        snap = self.snapshot()
        self._ensure_reporter().report(snap)
        return snap

    def prometheus_text(self) -> str:
        """Standard Prometheus text exposition of the registry."""
        self._sync_trace_drops()
        base = {"run_id": self.run_id, "rank": self.rank, "role": self.role}

        def labels(tags: Tuple, **extra: Any) -> str:
            merged = {**base, **dict(tags), **extra}
            inner = ",".join(
                f'{_sanitize_metric(k)}="{_escape_label_value(v)}"'
                for k, v in sorted(
                    (str(k), str(v)) for k, v in merged.items()
                )
            )
            return "{" + inner + "}"

        with self._lock:
            counters = sorted(self._counters.items(), key=lambda kv: kv[0])
            gauges = sorted(self._gauges.items(), key=lambda kv: kv[0])
            hists = sorted(self._hists.items(), key=lambda kv: kv[0])
        lines: List[str] = []
        seen_type = set()
        for (name, tags), v in counters:
            m = _sanitize_metric(name)
            if m not in seen_type:
                lines.append(f"# TYPE {m} counter")
                seen_type.add(m)
            lines.append(f"{m}{labels(tags)} {v}")
        for (name, tags), v in gauges:
            m = _sanitize_metric(name)
            if m not in seen_type:
                lines.append(f"# TYPE {m} gauge")
                seen_type.add(m)
            lines.append(f"{m}{labels(tags)} {v}")
        for (name, tags), h in hists:
            m = _sanitize_metric(name)
            # explicit-bucket series export as real histograms (the
            # serving latency/occupancy series); bucket-less ones stay
            # the lighter summary shape they always were
            kind = "histogram" if "le" in h else "summary"
            if m not in seen_type:
                lines.append(f"# TYPE {m} {kind}")
                seen_type.add(m)
            if "le" in h:
                for bound, c in zip(h["le"], h["le_counts"]):
                    lines.append(
                        f"{m}_bucket{labels(tags, le=bound)} {float(c)}"
                    )
                lines.append(
                    f'{m}_bucket{labels(tags, le="+Inf")} {h["count"]}'
                )
            lines.append(f"{m}_count{labels(tags)} {h['count']}")
            lines.append(f"{m}_sum{labels(tags)} {h['sum']}")
        return "\n".join(lines) + "\n"

    # -- run lifecycle -------------------------------------------------
    def maybe_start_watchdog(self, args) -> Optional["StallWatchdog"]:
        """Start (or return the running) stall watchdog when
        ``args.stall_timeout_s`` > 0 and telemetry is enabled."""
        timeout = float(getattr(args, "stall_timeout_s", 0) or 0)
        if not self._enabled or timeout <= 0:
            return None
        if self._watchdog is not None and self._watchdog.alive():
            return self._watchdog
        self._watchdog = StallWatchdog(
            self, timeout, getattr(args, "telemetry_dir", None)
        ).start()
        return self._watchdog

    def stop_watchdog(self) -> None:
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None

    def maybe_start_metrics_server(self, args) -> Optional["MetricsServer"]:
        """Start (or return the running) pull-based ``/metrics``
        endpoint when ``args.metrics_port`` > 0 and telemetry is
        enabled. Off by default — scrape-style exposition is opt-in."""
        port = int(getattr(args, "metrics_port", 0) or 0)
        if not self._enabled or port <= 0:
            return None
        if self._metrics_server is not None and self._metrics_server.alive():
            return self._metrics_server
        host = str(getattr(args, "metrics_host", None) or "127.0.0.1")
        try:
            self._metrics_server = MetricsServer(self, port, host=host).start()
        except OSError as e:
            # a busy port must not kill the run the metrics describe
            logging.error("metrics server on port %d failed: %s", port, e)
            self._metrics_server = None
        return self._metrics_server

    def stop_metrics_server(self) -> None:
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None

    def set_system_gauges(self, sample: Dict[str, Any]) -> None:
        """Mirror a ``sys_stats`` sample's numeric fields into
        ``sys_*`` gauges — the ONE naming/filter rule shared by the
        export-time snapshot and ``SysStats``' streaming sampler."""
        for k, v in sample.items():
            if isinstance(v, (int, float)):
                self.set_gauge(f"sys_{k}", v)

    def sample_system_gauges(self) -> None:
        """One host+device ``sys_stats`` sample into ``sys_*`` gauges
        (the card's memory in use, peak and limit; CPU/mem/net) — called at export so every
        ``metrics.prom`` carries the headroom figures; ``SysStats``
        can also stream them continuously (its ``telemetry`` arg)."""
        from . import sys_stats

        self.set_system_gauges(
            {**sys_stats.sample_host_stats(),
             **sys_stats.sample_device_stats(self.device)}
        )

    def export_run_artifacts(self, out_dir: Optional[str]) -> Optional[str]:
        """Write the run's flight record + registry to ``out_dir``:
        ``trace.json`` (Chrome trace / perfetto), ``metrics.prom``
        (Prometheus text) and one snapshot appended to
        ``telemetry.jsonl``. Non-zero ranks write rank-suffixed file
        names (``trace_rank2.json``) so a multi-PROCESS federation
        sharing one ``telemetry_dir`` never clobbers; single-process
        worlds (LOCAL threads) share this one registry, so their
        repeated exports rewrite the same merged view and the last —
        most complete — export wins. No-op when disabled or no dir
        given; never raises (a telemetry write failure must not mask a
        run's result or abort teardown)."""
        if not self._enabled or not out_dir:
            return None
        try:
            with self._export_lock:
                self.sample_system_gauges()
                os.makedirs(out_dir, exist_ok=True)
                suffix = "" if self.rank == 0 else f"_rank{self.rank}"
                meta = {
                    "run_id": self.run_id, "rank": self.rank, "role": self.role,
                }
                self.recorder.export(
                    os.path.join(out_dir, f"trace{suffix}.json"), meta=meta
                )
                with open(
                    os.path.join(out_dir, f"metrics{suffix}.prom"), "w"
                ) as fh:
                    fh.write(self.prometheus_text())
                snap = self.snapshot()  # records carry their rank already
                with open(os.path.join(out_dir, "telemetry.jsonl"), "a") as fh:
                    fh.write(json.dumps({"ts": time.time(), **snap}) + "\n")
        except Exception:  # noqa: BLE001 — never kill the run
            logging.exception("telemetry export to %s failed", out_dir)
            return None
        return out_dir


class StallWatchdog:
    """Heartbeat observer: when every registered heartbeat is older
    than ``stall_timeout_s``, dump ONE debug bundle per stall episode
    (re-armed when progress resumes) and keep the run alive — the
    bundle is for the operator, not a kill switch."""

    def __init__(
        self,
        telemetry: Telemetry,
        stall_timeout_s: float,
        out_dir: Optional[str],
        poll_s: Optional[float] = None,
    ) -> None:
        self.telemetry = telemetry
        self.stall_timeout_s = float(stall_timeout_s)
        self.out_dir = out_dir
        self.poll_s = (
            float(poll_s) if poll_s is not None
            else max(0.05, self.stall_timeout_s / 4.0)
        )
        self.bundles: List[str] = []
        self._fired = False
        self._n = 0
        self._started_mono = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "StallWatchdog":
        if self._thread is None:
            self._started_mono = time.monotonic()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="telemetry-stall-watchdog"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_s + 1)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            hb = self.telemetry.heartbeats()
            # progress baseline: the newest heartbeat of THIS run, or
            # the watchdog's start when none has landed yet. Marks left
            # by a previous run (the singleton outlives train() calls)
            # never count — but a run that hangs before its FIRST
            # heartbeat (compile deadlock, wedged device) still fires
            # after one full timeout of grace.
            fresh = [ts for _, ts in hb.values() if ts >= self._started_mono]
            newest = max(fresh) if fresh else self._started_mono
            youngest_age = time.monotonic() - newest
            if youngest_age > self.stall_timeout_s:
                if not self._fired:
                    try:
                        self.dump_bundle(
                            f"no heartbeat for {youngest_age:.1f}s "
                            f"(stall_timeout_s={self.stall_timeout_s})"
                        )
                        # only a successful dump closes the episode — a
                        # failed attempt retries next poll instead of
                        # losing the stall's only bundle
                        self._fired = True
                    except Exception:  # noqa: BLE001 — never kill the run
                        logging.exception("stall bundle dump failed")
            else:
                self._fired = False  # progress resumed; re-arm

    def dump_bundle(self, reason: str) -> Optional[str]:
        """Collect the debug bundle (the JSON of ``stall_bundle_NNN.json``) and write it to ``out_dir``; always log a summary."""
        from . import sys_stats

        tel = self.telemetry
        hb = tel.heartbeats()
        now = time.time()
        now_mono = time.monotonic()  # heartbeat stamps are monotonic
        probes = {}
        for name, fn in tel.probes().items():
            try:
                probes[name] = fn()
            except Exception as e:  # noqa: BLE001 — a probe must not abort the dump
                probes[name] = f"probe failed: {type(e).__name__}: {e}"
        bundle = {
            "kind": "stall_bundle",
            "reason": reason,
            "captured_at": now,
            "run_id": tel.run_id,
            "rank": tel.rank,
            "role": tel.role,
            "stall_timeout_s": self.stall_timeout_s,
            "heartbeats": {
                n: {"value": v, "age_s": round(now_mono - ts, 3)}
                for n, (v, ts) in hb.items()
            },
            "open_spans": tel.open_spans(),
            "pending_deferred_metrics": tel.pending_deferred(),
            "recent_events": tel.recorder.tail(200),
            "host_stats": _guarded(sys_stats.sample_host_stats),
            "device_stats": _guarded(lambda: sys_stats.sample_device_stats(tel.device)),
            "probes": probes,
            "snapshot": tel.snapshot(),
        }
        tel.inc("telemetry_stall_bundles_total")
        logging.error(
            "STALL detected (%s): %d open span(s), %d pending deferred "
            "metric(s), heartbeats: %s",
            reason, len(bundle["open_spans"]),
            bundle["pending_deferred_metrics"],
            {n: h["age_s"] for n, h in bundle["heartbeats"].items()},
        )
        if not self.out_dir:
            return None
        os.makedirs(self.out_dir, exist_ok=True)
        self._n += 1
        path = os.path.join(self.out_dir, f"stall_bundle_{self._n:03d}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(bundle, fh, indent=2, default=str)
        os.replace(tmp, path)
        self.bundles.append(path)
        logging.error("stall debug bundle written to %s", path)
        return path


class MetricsServer:
    """Tiny stdlib HTTP exposition endpoint: ``GET /metrics`` returns
    ``Telemetry.prometheus_text()`` (scrape-style pull, the push-less
    complement to the JSONL sinks). Serves on ``args.metrics_port``
    (off by default), started and stopped with the run; the listener
    thread is a daemon so a leaked server can never hold a process
    open. Binds loopback by default — an unauthenticated endpoint
    inside the training process must be opted onto the network
    (``metrics_host: 0.0.0.0``), never exposed by default."""

    def __init__(
        self, telemetry: Telemetry, port: int, host: str = "127.0.0.1"
    ) -> None:
        import http.server

        self.telemetry = telemetry
        outer = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 — stdlib API name
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                try:
                    body = outer.telemetry.prometheus_text().encode()
                except Exception as e:  # noqa: BLE001 — a scrape must not crash
                    self.send_error(500, str(e))
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args) -> None:  # noqa: A003
                logging.debug("metrics server: " + fmt, *args)

        self._httpd = http.server.ThreadingHTTPServer(
            (str(host), int(port)), _Handler
        )
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_port)  # resolved (0 = ephemeral)
        self._thread: Optional[threading.Thread] = None

    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "MetricsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.2},
                daemon=True,
                name="telemetry-metrics-server",
            )
            self._thread.start()
            logging.info("metrics server serving /metrics on port %d", self.port)
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
