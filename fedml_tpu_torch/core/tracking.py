"""Observability: round metrics, event spans, run logging, device
traces (port of ``fedml_tpu/core/tracking.py``).

``DeferredMetrics`` holds the round pipeline's metric tensors on the
device until a flush fetches them all at once. ``MetricsReporter`` fans
each record out to pluggable sinks: the log (``args.log_metrics``), one
JSON line per record in ``args.metrics_jsonl_path`` or any file given to
``add_jsonl_sink``, and any callable given to ``add_sink`` (a failing
sink is logged, never raised). The round's history of record stays on
the API (``FedAvgAPI.history``). ``ProfilerEvent`` is the reference's
span recorder; each span is also a ``torch.profiler.record_function``
range, so a profiled round shows it beside the device's work.
``RunLogger`` is per-run file logging with a chunked-upload seam, and
``device_trace`` captures a ``torch.profiler`` trace of a whole run on
the explicit device when ``args.profile_dir`` is set.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

Sink = Callable[[Dict[str, Any]], None]


class DeferredMetrics:
    """Device-resident metric ring for the round pipeline.

    The round pipeline (``core/round_pipeline.py``) keeps its hot loop
    free of host syncs: each evaluated round's metric tensors stay on
    the device and are ``push``ed here; ``flush`` brings every pending
    record to the host in ONE device-to-host copy. ``host_syncs``
    counts those copies.

    Contract: ``push`` never touches device values; ``flush(upto)``
    fetches (and removes) all records with ``round_idx <= upto`` (None =
    everything, the drain) and returns ``[(round_idx, host_tree), ...]``
    in push order, where ``host_tree`` has the pushed structure with a
    Python float at each leaf (every leaf a one-element tensor).
    """

    def __init__(self) -> None:
        self._pending: List[Tuple[int, Any]] = []
        self.host_syncs = 0
        self.flushes = 0

    def __len__(self) -> int:
        return len(self._pending)

    def push(self, round_idx: int, device_tree: Any) -> None:
        self._pending.append((round_idx, device_tree))

    def flush(self, upto: Optional[int] = None) -> List[Tuple[int, Any]]:
        ready, keep = [], []
        for rec in self._pending:  # one pass, push order preserved
            (ready if upto is None or rec[0] <= upto else keep).append(rec)
        if not ready:
            return []
        self._pending = keep
        flat = [pytree.tree_flatten(tree) for _, tree in ready]
        leaves = [leaf.reshape(()) for lv, _ in flat for leaf in lv]
        # one dtype wide enough for every leaf (float64 stays float64)
        dtype = functools.reduce(torch.promote_types, (t.dtype for t in leaves))
        host = torch.stack([t.to(dtype) for t in leaves]).tolist()  # ONE fetch for all
        self.host_syncs += 1
        self.flushes += 1
        out, at = [], 0
        for (r, _), (lv, spec) in zip(ready, flat):
            out.append((r, pytree.tree_unflatten(host[at:at + len(lv)], spec)))
            at += len(lv)
        return out


class MetricsReporter:
    """Round/train/test metrics to pluggable sinks."""

    def __init__(self, args=None, keep_history: bool = True) -> None:
        self.sinks: List[Sink] = []
        self.keep_history = keep_history
        self.history: List[Dict[str, Any]] = []
        path = getattr(args, "metrics_jsonl_path", None) if args else None
        if path:
            self.add_jsonl_sink(path)
        if args is None or getattr(args, "log_metrics", True):
            self.sinks.append(lambda rec: logging.info("metrics: %s", rec))

    def add_sink(self, sink: Sink) -> None:
        self.sinks.append(sink)

    def add_jsonl_sink(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

        def write(rec: Dict[str, Any]) -> None:
            with open(path, "a") as f:
                f.write(json.dumps(rec) + "\n")

        self.sinks.append(write)

    def report(self, record: Dict[str, Any]) -> None:
        rec = {"ts": time.time(), **record}
        if self.keep_history:
            self.history.append(rec)
        for sink in self.sinks:
            try:
                sink(rec)
            except Exception:  # noqa: BLE001 — a sink must not kill the run
                logging.exception("metrics sink failed")

    # reference-API aliases (mlops_metrics.py)
    def report_server_training_metric(self, metric: Dict[str, Any]) -> None:
        self.report({"kind": "server_train", **metric})

    def report_client_training_metric(self, metric: Dict[str, Any]) -> None:
        self.report({"kind": "client_train", **metric})


class RunLogger:
    """Per-run file logging with an upload seam."""

    _instance: Optional["RunLogger"] = None
    CHUNK_LINES = 100  # mlops_runtime_log.py:13

    def __init__(self, args=None) -> None:
        self.args = args
        self.uploader: Optional[Callable[[List[str]], None]] = None
        self._pending: List[str] = []

    @classmethod
    def get_instance(cls, args=None) -> "RunLogger":
        if cls._instance is None:
            cls._instance = cls(args)
        elif args is not None and cls._instance.args is None:
            # adopt late-supplied args instead of silently ignoring them
            cls._instance.args = args
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        """Drop the singleton so state cannot leak across tests."""
        cls._instance = None

    def init_logs(self, log_dir: Optional[str] = None) -> None:
        run_id = getattr(self.args, "run_id", "0") if self.args else "0"
        rank = getattr(self.args, "rank", 0) if self.args else 0
        handlers: List[logging.Handler] = [logging.StreamHandler()]
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f"run_{run_id}_rank_{rank}.log")
            handlers.append(logging.FileHandler(path))
        logging.basicConfig(
            level=logging.INFO,
            format="[%(asctime)s %(levelname)s rank" + str(rank) + "] %(message)s",
            handlers=handlers,
            force=True,
        )

    def set_uploader(self, fn: Callable[[List[str]], None]) -> None:
        """Chunked-upload seam (mlops_runtime_log.py:41-47)."""
        self.uploader = fn

    def upload_line(self, line: str) -> None:
        if self.uploader is None:
            return
        self._pending.append(line)
        if len(self._pending) >= self.CHUNK_LINES:
            self.flush()

    def flush(self) -> None:
        if self.uploader and self._pending:
            self.uploader(list(self._pending))
            self._pending.clear()


class device_trace:
    """Capture a ``torch.profiler`` trace of a whole run when
    ``args.profile_dir`` is set; inert otherwise. The device's activity
    is traced when ``device`` is a CUDA device, the host's always; the
    Chrome trace lands in ``<profile_dir>/trace.json`` (perfetto or
    chrome://tracing)."""

    def __init__(self, args=None, device="cuda") -> None:
        self.logdir = getattr(args, "profile_dir", None) if args else None
        self.device = device
        self._prof = None

    def __enter__(self) -> "device_trace":
        if self.logdir:
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(self.logdir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
            logging.info("device trace capturing to %s", self.logdir)
        return self

    def __exit__(self, *exc) -> bool:
        if self._prof is not None:
            self._prof.__exit__(*exc)
            self._prof.export_chrome_trace(os.path.join(self.logdir, "trace.json"))
            self._prof = None
        return False


class ProfilerEvent:
    """Span recorder. ``log_event_started(name)`` /
    ``log_event_ended(name)`` mirror the reference API; ``span(name)`` is
    the context-manager form. ``Telemetry.attach_profiler`` mirrors the
    spans into the flight recorder."""

    def __init__(self, args=None) -> None:
        self.args = args
        self.run_id = getattr(args, "run_id", "0") if args else "0"
        self._open: Dict[str, float] = {}
        self.spans: List[Dict[str, Any]] = []
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.recorder = None

    def log_event_started(self, event_name: str, value: Any = None,
                          **trace_args: Any) -> None:
        self._open[event_name] = time.perf_counter()
        if self.recorder is not None:
            self.recorder.begin(event_name, cat="profiler", **trace_args)

    def log_event_ended(self, event_name: str, value: Any = None,
                        **trace_args: Any) -> None:
        t0 = self._open.pop(event_name, None)
        if t0 is None:
            logging.warning("span %r ended without start", event_name)
            return
        if self.recorder is not None:
            self.recorder.end(event_name, cat="profiler", **trace_args)
        dt = time.perf_counter() - t0
        self.spans.append({"name": event_name, "duration_s": dt, "ended_at": time.time()})
        self.totals[event_name] += dt
        self.counts[event_name] += 1

    def span(self, name: str, **trace_args: Any) -> "_Span":
        return _Span(self, name, **trace_args)


class _Span:
    def __init__(self, ev: ProfilerEvent, name: str, **trace_args: Any) -> None:
        self.ev, self.name, self.trace_args = ev, name, trace_args
        self._range = None

    def __enter__(self) -> "_Span":
        self.ev.log_event_started(self.name, **self.trace_args)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._range.__exit__(*exc)
        self.ev.log_event_ended(self.name, **self.trace_args)
