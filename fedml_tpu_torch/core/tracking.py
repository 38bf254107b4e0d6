"""Round metrics to sinks (port subset of ``fedml_tpu/core/tracking.py``).

``MetricsReporter`` fans each round's record out to the log
(``args.log_metrics``) and, when ``args.metrics_jsonl_path`` is set, to
one JSON line per record in that file. The round's history of record
stays on the API (``FedAvgAPI.history``).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Dict, List

Sink = Callable[[Dict[str, Any]], None]


class MetricsReporter:
    def __init__(self, args=None) -> None:
        self.sinks: List[Sink] = []
        path = getattr(args, "metrics_jsonl_path", None) if args else None
        if path:
            self.add_jsonl_sink(path)
        if args is None or getattr(args, "log_metrics", True):
            self.sinks.append(lambda rec: logging.info("metrics: %s", rec))

    def add_jsonl_sink(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

        def write(rec: Dict[str, Any]) -> None:
            with open(path, "a") as f:
                f.write(json.dumps(rec) + "\n")

        self.sinks.append(write)

    def report(self, record: Dict[str, Any]) -> None:
        rec = {"ts": time.time(), **record}
        for sink in self.sinks:
            sink(rec)

    def report_server_training_metric(self, metric: Dict[str, Any]) -> None:
        self.report({"kind": "server_train", **metric})
