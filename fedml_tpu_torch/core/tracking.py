"""Round metrics (port subset of ``fedml_tpu/core/tracking.py``).

``DeferredMetrics`` holds the round pipeline's metric tensors on the
device until a flush fetches them all at once. ``MetricsReporter`` fans
each round's record out to the log (``args.log_metrics``) and, when
``args.metrics_jsonl_path`` is set, to one JSON line per record in that
file. The round's history of record stays on the API
(``FedAvgAPI.history``).
"""

from __future__ import annotations

import functools
import json
import logging
import os
import time
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
