"""System-resource sampling (port of ``fedml_tpu/core/sys_stats.py``).

Host CPU, memory, disk and network counters through psutil, and the
card's memory through the CUDA caching allocator, under the JAX
package's keys (``device{i}_bytes_in_use``, ``device{i}_peak_bytes``,
``device{i}_bytes_limit``), so the ``sys_*`` gauges a dashboard reads
carry the same names from either package. Records go to the same
pluggable-sink ``MetricsReporter`` the rest of the framework uses.

The device half reads one explicit device (or the current CUDA device
when CUDA is already initialised) and never initialises CUDA itself: a
CPU run samples no device. It is read at export or by ``SysStats``' own
thread, never inside a round.

``current_rss_bytes`` and ``peak_rss_bytes`` are what the registry
path's flat-memory claim is measured with (a warm re-run's RSS delta
must not grow with the registry).
"""

from __future__ import annotations

import logging
import os
import sys
import threading
from typing import Any, Dict, Optional

try:
    import psutil

    _HAS_PSUTIL = True
except ImportError:  # pragma: no cover
    _HAS_PSUTIL = False


def current_rss_bytes() -> int:
    """This process's resident set size right now (0 only when
    unmeasurable: no psutil and no ``/proc``); a caller that gates on
    it fails on 0 rather than passing vacuously."""
    if _HAS_PSUTIL:
        return int(psutil.Process().memory_info().rss)
    try:  # psutil-less Linux: statm field 2 is the resident page count
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE")
    except (OSError, ValueError, IndexError):  # pragma: no cover
        return 0


def peak_rss_bytes() -> int:
    """Lifetime peak resident set size of this process (``ru_maxrss``)."""
    try:
        import resource

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    except (ImportError, ValueError):  # pragma: no cover — non-POSIX
        return current_rss_bytes()
    # Linux reports KiB, macOS bytes
    return int(peak if sys.platform == "darwin" else peak * 1024)


def sample_host_stats() -> Dict[str, Any]:
    """One snapshot of host CPU/memory/disk/net counters."""
    if not _HAS_PSUTIL:
        return {}
    vm = psutil.virtual_memory()
    disk = psutil.disk_usage("/")
    net = psutil.net_io_counters()
    return {
        "cpu_util_pct": psutil.cpu_percent(interval=None),
        "mem_used_gb": vm.used / 2**30,
        "mem_util_pct": vm.percent,
        "disk_util_pct": disk.percent,
        "net_sent_mb": net.bytes_sent / 2**20,
        "net_recv_mb": net.bytes_recv / 2**20,
        "proc_rss_gb": psutil.Process().memory_info().rss / 2**30,
    }


def sample_device_stats(device=None) -> Dict[str, Any]:
    """The card's memory: bytes the caching allocator holds for tensors,
    its peak, and the card's total (``bytes_limit``, so headroom is a
    gauge, not a ratio the operator must reconstruct). ``device`` is the
    card to read (a ``torch.device``, ``"cuda:N"`` or an index); None
    reads the current CUDA device when CUDA is initialised. Empty on the
    CPU."""
    import torch

    if device is None:
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return {}
        index = torch.cuda.current_device()
    else:
        dev = torch.device(device) if not isinstance(device, int) else torch.device("cuda", device)
        if dev.type != "cuda":
            return {}
        index = dev.index if dev.index is not None else torch.cuda.current_device()
    _free, total = torch.cuda.mem_get_info(index)
    return {
        f"device{index}_bytes_in_use": int(torch.cuda.memory_allocated(index)),
        f"device{index}_peak_bytes": int(torch.cuda.max_memory_allocated(index)),
        f"device{index}_bytes_limit": int(total),
    }


class SysStats:
    """Background sampler publishing to a reporter every ``interval_s``
    (and, with ``telemetry``, into its ``sys_*`` gauges)."""

    def __init__(self, reporter, interval_s: float = 10.0, telemetry=None,
                 device=None) -> None:
        self.reporter = reporter
        self.interval_s = float(interval_s)
        self.telemetry = telemetry
        self.device = device
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "SysStats":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                rec = {"kind": "sys_stats", **sample_host_stats(),
                       **sample_device_stats(self.device)}
                self.reporter.report(rec)
                if self.telemetry is not None:
                    self.telemetry.set_system_gauges(rec)
            except Exception:  # noqa: BLE001 — a sampler must not kill the run
                logging.exception("sys stats sampling failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 1)
            self._thread = None
