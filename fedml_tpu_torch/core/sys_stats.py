"""Host memory readings (port subset of ``fedml_tpu/core/sys_stats.py``).

``current_rss_bytes`` and ``peak_rss_bytes``, which the registry path's
flat-memory claim is measured with (a warm re-run's RSS delta must not
grow with the registry). The rest of the module, host and device stats
sampled into the metrics sinks, waits for the telemetry exporters.
"""

from __future__ import annotations

import os
import sys

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
