"""The kernels' persistent build cache behind ``args.compile_cache_dir``
(port of ``fedml_tpu/core/compile_cache.py``).

The port does not use ``torch.compile``: what it compiles are its CUDA
sources, one ``nvcc`` run a library (``ops/_build.py``), whose file
names carry a hash of the source, the shared headers and the flags. The
JAX package's persistent XLA cache becomes the directory those
libraries are built into and reused from:

- ``maybe_enable_compile_cache(args)`` — idempotent, process-wide. The
  first call with the knob set roots the kernel build directory at it;
  later calls with the same directory are no-ops, a DIFFERENT directory
  logs one warning and keeps the first. Called from every engine init
  (``FedAvgAPI``, the planet loop, the serving engine). Without the
  knob, libraries build into ``ops/build/`` as before.
- hit/miss telemetry: ``ops/_build.build`` reports each library it
  finds already built (``compile_cache_hits_total``) and each one it
  runs ``nvcc`` for (``compile_cache_misses_total``), and
  ``cache_entries()`` gauges the libraries in the directory
  (``compile_cache_entries``; their ``.log`` reports are not entries).
  They count only while the cache is enabled and telemetry is on: a
  warm-started process shows hits == the libraries it loaded and a
  cold one shows the same number as misses.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

# process-scoped: the directory the cache was enabled with (None =
# never enabled); the kernel build directory is process-global, so this
# module is too
_enabled_dir: Optional[str] = None
_warned_conflict = False


def cache_entries(directory: Optional[str] = None) -> int:
    """Number of built libraries currently in the (given or enabled)
    cache directory; 0 when disabled/absent."""
    d = directory or _enabled_dir
    if not d or not os.path.isdir(d):
        return 0
    return sum(1 for n in os.listdir(d) if n.endswith(".so") and not n.startswith("."))


def enabled_dir() -> Optional[str]:
    return _enabled_dir


def record_build(hits: int, misses: int) -> None:
    """Count one ``ops/_build.build`` call's reused (``hits``) and
    freshly compiled (``misses``) libraries; nothing while the cache is
    disabled (host-side counter bumps only)."""
    if _enabled_dir is None or not (hits or misses):
        return
    from .telemetry import Telemetry

    tel = Telemetry.get_instance()
    if not tel.enabled:
        return
    if hits:
        tel.inc("compile_cache_hits_total", hits)
    if misses:
        tel.inc("compile_cache_misses_total", misses)
        # a miss just wrote an entry: keep the directory gauge live
        tel.set_gauge("compile_cache_entries", cache_entries())


def maybe_enable_compile_cache(args) -> bool:
    """Root the kernel build directory at ``args.compile_cache_dir`` when
    it is set. Returns True when the cache is active (now or from an
    earlier identical call)."""
    global _enabled_dir, _warned_conflict
    d = getattr(args, "compile_cache_dir", None)
    if not d:
        return _enabled_dir is not None
    d = os.path.abspath(str(d))
    if _enabled_dir is not None:
        if _enabled_dir != d and not _warned_conflict:
            _warned_conflict = True
            logging.warning(
                "compile_cache_dir=%s ignored: the process-wide kernel "
                "build cache is already rooted at %s (one directory per "
                "process)",
                d, _enabled_dir,
            )
        return True
    os.makedirs(d, exist_ok=True)
    from ..ops import _build

    _build.BUILD_DIR = Path(d)
    _enabled_dir = d
    from .telemetry import Telemetry

    tel = Telemetry.get_instance()
    if tel.enabled:
        tel.set_gauge("compile_cache_entries", cache_entries(d))
    logging.info("kernel build cache enabled at %s", d)
    return True
