"""Native (C++) runtime bindings (port of ``fedml_tpu/core/native.py``).

The port keeps its own copies of the JAX package's two C++ sources,
under ``fedml_tpu_torch/native/``, and builds them into
``fedml_tpu_torch/native/build/`` (gitignored), never into the JAX
package's ``native/build/``:

- ``native/scheduler.cpp`` — LPT + exact branch-and-bound makespan
  scheduling, via ctypes.
- ``native/broker.cpp`` — the deployment message broker (the wire
  protocol of ``core/comm/broker.py``), launched by
  ``core.comm.native_broker.spawn_native_broker``.

Build: ``g++ -O2`` on first use, to a per-process temporary name and
renamed into place (concurrent processes race for it). Without ``g++``,
or with ``FEDML_TPU_NO_NATIVE=1``, the callers take the Python broker
and LPT; a failed build logs ``native build failed``, as the JAX
package does.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
BUILD_DIR = os.path.join(NATIVE_DIR, "build")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def native_disabled() -> bool:
    return os.environ.get("FEDML_TPU_NO_NATIVE", "") == "1"


def build_native(source: str, output: str, extra_flags: Sequence[str] = ()) -> Optional[str]:
    """Compile one C++ source with g++; returns the output path or None."""
    if native_disabled():
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(NATIVE_DIR, source)
    out = os.path.join(BUILD_DIR, output)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    # compile to a per-process temp path and rename atomically: several
    # processes may race to build the same binary
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-std=c++17", *extra_flags, src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError) as e:
        detail = getattr(e, "stderr", b"")
        logging.warning("native build failed (%s): %s", source, detail)
        try:
            os.remove(tmp)
        except OSError:
            logging.debug("native: temp %s cleanup failed", tmp, exc_info=True)
        return None


def _scheduler_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = build_native("scheduler.cpp", "libfedml_sched.so", ["-shared", "-fPIC"])
        if path is None:
            _lib_failed = True
            return None
        lib = ctypes.CDLL(path)
        lib.lpt_makespan.restype = ctypes.c_double
        lib.lpt_makespan.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.bnb_makespan.restype = ctypes.c_double
        lib.bnb_makespan.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


def _as_buffers(workloads: Sequence[float]):
    w = np.ascontiguousarray(workloads, dtype=np.float64)
    assign = np.zeros(len(w), dtype=np.int32)
    return (
        w,
        assign,
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        assign.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )


def _bunches(assign: np.ndarray, num_resources: int) -> List[List[int]]:
    out: List[List[int]] = [[] for _ in range(num_resources)]
    for j, r in enumerate(assign.tolist()):
        out[r].append(j)
    return out


def lpt_makespan_native(
    workloads: Sequence[float], num_resources: int
) -> Optional[Tuple[List[List[int]], float]]:
    """Native LPT; None when the toolchain/lib is unavailable."""
    lib = _scheduler_lib()
    if lib is None or not len(workloads):
        return None
    w, assign, wp, ap = _as_buffers(workloads)
    ms = lib.lpt_makespan(wp, len(w), int(num_resources), ap)
    return _bunches(assign, num_resources), float(ms)


def exact_makespan(
    workloads: Sequence[float],
    num_resources: int,
    node_budget: int = 1 << 22,
) -> Optional[Tuple[List[List[int]], float]]:
    """Exact branch-and-bound schedule (native); None without the lib.
    Falls back internally to the LPT incumbent if the node budget trips,
    so the result is never worse than greedy."""
    lib = _scheduler_lib()
    if lib is None or not len(workloads):
        return None
    w, assign, wp, ap = _as_buffers(workloads)
    ms = lib.bnb_makespan(wp, len(w), int(num_resources), int(node_budget), ap)
    return _bunches(assign, num_resources), float(ms)
