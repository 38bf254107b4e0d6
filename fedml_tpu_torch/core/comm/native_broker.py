"""Launcher for the native (C++) broker binary (port of
``fedml_tpu/core/comm/native_broker.py``).

``fedml_tpu_torch/native/broker.cpp`` speaks the exact wire protocol of
the Python :class:`~fedml_tpu_torch.core.comm.broker.Broker` (and so of
the JAX package's brokers); this module builds it on demand into
``fedml_tpu_torch/native/build/`` and runs it as a child process.
``spawn_native_broker`` parses the "LISTENING <port>" handshake so
ephemeral ports work. The Python broker stays the in-process default;
``FEDML_TPU_NATIVE_BROKER=1`` makes ``ensure_broker`` start this one.
"""

from __future__ import annotations

import atexit
import logging
import select
import subprocess
import sys
from typing import Optional, Tuple

from ..native import build_native, native_disabled


def build_native_broker() -> Optional[str]:
    if native_disabled():
        return None
    return build_native("broker.cpp", "fedml_broker", ["-pthread"])


def spawn_native_broker(
    port: int = 0, timeout_s: float = 10.0
) -> Optional[Tuple[str, int, subprocess.Popen]]:
    """Start the C++ broker; returns (host, port, process) or None when
    the binary can't be built or its handshake fails."""
    binary = build_native_broker()
    if binary is None:
        return None
    proc = subprocess.Popen(
        [binary, str(port)], stdout=subprocess.PIPE, stderr=sys.stderr
    )
    ready, _, _ = select.select([proc.stdout], [], [], timeout_s)
    line = (
        proc.stdout.readline().decode("utf-8", "replace").strip() if ready else ""
    )
    if not line.startswith("LISTENING "):
        proc.terminate()
        proc.wait(timeout=5)
        logging.warning("native broker handshake failed: %r", line)
        return None
    bound = int(line.split()[1])
    atexit.register(proc.terminate)
    logging.info("native broker on port %d (pid %d)", bound, proc.pid)
    return ("127.0.0.1", bound, proc)
