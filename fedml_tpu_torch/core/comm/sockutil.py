"""Shared socket helpers for the comm transports."""

from __future__ import annotations

import socket
from typing import Optional


def recv_exact(sock: socket.socket, n: int) -> Optional[memoryview]:
    """Read exactly ``n`` bytes (recv_into, no re-concatenation);
    None on EOF."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            return None
        got += r
    return memoryview(buf)
