"""Device resolution (port of ``fedml_tpu/device.py``).

Every entry point of the port runs on ``"cuda"`` unless told otherwise:
by its ``device=`` argument, or else by the configuration's
``device_type`` (``device_args``; ``"cuda"`` by default). Nothing here
falls back: asking for CUDA where there is none raises, a device type
the port does not run (the JAX package's ``"tpu"``) raises naming the
knob, and the CPU runs only when the caller or the config names it (as
the tests do).
"""

from __future__ import annotations

import logging
from typing import List, Union

import torch

DeviceLike = Union[str, torch.device]


def get_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``: a device or its name, or an
    ``Arguments`` whose ``device_type`` names it (None: ``"cuda"``).
    Raises ``RuntimeError`` when it names CUDA and no card is present,
    ``ValueError`` for any other device type."""
    if device is None:
        device = "cuda"
    elif not isinstance(device, (str, torch.device)):
        kind = getattr(device, "device_type", None) or "cuda"
        if str(kind) not in ("cuda", "cpu"):
            raise ValueError(
                f"device_type {kind!r}: the port runs on 'cuda' or 'cpu'; set "
                "device_args.device_type in the config (or pass device=)"
            )
        dev = get_device(str(kind))
        logging.info("devices: %d x %s", device_count(dev.type),
                     torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu")
        return dev
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' (or set device_args.device_type: cpu) "
                "to run on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"device {str(dev)!r}: the port runs on 'cuda' or 'cpu'")


def device_count(device_type: str = "cuda") -> int:
    """How many devices of ``device_type`` this process sees: the cards
    on ``"cuda"``, one on ``"cpu"``."""
    return torch.cuda.device_count() if str(device_type) == "cuda" else 1


def topology(device_type: str = "cuda") -> List[str]:
    """The names of those devices (``"cuda:0"``, ... or ``"cpu"``)."""
    if str(device_type) == "cuda":
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return ["cpu"]
