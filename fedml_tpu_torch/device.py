"""Device resolution (port of ``fedml_tpu/device.py``).

Every entry point of the port takes ``device=`` and defaults to
``"cuda"``. Nothing here falls back: asking for CUDA where there is
none raises, and the CPU runs only when the caller names it (as the
tests do).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def get_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` when it
    names CUDA and no card is present, ``ValueError`` for any other
    device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"device {str(dev)!r}: the port runs on 'cuda' or 'cpu'")

