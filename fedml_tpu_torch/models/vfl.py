"""Vertical-FL party models (port of ``fedml_tpu/models/vfl.py``).

Each party's bottom net over its private feature slice, and the
guest's top model over the summed party representations
(``classical_vertical_fl``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class PartyLocalModel(nn.Module):
    """One party's bottom net: Dense -> ReLU per hidden width, then a
    Dense to the representation."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int] = (32,),
                 output_dim: int = 10) -> None:
        super().__init__()
        self.depth = len(hidden_dims)
        dims = [in_dim, *hidden_dims]
        for i in range(self.depth):
            self.add_module(f"Dense_{i}", nn.Linear(dims[i], dims[i + 1]))
        self.add_module(f"Dense_{self.depth}", nn.Linear(dims[-1], output_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not x.is_floating_point():
            x = x.to(torch.float32)
        for i in range(self.depth):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.depth}")(x)


class GuestTopModel(nn.Module):
    """The guest's top model over the summed party representations."""

    def __init__(self, rep_dim: int, output_dim: int = 1) -> None:
        super().__init__()
        self.Dense_0 = nn.Linear(rep_dim, output_dim)

    def forward(self, rep: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(rep)
