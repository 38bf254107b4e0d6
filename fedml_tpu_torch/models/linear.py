"""Linear models (port of ``fedml_tpu/models/linear.py``).

Layer names follow the flax modules (``Dense_0``, ``Dense_1``), so
``convert.params_from_flax`` carries their weights across by name.
PyTorch needs the input width up front, where flax infers it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _flat_float(x: torch.Tensor) -> torch.Tensor:
    """Flatten the trailing feature dims; promote integer inputs to f32
    and leave float inputs (f32 or bf16) alone."""
    x = x.reshape(x.shape[0], -1)
    return x if x.is_floating_point() else x.float()


class LogisticRegression(nn.Module):
    """One dense layer on the flattened features; the softmax lives in
    the loss."""

    def __init__(self, input_dim: int, output_dim: int) -> None:
        super().__init__()
        self.Dense_0 = nn.Linear(input_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(_flat_float(x))


class MLP(nn.Module):
    """Two-layer perceptron."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int) -> None:
        super().__init__()
        self.Dense_0 = nn.Linear(input_dim, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.relu(self.Dense_0(_flat_float(x))))
