"""FedAvg CNNs (port of ``fedml_tpu/models/cnn.py``).

Both take NHWC images, as the JAX package's do and as the packed
federation stores them, and permute to NCHW once for the convolutions.
flax's ``Conv`` with ``SAME`` padding at 3x3 stride 1 is ``padding=1``.
Before the first dense layer the activations are permuted back to NHWC
and flattened in that order, so that flax's ``Dense_0`` kernel carries
across with a plain transpose. No dropout, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .spec import to_nchw


def _flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class CNNFedAvg(nn.Module):
    """2-conv CNN for 28x28 grayscale (MNIST/FEMNIST):
    conv3x3(32) -> maxpool -> conv3x3(64) -> maxpool -> fc(hidden) -> out."""

    def __init__(self, output_dim: int = 62, hidden: int = 128) -> None:
        super().__init__()
        self.Conv_0 = nn.Conv2d(1, 32, 3, padding=1)
        self.Conv_1 = nn.Conv2d(32, 64, 3, padding=1)
        self.Dense_0 = nn.Linear(7 * 7 * 64, hidden)
        self.Dense_1 = nn.Linear(hidden, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_nchw(x)
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2)
        x = F.relu(self.Dense_0(_flatten_nhwc(x)))
        return self.Dense_1(x)


class CNNCifar(nn.Module):
    """Small CIFAR CNN: three conv3x3 + maxpool blocks (32, 64, 64) ->
    fc64 -> out, for ``image_size``-square RGB images."""

    def __init__(self, output_dim: int = 10, image_size: int = 32) -> None:
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 32, 3, padding=1)
        self.Conv_1 = nn.Conv2d(32, 64, 3, padding=1)
        self.Conv_2 = nn.Conv2d(64, 64, 3, padding=1)
        side = image_size // 8
        self.Dense_0 = nn.Linear(side * side * 64, 64)
        self.Dense_1 = nn.Linear(64, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_nchw(x)
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            x = F.max_pool2d(F.relu(conv(x)), 2)
        x = F.relu(self.Dense_0(_flatten_nhwc(x)))
        return self.Dense_1(x)
