"""FedGKT / SplitNN model pair (port of ``fedml_tpu/models/gkt.py``).

A small client extractor (stem + one GN basic block + a local head)
and a deep server tail over the client's feature maps, both GroupNorm
ResNets built from ``resnet.BasicBlock``. The client returns
``(features, logits)``; its features stay NCHW, the layout the server
consumes (the JAX package's are NHWC: a test permutes to compare).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import BasicBlock, GroupNorm
from .spec import to_nchw


class GKTClientNet(nn.Module):
    """Stem + ``blocks`` basic blocks; returns (feature map NCHW, local
    logits) (the resnet8_56 client: extractor + classifier head)."""

    def __init__(self, output_dim: int, channels: int = 16, blocks: int = 1,
                 in_channels: int = 3) -> None:
        super().__init__()
        self.blocks = blocks
        self.Conv_0 = nn.Conv2d(in_channels, channels, 3, padding=1, bias=False)
        self.GroupNorm_0 = GroupNorm(channels)
        for b in range(blocks):
            self.add_module(f"BasicBlock_{b}", BasicBlock(channels, channels))
        self.Dense_0 = nn.Linear(channels, output_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.GroupNorm_0(self.Conv_0(to_nchw(x))))
        for b in range(self.blocks):
            x = getattr(self, f"BasicBlock_{b}")(x)
        return x, self.Dense_0(x.mean(dim=(2, 3)))


class GKTServerNet(nn.Module):
    """Deep tail over client feature maps (NCHW): stages of GN basic
    blocks (the first block of each later stage at stride 2), global
    mean, dense head (resnet56_gkt/resnet_server.py)."""

    def __init__(self, output_dim: int, stage_sizes: Sequence[int] = (8, 9, 9),
                 stage_channels: Sequence[int] = (16, 32, 64), in_channels: int = 16) -> None:
        super().__init__()
        cin, k = in_channels, 0
        for i, (size, ch) in enumerate(zip(stage_sizes, stage_channels)):
            for j in range(size):
                self.add_module(f"BasicBlock_{k}",
                                BasicBlock(cin, ch, 2 if (i > 0 and j == 0) else 1))
                cin, k = ch, k + 1
        self.num_blocks = k
        self.Dense_0 = nn.Linear(cin, output_dim)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = features
        for k in range(self.num_blocks):
            x = getattr(self, f"BasicBlock_{k}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))
