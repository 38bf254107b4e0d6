"""ResNets with GroupNorm (port of ``fedml_tpu/models/resnet.py``).

``resnet18_gn`` (ResNet-18 + GroupNorm, the fed_cifar100 model of
"Adaptive Federated Optimization") and ``resnet56`` (the CIFAR
ResNet-56, GroupNorm in place of BatchNorm as in the JAX package, so
every parameter is a true parameter and aggregation has no running
statistics to skip).

Inputs arrive NHWC, as the packed federation stores them; the network
permutes once to NCHW and stays there. Two flax semantics are kept
exactly, because the same weights must compute the same function:

- ``Conv(padding="SAME")``: flax pads ``total = max((ceil(n/s) - 1) * s
  + k - n, 0)`` per spatial axis, ``total // 2`` before and the rest
  after. At 3x3 stride 2 on an even size that is (0, 1), which
  ``nn.Conv2d(padding=1)`` shifts by one pixel; ``SameConv2d`` pads
  explicitly where the two sides differ (``same_pads``).
- ``GroupNorm``: ``min(32, C)`` groups, epsilon 1e-6 (torch's default
  is 1e-5), statistics accumulated in at least f32 and the output in the
  input's dtype (bf16 under mixed precision). ``F.group_norm`` computes
  them so: its variance is two-pass where flax's is ``E[x^2] - E[x]^2``
  clipped at 0; the two agree to rounding, and neither is negative.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .spec import to_nchw


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA ``SAME`` padding of one spatial axis of size ``n`` for a
    kernel ``k`` at stride ``s``: (before, after)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's ``SAME`` padding, on NCHW input."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = True) -> None:
        super().__init__(cin, cout, kernel, stride=stride, padding=0, groups=groups,
                         bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = (
            same_pads(n, k, s)
            for n, k, s in zip(x.shape[-2:], self.kernel_size, self.stride)
        )
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, self.bias, self.stride, (top, left), 1,
                            self.groups)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, 1, self.groups)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` on NCHW input, ``min(32, C)`` groups unless
    ``num_groups`` says otherwise."""

    def __init__(self, channels: int, num_groups: Optional[int] = None,
                 eps: float = 1e-6) -> None:
        super().__init__()
        self.num_groups = num_groups or min(32, channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.num_groups, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, channels: int, stride: int = 1) -> None:
        super().__init__()
        self.Conv_0 = SameConv2d(cin, channels, 3, stride, bias=False)
        self.GroupNorm_0 = GroupNorm(channels)
        self.Conv_1 = SameConv2d(channels, channels, 3, bias=False)
        self.GroupNorm_1 = GroupNorm(channels)
        # flax adds the projection when the residual's shape differs
        self.shortcut = stride != 1 or cin != channels
        if self.shortcut:
            self.Conv_2 = SameConv2d(cin, channels, 1, stride, bias=False)
            self.GroupNorm_2 = GroupNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        residual = self.GroupNorm_2(self.Conv_2(x)) if self.shortcut else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Stage-configurable GN ResNet: stem conv -> GN -> ReLU (-> max
    pool), ``stage_sizes[i]`` basic blocks of ``stage_channels[i]``
    channels each (the first block of every stage after the first at
    stride 2), global average pool, dense head."""

    def __init__(self, stage_sizes: Sequence[int], stage_channels: Sequence[int],
                 output_dim: int, in_channels: int = 3, stem_kernel: int = 3,
                 stem_pool: bool = False) -> None:
        super().__init__()
        ch0 = stage_channels[0]
        self.stem_pool = stem_pool
        self.Conv_0 = SameConv2d(in_channels, ch0, stem_kernel, 2 if stem_pool else 1,
                                 bias=False)
        self.GroupNorm_0 = GroupNorm(ch0)
        cin, k = ch0, 0
        for i, (size, ch) in enumerate(zip(stage_sizes, stage_channels)):
            for j in range(size):
                self.add_module(f"BasicBlock_{k}",
                                BasicBlock(cin, ch, 2 if (i > 0 and j == 0) else 1))
                cin, k = ch, k + 1
        self.num_blocks = k
        self.Dense_0 = nn.Linear(cin, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.GroupNorm_0(self.Conv_0(to_nchw(x))))
        if self.stem_pool:
            # flax max_pool(3x3, stride 2, SAME): pads with -inf
            (top, bottom), (left, right) = (same_pads(n, 3, 2) for n in x.shape[-2:])
            x = F.max_pool2d(F.pad(x, (left, right, top, bottom), value=-math.inf), 3, 2)
        for k in range(self.num_blocks):
            x = getattr(self, f"BasicBlock_{k}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))  # global average pool


def resnet18_gn(output_dim: int, in_channels: int = 3) -> ResNet:
    """ResNet-18 + GN (resnet_gn.py; the fed_cifar100 benchmark model)."""
    return ResNet((2, 2, 2, 2), (64, 128, 256, 512), output_dim, in_channels)


def resnet56(output_dim: int, in_channels: int = 3) -> ResNet:
    """ResNet-56, CIFAR variant: 3 stages x 9 basic blocks, 16/32/64
    channels."""
    return ResNet((9, 9, 9), (16, 32, 64), output_dim, in_channels)
