"""MobileNet v1/v3 with GroupNorm (port of ``fedml_tpu/models/mobilenet.py``).

GroupNorm everywhere (the largest group count <= 32 that divides the
channels, since MobileNet widths such as 40, 88 or 576 are not powers of
two), depthwise convolutions as ``groups = channels``, CIFAR-sized
stems (stride-1 3x3). Hard-swish, the hard-sigmoid of squeeze-excite
and their order of operations are flax's, so the same weights compute
the same function. NHWC in, NCHW inside.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import GroupNorm, SameConv2d
from .spec import to_nchw


def gn(channels: int) -> GroupNorm:
    """GroupNorm over the largest group count <= 32 dividing ``channels``."""
    g = next(g for g in range(min(32, channels), 0, -1) if channels % g == 0)
    return GroupNorm(channels, num_groups=g)


def hardswish(x: torch.Tensor) -> torch.Tensor:
    return x * F.relu6(x + 3.0) / 6.0


class DepthwiseSeparable(nn.Module):
    """dw 3x3 + pw 1x1 (the reference's conv_dw block)."""

    def __init__(self, cin: int, channels: int, stride: int = 1) -> None:
        super().__init__()
        self.Conv_0 = SameConv2d(cin, cin, 3, stride, groups=cin, bias=False)
        self.GroupNorm_0 = gn(cin)
        self.Conv_1 = SameConv2d(cin, channels, 1, bias=False)
        self.GroupNorm_1 = gn(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        return F.relu(self.GroupNorm_1(self.Conv_1(x)))


class MobileNetV1(nn.Module):
    """MobileNetV1, CIFAR-sized stem (stride-1 3x3)."""

    _PLAN: Sequence[Tuple[int, int]] = (
        (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
        *(((512, 1),) * 5), (1024, 2), (1024, 1),
    )

    def __init__(self, output_dim: int, width: float = 1.0, in_channels: int = 3) -> None:
        super().__init__()

        def c(ch: int) -> int:
            return max(8, int(ch * width))

        self.Conv_0 = SameConv2d(in_channels, c(32), 3, bias=False)
        self.GroupNorm_0 = gn(c(32))
        cin = c(32)
        for i, (ch, s) in enumerate(self._PLAN):
            self.add_module(f"DepthwiseSeparable_{i}", DepthwiseSeparable(cin, c(ch), s))
            cin = c(ch)
        self.Dense_0 = nn.Linear(cin, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.GroupNorm_0(self.Conv_0(to_nchw(x))))
        for i in range(len(self._PLAN)):
            x = getattr(self, f"DepthwiseSeparable_{i}")(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


class SqueezeExcite(nn.Module):
    """Global pool -> Dense (ReLU) -> Dense -> hard-sigmoid gate."""

    def __init__(self, channels: int, reduce: int = 4) -> None:
        super().__init__()
        mid = max(8, channels // reduce)
        self.Dense_0 = nn.Linear(channels, mid)
        self.Dense_1 = nn.Linear(mid, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.Dense_0(x.mean(dim=(2, 3))))
        s = F.relu6(self.Dense_1(s) + 3.0) / 6.0
        return x * s[:, :, None, None]


class MBConvV3(nn.Module):
    """MobileNetV3 bottleneck: expand pw -> dw -> SE -> project pw."""

    def __init__(self, cin: int, channels: int, expand: int, kernel: int = 3,
                 stride: int = 1, use_se: bool = False, use_hs: bool = False) -> None:
        super().__init__()
        self.act = hardswish if use_hs else F.relu
        self.Conv_0 = SameConv2d(cin, expand, 1, bias=False)
        self.GroupNorm_0 = gn(expand)
        self.Conv_1 = SameConv2d(expand, expand, kernel, stride, groups=expand, bias=False)
        self.GroupNorm_1 = gn(expand)
        self.SqueezeExcite_0 = SqueezeExcite(expand) if use_se else None
        self.Conv_2 = SameConv2d(expand, channels, 1, bias=False)
        self.GroupNorm_2 = gn(channels)
        self.residual = stride == 1 and cin == channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.GroupNorm_0(self.Conv_0(x)))
        y = self.act(self.GroupNorm_1(self.Conv_1(y)))
        if self.SqueezeExcite_0 is not None:
            y = self.SqueezeExcite_0(y)
        y = self.GroupNorm_2(self.Conv_2(y))
        return y + x if self.residual else y


class MobileNetV3Small(nn.Module):
    """MobileNetV3-small body, CIFAR-sized stem."""

    # (channels, expand, kernel, stride, se, hs)
    _PLAN = (
        (16, 16, 3, 2, True, False),
        (24, 72, 3, 2, False, False),
        (24, 88, 3, 1, False, False),
        (40, 96, 5, 2, True, True),
        (40, 240, 5, 1, True, True),
        (40, 240, 5, 1, True, True),
        (48, 120, 5, 1, True, True),
        (48, 144, 5, 1, True, True),
        (96, 288, 5, 2, True, True),
        (96, 576, 5, 1, True, True),
        (96, 576, 5, 1, True, True),
    )

    def __init__(self, output_dim: int, in_channels: int = 3) -> None:
        super().__init__()
        self.Conv_0 = SameConv2d(in_channels, 16, 3, bias=False)
        self.GroupNorm_0 = gn(16)
        cin = 16
        for i, (ch, ex, k, s, se, hs) in enumerate(self._PLAN):
            self.add_module(f"MBConvV3_{i}", MBConvV3(cin, ch, ex, k, s, se, hs))
            cin = ch
        self.Conv_1 = SameConv2d(cin, 576, 1, bias=False)
        self.GroupNorm_1 = gn(576)
        self.Dense_0 = nn.Linear(576, 1024)
        self.Dense_1 = nn.Linear(1024, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = hardswish(self.GroupNorm_0(self.Conv_0(to_nchw(x))))
        for i in range(len(self._PLAN)):
            x = getattr(self, f"MBConvV3_{i}")(x)
        x = hardswish(self.GroupNorm_1(self.Conv_1(x)))
        x = hardswish(self.Dense_0(x.mean(dim=(2, 3))))
        return self.Dense_1(x)
