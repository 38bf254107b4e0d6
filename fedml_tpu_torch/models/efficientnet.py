"""EfficientNet (lite-style) with GroupNorm (port of
``fedml_tpu/models/efficientnet.py``).

The compound-scaled MBConv plan of EfficientNet-B0..B4 with GroupNorm,
swish, squeeze-excite (the MobileNet module's, reduction 4 x expand)
and no drop-connect, CIFAR-sized stem (stride 1), as in the JAX
package. A block without expansion has no expand convolution, so its
layers number from ``Conv_0`` = the depthwise one, as flax names them.
NHWC in, NCHW inside.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .mobilenet import SqueezeExcite, gn
from .resnet import SameConv2d
from .spec import to_nchw

# (expand_ratio, channels, repeats, strides, kernel)
_BASE_PLAN: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# (width_mult, depth_mult) per variant
_SCALING = {
    "efficientnet-b0": (1.0, 1.0),
    "efficientnet-b1": (1.0, 1.1),
    "efficientnet-b2": (1.1, 1.2),
    "efficientnet-b3": (1.2, 1.4),
    "efficientnet-b4": (1.4, 1.8),
}


def _round_channels(ch: float, divisor: int = 8) -> int:
    out = max(divisor, int(ch + divisor / 2) // divisor * divisor)
    if out < 0.9 * ch:
        out += divisor
    return out


class MBConv(nn.Module):
    def __init__(self, cin: int, channels: int, expand_ratio: int, kernel: int = 3,
                 stride: int = 1) -> None:
        super().__init__()
        mid = cin * expand_ratio
        self.expand = expand_ratio != 1
        k = 0
        if self.expand:
            self.add_module("Conv_0", SameConv2d(cin, mid, 1, bias=False))
            self.add_module("GroupNorm_0", gn(mid))
            k = 1
        self.add_module(f"Conv_{k}", SameConv2d(mid, mid, kernel, stride, groups=mid,
                                                bias=False))
        self.add_module(f"GroupNorm_{k}", gn(mid))
        self.SqueezeExcite_0 = SqueezeExcite(mid, reduce=4 * expand_ratio)
        self.add_module(f"Conv_{k + 1}", SameConv2d(mid, channels, 1, bias=False))
        self.add_module(f"GroupNorm_{k + 1}", gn(channels))
        self.residual = stride == 1 and cin == channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, k = x, 0
        if self.expand:
            y, k = F.silu(self.GroupNorm_0(self.Conv_0(y))), 1
        y = F.silu(getattr(self, f"GroupNorm_{k}")(getattr(self, f"Conv_{k}")(y)))
        y = self.SqueezeExcite_0(y)
        y = getattr(self, f"GroupNorm_{k + 1}")(getattr(self, f"Conv_{k + 1}")(y))
        return y + x if self.residual else y


class EfficientNet(nn.Module):
    def __init__(self, output_dim: int, width_mult: float = 1.0, depth_mult: float = 1.0,
                 in_channels: int = 3) -> None:
        super().__init__()
        stem = _round_channels(32 * width_mult)
        self.Conv_0 = SameConv2d(in_channels, stem, 3, bias=False)
        self.GroupNorm_0 = gn(stem)
        cin, n = stem, 0
        for expand, ch, repeats, strides, kernel in _BASE_PLAN:
            ch = _round_channels(ch * width_mult)
            for i in range(int(math.ceil(repeats * depth_mult))):
                self.add_module(f"MBConv_{n}",
                                MBConv(cin, ch, expand, kernel, strides if i == 0 else 1))
                cin, n = ch, n + 1
        self.num_blocks = n
        head = _round_channels(1280 * width_mult)
        self.Conv_1 = SameConv2d(cin, head, 1, bias=False)
        self.GroupNorm_1 = gn(head)
        self.Dense_0 = nn.Linear(head, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.GroupNorm_0(self.Conv_0(to_nchw(x))))
        for n in range(self.num_blocks):
            x = getattr(self, f"MBConv_{n}")(x)
        x = F.silu(self.GroupNorm_1(self.Conv_1(x)))
        return self.Dense_0(x.mean(dim=(2, 3)))


def efficientnet(name: str, output_dim: int, in_channels: int = 3) -> EfficientNet:
    if name not in _SCALING:
        raise ValueError(f"unknown efficientnet variant {name!r}")
    w, d = _SCALING[name]
    return EfficientNet(output_dim, w, d, in_channels)
