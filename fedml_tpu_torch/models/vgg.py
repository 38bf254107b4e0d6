"""VGG with GroupNorm (port of ``fedml_tpu/models/vgg.py``).

The torchvision-style layer plans (vgg11/13/16/19) with GroupNorm in
place of BatchNorm and the CIFAR-sized head (global average pool,
Dense 512, Dense out), as in the JAX package. NHWC in, NCHW inside.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import GroupNorm, SameConv2d
from .spec import to_nchw

_PLANS = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg16": (
        64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
        512, 512, 512, "M", 512, 512, 512, "M",
    ),
    "vgg19": (
        64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
        512, 512, 512, 512, "M", 512, 512, 512, 512, "M",
    ),
}


class VGG(nn.Module):
    def __init__(self, plan: Sequence[Union[int, str]], output_dim: int,
                 in_channels: int = 3) -> None:
        super().__init__()
        self.plan = tuple(plan)
        cin, k = in_channels, 0
        for item in self.plan:
            if item != "M":
                self.add_module(f"Conv_{k}", SameConv2d(cin, int(item), 3, bias=False))
                self.add_module(f"GroupNorm_{k}", GroupNorm(int(item)))
                cin, k = int(item), k + 1
        self.Dense_0 = nn.Linear(cin, 512)
        self.Dense_1 = nn.Linear(512, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, k = to_nchw(x), 0
        for item in self.plan:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)  # flax max_pool: VALID padding
            else:
                x = F.relu(getattr(self, f"GroupNorm_{k}")(getattr(self, f"Conv_{k}")(x)))
                k += 1
        x = F.relu(self.Dense_0(x.mean(dim=(2, 3))))
        return self.Dense_1(x)


def vgg(name: str, output_dim: int, in_channels: int = 3) -> VGG:
    if name not in _PLANS:
        raise ValueError(f"unknown vgg variant {name!r}")
    return VGG(_PLANS[name], output_dim, in_channels)
