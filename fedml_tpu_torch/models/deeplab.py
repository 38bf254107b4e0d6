"""Compact DeepLab-style segmentation net (port of ``fedml_tpu/models/deeplab.py``).

FedSeg's model: GroupNorm everywhere, an encoder to stride 4, an ASPP
block of parallel dilated convolutions plus image-level pooling, and a
bilinear-upsampling decoder that fuses the stride-2 features. Input
``[B, H, W, C]`` (NHWC, as the packed federation stores it) -> logits
``[B, H, W, classes]``, as the JAX package returns them and as
``core.losses.pixel_cross_entropy`` reads them.

Two flax semantics are kept so that the same weights compute the same
function: the stride-2 3x3 convolutions pad as flax ``SAME`` does
(``resnet.SameConv2d``: (0, 1) on an even size), and
``jax.image.resize(..., "bilinear")`` upsampling is
``F.interpolate(mode="bilinear", align_corners=False)``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import GroupNorm, SameConv2d
from .spec import to_nchw


class _ConvGN(nn.Module):
    """conv (no bias) -> GroupNorm -> ReLU. Stride 1 pads ``SAME``
    symmetrically (``dilation * (k - 1) / 2`` a side); stride 2 pads as
    flax does."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1) -> None:
        super().__init__()
        if stride == 1:
            self.Conv_0 = nn.Conv2d(cin, features, kernel, padding=dilation * (kernel - 1) // 2,
                                    dilation=dilation, bias=False)
        else:
            if dilation != 1:
                raise ValueError("a strided _ConvGN is not dilated")
            self.Conv_0 = SameConv2d(cin, features, kernel, stride, bias=False)
        self.GroupNorm_0 = GroupNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.GroupNorm_0(self.Conv_0(x)))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 branch, one dilated 3x3
    branch per rate and the image-level mean, concatenated and
    projected."""

    def __init__(self, cin: int, features: int = 64, rates: Sequence[int] = (1, 2, 4)) -> None:
        super().__init__()
        self.add_module("_ConvGN_0", _ConvGN(cin, features, 1))
        for i, r in enumerate(rates):
            self.add_module(f"_ConvGN_{i + 1}", _ConvGN(cin, features, 3, dilation=r))
        self.branches = len(rates) + 1
        self.add_module(f"_ConvGN_{self.branches}", _ConvGN(cin, features, 1))
        self.add_module(f"_ConvGN_{self.branches + 1}",
                        _ConvGN((self.branches + 1) * features, features, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [getattr(self, f"_ConvGN_{i}")(x) for i in range(self.branches)]
        pooled = getattr(self, f"_ConvGN_{self.branches}")(x.mean(dim=(2, 3), keepdim=True))
        outs.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        return getattr(self, f"_ConvGN_{self.branches + 1}")(torch.cat(outs, dim=1))


class DeepLabLite(nn.Module):
    """Encoder (stride 4) -> ASPP -> upsampled pixel classifier."""

    def __init__(self, num_classes: int, width: int = 32, in_channels: int = 3) -> None:
        super().__init__()
        w = width
        self.add_module("_ConvGN_0", _ConvGN(in_channels, w, 3, stride=2))
        self.add_module("_ConvGN_1", _ConvGN(w, 2 * w, 3, stride=2))
        self.add_module("_ConvGN_2", _ConvGN(2 * w, 2 * w, 3))
        self.ASPP_0 = ASPP(2 * w, features=2 * w)
        self.add_module("_ConvGN_3", _ConvGN(w, w, 1))
        self.add_module("_ConvGN_4", _ConvGN(3 * w, 2 * w, 3))
        self.Conv_0 = nn.Conv2d(2 * w, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_nchw(x)
        h, w = x.shape[2], x.shape[3]
        low = getattr(self, "_ConvGN_0")(x)  # /2
        x = getattr(self, "_ConvGN_2")(getattr(self, "_ConvGN_1")(low))  # /4
        x = self.ASPP_0(x)
        x = F.interpolate(x, size=(h // 2, w // 2), mode="bilinear", align_corners=False)
        x = torch.cat([x, getattr(self, "_ConvGN_3")(low)], dim=1)
        logits = self.Conv_0(getattr(self, "_ConvGN_4")(x))
        logits = F.interpolate(logits, size=(h, w), mode="bilinear", align_corners=False)
        return logits.permute(0, 2, 3, 1)
