"""MNIST GAN pair (port of ``fedml_tpu/models/gan.py``).

FedGAN's DCGAN-shaped generator and discriminator, GroupNorm in place of
BatchNorm so that both nets are plain parameters FedAvg can average.
NHWC in and out, as in the JAX package. Two flax layouts are kept so
that the same weights compute the same function:

- flax ``ConvTranspose`` (``transpose_kernel=False``, ``SAME``, 4x4
  stride 2) is ``F.conv_transpose2d(stride=2, padding=1)`` with the
  kernel flipped in space: ``FlaxConvTranspose2d`` holds it already
  flipped, ``[in, out, kh, kw]`` (``convert.params_from_flax`` flips
  and lays it out);
- the discriminator's 4x4 stride-2 convolutions pad as flax ``SAME``
  does (``resnet.SameConv2d``): (1, 2) on the 7x7 map, where
  ``padding=1`` would give 3x3.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import GroupNorm, SameConv2d
from .spec import to_nchw


class FlaxConvTranspose2d(nn.ConvTranspose2d):
    """flax ``ConvTranspose(features, (k, k), strides=(2, 2))`` with
    ``SAME`` padding on NCHW input: the output is exactly ``2x`` the
    input (``padding = (k - 2) / 2``, k even)."""

    def __init__(self, cin: int, cout: int, kernel: int = 4) -> None:
        super().__init__(cin, cout, kernel, stride=2, padding=(kernel - 2) // 2)


class Generator(nn.Module):
    """z ``[B, latent_dim]`` -> images ``[B, 28, 28, 1]`` in tanh range."""

    def __init__(self, latent_dim: int = 64) -> None:
        super().__init__()
        self.Dense_0 = nn.Linear(latent_dim, 7 * 7 * 128)
        self.GroupNorm_0 = GroupNorm(128, 32)
        self.ConvTranspose_0 = FlaxConvTranspose2d(128, 64)  # 14x14
        self.GroupNorm_1 = GroupNorm(64, 32)
        self.ConvTranspose_1 = FlaxConvTranspose2d(64, 32)  # 28x28
        self.GroupNorm_2 = GroupNorm(32, 16)
        self.Conv_0 = nn.Conv2d(32, 1, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        # flax's Dense output is laid out (h, w, c)
        x = self.Dense_0(z).reshape(z.shape[0], 7, 7, 128).permute(0, 3, 1, 2)
        x = F.relu(self.GroupNorm_0(x))
        x = F.relu(self.GroupNorm_1(self.ConvTranspose_0(x)))
        x = F.relu(self.GroupNorm_2(self.ConvTranspose_1(x)))
        return torch.tanh(self.Conv_0(x)).permute(0, 2, 3, 1)


class Discriminator(nn.Module):
    """images ``[B, 28, 28, 1]`` -> real/fake logits ``[B]``."""

    def __init__(self, in_channels: int = 1) -> None:
        super().__init__()
        self.Conv_0 = SameConv2d(in_channels, 32, 4, 2)  # 14x14
        self.Conv_1 = SameConv2d(32, 64, 4, 2)  # 7x7
        self.GroupNorm_0 = GroupNorm(64, 32)
        self.Conv_2 = SameConv2d(64, 128, 4, 2)  # 4x4
        self.GroupNorm_1 = GroupNorm(128, 32)
        self.Dense_0 = nn.Linear(4 * 4 * 128, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_nchw(x)
        x = F.leaky_relu(self.Conv_0(x), 0.2)
        x = F.leaky_relu(self.GroupNorm_0(self.Conv_1(x)), 0.2)
        x = F.leaky_relu(self.GroupNorm_1(self.Conv_2(x)), 0.2)
        # flattened in flax's NHWC order
        return self.Dense_0(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))[..., 0]
