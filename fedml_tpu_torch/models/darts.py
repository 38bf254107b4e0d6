"""DARTS differentiable-NAS search space (port of ``fedml_tpu/models/darts.py``).

FedNAS's searchable network: every edge of a cell computes the
softmax(alpha)-weighted sum of six candidate operations (``MixedEdge``),
and the architecture parameters are one leaf of the same params dict,
``alphas_holder`` ``[edges, primitives]``, so FedAvg averages weights
and alphas alike; the bilevel split (weights vs alphas) masks gradients
by that key (``split_grad_masks``).

flax's pooling semantics are kept: ``avg_pool`` with ``SAME`` padding
counts the padding (``count_include_pad=True``) and ``max_pool`` pads
with -inf; the depthwise convolution of ``sep3`` is ``groups=C``. Only
the operations with parameters are submodules (``_Op_2`` conv3 and
``_Op_3`` sep3, flax's names); the others are computed in place.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import GroupNorm
from .spec import to_nchw

PRIMITIVES = ("none", "skip", "conv3", "sep3", "avg_pool", "max_pool")
ARCH_KEY = "alphas_holder"


def num_edges(steps: int) -> int:
    return sum(1 + i for i in range(steps))


class _Conv3(nn.Module):
    """relu -> 3x3 conv (no bias) -> GroupNorm."""

    def __init__(self, c: int) -> None:
        super().__init__()
        self.Conv_0 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.GroupNorm_0 = GroupNorm(c)

    def forward(self, x):
        return self.GroupNorm_0(self.Conv_0(F.relu(x)))


class _Sep3(nn.Module):
    """relu -> depthwise 3x3 -> pointwise 1x1 (no biases) -> GroupNorm."""

    def __init__(self, c: int) -> None:
        super().__init__()
        self.Conv_0 = nn.Conv2d(c, c, 3, padding=1, groups=c, bias=False)
        self.Conv_1 = nn.Conv2d(c, c, 1, bias=False)
        self.GroupNorm_0 = GroupNorm(c)

    def forward(self, x):
        return self.GroupNorm_0(self.Conv_1(self.Conv_0(F.relu(x))))


class MixedEdge(nn.Module):
    """softmax(alpha)-weighted sum over the candidate operations
    (model_search.py MixedOp), summed in ``PRIMITIVES`` order."""

    def __init__(self, c: int) -> None:
        super().__init__()
        self.add_module("_Op_2", _Conv3(c))
        self.add_module("_Op_3", _Sep3(c))

    def forward(self, x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
        w = torch.softmax(alpha, dim=-1).to(x.dtype)
        outs = (
            torch.zeros_like(x),
            x,
            getattr(self, "_Op_2")(x),
            getattr(self, "_Op_3")(x),
            F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True),
            F.max_pool2d(x, 3, 1, padding=1),
        )
        total = 0
        for i, o in enumerate(outs):
            total = total + w[i] * o
        return total


class Cell(nn.Module):
    """DAG cell: each intermediate node sums mixed edges from all its
    predecessors; the output concatenates the intermediate nodes."""

    def __init__(self, c: int, steps: int = 2) -> None:
        super().__init__()
        self.steps = steps
        for e in range(num_edges(steps)):
            self.add_module(f"MixedEdge_{e}", MixedEdge(c))

    def forward(self, s0: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
        states, edge = [s0], 0
        for _ in range(self.steps):
            cur = 0
            for j, h in enumerate(states):
                cur = cur + getattr(self, f"MixedEdge_{edge + j}")(h, alphas[edge + j])
            edge += len(states)
            states.append(cur)
        return torch.cat(states[1:], dim=1)


class DARTSNetwork(nn.Module):
    """Searchable net: stem -> cells (each projected back to ``width``,
    GroupNorm, ReLU; a 2x2 average pool after the middle one) -> global
    mean -> dense head. The alphas are the root parameter
    ``alphas_holder``."""

    # FedModel.init draws alphas_holder as 1e-3 * N(0, 1), as flax does
    normal_scales = {ARCH_KEY: 1e-3}

    def __init__(self, num_classes: int, width: int = 16, num_cells: int = 2, steps: int = 2,
                 in_channels: int = 3) -> None:
        super().__init__()
        self.num_cells, self.steps = num_cells, steps
        self.alphas_holder = nn.Parameter(torch.zeros(num_edges(steps), len(PRIMITIVES)))
        self.Conv_0 = nn.Conv2d(in_channels, width, 3, padding=1, bias=False)
        self.GroupNorm_0 = GroupNorm(width)
        for i in range(num_cells):
            self.add_module(f"Cell_{i}", Cell(width, steps))
            self.add_module(f"Conv_{i + 1}", nn.Conv2d(steps * width, width, 1, bias=False))
            self.add_module(f"GroupNorm_{i + 1}", GroupNorm(width))
        self.Dense_0 = nn.Linear(width, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.GroupNorm_0(self.Conv_0(to_nchw(x)))
        for i in range(self.num_cells):
            x = getattr(self, f"Cell_{i}")(x, self.alphas_holder)
            x = F.relu(getattr(self, f"GroupNorm_{i + 1}")(getattr(self, f"Conv_{i + 1}")(x)))
            if i == self.num_cells // 2 and self.num_cells > 1:
                x = F.avg_pool2d(x, 2, 2)  # reduction
        return self.Dense_0(x.mean(dim=(2, 3)))


def arch_path(params: Dict[str, torch.Tensor]) -> str:
    """The key of the alphas leaf in a params dict."""
    for key in params:
        if key.rsplit("/", 1)[-1] == ARCH_KEY:
            return key
    raise KeyError(f"{ARCH_KEY} not in params")


def split_grad_masks(params: Dict[str, torch.Tensor]
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(weight_mask, arch_mask): dicts of 0/1 tensors shaped like the
    params, the bilevel split (architect.py keeps separate w and alpha
    optimizers)."""
    target = arch_path(params)
    w_mask = {k: (torch.zeros_like if k == target else torch.ones_like)(v)
              for k, v in params.items()}
    a_mask = {k: (torch.ones_like if k == target else torch.zeros_like)(v)
              for k, v in params.items()}
    return w_mask, a_mask


def genotype(alphas: torch.Tensor, steps: int = 2) -> List[Tuple[int, str]]:
    """The discrete architecture: per edge, the argmax primitive other
    than 'none' (genotypes.py derivation; the first maximum wins)."""
    a = torch.as_tensor(alphas).detach().to("cpu", torch.float64).clone()
    a[:, PRIMITIVES.index("none")] = float("-inf")
    return [(e, PRIMITIVES[int(torch.argmax(a[e]))]) for e in range(num_edges(steps))]
