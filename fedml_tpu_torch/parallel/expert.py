"""Expert parallelism: a routed FFN's expert stacks split over a mesh
``ep`` axis (port of ``fedml_tpu/parallel/expert.py``).

The stacked expert leaves (``wi``, ``bi``, ``wo``, ``bo`` under a
``SwitchFFN``) are split on their leading E dim over ``ep``; every other
leaf follows the Megatron tp rules (``tp_ep_layout``, the composition
``tp_ep_specs`` makes in the JAX package: the expert spec wins where it
is set). Where XLA partitions the dispatch einsums there, the port's
``SwitchFFN`` computes this rank's experts' slots from the tokens every
ep rank holds and all-reduces the partial combines over ep
(``models/moe.py``). An expert count the axis does not divide, or a mesh
without the axis, falls back to replicated, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .tensor import Shard, tp_layout

_EXPERT_LEAVES = {"wi", "bi", "wo", "bo"}


def _spec_for(key: str, axis: str) -> Optional[Shard]:
    names = key.split("/")
    if names[-1] in _EXPERT_LEAVES and any("SwitchFFN" in n for n in names):
        return Shard(axis, 0)
    return None


def ep_specs(params: Dict[str, torch.Tensor], axis: str = "ep") -> Dict[str, Optional[Shard]]:
    """Expert stacks split on E, the rest replicated."""
    return {key: _spec_for(key, axis) for key in params}


def tp_ep_layout(params: Dict[str, torch.Tensor], sizes: Dict[str, int], num_heads: int,
                 tp_axis: str = "tp", ep_axis: str = "ep") -> Dict[str, Optional[Shard]]:
    """The composed tp x ep layout of an (MoE) transformer's params, each
    leaf's fallback applied."""
    tp = tp_layout(params, sizes, num_heads, tp_axis)
    out = {}
    for key, spec in ep_specs(params, ep_axis).items():
        if spec is not None and (ep_axis not in sizes
                                 or params[key].shape[0] % sizes[ep_axis]):
            spec = None
        out[key] = spec if spec is not None else tp[key]
    return out


def attach_ep(module, layout: Dict[str, Optional[Shard]], group, rank: int, size: int) -> None:
    """Give each ``SwitchFFN`` of ``module`` whose stacks ``layout``
    splits its ``ExpertShard``."""
    from ..models.moe import ExpertShard, SwitchFFN

    for name, mod in module.named_modules():
        if isinstance(mod, SwitchFFN):
            key = f"{name.replace('.', '/')}/wi"
            if layout.get(key) is not None:
                count = mod.num_experts // size
                mod.ep = ExpertShard(group, rank * count, count)
            else:
                mod.ep = None
