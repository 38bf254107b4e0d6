"""Server-side aggregation, main-path part (port of ``core/aggregation.py``).

"A set of client models" is one params dict whose tensors carry a
leading client axis ``C`` (``stack_pytrees``), the layout the local
trainer returns; FedAvg is then one weighted sum over that axis on the
device. The exact expansion fold (``exact_weighted_mean``,
``StreamingAccumulator``) that the mesh and streaming paths run is not
ported yet (ROADMAP.md, kernel queue B2).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

Params = Dict[str, torch.Tensor]


def stack_pytrees(trees: Sequence[Params]) -> Params:
    """[params, params, ...] -> params with leading axis C."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def unstack_pytrees(stacked: Params, count: int) -> List[Params]:
    return [{k: v[i] for k, v in stacked.items()} for i in range(count)]


def normalize_weights(
    sample_nums: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Sample counts -> normalized FedAvg weights. ``valid`` ([C] in
    {0,1}) zeroes the weight of padded cohort slots."""
    w = sample_nums.to(torch.float32)
    if valid is not None:
        w = w * valid.to(torch.float32)
    return w / torch.clamp(w.sum(), min=1.0)


def weighted_average(stacked: Params, weights: torch.Tensor) -> Params:
    """FedAvg: sum_c w_c * theta_c; ``weights`` already normalized."""

    def avg(leaf: torch.Tensor) -> torch.Tensor:
        w = weights.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)
        return (w * leaf).sum(dim=0)

    return {k: avg(v) for k, v in stacked.items()}
