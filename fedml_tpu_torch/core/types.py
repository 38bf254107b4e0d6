"""Device-side data containers (port of ``fedml_tpu/core/types.py``).

A client's dataset is packed once into ``[num_batches, batch_size, ...]``
tensors with a validity mask; a federation of clients adds a leading
client axis ``C``. The same container describes one client, a cohort
of clients, or the whole federation: only the leading axes differ.

Layout convention:
  - ``mask``: [..., nb, bs] in {0, 1}
  - ``x``:    [..., nb, bs, *feature_dims]
  - ``y``:    [..., nb, bs, *label_dims]  (label_dims empty for class ids)
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Batches:
    x: torch.Tensor
    y: torch.Tensor
    mask: torch.Tensor

    @property
    def num_batches(self) -> int:
        return self.mask.shape[-2]

    @property
    def batch_size(self) -> int:
        return self.mask.shape[-1]

    def num_samples(self) -> torch.Tensor:
        return self.mask.sum(dim=(-1, -2))


def flat_examples(b: Batches) -> Batches:
    """Collapse the [nb, bs] batch axes into one [nb*bs] example axis
    (used for per-epoch reshuffling and full-batch eval)."""
    lead = tuple(b.mask.shape[:-2])
    n = b.num_batches * b.batch_size

    def rs(a: torch.Tensor) -> torch.Tensor:
        return a.reshape(lead + (n,) + tuple(a.shape[len(lead) + 2:]))

    return Batches(x=rs(b.x), y=rs(b.y), mask=rs(b.mask))


def rebatch(b: Batches, num_batches: int, batch_size: int) -> Batches:
    """Inverse of ``flat_examples``."""
    lead = tuple(b.mask.shape[:-1])

    def rs(a: torch.Tensor) -> torch.Tensor:
        feat = tuple(a.shape[len(lead) + 1:])
        return a.reshape(lead + (num_batches, batch_size) + feat)

    return Batches(x=rs(b.x), y=rs(b.y), mask=rs(b.mask))
