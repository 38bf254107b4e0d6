"""Attention over the sequence axis (port of ``fedml_tpu/parallel/sequence.py``).

So far only ``full_attention``: dense attention, the ``attention="full"``
path of the model and the oracle the tests hold the flash kernel
against. Ring attention and Ulysses (mesh-sharded over
``torch.distributed``) come with a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def full_attention(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Reference dense attention (the oracle). [B, T, H, D] layout."""
    scale = scale or (q.shape[-1] ** -0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril(tk - tq)
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
