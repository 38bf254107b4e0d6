"""Sequence / context parallelism (port of ``fedml_tpu/parallel/sequence.py``).

Attention over a sequence whose token axis is split contiguously over the
ranks of an ``sp`` process group (rank i holds positions [i*T/n,
(i+1)*T/n)), each rank calling with its own [B, T/n, H, D] shard:

- **Ring attention** (:func:`ring_attention`): queries stay put; K/V
  shards travel the ring (``collectives.ring_shift``) while an online
  softmax (running max ``m``, normalizer ``l``, accumulator ``o``, all
  f32) folds in each block, ``block_k`` keys at a time. It is the JAX
  package's fold, step for step; autograd differentiates it as written,
  the shifts' backward sending the K/V gradients back to their owners.
- **Ulysses** (:func:`ulysses_attention`): an all-to-all re-shards
  [B, T/n, H, D] to [B, T, H/n, D], the port's flash kernel (or dense
  attention where the shape does not tile, or the call is not causal)
  attends over the whole sequence for a head group, and the inverse
  all-to-all shards it back.

``full_attention`` is the dense oracle both are held to, and the
``attention="full"`` path of the model.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist

from .collectives import all_to_all, ring_shift

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


def ring_attention(q, k, v, group, causal: bool = True, scale: Optional[float] = None,
                   block_k: Optional[int] = None):
    """Blockwise ring attention over ``group``: per-rank [B, T/n, H, D]
    shards, the sequence split contiguously in rank order. The scores and
    the online-softmax state are f32 whatever the inputs' dtype (l sums T
    terms); the inputs are cast to f32 before each product, which makes
    the products exact for bf16, as the JAX fold's
    ``preferred_element_type=float32``. ``block_k`` chunks each hop's K/V
    shard (the same fold, more steps); None folds the whole shard."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = scale or (D**-0.5)
    bk = int(block_k) if block_k else Tk
    if bk <= 0 or Tk % bk:
        raise ValueError(
            f"ring block_k={bk} must be a positive divisor of the K/V shard length {Tk}"
        )
    q_pos = me * Tq + torch.arange(Tq, device=q.device)  # global query positions
    qf = q.to(torch.float32)

    def fold(o, m, l, kc, vc, k_pos):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kc.to(torch.float32)) * scale
        if causal:
            s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        correction = torch.exp(m - m_new)  # the running state to the new max
        p = torch.exp(s - m_new[..., None])
        l_new = l * correction + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, vc.to(torch.float32))
        return o * correction.transpose(1, 2)[..., None] + pv, m_new, l_new

    o = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Tq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for i in range(n):
        base = ((me - i) % n) * Tk  # the owner of the block held now
        for j in range(Tk // bk):
            k_pos = base + j * bk + torch.arange(bk, device=q.device)
            o, m, l = fold(o, m, l, k_cur[:, j * bk:(j + 1) * bk],
                           v_cur[:, j * bk:(j + 1) * bk], k_pos)
        if i + 1 < n:  # rotate K/V one hop (the last block needs no send)
            k_cur, v_cur = ring_shift(k_cur, group), ring_shift(v_cur, group)
    l_t = l.transpose(1, 2)[..., None]  # [B, Tq, H, 1]
    return (o / l_t.clamp_min(1e-30)).to(q.dtype)


def _blockwise_or_full(q, k, v, causal: bool, scale: Optional[float]):
    """Attention over the gathered sequence: the flash kernel when the
    shape tiles and the call is causal, dense attention otherwise (the
    JAX package's rule)."""
    from ..ops.flash_attention import flash_attention, pick_block

    b = pick_block(q.shape[1], minimum=8)
    if b is None or not causal:
        return full_attention(q, k, v, causal=causal, scale=scale)
    return flash_attention(q, k, v, causal, scale, b, b)


def ulysses_attention(q, k, v, group, causal: bool = True, scale: Optional[float] = None):
    """DeepSpeed-Ulysses sequence parallelism over ``group``: re-shard
    sequence -> heads, attend over the full sequence for a head group,
    re-shard back. Needs H % n == 0. Per-rank input [B, T/n, H, D]."""
    n = dist.get_world_size(group)
    if q.shape[2] % n:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) divisible by the sp axis "
            f"size ({n}); use ring attention otherwise"
        )
    # [B, T/n, H, D] -> [B, T, H/n, D]: heads scattered, time gathered
    qg, kg, vg = (all_to_all(x, 2, 1, group) for x in (q, k, v))
    og = _blockwise_or_full(qg, kg, vg, causal=causal, scale=scale)
    return all_to_all(og, 1, 2, group)


def make_sequence_sharded_attention(group, strategy: str = "ring", causal: bool = True,
                                    ring_block_k: Optional[int] = None):
    """``(q, k, v) -> o`` over this rank's [B, T/n, H, D] shard, the
    sequence split over ``group``: the model's ``attn_fn`` in the
    sequence mode. Refuses an unknown strategy and a ring block for
    Ulysses, as the JAX package does."""
    strategies = {"ring": ring_attention, "ulysses": ulysses_attention}
    if strategy not in strategies:
        raise ValueError(f"sp_strategy {strategy!r}: pick one of {sorted(strategies)}")
    inner = functools.partial(strategies[strategy], group=group, causal=causal)
    if ring_block_k:
        if strategy != "ring":
            # the user tuned a memory cap that this strategy would not honor
            raise ValueError(
                f"sp_ring_block={ring_block_k} only applies to "
                f"sp_strategy 'ring', not {strategy!r}"
            )
        inner = functools.partial(inner, block_k=ring_block_k)
    return inner
