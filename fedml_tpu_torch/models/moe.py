"""Mixture-of-Experts transformer, Switch top-1 routing (port of
``fedml_tpu/models/moe.py``).

:class:`SwitchFFN` is the JAX layer's function: an f32 router (its input
cast to f32 and its weight promoted with it, so a float64 model routes in
float64 logits), the softmax in f32, argmax routing, a capacity of
``ceil(N / E * capacity_factor)`` tokens an expert and positions by an f32
cumsum, as the JAX layer computes them. Where the JAX layer then builds
0/1 dispatch and gate-weighted combine tensors ``[N, E, cap]`` and
contracts them by einsum, the port routes by index: token n goes to
expert e_n at slot c_n = pos[n, e_n] if c_n < cap. Its row of x is
scattered into ``[E, cap, C]`` at (e_n, c_n) (slots are unique, so
nothing accumulates), the experts' FFN runs as two batched einsums, and
its output is y[n] = gate_n * out[e_n, c_n], 0 for a dropped token (the
residual carries it). That is the einsums' one nonzero term each, so the
function is the same, and its memory grows with N, not N^2 (the whole
batch's one-hots of the MoE configuration, 32 x 4096 tokens over 8
experts, would hold 21.5 G elements). Every gather and scatter has a
fixed shape (a dropped token goes to a spare row), so the layer runs
under ``torch.func.vmap``.

Two seams on each layer replace the JAX package's ``sow`` and SPMD:

- :func:`collect` (a model's layers, while it is open) records each
  layer's Switch aux loss ``E * sum_e f_e P_e`` and its slot occupancy
  ``[E, cap]`` (a count of the tokens in each slot, which must be 0/1)
  under ``moe_aux_loss`` and ``moe_slot_occupancy``, where the JAX
  package sows them.
- :func:`set_routing_pool` makes a model's routing pool global across
  ranks that hold different tokens of one batch (dp, and sp in the
  sequence mode), as SPMD does over the global token axis: each rank's
  capacity positions are offset by the counts of every token before its
  own in the global order (an all-gather of per-example counts), the
  capacity comes from the global N, and the aux loss's means are global.
  A rank may hold more rows than its ids (the trainer pads a short share
  of an accumulation chunk): the rows past them are padding, routed to no
  expert, taking no capacity and adding nothing to the aux loss.
  Without it the pool is the layer's own tokens.

With ``ep`` set (``parallel/expert.py``), a rank holds ``E / ep`` experts:
it scatters the (ep-replicated) tokens of its experts into its
``[E / ep, cap, C]`` slots, and the partial outputs are all-reduced over
ep.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_gather_list, all_reduce_, copy_to, reduce_from
from .transformer import Block, TransformerLM

def _switch_layers(module: nn.Module) -> List["SwitchFFN"]:
    return [m for m in module.modules() if isinstance(m, SwitchFFN)]


@contextlib.contextmanager
def collect(module: nn.Module):
    """Record the ``moe_aux_loss`` and ``moe_slot_occupancy`` of every
    SwitchFFN in ``module`` (itself one, or a model) while open, in the
    yielded dict of lists, in call order."""
    sink: Dict[str, List[torch.Tensor]] = {"moe_aux_loss": [], "moe_slot_occupancy": []}
    layers = _switch_layers(module)
    for layer in layers:
        layer.sink = sink
    try:
        yield sink
    finally:
        for layer in layers:
            layer.sink = None


@dataclasses.dataclass(frozen=True)
class RoutingPool:
    """Where this rank's tokens sit in the global routing pool.

    ``group`` spans the ranks whose tokens share a pool; ``layout[r]`` is
    group rank r's (example ids in the pool, sequence-shard index): its
    first ``len(ids)`` local examples are the pool's examples ``ids`` (any
    local rows after them are padding), and of each it holds the
    ``sp_index``-th of ``sp_size`` equal shards of the time axis. The
    global token order is (example, time)."""

    group: object
    layout: Sequence[tuple]
    examples: int
    sp_size: int = 1


def set_routing_pool(module: nn.Module, pool: Optional[RoutingPool]) -> None:
    """Every SwitchFFN of ``module`` routes over ``pool`` (None: its own
    tokens)."""
    for layer in _switch_layers(module):
        layer.pool = pool


@dataclasses.dataclass(frozen=True)
class ExpertShard:
    """This rank holds experts [start, start + count) of ``group``'s
    split (``parallel.expert.attach_ep``)."""

    group: object
    start: int
    count: int


def _onehot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.float32)


def _pool_positions(onehot: torch.Tensor, B: int, pool: RoutingPool):
    """The global capacity positions ``[N, E]`` of this rank's tokens (f32;
    zero where a token is not routed to e), from the per-example counts
    gathered over the pool."""
    E = onehot.shape[-1]
    per_ex = onehot.view(B, -1, E)  # [B, T_local, E]
    counts = per_ex.sum(1)  # [B, E]
    gathered = all_gather_list(counts, pool.group)
    table = torch.zeros((pool.examples, pool.sp_size, E), dtype=torch.float32,
                        device=onehot.device)
    for (ids, shard), c in zip(pool.layout, gathered):
        table[ids.to(onehot.device), shard] = c[:ids.numel()]
    flat = table.reshape(-1, E)
    before = torch.cumsum(flat, 0) - flat  # exclusive prefix in the global order
    ids, shard = pool.layout[dist.get_rank(pool.group)]
    offset = before.view(pool.examples, pool.sp_size, E)[ids.to(onehot.device), shard]
    if ids.numel() < B:  # padded rows: routed nowhere, any offset does
        offset = torch.cat([offset, offset.new_zeros((B - ids.numel(), E))])
    pos = offset[:, None, :] + torch.cumsum(per_ex, 1) - 1.0
    return (pos * per_ex).reshape(-1, E)


class SwitchFFN(nn.Module):
    """Top-1 routed MoE feed-forward: [B, T, C] -> [B, T, C]."""

    def __init__(self, embed_dim: int, num_experts: int, capacity_factor: float = 1.25,
                 mlp_ratio: int = 4) -> None:
        super().__init__()
        C, E, H = embed_dim, num_experts, mlp_ratio * embed_dim
        self.num_experts = E
        self.capacity_factor = capacity_factor
        self.router = nn.Linear(C, E, bias=False)
        self.wi = nn.Parameter(torch.empty(E, C, H))
        self.bi = nn.Parameter(torch.zeros(E, H))
        self.wo = nn.Parameter(torch.empty(E, H, C))
        self.bo = nn.Parameter(torch.zeros(E, C))
        # flax's lecun_normal on [E, fan, out] counts E in the fan_in
        self.truncated_fans = {"wi": E * C, "wo": E * H}
        self.zero_params = ("bi", "bo")
        self.ep: Optional[ExpertShard] = None  # parallel.expert.attach_ep
        self.pool: Optional[RoutingPool] = None  # set_routing_pool
        self.sink: Optional[Dict[str, List[torch.Tensor]]] = None  # collect

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        N, E = B * T, self.num_experts
        pool, sink = self.pool, self.sink
        n_global = N if pool is None else pool.examples * T * pool.sp_size
        cap = max(1, math.ceil(n_global / E * self.capacity_factor))
        xf = x.reshape(N, C)

        # routing in f32 (bf16 cumsum holds integers exactly only up to
        # 256): flax promotes the f32 input and the weight, so a float64
        # weight gives float64 logits, then the softmax is f32
        rdt = torch.promote_types(torch.float32, self.router.weight.dtype)
        logits = F.linear(xf.to(rdt), self.router.weight.to(rdt))
        probs = torch.softmax(logits.to(torch.float32), dim=-1)  # [N, E]
        gate = probs.amax(dim=-1)
        expert = torch.argmax(probs, dim=-1)  # [N]
        onehot = _onehot(expert, E)  # [N, E]

        real = None  # [N] 1 for a real token, 0 for padding (None: all real)
        if pool is None:
            frac, mean_prob = onehot.mean(0), probs.mean(0)
            pos = (torch.cumsum(onehot, 0) - 1.0) * onehot
        else:
            held = pool.layout[dist.get_rank(pool.group)][0].numel()
            pooled = probs
            if held < B:  # padded rows: in no expert's pool
                real = (torch.arange(B, device=x.device) < held).repeat_interleave(T)
                onehot = onehot * real[:, None]
                pooled = probs * real[:, None]
            frac = all_reduce_(onehot.sum(0), pool.group) / n_global
            # the aux loss is the same on every rank of the pool: each
            # rank's gradient flows through its own tokens' probs only
            mean_prob = reduce_from(pooled.sum(0), pool.group) / n_global
            pos = _pool_positions(onehot, B, pool)
        # token n's slot at its expert, kept below the capacity; a dropped
        # token's index is the spare row E * cap
        slot = pos.gather(1, expert[:, None])[:, 0]
        kept = slot < cap
        if real is not None:
            kept = kept & real
        slot = slot.to(torch.int64)
        spare = torch.full_like(expert, E * cap)
        index = torch.where(kept, expert * cap + slot, spare)
        if sink is not None:
            occupancy = torch.zeros(E * cap + 1, dtype=torch.float32, device=x.device)
            occupancy = occupancy.index_add(0, index, torch.ones_like(gate))[:-1].view(E, cap)
            if pool is not None:
                occupancy = all_reduce_(occupancy, pool.group)
            sink["moe_aux_loss"].append(E * torch.sum(frac * mean_prob))
            sink["moe_slot_occupancy"].append(occupancy)

        wi, bi, wo, bo = self.wi, self.bi, self.wo, self.bo
        g = gate.to(x.dtype)
        n_exp = E
        if self.ep is not None:
            # this rank's experts, from the tokens and gates every ep rank
            # holds: their gradients are the sum of the ranks' partials
            e0, n_exp = self.ep.start, self.ep.count
            mine = kept & (expert >= e0) & (expert < e0 + n_exp)
            index = torch.where(mine, (expert - e0) * cap + slot,
                                torch.full_like(expert, n_exp * cap))
            xf, g = copy_to(xf, self.ep.group), copy_to(g, self.ep.group)
        # each kept row lands alone in its slot (0 + x is x); the spare
        # row collects the dropped ones and is cut off
        slots = xf.new_zeros((n_exp * cap + 1, C)).index_add(0, index, xf)
        expert_in = slots[:-1].view(n_exp, cap, C)
        h = F.gelu(torch.einsum("ecd,edh->ech", expert_in, wi) + bi[:, None], approximate="tanh")
        out = torch.einsum("ech,ehd->ecd", h, wo) + bo[:, None]  # [E, cap, C]
        out = torch.cat([out.reshape(n_exp * cap, C), out.new_zeros((1, C))])
        y = out.index_select(0, index) * g[:, None]  # [N, C]
        if self.ep is not None:
            y = reduce_from(y, self.ep.group)
        return y.reshape(B, T, C)


class MoETransformerLM(TransformerLM):
    """``TransformerLM`` with a routed FFN on every ``moe_every``-th block
    (where ``(i + 1) % moe_every == 0``); attention, embeddings and head
    are the inherited ones."""

    def __init__(self, vocab_size: int, num_experts: int = 8, capacity_factor: float = 1.25,
                 moe_every: int = 2, **kw) -> None:
        # read by make_block, which TransformerLM.__init__ calls
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.moe_every = moe_every
        super().__init__(vocab_size, **kw)

    def make_block(self, i: int, attn, ffn=None) -> Block:
        if (i + 1) % self.moe_every != 0:
            return super().make_block(i, attn)
        return super().make_block(i, attn, ffn=lambda: SwitchFFN(
            self.embed_dim, self.num_experts, self.capacity_factor))
