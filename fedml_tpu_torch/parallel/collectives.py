"""Differentiable collectives over ``torch.distributed`` process groups.

The JAX package writes no collective by hand: ``shard_map`` and XLA's SPMD
partitioner insert them (``ppermute`` in the ring, ``all_to_all`` in
Ulysses, the all-reduces after Megatron's row-parallel products and after
the expert stacks' dispatch). The port runs one process per rank, so it
calls them itself, and every mode (sharded, sequence) uses these:

- :func:`copy_to`: identity forward, all-reduce (sum) of the gradient
  backward; Megatron's ``f``, put where a replicated activation enters a
  sharded computation, so the partial gradients of the ranks add up;
- :func:`reduce_from`: all-reduce (sum) forward, identity backward;
  Megatron's ``g``, after a row-parallel product or a sum of partials;
- :func:`gather_from`: all-gather along a dim forward, the rank's own
  slice of the gradient backward (the gathered tensor feeds a computation
  every rank repeats);
- :func:`all_to_all`: split one dim across the ranks and concatenate what
  arrives along another; the backward is the inverse all-to-all;
- :func:`ring_shift`: send to the next rank, receive from the previous;
  the backward is the reverse shift.

Each is a ``torch.autograd.Function`` whose backward issues the mirrored
collective, so autograd on every rank issues the same collectives in the
same order. A group of one rank makes every one of them the identity;
they still run (on one card over NCCL at world size 1). ``copy_to``,
``reduce_from`` and ``gather_from`` given no group (``None``: the
computation is not sharded) return their input.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

__all__ = [
    "all_gather_list",
    "all_reduce_",
    "all_to_all",
    "copy_to",
    "gather_from",
    "reduce_from",
    "ring_shift",
]


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``x`` over ``group`` (no autograd); returns ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather_list(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x`` (same shape), in group rank order (no autograd)."""
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.rank = dim, dist.get_rank(group)
        ctx.size = dist.get_world_size(group)
        return torch.cat(all_gather_list(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size, dim=ctx.dim)[ctx.rank].contiguous(), None, None


def _all_to_all(x: torch.Tensor, scatter_dim: int, gather_dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    send = x.movedim(scatter_dim, 0)
    send = send.reshape((n, send.shape[0] // n) + tuple(send.shape[1:])).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[j]: rank j's chunk for this rank
    return torch.cat([recv[j].movedim(0, scatter_dim) for j in range(n)], dim=gather_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scatter_dim, gather_dim, group):
        ctx.dims, ctx.group = (scatter_dim, gather_dim), group
        return _all_to_all(x, scatter_dim, gather_dim, group)

    @staticmethod
    def backward(ctx, g):
        scatter_dim, gather_dim = ctx.dims
        return _all_to_all(g, gather_dim, scatter_dim, ctx.group), None, None, None


def _shift(x: torch.Tensor, shift: int, group) -> torch.Tensor:
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    recv = torch.empty_like(x)
    ops = [
        dist.P2POp(dist.isend, x, dist.get_global_rank(group, (rank + shift) % n), group),
        dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (rank - shift) % n), group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, -1, ctx.group), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _GatherFrom.apply(x, dim, group)


def all_to_all(x: torch.Tensor, scatter_dim: int, gather_dim: int, group) -> torch.Tensor:
    """``x``'s ``scatter_dim`` split into one chunk a rank (chunk j to
    rank j), the chunks that arrive concatenated along ``gather_dim`` in
    rank order."""
    return _AllToAll.apply(x, scatter_dim, gather_dim, group)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of the previous rank of ``group`` (this rank's goes to the
    next)."""
    return _RingShift.apply(x, group)
