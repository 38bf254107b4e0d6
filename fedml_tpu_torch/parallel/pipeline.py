"""Pipeline parallelism: the GPipe schedule over a ``pp`` process group
(port of ``fedml_tpu/parallel/pipeline.py``).

The JAX package runs the whole pipeline as one SPMD program under
``shard_map``: every stage runs every one of the M + S - 1 ticks of a
``lax.scan``; at tick t stage 0 takes microbatch ``min(t, M - 1)`` and
every other stage what it received; the activation hops to the next
stage by a non-cyclic ``ppermute``; the last stage's outputs from tick
S - 1 on are kept, and a ``psum`` over the stages replicates them. The
garbage ticks (the bubble, and the repeats of the last microbatch) are
computed and masked out, so autodiff gives them zero gradient.

The port runs one process a stage and the same schedule, tick for tick,
with the autograd collectives of ``parallel/collectives.py``:

- the hop is :func:`ring_shift` (cyclic: stage 0 receives the last
  stage's output and ignores it, as the non-cyclic ``ppermute`` hands it
  zeros), skipped after the last tick, whose carry the scan drops;
- stage 0's choice between its microbatch and what it received is a
  ``torch.where`` on a 0-d tensor, not a Python branch, and the last
  stage's outputs are kept the same way, so every rank's autograd graph
  holds every hop: the backward issues the mirrored shifts on every rank
  in the same order, and nothing deadlocks;
- the final sum is :func:`reduce_from` (all-reduce forward, identity
  backward): every rank continues with the same outputs, and the
  gradient of its own copy flows back into the last stage's ticks.

``torch.distributed.pipelining``'s schedules are not used: they reorder
the arithmetic and drop the garbage ticks the reference's gradients rest
on.

Two gradient rules sit with the caller (``distributed.py``): the input
enters every stage replicated, and only stage 0 reads it, so its
gradient must be summed over the stages (``copy_to``: the transpose of
the reference's ``pcast`` to varying); what runs replicated after the
sum (the head) must not be summed.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from .collectives import reduce_from, ring_shift

Tree = Dict[str, torch.Tensor]

__all__ = ["check_microbatch", "check_stage_stack", "pipeline_apply", "split_microbatches",
           "stack_stage_params"]


def stack_stage_params(per_stage: List[Tree]) -> Tree:
    """[stage0_tree, stage1_tree, ...] -> one tree with leading axis S."""
    return {k: torch.stack([t[k] for t in per_stage]) for k in per_stage[0]}


def check_stage_stack(stage_params: Tree, stages: int) -> None:
    """The reference's refusal of a stage stack whose leading axis is not
    the pp axis's size."""
    leading = next(iter(stage_params.values())).shape[0]
    if leading != stages:
        raise ValueError(f"stage_params leading axis {leading} != pp axis {stages}")


def split_microbatches(x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...]."""
    B = x.shape[0]
    if B % num_microbatches:
        raise ValueError(f"batch {B} not divisible by {num_microbatches} microbatches")
    return x.reshape(num_microbatches, B // num_microbatches, *x.shape[1:])


def check_microbatch(mb: int, batch_axis: Optional[str], batch_size: int) -> None:
    """The reference's refusal of a data axis that does not divide the
    microbatch (its ``pipeline_apply`` shards the microbatch's examples
    over ``batch_axis``)."""
    if batch_axis is not None and mb % batch_size:
        raise ValueError(
            f"batch_axis {batch_axis}={batch_size} must divide "
            f"microbatch size {mb}"
        )


def pipeline_apply(stage_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                   group) -> torch.Tensor:
    """``y_i = stage_{S-1}(... stage_0(x_i))`` for the microbatches ``x``
    [M, mb, ...] over the S ranks of ``group``, this rank stage
    ``group``'s rank: ``stage_fn`` is this rank's stage, its params bound
    (its row of the [S, ...] stage stack, as the reference's
    ``shard_map`` hands each device its row); only stage 0 reads ``x``.
    Returns the last stage's outputs [M, mb, ...] on every rank.
    ``stage_fn`` must keep the activation's shape."""
    M, S, stage = x.shape[0], dist.get_world_size(group), dist.get_rank(group)
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == S - 1, device=x.device)
    recv = torch.zeros_like(x[0])
    outs = []
    ticks = M + S - 1
    for t in range(ticks):
        y = stage_fn(torch.where(first, x[min(t, M - 1)], recv))
        if t >= S - 1:
            outs.append(y)
        if S > 1 and t < ticks - 1:
            recv = ring_shift(y, group)
    out = torch.stack(outs)
    if S == 1:
        return out
    # only the last stage holds real outputs; replicate them
    return reduce_from(torch.where(last, out, torch.zeros_like(out)), group)
