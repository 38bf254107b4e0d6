"""The client-side hot loop: local training vectorized over clients.

The port of ``fedml_tpu/core/local_trainer.py``. One optimizer step is a
per-client function ``(params, opt_state, x, y, mask) -> (params,
opt_state, metrics)``; ``torch.func.vmap`` over
``torch.func.grad_and_value`` runs it for a whole cohort at once, on
params and optimizer state stacked along a leading client axis, and
Python drives the epochs x batches around it, eagerly. The same
function trains one client (the sequential mode: a cohort of one) or
the full cohort (the vectorized mode).

As in the JAX package:

- a fully masked (padding) batch is skipped exactly: params *and*
  optimizer state keep their values (``torch.where``), so a padded
  client matches ragged iteration under any optimizer;
- the per-epoch reshuffle permutes the real examples and keeps padding
  at the tail, so a client with n samples takes ceil(n/bs) steps per
  epoch;
- the FedProx term mu/2 ||w - w_global||^2 is a flag, not a fork;
- ``args.dtype: bfloat16`` runs the forward and backward in bf16 over
  f32 master params (cast inside the loss, so gradients return to the
  f32 copy in f32); optimizer state, the loss reduction, the prox term
  and the metric sums stay f32. Only floating inputs are cast: token ids
  stay integers (``_cast_floats``, as the JAX package casts its leaves).

``data_group`` (the legacy simulator mesh's ``data`` axis) splits each
batch's examples over that process group's ranks, after the shuffle:
each rank differentiates the masked loss *sum* of its examples, the
sums of gradients and counts are all-reduced, and the step takes their
quotient (plus the prox term's own gradient), so the ranks take the
one-rank step to f32 rounding and end every step with the same params.

The shuffle draws its permutations from uniforms the caller passes
(``rng``: ``[C, epochs, nb*bs]``), drawn by the round engine from its
``torch.Generator``; PyTorch's stream is not ``jax.random``'s, so the
two packages agree on a shuffled run in distribution, not bitwise.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch.utils import _pytree as pytree

from .optimizers import GradientTransformation
from .types import Batches, flat_examples, rebatch

Params = Dict[str, torch.Tensor]

# float16 is absent: without loss scaling its ~6e-5 normal floor flushes
# small gradients to zero; bf16 keeps f32's exponent range
_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}

# One forward pass of evaluation takes at most EVAL_CHUNK examples and at
# most EVAL_ELEMENTS of (examples x input elements x predicted positions).
# An image is one prediction over its pixels; a sequence of T tokens is T
# predictions over T inputs, so its cost grows as T^2, as attention's
# does. The first limit binds for images up to the CIFAR size (4096
# examples of 28x28x1 or 32x32x3 per pass); the second for long
# sequences (at T 4096 one packed batch per pass).
EVAL_CHUNK = 4096
EVAL_ELEMENTS = 4096 * 32 * 32 * 3


def compute_dtype_from_args(args) -> Optional[torch.dtype]:
    """``args.dtype`` -> compute dtype of the hot loop (None = f32, no
    casting)."""
    name = str(getattr(args, "dtype", "float32") or "float32")
    if name not in _DTYPES:
        raise ValueError(
            f"dtype {name!r}: pick one of {sorted(_DTYPES)} (float16 is "
            "unsupported — no loss scaling)"
        )
    return _DTYPES[name]


def _cast_float(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype) if x.is_floating_point() else x


def _cast_floats(tree: Params, dtype) -> Params:
    return {k: _cast_float(v, dtype) for k, v in tree.items()}


def _shuffle_batches(b: Batches, u: torch.Tensor) -> Batches:
    """Random order of the REAL examples, padding kept at the tail.

    ``b`` has leaves ``[C, nb, bs, ...]``, ``u`` is ``[C, nb*bs]``
    uniforms: ``argsort(u)`` is a random permutation per client, and a
    stable sort by validity then moves the real examples, in that random
    order, to the leading slots."""
    flat = flat_examples(b)
    perm = torch.argsort(u, dim=-1)
    invalid = 1.0 - torch.gather(flat.mask, -1, perm)
    order = torch.sort(invalid, dim=-1, stable=True).indices
    idx = torch.gather(perm, -1, order)
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    shuffled = Batches(x=flat.x[rows, idx], y=flat.y[rows, idx], mask=flat.mask[rows, idx])
    return rebatch(shuffled, b.num_batches, b.batch_size)


def example_share(batch_size: int, ranks: int, rank: int):
    """Rank ``rank`` of a ``data_group`` of ``ranks``: its rows ``[lo,
    hi)`` of each batch of ``batch_size`` examples."""
    return rank * batch_size // ranks, (rank + 1) * batch_size // ranks


def _stack(tree, count: int):
    """Every leaf broadcast along a new leading client axis."""
    return pytree.tree_map(lambda t: t.expand((count,) + tuple(t.shape)), tree)


def make_local_train_fn(
    apply_fn: Callable[[Params, torch.Tensor], torch.Tensor],
    loss_fn: Callable,
    optimizer: GradientTransformation,
    epochs: int,
    prox_mu: float = 0.0,
    shuffle: bool = True,
    compute_dtype: Optional[torch.dtype] = None,
    data_group=None,
) -> Callable:
    """Build ``local_train(params, batches, rng=None, lr_mult=None) ->
    (new_params, metrics)``.

    ``params`` are the global params (one model); ``batches`` are a
    cohort's, leaves ``[C, nb, bs, ...]``; ``rng`` the shuffle's
    uniforms ``[C, epochs, nb*bs]`` (required when ``shuffle``);
    ``lr_mult`` scales every update (the round-indexed LR). With
    ``stacked=True`` the params are already one model per client
    (leaves ``[C, ...]``, the decentralized nodes' own models) and each
    client trains its own row. Returns the
    C clients' params stacked ``[C, ...]`` and, per client, the last
    epoch's f32 ``loss_sum`` / ``correct`` / ``count``. Inputs are never
    written to.
    """

    def batch_loss(params, global_params, x, y, mask):
        if compute_dtype is not None:
            logits = apply_fn(
                _cast_floats(params, compute_dtype), _cast_float(x, compute_dtype)
            ).to(torch.float32)
        else:
            logits = apply_fn(params, x)
        loss, metrics = loss_fn(logits, y, mask)
        if prox_mu > 0.0:
            sq = sum(torch.sum((p - g) * (p - g))
                     for p, g in zip(params.values(), global_params.values()))
            loss = loss + 0.5 * prox_mu * sq
        return loss, metrics

    grad_fn = torch.func.grad_and_value(batch_loss, has_aux=True)

    def local_sum(params, x, y, mask):
        """The masked loss sum of this rank's examples (its count is the
        loss's own: examples or tokens)."""
        loss, metrics = batch_loss(params, params, x, y, mask)
        return loss * metrics["count"], metrics

    sum_grad_fn = torch.func.vmap(torch.func.grad_and_value(local_sum, has_aux=True))

    def apply_update(p, s, grads, count, lr_mult):
        """The optimizer's step on ``grads``, scaled by ``lr_mult``; a
        client whose step saw no example (``count`` 0) keeps its params
        and state."""
        updates, s_new = optimizer.update(grads, s, p)
        if lr_mult is not None:
            updates = {k: u * lr_mult for k, u in updates.items()}
        p_new = {k: p[k] + updates[k] for k in p}
        nonempty = count > 0
        p = pytree.tree_map(lambda a, b: torch.where(nonempty, a, b), p_new, p)
        s = pytree.tree_map(lambda a, b: torch.where(nonempty, a, b), s_new, s)
        return p, s

    def split_step(p, s, global_params, x, y, m, lr_mult):
        """One step over the data group: this rank's share of each
        client's batch (examples ``[lo, hi)``), the gradient sums and
        counts all-reduced."""
        import torch.distributed as dist

        n, r = dist.get_world_size(data_group), dist.get_rank(data_group)
        lo, hi = example_share(m.shape[1], n, r)
        (gsum, (_, metrics)) = sum_grad_fn(p, x[:, lo:hi], y[:, lo:hi], m[:, lo:hi])
        keys = list(gsum)
        flat = torch.cat([gsum[k].reshape(gsum[k].shape[0], -1) for k in keys]
                         + [metrics["count"].to(gsum[keys[0]].dtype)[:, None]], dim=1)
        dist.all_reduce(flat, group=data_group)
        count = flat[:, -1]
        parts = flat[:, :-1].split([gsum[k][0].numel() for k in keys], dim=1)
        denom = count.clamp_min(1.0)[:, None]
        grads = {k: (part / denom).view_as(gsum[k]) for k, part in zip(keys, parts)}
        if prox_mu > 0.0:  # the prox term's own gradient: the sums carry none
            grads = {k: g + prox_mu * (p[k] - global_params[k]) for k, g in grads.items()}
        p, s = torch.func.vmap(apply_update, in_dims=(0, 0, 0, 0, None))(
            p, s, grads, count, lr_mult)
        return p, s, metrics

    def train_step(p, s, global_params, x, y, m, lr_mult):
        grads, (_, metrics) = grad_fn(p, global_params, x, y, m)
        p, s = apply_update(p, s, grads, m.sum(), lr_mult)
        return p, s, metrics

    def local_train(params: Params, batches: Batches, rng=None, lr_mult=None,
                    stacked: bool = False):
        C = batches.mask.shape[0]
        if shuffle and rng is None:
            raise ValueError("local_train: shuffle is on, so rng (the uniforms) is required")
        if stacked:
            # one model per client already (DSGD/PushSum's nodes): each
            # client starts from, and is proximal to, its own row
            if any(v.shape[0] != C for v in params.values()):
                raise ValueError(
                    f"local_train(stacked=True): params must lead with the "
                    f"cohort's {C} clients"
                )
            vstep = torch.func.vmap(
                lambda p, s, g, x, y, m: train_step(p, s, g, x, y, m, lr_mult)
            )

            def step(p, s, x, y, m):
                return vstep(p, s, params, x, y, m)

            first = {k: v[0] for k, v in params.items()}
            p, s = dict(params), _stack(optimizer.init(first), C)
        elif data_group is not None:
            def step(p, s, x, y, m):
                return split_step(p, s, params, x, y, m, lr_mult)

            p, s = _stack(params, C), _stack(optimizer.init(params), C)
        else:
            step = torch.func.vmap(
                lambda p, s, x, y, m: train_step(p, s, params, x, y, m, lr_mult)
            )
            p, s = _stack(params, C), _stack(optimizer.init(params), C)
        for epoch in range(epochs):
            b = _shuffle_batches(batches, rng[:, epoch]) if shuffle else batches
            sums = {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
            for i in range(b.num_batches):
                p, s, m = step(p, s, b.x[:, i], b.y[:, i], b.mask[:, i])
                # summed in the metrics' own dtype (the loss is f32 under
                # bf16, f64 in a float64 run) and cast once, as the JAX
                # package sums its scan's outputs
                sums = {"loss_sum": sums["loss_sum"] + m["loss"] * m["count"],
                        "correct": sums["correct"] + m["correct"],
                        "count": sums["count"] + m["count"]}
        sums = {k: v.to(torch.float32) for k, v in sums.items()}
        if data_group is not None:  # each rank summed its own examples
            import torch.distributed as dist

            flat = torch.stack([sums[k] for k in sums])
            dist.all_reduce(flat, group=data_group)
            sums = dict(zip(sums, flat.unbind(0)))
        return p, sums

    return local_train


def eval_batches_per_pass(batches: Batches) -> int:
    """Packed batches per forward pass of evaluation: as many as fit
    ``EVAL_CHUNK`` examples and ``EVAL_ELEMENTS`` (examples x input
    elements x predicted positions), at least one."""
    lead = batches.mask.dim()
    x_elems = math.prod(batches.x.shape[lead:])
    y_elems = math.prod(batches.y.shape[lead:])
    bs = batches.batch_size
    return max(1, min(EVAL_CHUNK // bs, EVAL_ELEMENTS // (bs * x_elems * y_elems)))


def make_eval_fn(
    apply_fn: Callable[[Params, torch.Tensor], torch.Tensor],
    loss_fn: Callable,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable[[Params, Batches], Dict[str, torch.Tensor]]:
    """Build ``evaluate(params, batches) -> summed metrics`` over every
    packed batch of ``batches`` (any leading axes before ``[nb, bs]``),
    ``eval_batches_per_pass`` batches per forward pass; the sums stay on
    the device."""

    def evaluate(params: Params, batches: Batches) -> Dict[str, torch.Tensor]:
        bs = batches.batch_size
        feat = tuple(batches.x.shape[batches.mask.dim():])
        x = batches.x.reshape((-1, bs) + feat)
        y = batches.y.reshape((-1, bs) + tuple(batches.y.shape[batches.mask.dim():]))
        mask = batches.mask.reshape(-1, bs)
        if compute_dtype is not None:
            params = _cast_floats(params, compute_dtype)
        per = eval_batches_per_pass(batches)
        parts = []
        with torch.no_grad():
            for i in range(0, mask.shape[0], per):
                xb = x[i:i + per].flatten(0, 1)
                if compute_dtype is not None:
                    logits = apply_fn(params, _cast_float(xb, compute_dtype)).to(torch.float32)
                else:
                    logits = apply_fn(params, xb)
                loss, metrics = loss_fn(logits, y[i:i + per].flatten(0, 1),
                                        mask[i:i + per].flatten(0, 1))
                # task-specific extras ride along (tag prediction's
                # tp/fp/fn feed precision, recall and F1)
                keys = [k for k in ("tp", "fp", "fn") if k in metrics]
                parts.append(torch.stack([loss * metrics["count"], metrics["correct"],
                                          metrics["count"], *(metrics[k] for k in keys)]))
        return dict(zip(("loss_sum", "correct", "count", *keys), torch.stack(parts).sum(0)))

    return evaluate
