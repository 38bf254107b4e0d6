"""``training_type: distributed``: mesh-parallel LM training through the
one-line API (port of ``fedml_tpu/distributed.py``).

YAML surface::

    common_args: {training_type: distributed}
    train_args:  {mesh_shape: {dp: 2, tp: 2, ep: 2}, epochs: 2, ...}
    model_args:  {model: moe_transformer, ...}
    data_args:   {dataset: shakespeare, ...}

One process a rank over ``torch.distributed`` (``run_distributed`` sets
the process group up), the mesh a ``DeviceMesh`` over it
(``parallel/mesh.py``). Modes, from the mesh axes:

- **sharded** (axes within {dp, tp, ep}): the batch over ``dp``, the
  Megatron layout over ``tp`` (``parallel/tensor.py``), expert stacks over
  ``ep`` (``parallel/expert.py``); the gradients are all-reduced over dp.
- **sequence** ({sp} or {dp, sp}): ring or Ulysses attention
  (``parallel/sequence.py``) with the token axis split over ``sp``, the
  batch over an optional ``dp``; parameters replicated, gradients
  all-reduced over every rank.
- **pipeline** ({pp} or {dp, pp}): the plain ``TransformerLM``'s block
  stack cut into pp stages (stage-major ``[S, L/S, ...]`` stacking, each
  pp rank holding its stage) and run on the GPipe schedule of
  ``parallel/pipeline.py`` over microbatches of each accumulation chunk
  (``pp_microbatches``, 0 = the reference's auto rule); an optional
  ``dp`` splits each microbatch's examples. The embedding's gradient is
  summed over the stages (only stage 0 reads it), the replicated
  LayerNorm and head's are not.

Each optimizer step is the JAX package's (``_epoch_scanner``): the loss
is the model's masked mean over the global batch (tokens for an LM) plus
``moe_aux_weight``
times the mean Switch aux loss, ``grad_accum_steps`` chunks of the global
batch are differentiated in turn and their gradients summed weighted by
their token counts (exactly the unchunked gradient), the optimizer
(``client_optimizer`` with its step-indexed LR schedule) updates f32
master params, a bf16 ``dtype`` running the forward and backward in bf16
over them. Every rank computes the masked *sum* over its own examples
divided by the global count (an all-reduce of counts), so the
all-reduced gradients are the global mean's. Each accumulation chunk
(rows ``[j * chunk, (j + 1) * chunk)`` of the shuffled global batch, as
the JAX package splits it) is spread over the dp ranks as evenly as it
goes: dp rank d computes the chunk's rows ``[d * chunk // dp, (d + 1) *
chunk // dp)`` (in the pipeline mode, its share of each microbatch),
padded with masked rows to the largest share, so that a dp that divides
the batch but not the chunk trains the reference's gradient too, and a
rank with no rows of a chunk still joins every collective of it. The
MoE routing pool is the chunk's real tokens across the ranks
(``models.moe.set_routing_pool``) as it is under SPMD, the padded rows
taking no capacity; in evaluation it is the whole test batch, which the
JAX package passes in one forward whatever the accumulation. A sequence
rank's position embeddings are its tokens' global positions.

The per-epoch shuffle permutes the global batch's real examples (padding
kept at the tail) by a permutation drawn from a ``torch.Generator``
seeded with the run's seed and the epoch, so a resumed run replays it
(the JAX package draws it from threefry; tests hand the port JAX's
permutations through ``epoch_permutation``). Checkpoints (``core/
checkpoint.py``, every ``checkpoint_freq`` epochs and after the last)
hold ``{params, opt_state, epoch}`` gathered whole, written by rank 0;
every rank restores and re-shards them, and a run whose checkpoint is
its last epoch evaluates only.

On one card the world is one rank and every collective is the identity:
the card proves the kernels, shapes, memory and time; worlds of 2-8 gloo
ranks on the CPU prove the collectives (``tests/test_torch_distributed.py``).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .core.local_trainer import _cast_floats, compute_dtype_from_args
from .core.optimizers import create_client_optimizer
from .core.types import Batches, flat_examples, rebatch
from .parallel.collectives import all_reduce_, copy_to
from .parallel.expert import attach_ep, tp_ep_layout
from .parallel.mesh import build_mesh, resolve_mesh_shape
from .parallel.pipeline import (check_microbatch, check_stage_stack, pipeline_apply,
                                 split_microbatches, stack_stage_params)
from .parallel.tensor import Shard, attach_tp, gather_full, local_shard

Params = Dict[str, torch.Tensor]

# the shuffle's stream: the JAX package folds 0x51 into its init key for it
_SHUFFLE_STREAM = 0x51

# the pipeline mode's parameter split: what TransformerLM holds outside
# its blocks (the reference's ``expected`` outer set), and the prefixes
# of the two halves
PP_OUTER = {"Embed_0", "Embed_1", "LayerNorm_0", "Dense_0"}
PP_PREFIXES = ("outer/", "stages/")


def pipeline_params(params: Params, num_layers: int, stages: int) -> Params:
    """A ``TransformerLM``'s params in the pipeline mode's layout:
    ``outer/<key>`` for the embeddings, the final LayerNorm and the head,
    and ``stages/<block leaf>`` ``[S, L/S, ...]`` for the block stack,
    stage-major (stage s holds blocks ``s * L/S`` to ``(s + 1) * L/S -
    1``). Params already in that layout (carried from the JAX package by
    ``convert.params_from_flax``) are checked and kept."""
    if not any(k.startswith(PP_PREFIXES) for k in params):
        per = num_layers // stages
        leaves = sorted({k.split("/", 1)[1] for k in params if k.startswith("Block_")})
        stacked = stack_stage_params([
            {f"stages/{leaf}": torch.stack([params[f"Block_{s * per + i}/{leaf}"]
                                            for i in range(per)]) for leaf in leaves}
            for s in range(stages)])
        params = {**{f"outer/{k}": v for k, v in params.items()
                     if not k.startswith("Block_")}, **stacked}
    outer = {k.split("/")[1] for k in params if k.startswith("outer/")}
    if outer != PP_OUTER:
        raise ValueError(
            "pipeline mode mirrors TransformerLM's embed/head "
            f"structure; unexpected params: {sorted(outer ^ PP_OUTER)}"
        )
    check_stage_stack({k: v for k, v in params.items() if k.startswith("stages/")}, stages)
    return params


def _map_params_trees(tree, keys, fn):
    """``fn(key, leaf)`` on every params-keyed dict inside an optimizer
    state (dicts, tuples), other leaves kept."""
    if isinstance(tree, dict):
        if set(tree) == keys:
            return {k: fn(k, v) for k, v in tree.items()}
        return {k: _map_params_trees(v, keys, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_params_trees(v, keys, fn) for v in tree)
    return tree


def _like(fresh, restored):
    """``restored``'s leaves on the devices of ``fresh``'s (a schedule's
    step count stays on the CPU, Adam's on the card)."""
    if isinstance(fresh, torch.Tensor):
        return restored.to(fresh.device)
    if isinstance(fresh, dict):
        return {k: _like(v, restored[k]) for k, v in fresh.items()}
    if isinstance(fresh, (tuple, list)):
        return type(fresh)(_like(a, b) for a, b in zip(fresh, restored))
    return restored


class DistributedTrainer:
    """One-line distributed LM training over a ``torch.distributed`` mesh.

    ``params`` (full, unsharded; default: drawn from the model's init with
    the run's seed) lets a caller carry weights in, as the parity tests
    carry the JAX package's across with ``convert.params_from_flax``."""

    def __init__(self, args, device: torch.device, dataset, model,
                 params: Optional[Params] = None) -> None:
        self.args, self.device, self.dataset, self.model = args, device, dataset, model
        self.shape = resolve_mesh_shape(getattr(args, "mesh_shape", None),
                                        dist.get_world_size())
        self.mode = ("pipeline" if "pp" in self.shape
                     else "sequence" if "sp" in self.shape else "sharded")
        self.mesh = build_mesh(self.shape, device.type)
        self.groups = {axis: self.mesh.get_group(axis) for axis in self.shape}
        self.coords = self._coords(dist.get_rank())  # this rank's place on each axis
        self.compute_dtype = compute_dtype_from_args(args)
        self.optimizer = create_client_optimizer(args, schedules=True)
        self.aux_w = float(getattr(args, "moe_aux_weight", 0.0) or 0.0)
        self.accum = int(getattr(args, "grad_accum_steps", 1) or 1)
        if self.accum < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {self.accum}")
        from .core.tracking import MetricsReporter

        self.metrics_reporter = MetricsReporter(args)
        self.seed = int(getattr(args, "random_seed", 0))
        train = dataset.train_data_global
        bs, seq_len = int(train.x.shape[1]), int(train.x.shape[-1])
        dp, sp = self.shape.get("dp", 1), self.shape.get("sp", 1)
        self.dp = dp
        if params is None:
            params = model.init(torch.Generator().manual_seed(self.seed))
        if self.mode == "sequence":
            self._build_sequence(seq_len)
        elif self.mode == "pipeline":
            params = self._build_pipeline(params)
        if "dp" in self.shape and bs % dp:
            raise ValueError(f"mesh axis dp={dp} must divide batch_size {bs}")
        if bs % self.accum:
            raise ValueError(f"grad_accum_steps={self.accum} must divide batch_size {bs}")
        self.bs, self.seq_len, self.sp = bs, seq_len, sp
        if self.mode == "pipeline":  # the reference's refusals, at both batch shapes
            for b in (bs // self.accum, bs):
                m = self._microbatches(b)
                split_microbatches(torch.empty(b, 0), m)
                check_microbatch(b // m, "dp" if dp > 1 else None, dp)
        # the ranks whose tokens make one batch (the gradient all-reduce
        # and the routing pool): dp in the sharded and pipeline modes,
        # every rank in the sequence mode
        self.data_group = (dist.group.WORLD if self.mode == "sequence"
                           else self.groups.get("dp"))
        params = {k: v.to(device) for k, v in params.items()}
        num_heads = getattr(model.module, "num_heads", 1)
        if self.mode == "sharded":
            self.layout = tp_ep_layout(params, self.shape, num_heads)
        elif self.mode == "pipeline":  # each pp rank holds its stage
            self.layout = {k: Shard("pp", 0) if k.startswith("stages/") else None
                           for k in params}
        else:
            self.layout = {k: None for k in params}
        self.params = self._shard(params)
        if self.mode == "sharded":
            if "tp" in self.shape:
                attach_tp(model.module, self.layout, self.groups["tp"], self.shape["tp"])
            if "ep" in self.shape:
                attach_ep(model.module, self.layout, self.groups["ep"], self.coords["ep"],
                          self.shape["ep"])
        from .models.moe import set_routing_pool

        # training runs in chunks of bs / accum (evaluate pools whole batches)
        set_routing_pool(model.module, self._pool(bs // self.accum))
        if getattr(model.module, "remat", False):
            from .models.transformer import checkpoint_block

            model.module.remat_fn = checkpoint_block
        self.opt_state = self.optimizer.init(self.params)
        self._ckpt, self._start_epoch = None, 0
        ckpt_dir = getattr(args, "checkpoint_dir", None)
        if ckpt_dir:
            from .core.checkpoint import RoundCheckpointer

            self._ckpt = RoundCheckpointer(ckpt_dir)
            # None = this scenario's cadence: every epoch
            self._ckpt_freq = max(1, int(getattr(args, "checkpoint_freq", None) or 1))
            state = self._ckpt.restore()
            if state is not None:
                self._start_epoch = int(state["epoch"]) + 1
                self.params = self._shard({k: v.to(device) for k, v in state["params"].items()})
                restored = _map_params_trees(state["opt_state"], set(self.params),
                                             lambda k, v: self._local(k, v.to(device)))
                self.opt_state = _like(self.opt_state, restored)
                logging.info("distributed trainer resumed at epoch %d from %s",
                             self._start_epoch, ckpt_dir)

    # -- layout --------------------------------------------------------
    def _build_sequence(self, seq_len: int) -> None:
        from .parallel.sequence import make_sequence_sharded_attention

        module = self.model.module
        if not hasattr(module, "set_attention"):
            raise ValueError(
                f"model {self.model.name!r} has no pluggable attention; "
                "sequence parallelism needs the transformer family"
            )
        sp = self.shape["sp"]
        ring_bk = getattr(self.args, "sp_ring_block", None)
        attn = make_sequence_sharded_attention(
            self.groups["sp"], strategy=str(getattr(self.args, "sp_strategy", "ring") or "ring"),
            causal=True, ring_block_k=int(ring_bk) if ring_bk else None,
        )
        module.set_attention(attn)
        if seq_len % sp:
            raise ValueError(f"mesh axis sp={sp} must divide seq_len {seq_len}")

    def _build_pipeline(self, params: Params) -> Params:
        """The reference's ``_build_pipeline`` checks, and ``params`` in
        the pipeline layout (``pipeline_params``)."""
        from .models.transformer import TransformerLM

        module = self.model.module
        if type(module) is not TransformerLM:
            raise ValueError(
                f"pipeline mode supports the plain TransformerLM block "
                f"stack, got {type(module).__name__}"
            )
        S, L = self.shape["pp"], int(module.num_layers)
        if L % S:
            raise ValueError(f"pp={S} must divide num_layers {L}")
        self.layers_per_stage = L // S
        return pipeline_params(params, L, S)

    def _microbatches(self, B: int) -> int:
        """The microbatch count of a ``B``-example batch: ``pp_microbatches``,
        or the reference's auto rule (``_pp_apply``): up to 2 x stages,
        the largest that divides B with a microbatch dp divides."""
        micro = int(getattr(self.args, "pp_microbatches", 0) or 0)
        if micro <= 0:
            dp = self.dp
            micro = min(B // dp if B >= dp else B, max(2 * self.shape["pp"], 1))
            while micro > 1 and (B % micro or (B // micro) % dp):
                micro -= 1
        return micro

    def _coords(self, rank: int) -> Dict[str, int]:
        """``rank``'s coordinate on each mesh axis (row-major, as the
        mesh lays ranks out)."""
        return {axis: int(c) for axis, c in zip(
            self.shape, np.unravel_index(rank, tuple(self.shape.values())))}

    def _local(self, key: str, full: torch.Tensor) -> torch.Tensor:
        shard = self.layout.get(key)
        if shard is None:
            return full
        return local_shard(full, shard, self.coords[shard.axis], self.shape[shard.axis])

    def _full(self, key: str, local: torch.Tensor) -> torch.Tensor:
        shard = self.layout.get(key)
        return local if shard is None else gather_full(local, shard, self.groups[shard.axis])

    def _shard(self, params: Params) -> Params:
        return {k: self._local(k, v).clone().requires_grad_() for k, v in params.items()}

    def full_params(self) -> Params:
        """The whole params, gathered from every rank's shards."""
        return {k: self._full(k, v.detach()) for k, v in self.params.items()}

    def _full_opt_state(self):
        return _map_params_trees(self.opt_state, set(self.params),
                                 lambda k, v: self._full(k, v))

    def _rank_rows(self, d: int, chunk: int) -> torch.Tensor:
        """dp rank ``d``'s rows of a ``chunk``-example chunk, in order:
        an even split (``[d * chunk // dp, (d + 1) * chunk // dp)``), or
        in the pipeline mode its share of each microbatch (the reference
        splits each microbatch's examples over dp)."""
        if self.mode == "pipeline":
            M = self._microbatches(chunk)
            mb = chunk // M
            part = mb // self.dp
            return torch.cat([torch.arange(m * mb + d * part, m * mb + (d + 1) * part)
                              for m in range(M)])
        return torch.arange(d * chunk // self.dp, (d + 1) * chunk // self.dp)

    def _width(self, chunk: int) -> int:
        """The rows a rank computes for each chunk: the largest share."""
        return -(-chunk // self.dp)

    def _example_ids(self, bs: int, chunk: int):
        """This dp rank's rows of a ``bs`` batch split into chunks of
        ``chunk`` examples, ``_width(chunk)`` a chunk (a short share
        padded with copies of the chunk's first row), and which of them
        are real."""
        d, width = self.coords.get("dp", 0), self._width(chunk)
        rows = self._rank_rows(d, chunk)
        pad = width - rows.numel()
        ids = torch.cat([torch.cat([j * chunk + rows, torch.full((pad,), j * chunk)])
                         for j in range(bs // chunk)])
        real = torch.cat([torch.ones(rows.numel()), torch.zeros(pad)]).repeat(bs // chunk)
        return ids, real

    def _pool(self, chunk: int):
        """The MoE routing pool of ``chunk`` examples across the data
        group: each rank's (real ids within the chunk, sequence shard)."""
        from .models.moe import RoutingPool

        if self.data_group is None:
            return None
        layout = []
        for r in range(dist.get_world_size(self.data_group)):
            if self.mode == "sequence":
                c = self._coords(r)
                d, s = c.get("dp", 0), c["sp"]
            else:
                d, s = r, 0
            layout.append((self._rank_rows(d, chunk), s))
        return RoutingPool(self.data_group, layout, chunk, self.sp)

    def _local_batches(self, b: Batches, chunk: int) -> Batches:
        """This rank's part of global batches [nb, bs, T...]: its rows of
        each chunk (``_example_ids``, padding masked) and, in the
        sequence mode, its time shard."""
        idx, real = self._example_ids(b.batch_size, chunk)
        idx = idx.to(b.x.device)
        x, y = b.x[:, idx], b.y[:, idx]
        m = b.mask[:, idx] * real.to(b.mask.device, b.mask.dtype)
        if self.mode == "sequence":
            t = self.seq_len // self.sp
            s = self.coords["sp"] * t
            x, y = x[..., s:s + t], y[..., s:s + t]
        return Batches(x=x, y=y, mask=m)

    def _positions(self) -> Optional[torch.Tensor]:
        if self.mode != "sequence":
            return None
        t = self.seq_len // self.sp
        return self.coords["sp"] * t + torch.arange(t, device=self.device)

    # -- the step ------------------------------------------------------
    def epoch_permutation(self, ep: int) -> torch.Tensor:
        """The epoch's permutation of the global batch's flat examples."""
        n = int(self.dataset.train_data_global.mask.numel())
        g = torch.Generator().manual_seed(self.seed * 1_000_003 + _SHUFFLE_STREAM * 10_007 + ep)
        return torch.randperm(n, generator=g)

    def _shuffled(self, b: Batches, ep: int) -> Batches:
        """The JAX package's ``_shuffle_batches``: a random order of the
        real examples, padding kept at the tail."""
        flat = flat_examples(b)
        perm = self.epoch_permutation(ep).to(flat.mask.device)
        order = torch.sort(1.0 - flat.mask[perm], stable=True).indices
        idx = perm[order]
        return rebatch(Batches(x=flat.x[idx], y=flat.y[idx], mask=flat.mask[idx]),
                       b.num_batches, b.batch_size)

    def _apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "pipeline":
            return self._pp_apply(params, x)
        named = {k.replace("/", "."): v for k, v in params.items()}
        return torch.func.functional_call(self.model.module, named, (x,),
                                          {"positions": self._positions()}, strict=True)

    def _pp_apply(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """``TransformerLM.forward`` with the block stack pipelined (the
        reference's ``_pp_apply``): the embeddings, this rank's stage of
        blocks on the GPipe schedule over the batch's microbatches, the
        final LayerNorm and the head, each run by the model's own module
        on the given params. ``tokens`` are this rank's rows, microbatch-
        major (``_rank_rows``)."""
        from torch.func import functional_call

        from .models.transformer import Rematerialize

        m = self.model.module

        def outer(name: str, x):
            sub = getattr(m, name)
            return functional_call(sub, {leaf: params[f"outer/{name}/{leaf}"]
                                         for leaf, _ in sub.named_parameters()}, (x,))

        B, T = tokens.shape
        x = outer("Embed_0", tokens) + outer("Embed_1", torch.arange(T, device=tokens.device))[None]
        # only stage 0 reads the embeddings: their gradient is summed over
        # the stages (the transpose of the reference's pcast to varying)
        x = copy_to(x, self.groups["pp"])
        names = [k[len("stages/"):] for k in params if k.startswith("stages/")]
        stage = [params[f"stages/{n}"][0] for n in names]  # this rank's [L/S, ...]
        dotted = [n.replace("/", ".") for n in names]
        block = m.Block_0  # every block has Block_0's structure

        def run_block(h, ps):
            return functional_call(block, ps, (h,), strict=True)

        def stage_fn(h):
            for i in range(self.layers_per_stage):
                ps = [t[i] for t in stage]
                if m.remat:  # recompute the block in the backward pass
                    h = Rematerialize.apply(run_block, tuple(dotted), h, *ps)
                else:
                    h = run_block(h, dict(zip(dotted, ps)))
            return h

        M = self._microbatches(B * self.dp)
        out = pipeline_apply(stage_fn, split_microbatches(x, M), self.groups["pp"])
        return outer("Dense_0", outer("LayerNorm_0", out.reshape(x.shape)))

    def _sums(self, params: Params, x, y, m):
        """(masked loss sum, correct, count, per-layer aux losses, slot
        occupancies) of this rank's examples: the model's loss on f32
        logits, as the JAX package computes it, times its count."""
        from .models.moe import collect

        if self.compute_dtype is not None:
            params = _cast_floats(params, self.compute_dtype)
        with collect(self.model.module) as sink:
            logits = self._apply(params, x).to(torch.float32)
        loss, metrics = self.model.loss_fn(logits, y, m)
        return (loss * metrics["count"], metrics["correct"], metrics["count"],
                sink["moe_aux_loss"], sink["moe_slot_occupancy"])

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_(t, self.data_group) if self.data_group is not None else t

    def _step(self, x, y, m) -> torch.Tensor:
        """One optimizer step on this rank's part of a global batch;
        returns its local (nll sum, correct, count)."""
        local = self._width(self.bs // self.accum)
        keys = list(self.params)
        gsum = {k: torch.zeros_like(v) for k, v in self.params.items()}
        sums = torch.zeros(3, dtype=torch.float32, device=self.device)  # nll, correct, count
        occupancy = []
        for j in range(self.accum):
            sl = slice(j * local, (j + 1) * local)
            nll, correct, count, auxes, occ = self._sums(self.params, x[sl], y[sl], m[sl])
            gcount = self._reduce(count.detach().clone())
            loss = nll / gcount.clamp_min(1.0)
            if auxes:
                loss = loss + self.aux_w * (sum(auxes) / len(auxes)).to(torch.float32)
            grads = torch.autograd.grad(loss, [self.params[k] for k in keys])
            for k, g in zip(keys, grads):
                gsum[k] += g * gcount
            sums += torch.stack([nll.detach(), correct, count])
            occupancy.extend(o.detach() for o in occ)
        total = self._reduce(sums.clone())
        if self.data_group is not None:  # one all-reduce of every gradient, flat
            flat = self._reduce(torch.cat([g.reshape(-1) for g in gsum.values()]))
            gsum = dict(zip(keys, (part.view_as(gsum[k]) for k, part in zip(
                keys, flat.split([g.numel() for g in gsum.values()])))))
        denom = total[2].clamp_min(1.0)
        grads = {k: g / denom for k, g in gsum.items()}
        with torch.no_grad():
            updates, self.opt_state = self.optimizer.update(grads, self.opt_state, self.params)
            self.params = {k: (p + updates[k]).requires_grad_() for k, p in self.params.items()}
        self.last_occupancy = occupancy
        return sums

    def _train_epoch(self, ep: int) -> torch.Tensor:
        b = self.dataset.train_data_global
        if bool(getattr(self.args, "shuffle", True)):
            b = self._shuffled(b, ep)
        local = self._local_batches(b, self.bs // self.accum)
        sums = torch.zeros(3, dtype=torch.float32, device=self.device)
        for i in range(local.num_batches):
            sums += self._step(local.x[i], local.y[i], local.mask[i])
        return self._reduce(sums)

    # -- run loop ------------------------------------------------------
    def run(self) -> Dict[str, float]:
        epochs = int(getattr(self.args, "epochs", 1))
        eval_every = int(getattr(self.args, "frequency_of_the_test", 1) or 1)
        stats: Dict[str, float] = {}
        if self._start_epoch > 0 and self._start_epoch >= epochs:
            # resumed at or past the last epoch: nothing to train
            logging.info("resumed at epoch %d >= epochs %d; evaluating only",
                         self._start_epoch, epochs)
            stats = {"epoch": epochs - 1, **self.evaluate()}
            self._report(stats)
            return stats
        for ep in range(self._start_epoch, epochs):
            self._sync()
            t0 = time.perf_counter()
            sums = self._train_epoch(ep).tolist()
            self._sync()
            dt = time.perf_counter() - t0
            count = sums[2]
            stats = {
                "epoch": ep,
                "train_loss": sums[0] / max(count, 1.0),
                "train_acc": sums[1] / max(count, 1.0),
                "epoch_time_s": dt,
                "tokens_per_sec": count / max(dt, 1e-9),
            }
            if (ep + 1) % eval_every == 0 or ep == epochs - 1:
                stats.update(self.evaluate())
            self._report(stats)
            logging.info("distributed epoch %d: %s", ep, stats)
            if self._ckpt and ((ep + 1) % self._ckpt_freq == 0 or ep == epochs - 1):
                state = {"params": self.full_params(), "opt_state": self._full_opt_state(),
                         "epoch": ep}
                if dist.get_rank() == 0:
                    self._ckpt.save(ep, state)
                dist.barrier()
        return stats

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _report(self, stats: Dict[str, float]) -> None:
        if dist.get_rank() == 0:
            self.metrics_reporter.report({"kind": "distributed_train", **stats})

    def evaluate(self) -> Dict[str, float]:
        """Test loss and accuracy over the global test batches, each whole
        batch one forward pass whatever ``grad_accum_steps`` is, as the JAX
        package's ``_evaluate`` does: the MoE routing pool is the whole
        batch across the data group while it runs (training's pool is one
        accumulation chunk)."""
        from .models.moe import set_routing_pool

        glob = self.dataset.test_data_global
        if glob.batch_size != self.bs:
            raise ValueError(f"test batch size {glob.batch_size} is not the training "
                             f"batch size {self.bs}")
        test = self._local_batches(glob, self.bs)
        sums = torch.zeros(3, dtype=torch.float32, device=self.device)
        set_routing_pool(self.model.module, self._pool(self.bs))
        try:
            with torch.no_grad():
                for i in range(test.num_batches):
                    nll, correct, count, _, _ = self._sums(
                        self.params, test.x[i], test.y[i], test.mask[i])
                    sums += torch.stack([nll, correct, count])
        finally:
            set_routing_pool(self.model.module, self._pool(self.bs // self.accum))
        loss_sum, correct, count = self._reduce(sums).tolist()
        return {"test_loss": loss_sum / max(count, 1.0), "test_acc": correct / max(count, 1.0)}
