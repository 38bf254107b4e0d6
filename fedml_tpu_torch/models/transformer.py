"""Decoder-only transformer LM (port of ``fedml_tpu/models/transformer.py``).

Pre-LN blocks with a pluggable attention implementation:

- ``attention="full"``  — dense (``parallel.sequence.full_attention``)
- ``attention="flash"`` — the hand-written Hopper flash kernel
  (``ops.flash_attention``)
- ``attention="ring"`` / ``"ulysses"`` — built by the distributed
  trainer over its ``sp`` group (``parallel.sequence``) and passed in as
  ``attn_fn``; ``forward(tokens, positions)`` then takes each rank's
  global positions.

``make_block(i, attn, ffn=...)`` builds layer ``i``; ``ffn`` swaps the
MLP for a routed one (``models.moe.MoETransformerLM``). Under tensor
parallelism (``parallel/tensor.py`` sets ``Block.tp`` and
``TransformerLM.tp_head``) a block holds its heads' share of ``Dense_0``
and ``Dense_1`` and its share of the MLP, and the head its share of the
vocabulary, with the all-reduce after each row-parallel product.

Module names are the flax module names (``Embed_0``, ``Block_i``,
``Dense_0`` ...), so ``convert.params_from_flax`` maps a JAX checkpoint
onto these modules key for key. Three details match flax exactly, each
worth a small but real mismatch otherwise: ``LayerNorm`` uses epsilon
1e-6 and the fast variance E[x²]−E[x]²; ``gelu`` is the tanh
approximation; ``Dense_0``'s output splits into q, k, v in that order
along the last axis, each then viewed as [B, T, H, D].

``remat=True`` rematerializes each block (the JAX package's
``nn.remat(Block)``, with the same parameter names): the block runs
under :class:`Rematerialize`, which keeps only the block's inputs for
the backward and recomputes its forward there. ``torch.utils.checkpoint``
cannot serve: its saved-tensor hooks are refused under ``torch.func.grad``,
which the trainer's vmapped step is.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import copy_to, gather_from, reduce_from


def _dense_attention(q, k, v):
    from ..parallel.sequence import full_attention

    return full_attention(q, k, v, causal=True)


def _flash(q, k, v):
    from ..ops.flash_attention import flash_attention, pick_block

    # explicit attention="flash" engages the kernel at any block size
    # (minimum=1)
    b = pick_block(q.shape[1], minimum=1)
    return flash_attention(q, k, v, True, None, b, b)


def resolve_attention(name_or_fn) -> Callable:
    if callable(name_or_fn):
        return name_or_fn
    table = {"full": _dense_attention, "flash": _flash}
    if name_or_fn not in table:
        raise ValueError(
            f"attention {name_or_fn!r}: only {sorted(table)} resolve by name; "
            "'ring'/'ulysses' are mesh-sharded — build them with "
            "parallel.sequence.make_sequence_sharded_attention(group, ...) "
            "and pass the callable as attn_fn"
        )
    return table[name_or_fn]


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm``: statistics in f32 (float64 for a float64
    input), the fast variance E[x²]−E[x]² clipped at zero, epsilon 1e-6."""

    def __init__(self, dim: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


class Block(nn.Module):
    """Pre-LN block: attention, then a tanh-gelu MLP, or the module
    ``ffn()`` builds in its place (named after its class, ``SwitchFFN_0``,
    as flax names it)."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        attn_fn: Callable = _dense_attention,
        mlp_ratio: int = 4,
        ffn: Optional[Callable[[], nn.Module]] = None,
    ) -> None:
        super().__init__()
        C = embed_dim
        self.num_heads = num_heads
        self.attn_fn = attn_fn
        self.tp = None  # parallel.tensor.TensorShard
        self.LayerNorm_0 = LayerNorm(C)
        self.Dense_0 = nn.Linear(C, 3 * C)
        self.Dense_1 = nn.Linear(C, C)
        self.LayerNorm_1 = LayerNorm(C)
        self.ffn_name = None
        if ffn is not None:
            module = ffn()
            self.ffn_name = f"{type(module).__name__}_0"
            self.add_module(self.ffn_name, module)
        else:
            self.Dense_2 = nn.Linear(C, mlp_ratio * C)
            self.Dense_3 = nn.Linear(mlp_ratio * C, C)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        tp = self.tp
        # under tp a sharded pair holds this rank's share: Dense_0 its
        # heads' q, k and v columns and Dense_1 the matching input rows,
        # Dense_2 its hidden columns and Dense_3 their rows
        attn_group = tp.group if tp is not None and tp.attn else None
        mlp_group = tp.group if tp is not None and tp.mlp else None
        width = C // tp.size if attn_group is not None else C
        h = self.LayerNorm_0(x)
        q, k, v = self.Dense_0(copy_to(h, attn_group)).split(width, dim=-1)
        heads = self.num_heads * width // C
        shape = (B, T, heads, width // heads)
        o = self.attn_fn(q.reshape(shape), k.reshape(shape), v.reshape(shape))
        x = x + _row_parallel(self.Dense_1, o.reshape(B, T, width), attn_group)
        h = self.LayerNorm_1(x)
        if self.ffn_name is not None:
            return x + getattr(self, self.ffn_name)(h)
        h = F.gelu(self.Dense_2(copy_to(h, mlp_group)), approximate="tanh")
        return x + _row_parallel(self.Dense_3, h, mlp_group)


def _row_parallel(dense: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """``dense(x)``; with a tp ``group``, ``x`` and the weight's input
    rows are this rank's share, and the partial products are summed over
    the group before the bias is added once. (The unsharded path keeps
    ``dense``'s own fused bias add: in bf16 a separate add would round
    twice and move the FedAvg path's results.)"""
    if group is None:
        return dense(x)
    return reduce_from(F.linear(x, dense.weight), group) + dense.bias


class Rematerialize(torch.autograd.Function):
    """``fn(x, params)`` with nothing saved for the backward but its
    inputs: the backward runs ``fn`` again under ``torch.func.vjp`` and
    pulls the gradient through that recomputation. A new-style function
    with a generated ``vmap`` rule, so it runs under the trainer's
    ``vmap(grad)``; inside, the flash functions' own ``vmap`` rules
    still fold the cohort into one kernel launch (per layer: the
    forward, the recomputed forward, and the backward). The recomputed
    forward is the same arithmetic on the same inputs, so the gradients
    are bitwise those without remat.

    ``apply(fn, names, x, *tensors)``: ``params = dict(zip(names,
    tensors))``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, names, x, *tensors):
        return fn(x, dict(zip(names, tensors)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, names, x, *tensors = inputs
        ctx.fn, ctx.names = fn, names
        ctx.save_for_backward(x, *tensors)

    @staticmethod
    def backward(ctx, g):
        # detached: the recomputation is differentiated by its own vjp
        # only. Left attached, the enclosing autograd (which torch.func.grad
        # runs with create_graph) would record it too and keep every
        # block's recomputed activations alive to the end of the backward
        x, *tensors = (t.detach() for t in ctx.saved_tensors)
        _, pull = torch.func.vjp(
            lambda x, ts: ctx.fn(x, dict(zip(ctx.names, ts))), x, tuple(tensors)
        )
        gx, gts = pull(g)
        return (None, None, gx, *gts)


def remat_block(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` under :class:`Rematerialize`, its current parameters
    (the tensors a ``functional_call`` put in) passed in explicitly so
    that their gradients flow."""
    names, tensors = zip(*block.named_parameters())
    return Rematerialize.apply(
        lambda x, params: torch.func.functional_call(block, params, (x,), strict=True),
        names, x, *tensors,
    )


def checkpoint_block(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` under ``torch.utils.checkpoint`` (non-reentrant): the
    remat of plain autograd (the distributed trainer), where what the
    block records on the way (a routed FFN's aux loss) keeps its
    gradient. ``remat_block`` serves ``torch.func``."""
    import torch.utils.checkpoint

    return torch.utils.checkpoint.checkpoint(block, x, use_reentrant=False)


class TransformerLM(nn.Module):
    """Causal LM: tokens [B, T] -> logits [B, T, vocab]."""

    def __init__(
        self,
        vocab_size: int,
        num_layers: int = 2,
        num_heads: int = 4,
        embed_dim: int = 128,
        max_len: int = 512,
        attention: str = "full",
        attn_fn: Optional[Callable] = None,
        remat: bool = False,
    ) -> None:
        super().__init__()
        attn = attn_fn or resolve_attention(attention)
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.embed_dim = embed_dim
        self.remat = remat
        # how a remat block runs: remat_block under torch.func (the FedAvg
        # trainer), checkpoint_block under plain autograd
        self.remat_fn = remat_block
        self.tp_head = None  # parallel.tensor.TensorShard: vocab-sharded head
        self.Embed_0 = nn.Embedding(vocab_size, embed_dim)
        self.Embed_1 = nn.Embedding(max_len, embed_dim)
        for i in range(num_layers):
            self.add_module(f"Block_{i}", self.make_block(i, attn))
        self.LayerNorm_0 = LayerNorm(embed_dim)
        self.Dense_0 = nn.Linear(embed_dim, vocab_size)

    def make_block(self, i: int, attn: Callable, ffn: Optional[Callable] = None) -> Block:
        """Layer ``i``'s block; a subclass overrides it and passes ``ffn``
        (a factory of the FFN module) back here."""
        return Block(self.embed_dim, self.num_heads, attn, ffn=ffn)

    def set_attention(self, attn_fn: Callable) -> None:
        """Every block's attention, e.g. the sequence-sharded one."""
        for i in range(self.num_layers):
            getattr(self, f"Block_{i}").attn_fn = attn_fn

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``positions`` [T] are the tokens' global positions (a sequence
        shard's, in the sequence mode); default ``arange(T)``."""
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.Embed_0(tokens)
        x = x + self.Embed_1(positions)[None]
        for i in range(self.num_layers):
            block = getattr(self, f"Block_{i}")
            x = self.remat_fn(block, x) if self.remat else block(x)
        h = self.LayerNorm_0(x)
        # under tp, this rank's vocabulary columns, gathered for the loss
        # every rank computes
        group = None if self.tp_head is None else self.tp_head.group
        return gather_from(self.Dense_0(copy_to(h, group)), -1, group)
