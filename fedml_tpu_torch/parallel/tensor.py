"""Tensor parallelism: the Megatron layout of the TransformerLM (port of
``fedml_tpu/parallel/tensor.py``).

The leaf rules are the JAX package's, in torch's ``[out, in]`` layout:

- qkv projection (``Block_*/Dense_0``): column-parallel, the weight and
  bias split on the output dim;
- attention output (``Block_*/Dense_1``): row-parallel, the weight split
  on the input dim, the bias replicated (added after the all-reduce);
- MLP up (``Block_*/Dense_2``) column-parallel, MLP down
  (``Block_*/Dense_3``) row-parallel;
- LM head (top-level ``Dense_0``): column-parallel over the vocabulary;
- embeddings, LayerNorms and a routed FFN's router: replicated.

Where the JAX package lets XLA's SPMD partitioner place the collectives,
the port runs explicit column- and row-parallel products
(``models/transformer.py``): ``copy_to`` where a replicated activation
enters a column-parallel product, ``reduce_from`` (the all-reduce) after
each row-parallel one, ``gather_from`` over the head's vocabulary shards.
So a rank must hold whole heads: the qkv projection's output dim is split
per head group, rank r holding the q, k and v columns of heads [r*H/tp,
(r+1)*H/tp) (``Shard.parts = 3``), and a block's attention pair is
sharded only when tp divides the heads. Dims that do not divide the tp
axis fall back to replicated, as in the JAX package, a block's attention
pair, its MLP pair and the head each as one: the function computed is the
same either way.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .collectives import all_gather_list

_BLOCK_DENSE_RULES = {
    "Dense_0": "column",  # qkv
    "Dense_1": "row",     # attention output proj
    "Dense_2": "column",  # mlp up
    "Dense_3": "row",     # mlp down
}


@dataclasses.dataclass(frozen=True)
class Shard:
    """A leaf split on ``dim`` over mesh axis ``axis``; with ``parts`` >
    1 the dim is ``parts`` equal parts (q, k, v) each split on its own."""

    axis: str
    dim: int
    parts: int = 1


@dataclasses.dataclass(frozen=True)
class TensorShard:
    """A block's (or the head's) tensor-parallel state: the tp group,
    its size, and which of its pairs are sharded."""

    group: object
    size: int
    attn: bool = False
    mlp: bool = False


def _spec_for(key: str, axis: str) -> Optional[Shard]:
    names = key.split("/")
    in_block = any("Block_" in n for n in names)
    dense = next((n for n in names if n.startswith("Dense_")), None)
    kind = names[-1]  # "weight" | "bias"
    if dense is None:
        return None  # embeddings, layernorms, the router
    if in_block:
        rule = _BLOCK_DENSE_RULES.get(dense)
        if rule is None:
            return None
    else:
        rule = "column"  # top-level LM head: vocab-sharded
    parts = 3 if in_block and dense == "Dense_0" else 1
    if rule == "column":
        return Shard(axis, 0, parts)
    # row-parallel: the bias is added after the all-reduce, replicated
    return Shard(axis, 1) if kind == "weight" else None


def tp_specs(params: Dict[str, torch.Tensor], axis: str = "tp") -> Dict[str, Optional[Shard]]:
    """Each leaf's Megatron shard (None: replicated), by the leaf rules
    alone."""
    return {key: _spec_for(key, axis) for key in params}


def _pair_ok(params, keys, size: int) -> bool:
    return all(params[k].shape[s.dim] % (s.parts * size) == 0 for k, s in keys)


def tp_layout(params: Dict[str, torch.Tensor], sizes: Dict[str, int], num_heads: int,
              axis: str = "tp") -> Dict[str, Optional[Shard]]:
    """``tp_specs`` with the fallbacks: a mesh without the axis replicates
    everything; a block's attention pair is sharded only when the axis
    divides its heads, its MLP pair and the head only when it divides
    every split dim."""
    specs = tp_specs(params, axis)
    size = sizes.get(axis, 1)
    if axis not in sizes:
        return {key: None for key in specs}
    groups: Dict[str, list] = {}
    for key, spec in specs.items():
        if spec is None:
            continue
        prefix, _, _ = key.rpartition("/")
        block, _, dense = prefix.rpartition("/")
        unit = (block, "attn" if dense in ("Dense_0", "Dense_1") else "mlp") if block else ("", "head")
        groups.setdefault(unit, []).append((key, spec))
    out = dict(specs)
    for (block, kind), keys in groups.items():
        ok = _pair_ok(params, keys, size) and (kind != "attn" or num_heads % size == 0)
        if not ok:
            for key, _ in keys:
                out[key] = None
    return out


def local_shard(full: torch.Tensor, shard: Optional[Shard], rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s piece of ``full`` (itself when replicated)."""
    if shard is None:
        return full
    parts = full.chunk(shard.parts, dim=shard.dim)
    return torch.cat([p.chunk(size, dim=shard.dim)[rank] for p in parts],
                     dim=shard.dim).contiguous()


def gather_full(local: torch.Tensor, shard: Optional[Shard], group) -> torch.Tensor:
    """The whole leaf from every rank's piece (``local`` when replicated)."""
    if shard is None:
        return local
    pieces = [p.chunk(shard.parts, dim=shard.dim) for p in all_gather_list(local, group)]
    return torch.cat([torch.cat([p[i] for p in pieces], dim=shard.dim)
                      for i in range(shard.parts)], dim=shard.dim)


def attach_tp(module, layout: Dict[str, Optional[Shard]], group, size: int) -> None:
    """Give each block and the head of a TransformerLM ``module`` its
    ``TensorShard`` from ``layout`` (a no-op for replicated ones)."""
    for i in range(module.num_layers):
        block = getattr(module, f"Block_{i}")
        attn = layout.get(f"Block_{i}/Dense_0/weight") is not None
        mlp = layout.get(f"Block_{i}/Dense_2/weight") is not None
        block.tp = TensorShard(group, size, attn, mlp) if attn or mlp else None
    module.tp_head = (TensorShard(group, size) if layout.get("Dense_0/weight") is not None
                      else None)
