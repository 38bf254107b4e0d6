"""Uplink update compression (port of ``fedml_tpu/core/compression.py``).

Two codecs over an update delta (a params dict ``{name: tensor}``):

- ``int8``: per-leaf symmetric linear quantization, ``scale =
  max|x| * fl32(1/127)``, ``q = clamp(round(x / scale), -127, 127)`` (an all-zero
  leaf has scale 0 and decodes to zeros). ``torch.round`` and
  ``jnp.round`` both round half to even, so ``q`` and ``scale`` are
  bitwise the JAX package's. Torch ops (a max-abs, a divide, a round, a
  clamp), not a kernel.
- ``topk``: global magnitude top-k over the leaves laid end to end (the
  params dict's order), indices as int32 and values f32, with the
  client's error feedback (``EncoderState``). Ties: ``jax.lax.top_k``
  keeps the lower index of two equal magnitudes; ``torch.topk`` does not
  promise an order among equals, so the two packages may keep different
  coordinates of tied magnitudes. On distinct magnitudes the kept sets
  and the decoded deltas are the same.

A server decodes a payload against the pre-round global dict
(``decode_delta``, ``reconstruct_from_encoded``); the streaming fold
decodes, clips and weights in one pass instead
(``core/aggregation.py``, K3).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

Params = Dict[str, torch.Tensor]

COMPRESSION_NONE = "none"
COMPRESSION_INT8 = "int8"
COMPRESSION_TOPK = "topk"


# XLA compiles the JAX package's ``max|x| / 127.0`` into a multiply by the
# f32 reciprocal of 127 (one ulp off the divide for ~5% of inputs); the
# port multiplies by the same constant, so its scales are bitwise those
_INV_127 = float(np.float32(1.0 / 127.0))


def _leaf_encode_int8(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    x = x.to(torch.float32)
    scale = x.abs().max() * _INV_127 if x.numel() else torch.zeros((), device=x.device)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32)}


def _leaf_decode_int8(enc: Dict[str, torch.Tensor]) -> torch.Tensor:
    return enc["q"].to(torch.float32) * enc["scale"]


class Int8Codec:
    """Per-leaf symmetric int8 quantization; deterministic."""

    name = COMPRESSION_INT8

    @staticmethod
    def encode(delta: Params) -> Dict[str, Dict[str, torch.Tensor]]:
        return {k: _leaf_encode_int8(v) for k, v in delta.items()}

    @staticmethod
    def decode(encoded) -> Params:
        return {k: _leaf_decode_int8(v) for k, v in encoded.items()}


def _flat(tree: Params) -> torch.Tensor:
    return torch.cat([v.reshape(-1).to(torch.float32) for v in tree.values()])


def _unflat(flat: torch.Tensor, like: Params) -> Params:
    out, off = {}, 0
    for k, v in like.items():
        out[k] = flat[off:off + v.numel()].reshape(v.shape)
        off += v.numel()
    return out


class TopKCodec:
    """Global magnitude top-k over the flattened update (``ratio`` the
    kept fraction), one ``torch.topk`` over the leaves end to end, so
    small leaves spend no budget of their own."""

    name = COMPRESSION_TOPK

    def __init__(self, ratio: float) -> None:
        if not 0.0 < ratio <= 1.0:
            raise ValueError(f"topk ratio must be in (0, 1], got {ratio}")
        self.ratio = float(ratio)

    def encode(self, delta: Params) -> Dict[str, torch.Tensor]:
        flat = _flat(delta)
        k = max(1, int(round(flat.numel() * self.ratio)))
        _, idx = torch.topk(flat.abs(), k)
        return {"idx": idx.to(torch.int32), "val": flat[idx]}

    def decode(self, encoded: Dict[str, torch.Tensor], like: Params) -> Params:
        """Scatter the kept coordinates into a dict shaped like ``like``
        (the receiver has the global dict for shapes)."""
        flat = self.decode_flat(encoded, sum(v.numel() for v in like.values()),
                                next(iter(like.values())).device)
        return _unflat(flat, like)

    @staticmethod
    def decode_flat(encoded: Dict[str, torch.Tensor], numel: int, device) -> torch.Tensor:
        """The decoded delta as one ``[numel]`` f32 tensor (the flat layout)."""
        flat = torch.zeros(numel, dtype=torch.float32, device=device)
        flat[encoded["idx"].to(device=device, dtype=torch.int64)] = encoded["val"].to(
            device=device, dtype=torch.float32)
        return flat


class EncoderState:
    """Client-side error feedback: what the codec dropped this round is
    added to the next round's update before encoding (top-k only; int8's
    rounding error is ~scale/2 a coordinate and carries no state)."""

    def __init__(self, codec) -> None:
        self.codec = codec
        self.residual: Optional[Params] = None

    def encode(self, delta: Params):
        if isinstance(self.codec, Int8Codec):
            return self.codec.encode(delta)
        if self.residual is None:
            self.residual = {k: torch.zeros_like(v) for k, v in delta.items()}
        corrected = {k: delta[k] + self.residual[k] for k in delta}
        enc = self.codec.encode(corrected)
        sent = self.codec.decode(enc, corrected)
        self.residual = {k: corrected[k] - sent[k] for k in corrected}
        return enc


def make_codec(args):
    """``args.compression`` -> codec instance (or None)."""
    kind = str(getattr(args, "compression", COMPRESSION_NONE) or COMPRESSION_NONE)
    if kind == COMPRESSION_NONE:
        return None
    if kind == COMPRESSION_INT8:
        return Int8Codec()
    if kind == COMPRESSION_TOPK:
        return TopKCodec(float(getattr(args, "compression_topk_ratio", 0.01)))
    raise ValueError(f"unknown compression '{kind}'")


def payload_matches_codec(codec, encoded) -> bool:
    """Does this payload look like ``codec``'s? Lets a receiver detect
    int8-against-topk configuration skew before decoding. A top-k payload
    holds at least ``idx`` and ``val`` (extra keys from an older peer are
    tolerated)."""
    is_topk = isinstance(encoded, dict) and {"idx", "val"} <= set(encoded.keys())
    if isinstance(codec, TopKCodec):
        return is_topk
    if isinstance(codec, Int8Codec):
        return not is_topk
    return False


def decode_delta(codec, encoded, like: Params) -> Params:
    """Server-side decode; dispatches on the codec's kind."""
    if isinstance(codec, TopKCodec):
        return codec.decode(encoded, like)
    return codec.decode(encoded)


def reconstruct_from_encoded(codec, encoded, like: Params) -> Params:
    """``like + decode(encoded)``: the full model a buffered aggregation
    needs. The streaming fold never calls this: it decodes, reconstructs
    and weights in one pass (``core/aggregation.py``)."""
    delta = decode_delta(codec, encoded, like)
    return {k: like[k] + delta[k] for k in like}


def encoded_nbytes(encoded) -> int:
    """Wire size of an encoded payload (the sum of its buffers' bytes)."""
    if isinstance(encoded, torch.Tensor):
        return int(encoded.numel() * encoded.element_size())
    if isinstance(encoded, dict):
        return sum(encoded_nbytes(v) for v in encoded.values())
    return int(np.asarray(encoded).nbytes)
