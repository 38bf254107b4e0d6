"""Beehive check-in protocol: the payloads gateway and device share
(port of ``fedml_tpu/cross_device/protocol.py``).

Everything both ends of the connectionless plane must agree on byte for
byte, all of it host numpy, the same bytes as the JAX module's on the
same inputs:

- the linear device model template and its flat field layout (the
  pairwise masks live on the flattened update, so both ends flatten in
  the same leaf order: ``b``, then ``w``);
- the int8 offer codec (``core/compression.Int8Codec``): the offer is
  lossy by design, and the masked and unmasked worlds train from the
  same decoded tree, one of the two legs of their bitwise identity;
- the participant-roster and share-reveal packing (numpy columns; no
  pickled object crosses the fabric).

A roster is a pair of int64 columns and a reveal a (point, value) table:
the gateway's per-device state is bounded by the cohort.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..core.compression import Int8Codec

Params = Dict[str, Any]

__all__ = [
    "linear_template",
    "flat_dim",
    "encode_offer_params",
    "decode_offer_params",
    "pack_participants",
    "unpack_participants",
    "pack_reveals",
    "unpack_reveals",
]


# -- device model ----------------------------------------------------------


def linear_template(feature_dim: int, class_num: int) -> Params:
    """The device model: one linear softmax classifier, zeros (every
    world starts from the same params)."""
    return {
        "b": np.zeros((int(class_num),), np.float32),
        "w": np.zeros((int(feature_dim), int(class_num)), np.float32),
    }


def flat_dim(feature_dim: int, class_num: int) -> int:
    """Length of the flattened update vector the field math runs on."""
    return int(feature_dim) * int(class_num) + int(class_num)


# -- offer codec (int8 over the wire) --------------------------------------


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def encode_offer_params(params: Params) -> Dict[str, Dict[str, np.ndarray]]:
    """Global params -> int8 wire tree ``{leaf: {"q", "scale"}}`` of host
    numpy."""
    enc = Int8Codec.encode({k: torch.as_tensor(_host(v)) for k, v in params.items()})
    return {k: {f: _host(t) for f, t in leaf.items()} for k, leaf in enc.items()}


def decode_offer_params(encoded) -> Dict[str, np.ndarray]:
    """int8 wire tree -> float32 params (host numpy)."""
    dec = Int8Codec.decode({
        k: {f: torch.as_tensor(_host(t)) for f, t in leaf.items()}
        for k, leaf in encoded.items()
    })
    return {k: _host(v) for k, v in dec.items()}


# -- participant roster ----------------------------------------------------


def pack_participants(participants: Dict[int, int]) -> Dict[str, np.ndarray]:
    """{device_id: mask pubkey} -> two aligned int64 columns, sorted by
    device id. The sorted order is normative: Shamir share points are
    positions in this roster (the device at position k holds point
    k+1)."""
    ids = np.fromiter(sorted(participants), dtype=np.int64)
    pubs = np.asarray([participants[int(i)] for i in ids], dtype=np.int64)
    return {"ids": ids, "pubs": pubs}


def unpack_participants(payload: Dict[str, np.ndarray]) -> Dict[int, int]:
    ids = np.asarray(payload["ids"], dtype=np.int64)
    pubs = np.asarray(payload["pubs"], dtype=np.int64)
    return {int(i): int(p) for i, p in zip(ids, pubs)}


# -- share reveals ---------------------------------------------------------


def pack_reveals(reveals: Dict[int, List[Tuple[int, int]]]) -> Dict[str, np.ndarray]:
    """{vanished_id: [(point, share_value), ...]} -> one int64 table
    ``[n, 3]`` of (vanished_id, point, value) rows."""
    rows = [
        (int(v), int(point), int(val))
        for v, pairs in sorted(reveals.items())
        for point, val in pairs
    ]
    return {"table": np.asarray(rows, dtype=np.int64).reshape(len(rows), 3)}


def unpack_reveals(payload: Dict[str, np.ndarray]) -> Dict[int, List[Tuple[int, int]]]:
    out: Dict[int, List[Tuple[int, int]]] = {}
    for v, point, val in np.asarray(payload["table"], dtype=np.int64):
        out.setdefault(int(v), []).append((int(point), int(val)))
    return out
