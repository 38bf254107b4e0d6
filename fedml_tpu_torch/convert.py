"""Carry flax weights across to the port: ``params_from_flax``.

The JAX package's params are a flax tree; its framework-neutral form is
numpy arrays under slash-joined keys (``cross_device/model_file.py``).
This maps each parameter onto the port's module of the same name:

- ``Dense.kernel`` ``[in, out]`` -> ``Linear.weight`` ``[out, in]``;
- ``Conv.kernel`` ``[kh, kw, in, out]`` -> ``Conv2d.weight``
  ``[out, in, kh, kw]``;
- ``Dense.bias`` and ``LayerNorm.bias`` -> ``bias``;
- ``LayerNorm.scale`` -> ``weight``;
- ``Embed.embedding`` -> ``Embedding.weight``;
- an ``OptimizedLSTMCell_<k>``'s gate kernels ``{ii,if,ig,io}/kernel``
  ``[in, H]`` -> ``ih.weight`` ``[4H, in]`` and ``{hi,hf,hg,ho}/kernel``
  ``[H, H]`` and ``/bias`` -> ``hh.weight`` ``[4H, H]`` and ``hh.bias``
  ``[4H]``, each stacked in i, f, g, o order (``models/rnn.py``).

With it, both packages compute the same function from the same weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_SEP = "/"

# flax leaf name -> torch leaf name (Dense kernels are also transposed)
_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}
_LSTM_CELL = "OptimizedLSTMCell_"
_GATES = "ifgo"
# an LSTM cell's flax leaves, (gate module, leaf): the input kernels have
# no bias
_LSTM_LEAVES = {(f"i{g}", "kernel") for g in _GATES} | {
    (f"h{g}", leaf) for g in _GATES for leaf in ("kernel", "bias")
}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}{_SEP}{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path))
        else:
            flat[path] = val
    return flat


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax params tree (nested dicts, or slash-joined keys, of numpy
    arrays) -> the port's ``{slash/joined/key: Tensor}`` params on the
    CPU. Raises ``ValueError`` on a leaf this mapping does not know."""
    out: Dict[str, torch.Tensor] = {}
    cells: Dict[str, Dict[tuple, np.ndarray]] = {}
    for key, val in _flatten(tree).items():
        parts = key.split(_SEP)
        if len(parts) >= 3 and parts[-3].startswith(_LSTM_CELL):
            if (parts[-2], parts[-1]) not in _LSTM_LEAVES:
                raise ValueError(f"flax param {key!r}: unknown LSTM cell leaf")
            cells.setdefault(_SEP.join(parts[:-2]), {})[(parts[-2], parts[-1])] = np.asarray(val)
            continue
        path, _, leaf = key.rpartition(_SEP)
        if leaf not in _LEAVES:
            raise ValueError(f"flax param {key!r}: unknown leaf {leaf!r}")
        arr = np.asarray(val)
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(
                    f"flax param {key!r}: {arr.ndim}-d kernel; only Dense "
                    "(2-d) and 2-D Conv (4-d) kernels are ported so far"
                )
        name = f"{path}{_SEP}{_LEAVES[leaf]}" if path else _LEAVES[leaf]
        out[name] = torch.tensor(np.ascontiguousarray(arr))
    for cell, leaves in cells.items():
        missing = sorted(_SEP.join(k) for k in _LSTM_LEAVES - set(leaves))
        if missing:
            raise ValueError(f"flax LSTM cell {cell!r}: missing {missing}")

        def stack(kind, leaf):
            return np.concatenate([leaves[(f"{kind}{g}", leaf)].T for g in _GATES])

        out[f"{cell}{_SEP}ih{_SEP}weight"] = torch.tensor(stack("i", "kernel"))
        out[f"{cell}{_SEP}hh{_SEP}weight"] = torch.tensor(stack("h", "kernel"))
        out[f"{cell}{_SEP}hh{_SEP}bias"] = torch.tensor(stack("h", "bias"))
    return out
