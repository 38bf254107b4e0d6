"""Carry flax weights across to the port: ``params_from_flax``.

The JAX package's params are a flax tree; its framework-neutral form is
numpy arrays under slash-joined keys (``cross_device/model_file.py``).
This maps each parameter onto the port's module of the same name:

- ``Dense.kernel`` ``[in, out]`` -> ``Linear.weight`` ``[out, in]``;
- ``Conv.kernel`` ``[kh, kw, in, out]`` -> ``Conv2d.weight``
  ``[out, in, kh, kw]``;
- ``Dense.bias`` and ``LayerNorm.bias`` -> ``bias``;
- ``LayerNorm.scale`` -> ``weight``;
- ``Embed.embedding`` -> ``Embedding.weight``.

With it, both packages compute the same function from the same weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_SEP = "/"

# flax leaf name -> torch leaf name (Dense kernels are also transposed)
_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}


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
    for key, val in _flatten(tree).items():
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
    return out
