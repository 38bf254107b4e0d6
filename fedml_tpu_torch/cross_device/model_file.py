"""Portable model-file round trip, the .mnn boundary's analog (port of
``fedml_tpu/cross_device/model_file.py``).

The reference's cross-device servers exchange model files with edge
clients, not pickled state dicts (``server_mnn/utils.py:11-51``). The
file here is framework-neutral: ``.npz`` with slash-joined tree paths as
keys, the JAX package's format, so a file either package writes, the
other reads with equal arrays. A nested tree of arrays round-trips
losslessly. The port's params are already flat under slash-joined names
(``{"fc/weight": tensor}``): they are written as they are and read back
with ``flat=True``.
"""

from __future__ import annotations

import io
from typing import Any, Dict, Mapping

import numpy as np
import torch

_SEP = "/"


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays or tensors -> ``{"a/b/c": numpy array}``,
    in the dict's order."""
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}{_SEP}{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(flatten_tree(val, path))
        elif isinstance(val, torch.Tensor):
            out[path] = val.detach().cpu().numpy()
        else:
            out[path] = np.asarray(val)
    return out


def unflatten_tree(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of ``flatten_tree``: slash-joined keys -> nested
    dicts."""
    out: Dict[str, Any] = {}
    for path, val in flat.items():
        *parents, leaf = path.split(_SEP)
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def params_to_model_bytes(params: Mapping[str, Any]) -> bytes:
    """Serialize a (nested or flat) params dict to npz bytes."""
    buf = io.BytesIO()
    np.savez(buf, **flatten_tree(params))
    return buf.getvalue()


def model_bytes_to_params(data: bytes, flat: bool = False) -> Dict[str, Any]:
    """npz bytes -> the params tree of numpy arrays: nested dicts, or with
    ``flat=True`` the slash-joined keys as they are (the port's
    ``{"fc/weight": ...}`` params)."""
    with np.load(io.BytesIO(data)) as z:
        leaves = {k: z[k] for k in z.files}
    return leaves if flat else unflatten_tree(leaves)


def write_model_file(params: Mapping[str, Any], path: str) -> None:
    with open(path, "wb") as f:
        f.write(params_to_model_bytes(params))


def read_model_file(path: str, flat: bool = False) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return model_bytes_to_params(f.read(), flat=flat)
