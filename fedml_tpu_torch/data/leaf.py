"""LEAF-format federated dataset reader (port of ``fedml_tpu/data/leaf.py``).

Plain numpy, kept as the port's own copy: the arrays are bitwise the
JAX package's for the same files. The text below is the JAX package's
own.

Reference: ``data/MNIST/data_loader.py`` (``read_data``/``batch_data``
semantics, :30-99) and the FederatedEMNIST/shakespeare loaders — the
LEAF benchmark stores NATURALLY federated splits as JSON:

    {"users": [...], "num_samples": [...],
     "user_data": {user_id: {"x": [...], "y": [...]}}}

across one or more ``.json`` files per split directory. Reading LEAF
keeps the real per-user partition instead of a synthetic LDA split —
the canonical "natural non-IID" setting.

Layout expected under ``<data_cache_dir>/<dataset>/``:
``train/*.json`` and ``test/*.json`` (the reference's auto-downloaded
archive layout, data/MNIST/data_loader.py:17-29).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def read_leaf_dir(split_dir: str) -> Tuple[List[str], Dict[str, dict]]:
    """All users + user_data merged across the split's json files
    (read_data, data_loader.py:30-55)."""
    users: List[str] = []
    user_data: Dict[str, dict] = {}
    for path in sorted(glob.glob(os.path.join(split_dir, "*.json"))):
        with open(path) as f:
            blob = json.load(f)
        users.extend(blob["users"])
        user_data.update(blob["user_data"])
    return users, user_data


def _to_arrays(entry: dict, feature_shape: Optional[Tuple[int, ...]]):
    x = np.asarray(entry["x"], dtype=np.float32)
    y = np.asarray(entry["y"])
    if feature_shape is not None and len(x) == 0:
        # an empty user entry parses as shape (0,) — give it the real
        # feature shape or downstream concatenation dies
        x = np.zeros((0,) + tuple(feature_shape), np.float32)
    elif feature_shape is not None and x.ndim == 2:
        x = x.reshape((len(x),) + tuple(feature_shape))
    if y.dtype.kind in "fc":
        y = y.astype(np.int64)
    return x, y


def load_leaf(
    root: str,
    feature_shape: Optional[Tuple[int, ...]] = None,
    max_users: Optional[int] = None,
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """Per-user train/test arrays in a stable user order. Users missing
    from the test split get an empty test set (LEAF guarantees matching
    users, but partial downloads happen)."""
    train_users, train_data = read_leaf_dir(os.path.join(root, "train"))
    _, test_data = read_leaf_dir(os.path.join(root, "test"))
    if max_users is not None:
        train_users = train_users[:max_users]
    xs_tr, ys_tr, xs_te, ys_te = [], [], [], []
    for u in train_users:
        x, y = _to_arrays(train_data[u], feature_shape)
        xs_tr.append(x)
        ys_tr.append(y)
        if u in test_data:
            xt, yt = _to_arrays(test_data[u], feature_shape)
        else:
            xt = np.zeros((0,) + x.shape[1:], np.float32)
            yt = np.zeros((0,), np.int64)
        xs_te.append(xt)
        ys_te.append(yt)
    return xs_tr, ys_tr, xs_te, ys_te


def leaf_available(root: str) -> bool:
    return bool(glob.glob(os.path.join(root, "train", "*.json")))
