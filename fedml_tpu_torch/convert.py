"""Carry flax weights across to the port: ``params_from_flax``.

The JAX package's params are a flax tree; its framework-neutral form is
numpy arrays under slash-joined keys (``cross_device/model_file.py``).
This maps each parameter onto the port's module of the same name:

- ``Dense.kernel`` ``[in, out]`` -> ``Linear.weight`` ``[out, in]``;
- ``Conv.kernel`` ``[kh, kw, in, out]`` -> ``Conv2d.weight``
  ``[out, in, kh, kw]``;
- ``ConvTranspose.kernel`` ``[kh, kw, in, out]`` (a ``ConvTranspose_<k>``
  module, told apart from a ``Conv`` by its name, not its rank) ->
  ``FlaxConvTranspose2d.weight`` ``[in, out, kh, kw]``, flipped in space
  (flax's ``transpose_kernel=False`` correlates where torch's transposed
  convolution convolves);
- a root ``alphas_holder`` (DARTS' architecture parameters) as it is;
- a ``SwitchFFN``'s expert stacks ``wi`` ``[E, C, H]``, ``bi``, ``wo``
  ``[E, H, C]`` and ``bo`` as they are (its ``router`` is a Dense), under
  a ``SwitchFFN_<k>`` module or at the root of a lone layer's tree;
- ``Dense.bias`` and ``LayerNorm.bias`` -> ``bias``;
- ``LayerNorm.scale`` -> ``weight``;
- ``Embed.embedding`` -> ``Embedding.weight``;
- an ``OptimizedLSTMCell_<k>``'s gate kernels ``{ii,if,ig,io}/kernel``
  ``[in, H]`` -> ``ih.weight`` ``[4H, in]`` and ``{hi,hf,hg,ho}/kernel``
  ``[H, H]`` and ``/bias`` -> ``hh.weight`` ``[4H, H]`` and ``hh.bias``
  ``[4H]``, each stacked in i, f, g, o order (``models/rnn.py``).

With it, both packages compute the same function from the same weights.
``stacked=True`` keeps a leading axis on every leaf (one model per
client, FedGKT's personal nets ``[C, ...]``) and maps the rest of each
leaf as above. The distributed trainer's pipeline tree ``{"outer": ...,
"stages": ...}`` maps to the port's pipeline layout: ``outer/<key>``, and
``stages/<key>`` with the two leading axes ``[S, L/S]`` kept.
``opt_state_from_flax`` carries an optax state across: every params tree
in it mapped as above, each named tuple a dict of its fields (an empty
state an empty tuple), as ``core/optimizers.py`` lays its states out.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_SEP = "/"

# flax leaf name -> torch leaf name (Dense kernels are also transposed)
_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}
_LSTM_CELL = "OptimizedLSTMCell_"
_CONV_TRANSPOSE = "ConvTranspose_"
# root leaves carried as they are
_RAW = ("alphas_holder",)
# a routed FFN's expert stacks, carried as they are
_EXPERT_LEAVES = ("wi", "bi", "wo", "bo")
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


def _kernel(key: str, module: str, arr: np.ndarray, lead: int) -> np.ndarray:
    """A flax kernel in the port's layout; the first ``lead`` axes are
    kept as they are."""
    nd = arr.ndim - lead
    keep = tuple(range(lead))
    if nd == 2:
        return arr.transpose(keep + (lead + 1, lead))
    if nd == 4:
        if module.startswith(_CONV_TRANSPOSE):
            arr = np.flip(arr, axis=(lead, lead + 1))
            return arr.transpose(keep + tuple(lead + i for i in (2, 3, 0, 1)))
        return arr.transpose(keep + tuple(lead + i for i in (3, 2, 0, 1)))
    raise ValueError(
        f"flax param {key!r}: {nd}-d kernel; only Dense (2-d) and 2-D Conv and "
        "ConvTranspose (4-d) kernels are ported so far"
    )


_PIPELINE = {"outer", "stages"}


def params_from_flax(tree: Mapping[str, Any], stacked: bool = False) -> Dict[str, torch.Tensor]:
    """A flax params tree (nested dicts, or slash-joined keys, of numpy
    arrays) -> the port's ``{slash/joined/key: Tensor}`` params on the
    CPU; ``stacked`` keeps every leaf's leading axis. Raises
    ``ValueError`` on a leaf this mapping does not know."""
    if set(tree) == _PIPELINE and all(isinstance(v, Mapping) for v in tree.values()):
        out = {f"outer{_SEP}{k}": v for k, v in _convert(tree["outer"], 0).items()}
        out.update({f"stages{_SEP}{k}": v for k, v in _convert(tree["stages"], 2).items()})
        return out
    return _convert(tree, 1 if stacked else 0)


def _is_params(tree: Mapping[str, Any]) -> bool:
    """A flax params tree: nested dicts down to arrays, its top keys
    module names (or the pipeline tree's halves)."""
    return set(tree) == _PIPELINE or (bool(tree) and all(
        isinstance(v, Mapping) or k in _RAW for k, v in tree.items()))


def opt_state_from_flax(state: Any) -> Any:
    """An optax optimizer state -> the port's: params trees through
    ``params_from_flax``, named tuples as dicts of their fields (an empty
    one as ``()``), tuples as tuples, arrays as tensors."""
    if isinstance(state, Mapping):
        if _is_params(state):
            return params_from_flax(state)
        return {k: opt_state_from_flax(v) for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return ({f: opt_state_from_flax(getattr(state, f)) for f in state._fields}
                if state._fields else ())
    if isinstance(state, (tuple, list)):
        return tuple(opt_state_from_flax(v) for v in state)
    return torch.tensor(np.asarray(state))


def _convert(tree: Mapping[str, Any], lead: int) -> Dict[str, torch.Tensor]:
    """``params_from_flax`` with the first ``lead`` axes of every leaf
    kept as they are."""
    out: Dict[str, torch.Tensor] = {}
    cells: Dict[str, Dict[tuple, np.ndarray]] = {}
    stacked = lead > 0
    for key, val in _flatten(tree).items():
        parts = key.split(_SEP)
        if len(parts) >= 3 and parts[-3].startswith(_LSTM_CELL):
            if stacked:
                raise ValueError(f"flax param {key!r}: stacked LSTM cells are not ported")
            if (parts[-2], parts[-1]) not in _LSTM_LEAVES:
                raise ValueError(f"flax param {key!r}: unknown LSTM cell leaf")
            cells.setdefault(_SEP.join(parts[:-2]), {})[(parts[-2], parts[-1])] = np.asarray(val)
            continue
        if key in _RAW:
            out[key] = torch.tensor(np.ascontiguousarray(np.asarray(val)))
            continue
        path, _, leaf = key.rpartition(_SEP)
        if leaf in _EXPERT_LEAVES and (not path or path.rpartition(_SEP)[2].startswith(
                "SwitchFFN_")):
            out[key] = torch.tensor(np.ascontiguousarray(np.asarray(val)))
            continue
        if leaf not in _LEAVES:
            raise ValueError(f"flax param {key!r}: unknown leaf {leaf!r}")
        arr = np.asarray(val)
        if leaf == "kernel":
            arr = _kernel(key, path.rpartition(_SEP)[2], arr, lead)
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
