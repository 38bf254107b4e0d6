"""Poisoned and backdoor datasets (port of ``fedml_tpu/data/poison.py``).

The attacker clients of the reference fork's robustness experiments
(``data/edge_case_examples/data_loader.py``) train on examples
relabelled to a target class, some carrying a trigger or an edge-case
(out-of-distribution) pattern. Host numpy throughout, drawn from
``np.random.RandomState(seed)``, so every attack is bitwise the JAX
package's:

- ``label_flip``       — y -> (y + 1) % C  (untargeted poisoning)
- ``targeted_flip``    — y[source] -> target
- ``backdoor_pattern`` — a bottom-right trigger patch stamped on a
  fraction of the images, which are relabelled to the target (BadNets)
- ``edge_case``        — out-of-distribution samples labelled as the
  target: the reference's real edge-case images when its downloaded
  ``edge_case_examples`` archive sits under ``data_cache_dir``, else
  far-tail noise (``3 + N(0, 0.5)``)

``poison_clients`` applies an attack to a subset of a federation's
clients (seed ``1000 + client index``): the world S-FedAvg, HS-FedAvg
and the robust aggregators defend against.
"""

from __future__ import annotations

import functools
import logging
import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import constants

POISON_TYPES = constants.POISON_TYPES

# archive-relative candidates per edge-case kind (the reference's file
# names): southwest airplanes are CIFAR-shaped 32x32x3 pickled arrays;
# ARDIS is an MNIST-shaped digit set stored as a torch-saved dataset
_EDGE_CASE_FILES = {
    "southwest": (
        "southwest_images_new_train.pkl",
        "southwest_images_adv_p_percent_edge_case.pkl",
    ),
    "ardis": ("ardis_test_dataset.pt", "ARDIS/ardis_test_dataset.pt"),
    "howto": ("howto_trigger_images.pkl", "saved_datasets/howto_trigger.pkl"),
    "greencar": ("greencar_images.pkl", "saved_datasets/greencar.pkl"),
}


def _as_nhwc(arr) -> Optional[np.ndarray]:
    """Loaded images as float ``[N, H, W, C]`` in [0, 1], the scale every
    real-data reader uses, so injected rows do not stand out by scale."""
    a = np.asarray(arr)
    if a.ndim == 3:  # [N, H, W] grayscale
        a = a[..., None]
    if a.ndim != 4:
        return None
    if a.shape[1] in (1, 3) and a.shape[-1] not in (1, 3):  # NCHW -> NHWC
        a = np.transpose(a, (0, 2, 3, 1))
    a = a.astype(np.float32)
    if a.max() > 2.0:  # raw uint8 range
        a = a / 255.0
    return a


@functools.lru_cache(maxsize=8)
def load_edge_case_arrays(data_cache_dir: Optional[str],
                          kind: str = "southwest") -> Optional[np.ndarray]:
    """Real out-of-distribution images from the reference's
    ``edge_case_examples`` archive under ``data_cache_dir``, or None when
    it is absent (callers then fall back to the synthetic far-tail
    samples). Cached per (dir, kind); treat the array as read-only. The
    port fetches no archive itself: place the files there, or fetch them
    with ``data.download.download_dataset('edge_case_examples', dir,
    urls=[...])``."""
    if not data_cache_dir:
        return None
    root = os.path.join(data_cache_dir, "edge_case_examples")
    for rel in _EDGE_CASE_FILES.get(kind, ()):
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            continue
        try:
            if path.endswith(".pt"):
                import torch

                # a torch-saved dataset object of the reference's archive
                obj = torch.load(path, map_location="cpu", weights_only=False)
                arr = getattr(obj, "data", obj)
                if hasattr(arr, "numpy"):
                    arr = arr.numpy()
            else:
                with open(path, "rb") as f:
                    arr = pickle.load(f)
            out = _as_nhwc(arr)
            if out is not None and len(out):
                return out
        except Exception:  # noqa: BLE001 — a corrupt file must not end the run
            logging.exception("edge-case file %s unreadable; skipping", path)
    return None


def stamp_trigger(x: np.ndarray, size: int = 4, value: float = None) -> np.ndarray:
    """Stamp a bottom-right square trigger on an image batch ``[N, H, W, C]``."""
    out = np.array(x, copy=True)
    v = float(out.max()) if value is None else value
    out[:, -size:, -size:, :] = v
    return out


def poison_dataset(
    x: np.ndarray,
    y: np.ndarray,
    poison_type: str,
    num_classes: int,
    target_label: int = 0,
    source_label: int = 1,
    fraction: float = 1.0,
    trigger_size: int = 4,
    seed: int = 0,
    data_cache_dir: Optional[str] = None,
    edge_case_kind: str = "southwest",
) -> Tuple[np.ndarray, np.ndarray]:
    """A poisoned copy of ``(x, y)``: the first ``max(1, fraction * n)``
    examples of a seeded permutation carry the attack."""
    if poison_type not in POISON_TYPES:
        raise ValueError(f"poison_type {poison_type!r} not in {POISON_TYPES}")
    rng = np.random.RandomState(seed)
    x, y = np.array(x, copy=True), np.array(y, copy=True)
    n = len(y)
    chosen = rng.permutation(n)[: max(1, int(fraction * n))]
    if poison_type == "label_flip":
        y[chosen] = (y[chosen] + 1) % num_classes
    elif poison_type == "targeted_flip":
        sel = chosen[np.isin(y[chosen], [source_label])]
        y[sel] = target_label
    elif poison_type == "backdoor_pattern":
        if x.ndim < 4:
            raise ValueError("backdoor_pattern needs image data [N, H, W, C]")
        x[chosen] = stamp_trigger(x[chosen], size=trigger_size)
        y[chosen] = target_label
    elif poison_type == "edge_case":
        real = load_edge_case_arrays(data_cache_dir, edge_case_kind)
        if real is not None and real.shape[1:] == x.shape[1:]:
            x[chosen] = real[rng.randint(0, len(real), len(chosen))].astype(x.dtype)
        else:
            if data_cache_dir:
                logging.info(
                    "edge_case archive absent or shape-mismatched under %s; "
                    "using synthetic far-tail noise", data_cache_dir,
                )
            x[chosen] = 3.0 + rng.normal(0, 0.5, x[chosen].shape).astype(x.dtype)
        y[chosen] = target_label
    return x, y


def poison_clients(
    xs: List[np.ndarray],
    ys: List[np.ndarray],
    poison_type,
    num_classes: int,
    poisoned_client_idxs: Sequence[int],
    **kw,
) -> Tuple[List[np.ndarray], List[np.ndarray], List[int]]:
    """Poison the listed clients (copies); returns ``(xs, ys, poisoned
    idxs)``. ``poison_type`` is one type for every client or a sequence
    paired 1:1 with ``poisoned_client_idxs`` in the caller's order. Client
    ``i`` draws from seed ``1000 + i``."""
    xs, ys = list(xs), list(ys)
    types = (
        list(poison_type)
        if isinstance(poison_type, (list, tuple))
        else [poison_type] * len(poisoned_client_idxs)
    )
    if len(types) != len(poisoned_client_idxs):
        raise ValueError(
            f"poison_type list has {len(types)} entries for "
            f"{len(poisoned_client_idxs)} poisoned clients — pair them "
            "1:1 (or pass one type)"
        )
    for i, t in zip(poisoned_client_idxs, types):
        xs[i], ys[i] = poison_dataset(xs[i], ys[i], t, num_classes, seed=1000 + i, **kw)
    return xs, ys, list(poisoned_client_idxs)


def backdoor_attack_success_rate(
    predict_fn, x_clean: np.ndarray, y_clean: np.ndarray,
    target_label: int, trigger_size: int = 4,
) -> float:
    """The share of the non-target clean examples that the model sends to
    the target class once the trigger is stamped (the fork's backdoor
    metric). ``predict_fn`` maps an image batch to class ids."""
    keep = y_clean != target_label
    if keep.sum() == 0:
        return 0.0
    triggered = stamp_trigger(x_clean[keep], size=trigger_size)
    preds = np.asarray(predict_fn(triggered))
    return float((preds == target_label).mean())
