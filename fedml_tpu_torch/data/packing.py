"""Host-side packing: ragged per-client numpy data -> static-shape tensors.

The port of ``fedml_tpu/data/packing.py``. Each client's samples are
padded up to ``num_batches * batch_size`` with a {0,1} mask; a
federation is stacked along a leading client axis, so a whole cohort is
one set of tensors that ``torch.func.vmap`` runs over. The padding,
truncation and bucketing are numpy and bitwise those of the JAX package;
only the final transfer differs (one ``torch.as_tensor`` per leaf).
Class labels become ``int64``, PyTorch's index dtype.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.types import Batches
from ..device import DeviceLike, get_device


def _pack_one_np(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    num_batches: Optional[int] = None,
    allow_truncate: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad/truncate + reshape into ``([nb, bs, ...x], [nb, bs, ...y],
    mask[nb, bs])`` numpy arrays."""
    n = x.shape[0]
    nb = num_batches if num_batches is not None else max(1, -(-n // batch_size))
    total = nb * batch_size
    if n > total:
        if not allow_truncate:
            raise ValueError(f"num_batches={nb} too small for {n} samples")
        x, y, n = x[:total], y[:total], total
    pad = total - n
    xp = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)]) if pad else x
    yp = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)]) if pad else y
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return (
        xp.reshape((nb, batch_size) + x.shape[1:]),
        yp.reshape((nb, batch_size) + y.shape[1:]),
        mask.reshape(nb, batch_size),
    )


def _label_dtype(y: np.ndarray) -> torch.dtype:
    return torch.int64 if np.issubdtype(y.dtype, np.integer) else torch.float32


def pack_one(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    num_batches: Optional[int] = None,
    x_dtype: torch.dtype = torch.float32,
    y_dtype: Optional[torch.dtype] = None,
    allow_truncate: bool = False,
    device: DeviceLike = "cuda",
) -> Batches:
    """Pack one client's samples into [nb, bs, ...] + mask on ``device``."""
    dev = get_device(device)
    xp, yp, mask = _pack_one_np(
        x, y, batch_size, num_batches, allow_truncate=allow_truncate
    )
    return Batches(
        x=torch.as_tensor(xp, dtype=x_dtype, device=dev),
        y=torch.as_tensor(yp, dtype=y_dtype or _label_dtype(y), device=dev),
        mask=torch.as_tensor(mask, device=dev),
    )


def pack_clients(
    xs: Sequence[np.ndarray],
    ys: Sequence[np.ndarray],
    batch_size: int,
    num_batches: Optional[int] = None,
    x_dtype: torch.dtype = torch.float32,
    device: DeviceLike = "cuda",
) -> Tuple[Batches, torch.Tensor]:
    """Pack a federation: all clients padded to a common ``num_batches``
    (max over clients unless given) and stacked -> leaves [C, nb, bs, ...].

    Returns (stacked_batches, num_samples[C]); the counts are of the
    samples actually packed (long-tail clients may be truncated)."""
    dev = get_device(device)
    if num_batches is None:
        num_batches = max(max(1, -(-len(x) // batch_size)) for x in xs)
    _warn_truncation("pack_clients", [len(x) for x in xs], num_batches, batch_size)
    packed = [
        _pack_one_np(x, y, batch_size, num_batches, allow_truncate=True)
        for x, y in zip(xs, ys)
    ]
    # stack host-side, one transfer per leaf
    stacked = Batches(
        x=torch.as_tensor(np.stack([p[0] for p in packed]), dtype=x_dtype, device=dev),
        y=torch.as_tensor(
            np.stack([p[1] for p in packed]), dtype=_label_dtype(ys[0]), device=dev
        ),
        mask=torch.as_tensor(np.stack([p[2] for p in packed]), device=dev),
    )
    cap = num_batches * batch_size
    num_samples = torch.tensor(
        [min(len(x), cap) for x in xs], dtype=torch.float32, device=dev
    )
    return stacked, num_samples


def pack_labels_np(
    ys: Sequence[np.ndarray],
    batch_size: int,
    num_batches: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side federation packing of labels only: ``(y[C, nb, bs],
    mask[C, nb, bs], num_samples[C])`` numpy arrays, the pad/truncate of
    :func:`pack_clients` (labels in the x slot), written into
    preallocated arrays in one copy a client."""
    if num_batches is None:
        num_batches = max(max(1, -(-len(y) // batch_size)) for y in ys)
    _warn_truncation("pack_labels_np", [len(y) for y in ys], num_batches, batch_size)
    cap = num_batches * batch_size
    first = np.asarray(ys[0])
    dtype = np.result_type(*[np.asarray(y).dtype for y in ys])
    y_p = np.zeros((len(ys), cap) + first.shape[1:], dtype=dtype)
    mask = np.zeros((len(ys), cap), dtype=np.float32)
    for c, y in enumerate(ys):
        n = min(len(y), cap)
        y_p[c, :n] = y[:n]
        mask[c, :n] = 1.0
    num_samples = np.asarray([min(len(y), cap) for y in ys], dtype=np.float32)
    return (
        y_p.reshape((len(ys), num_batches, batch_size) + first.shape[1:]),
        mask.reshape(len(ys), num_batches, batch_size),
        num_samples,
    )


def _warn_truncation(
    who: str, sizes: List[int], num_batches: int, batch_size: int
) -> None:
    """No silent caps: name what a too-small ``num_batches`` drops and
    the knob that raises it."""
    cap = num_batches * batch_size
    truncated = [s - cap for s in sizes if s > cap]
    if truncated:
        dropped = sum(truncated)
        total = sum(sizes)
        logging.warning(
            "%s: long-tail truncation — %d/%d clients exceed "
            "num_batches=%d x batch_size=%d; dropping %d/%d samples "
            "(%.2f%%). Raise args.packing_waste_cap to keep them.",
            who, len(truncated), len(sizes), num_batches, batch_size,
            dropped, total, 100.0 * dropped / max(total, 1),
        )


def bucket_num_batches(sizes: List[int], batch_size: int, waste_cap: float = 4.0) -> int:
    """Shared nb: the largest client's batch count, clamped to
    ``waste_cap`` x the median (``args.packing_waste_cap``; ``inf``
    disables truncation)."""
    nbs = [max(1, -(-s // batch_size)) for s in sizes]
    med = float(np.median(nbs))
    return int(min(max(nbs), max(1.0, waste_cap * med)))
