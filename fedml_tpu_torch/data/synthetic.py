"""Synthetic stand-ins for the classification datasets.

The port of the classification part of ``fedml_tpu/data/synthetic.py``:
class-conditional Gaussian blobs (each class has a mean vector, an
example is mean + noise), shaped like the real dataset, so that models
and their costs are those of the real one and no download is needed.

- :func:`synthetic_classification` is the host generator, numpy MT19937,
  bitwise the JAX package's for the same seed.
- :func:`synthetic_classification_device` is its twin on the device:
  given packed labels it draws ``means[y] + sigma * noise`` where the
  data will be used, from a seeded ``torch.Generator``. The class means
  are the host generator's (``_class_means``), so the distribution is
  the same; the noise stream is PyTorch's, not JAX's threefry.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, get_device


def _class_means(num_classes: int, dim: int, means_seed: int) -> np.ndarray:
    """The one class-means construction both generators use: train and
    test, host and device share a distribution through it."""
    return np.random.RandomState(means_seed).normal(
        0, 1, (num_classes, dim)
    ).astype(np.float32)


def synthetic_classification(
    n_samples: int,
    num_classes: int,
    feature_shape: Tuple[int, ...],
    seed: int = 0,
    sigma: float = 1.0,
    means_seed: int = 1234,
) -> Tuple[np.ndarray, np.ndarray]:
    """``n_samples`` examples (x [n, *feature_shape] f32, y [n] int64);
    ``means_seed`` fixes the class means apart from the sampling seed so
    that train and test splits share one distribution."""
    rng = np.random.RandomState(seed)
    dim = int(np.prod(feature_shape))
    means = _class_means(num_classes, dim, means_seed)
    y = rng.randint(0, num_classes, n_samples).astype(np.int64)
    x = means[y] + sigma * rng.normal(0, 1, (n_samples, dim)).astype(np.float32)
    return x.reshape((n_samples,) + feature_shape), y


def synthetic_classification_device(
    y_packed,
    feature_shape: Tuple[int, ...],
    num_classes: int,
    seed: int = 0,
    sigma: float = 1.0,
    means_seed: int = 1234,
    dtype: Optional[torch.dtype] = None,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """Features for host-packed labels ``y_packed`` (any leading shape),
    made on ``device``: ``x[..., *feature_shape]`` with
    ``x = means[y] + sigma * noise``, noise from a ``torch.Generator`` on
    the device seeded with ``seed``. Only the labels cross to the
    device."""
    dev = get_device(device)
    dim = int(np.prod(feature_shape))
    means = torch.as_tensor(_class_means(num_classes, dim, means_seed), device=dev)
    y = torch.as_tensor(np.asarray(y_packed), dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    noise = torch.randn(tuple(y.shape) + (dim,), generator=gen, device=dev)
    x = means[y] + sigma * noise
    return x.reshape(tuple(y.shape) + tuple(feature_shape)).to(dtype or torch.float32)
