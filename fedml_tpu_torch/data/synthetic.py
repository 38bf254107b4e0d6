"""Synthetic stand-ins for the classification and sequence datasets.

The port of the classification and sequence parts of
``fedml_tpu/data/synthetic.py``: class-conditional Gaussian blobs (each
class has a mean vector, an example is mean + noise) and Markov-chain
token streams, shaped like the real dataset, so that models and their
costs are those of the real one and no download is needed.

- :func:`synthetic_classification` is the host generator, numpy MT19937,
  bitwise the JAX package's for the same seed.
- :func:`synthetic_sequences` is the next-token stand-in, host numpy,
  bitwise the JAX package's for the same seed.
- :func:`synthetic_classification_device` is its twin on the device:
  given packed labels it draws ``means[y] + sigma * noise`` where the
  data will be used, from a seeded ``torch.Generator``. The class means
  are the host generator's (``_class_means``), so the distribution is
  the same; the noise stream is PyTorch's, not JAX's threefry.
- :func:`synthetic_classification_device_per_client` is the registry
  path's twin: one row of labels per client, each row's noise keyed by
  (that client's seed, sample index), so a client's features are a
  function of the client alone (``ops/synth_features.py``: a
  hand-written kernel on the card, Philox4x32-10 + Box-Muller).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, get_device
from ..ops.synth_features import synth_features


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


def synthetic_sequences(
    n_samples: int,
    seq_len: int,
    vocab_size: int,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Markov-chain token streams for next-token models: x = tokens[:-1],
    y = tokens[1:], both int64 [n, seq_len]. The chain's sparse
    transition matrix makes the next token learnable above chance."""
    rng = np.random.RandomState(seed)
    trans = rng.dirichlet(np.full(vocab_size, 0.05), size=vocab_size)
    toks = np.zeros((n_samples, seq_len + 1), np.int64)
    toks[:, 0] = rng.randint(0, vocab_size, n_samples)
    for t in range(seq_len):
        cum = trans[toks[:, t]].cumsum(axis=1)
        u = rng.rand(n_samples, 1)
        toks[:, t + 1] = (u > cum).sum(axis=1)
    return toks[:, :-1], toks[:, 1:]


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


def synthetic_classification_device_per_client(
    y_packed,
    feature_shape: Tuple[int, ...],
    num_classes: int,
    client_seeds,
    sigma: float = 1.0,
    means_seed: int = 1234,
    dtype: Optional[torch.dtype] = None,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """Features for ``y_packed`` ``[C, ...]`` (one leading row per
    client), made on ``device``: ``x[c, ..., *feature_shape] =
    means[y] + sigma * noise``, where ``client_seeds[c]`` keys row ``c``'s
    noise per sample index (the row's flat position), so sample ``s`` of
    a client keeps its features whatever slot, group shape or cohort the
    client lands in. Same class means as the host generator. One kernel
    launch on the card."""
    dev = get_device(device)
    dim = int(np.prod(feature_shape))
    means = torch.as_tensor(_class_means(num_classes, dim, means_seed), device=dev)
    y = torch.as_tensor(y_packed, dtype=torch.int64, device=dev)
    seeds = torch.as_tensor(np.asarray(client_seeds, dtype=np.int64), device=dev)
    C = y.shape[0]
    x = synth_features(y.reshape(C, -1), means, seeds, float(sigma), dtype or torch.float32)
    return x.reshape(tuple(y.shape) + tuple(feature_shape))

