"""Synthetic datasets: the FedProx set and the stand-ins.

The port of ``fedml_tpu/data/synthetic.py``:

- :func:`synthetic_fedprox` is FedProx's synthetic(alpha, beta)
  federation (per-client logistic models from a hierarchical Gaussian),
  host numpy, bitwise the JAX package's for the same seed;
- :func:`synthetic_multilabel` is the tag-prediction stand-in (multi-hot
  tags, features the sum of the tags' embeddings plus noise), host
  numpy, bitwise the JAX package's for the same seed.

The stand-ins for the classification and sequence datasets are
class-conditional Gaussian blobs (each
class has a mean vector, an example is mean + noise) and Markov-chain
token streams, shaped like the real dataset, so that models and their
costs are those of the real one and no download is needed.

- :func:`synthetic_classification` is the host generator, numpy MT19937,
  bitwise the JAX package's for the same seed.
- :func:`synthetic_sequences` is the next-token stand-in, host numpy,
  bitwise the JAX package's for the same seed.
- :func:`synthetic_segmentation` is the segmentation stand-in (class
  rectangles on a background), host numpy, bitwise the JAX package's
  for the same seed.
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

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, get_device
from ..ops.synth_features import synth_features


def synthetic_fedprox(
    num_clients: int = 30,
    alpha: float = 1.0,
    beta: float = 1.0,
    input_dim: int = 60,
    num_classes: int = 10,
    seed: int = 0,
    min_samples: int = 20,
    max_samples: int = 400,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """FedProx synthetic(alpha, beta): W_k ~ N(u_k, 1), u_k ~ N(0, alpha);
    x_k ~ N(v_k, Sigma), v_k ~ N(B_k, 1), B_k ~ N(0, beta); lognormal
    client sizes. Returns per-client (x, y) lists."""
    rng = np.random.RandomState(seed)
    sizes = np.clip(
        rng.lognormal(4, 2, num_clients).astype(int), min_samples, max_samples
    )
    diag = np.array([(j + 1) ** -1.2 for j in range(input_dim)])
    xs, ys = [], []
    for k in range(num_clients):
        u_k = rng.normal(0, alpha)
        b_k = rng.normal(0, beta)
        v_k = rng.normal(b_k, 1, input_dim)
        W = rng.normal(u_k, 1, (input_dim, num_classes))
        b = rng.normal(u_k, 1, num_classes)
        x = rng.multivariate_normal(v_k, np.diag(diag), sizes[k]).astype(np.float32)
        logits = x @ W + b
        y = np.argmax(logits, axis=1).astype(np.int64)
        xs.append(x)
        ys.append(y)
    return xs, ys


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


def synthetic_segmentation(
    n_samples: int,
    num_classes: int,
    feature_shape: Tuple[int, ...],
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Blob-mask segmentation stand-in (the pascal_voc / cityscapes /
    coco_seg shapes; fets2021's 4 channels use the same generator):
    each image holds 1-3 axis-aligned rectangles of foreground classes
    on a background of class 0, and a pixel's intensities encode its
    class. x [n, h, w, ch] f32, y [n, h, w] int64."""
    h, w = feature_shape[0], feature_shape[1]
    ch = feature_shape[2] if len(feature_shape) > 2 else 3
    rng = np.random.RandomState(seed)
    palette = np.random.RandomState(4321).uniform(-1, 1, (num_classes, ch)).astype(
        np.float32
    )
    x = np.zeros((n_samples, h, w, ch), np.float32)
    y = np.zeros((n_samples, h, w), np.int64)
    for i in range(n_samples):
        x[i] = palette[0] + 0.3 * rng.normal(0, 1, (h, w, ch))
        for _ in range(rng.randint(1, 4)):
            c = rng.randint(1, num_classes)
            hh, ww = rng.randint(h // 6, h // 2), rng.randint(w // 6, w // 2)
            r0, c0 = rng.randint(0, h - hh), rng.randint(0, w - ww)
            x[i, r0:r0 + hh, c0:c0 + ww] = palette[c] + 0.3 * rng.normal(0, 1, (hh, ww, ch))
            y[i, r0:r0 + hh, c0:c0 + ww] = c
    return x, y


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
    # each row's running sum once, not once a step: a row sums in the same
    # order either way, so the bits are the same; and every step's
    # uniforms in one draw, which takes them from the stream in the order
    # the steps would
    cum = trans.cumsum(axis=1)
    del trans
    u = rng.rand(seq_len, n_samples)
    # the next token counts the running sums below u; a row's sums never
    # decrease, so the count is where u lands in the row: a binary search
    # for every sample at once, exact like the count (no [n, vocab] gather)
    for t in range(seq_len):
        cur, ut = toks[:, t], u[t]
        lo = np.zeros(n_samples, np.int64)
        hi = np.full(n_samples, vocab_size, np.int64)
        for _ in range(int(vocab_size).bit_length()):
            mid = (lo + hi) >> 1
            below = (mid < hi) & (cum[cur, np.minimum(mid, vocab_size - 1)] < ut)
            lo = np.where(below, mid + 1, lo)
            hi = np.where(below, hi, mid)
        toks[:, t + 1] = lo
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


def synthetic_multilabel(
    n_samples: int,
    num_tags: int,
    feature_shape: Tuple[int, ...],
    seed: int = 0,
    tags_per_sample: int = 3,
    sigma: float = 0.5,
    means_seed: int = 1234,
) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-hot tag-prediction stand-in (stackoverflow_lr shape): each
    sample carries 1..tags_per_sample tags; features are the sum of the
    active tags' embedding vectors + noise, so a linear sigmoid model
    is learnable. Returns (x [N, *shape], y multi-hot [N, num_tags])."""
    rng = np.random.RandomState(seed)
    dim = int(np.prod(feature_shape))
    emb = np.random.RandomState(means_seed).normal(
        0, 1, (num_tags, dim)
    ).astype(np.float32)
    y = np.zeros((n_samples, num_tags), np.float32)
    x = sigma * rng.normal(0, 1, (n_samples, dim)).astype(np.float32)
    counts = rng.randint(1, tags_per_sample + 1, n_samples)
    for i in range(n_samples):
        tags = rng.choice(num_tags, counts[i], replace=False)
        y[i, tags] = 1.0
        x[i] += emb[tags].sum(axis=0)
    return x.reshape((n_samples,) + feature_shape), y
