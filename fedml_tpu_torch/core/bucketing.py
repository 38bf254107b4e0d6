"""Shared power-of-two shape bucketing for the jit compile cache.

A verbatim copy of ``fedml_tpu/core/bucketing.py`` (plain numpy), kept
in the port so that importing it loads no JAX; tests hold the two
bitwise equal. The text below is the JAX package's own.

One rule, two consumers. The async round pipeline
(``core/round_pipeline.py``) pads sampled cohorts up to pow2 buckets so
mid-run cohort-size changes hit the jit cache instead of retracing; the
serving plane (``fedml_tpu/serving``) assembles request micro-batches
into the SAME buckets so the forward fn compiles once per bucket no
matter how many requests happen to be queued. Both sides mask the
padded slots out (zero validity weight in training, result rows sliced
off in serving) — padding changes shapes, never numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["bucket_cohort", "pad_cohort_idx", "pad_batch"]


def bucket_cohort(
    n: int,
    policy: str = "pow2",
    max_size: Optional[int] = None,
    shard_multiple: int = 1,
) -> int:
    """Cohort/batch size -> compile-cache bucket size.

    ``pow2`` rounds up to the next power of two (capped at ``max_size``
    — the total client count in training, the micro-batch cap in
    serving; a bucket can never exceed the population it draws from).
    A mesh's ``clients`` axis must still tile the bucket; when the
    power-of-two bucket is not a multiple of ``shard_multiple`` the
    exact size is used instead (it was already validated to tile).
    """
    if policy not in ("pow2", "exact"):
        raise ValueError(
            f"pipeline_bucket/serve_bucket {policy!r}: pick 'pow2' or 'exact'"
        )
    if policy == "exact" or n <= 0:
        return n
    b = 1 << (int(n) - 1).bit_length()
    if max_size is not None:
        b = min(b, int(max_size))
    if b < n or b % max(1, shard_multiple) != 0:
        return n
    return b


def pad_cohort_idx(idx: np.ndarray, bucket: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad sampled client indices up to ``bucket``; returns
    ``(padded_idx, valid)`` where ``valid`` is 1.0 for real slots and
    0.0 for padding. Padded slots repeat ``idx[0]`` (a real, in-range
    index — the round fn zeroes their batch mask so they train on
    nothing and aggregate with weight zero)."""
    idx = np.asarray(idx, dtype=np.int32)
    n = idx.shape[0]
    valid = np.ones((bucket,), dtype=np.float32)
    if bucket == n:
        return idx, valid
    pad = np.full((bucket - n,), idx[0], dtype=np.int32)
    valid[n:] = 0.0
    return np.concatenate([idx, pad]), valid


def pad_batch(xs: np.ndarray, bucket: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a stacked request batch ``[n, ...]`` up to ``bucket`` rows;
    returns ``(padded, valid)`` with zero rows in the padded slots.
    The forward pass computes garbage for them (no NaN risk: zeros are
    in-domain for every model input) and the caller masks by slicing
    the first ``n`` result rows — the serving-side analog of the
    training cohort's zero-weight invisibility contract."""
    xs = np.asarray(xs)
    n = xs.shape[0]
    if bucket == n:
        return xs, np.ones((n,), dtype=np.float32)
    if bucket < n:
        raise ValueError(f"bucket {bucket} smaller than batch {n}")
    pad = np.zeros((bucket - n,) + xs.shape[1:], dtype=xs.dtype)
    valid = np.ones((bucket,), dtype=np.float32)
    valid[n:] = 0.0
    return np.concatenate([xs, pad], axis=0), valid
