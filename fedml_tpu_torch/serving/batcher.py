"""Continuous micro-batching over the bounded request queue.

Port of ``fedml_tpu/serving/batcher.py``.

vLLM-style continuous batching, shrunk to its core: the
worker never waits for a "full" batch. It blocks for the FIRST queued
request, then drains whatever else is already waiting (up to
``serve_max_batch``), lingering at most ``serve_batch_wait_ms`` for
stragglers — so a lone request pays ~zero batching delay and a burst
amortizes one forward dispatch across the whole burst. The assembled
batch is padded up to the shared power-of-two bucket
(``core/bucketing.py``), so every possible drain size maps onto a
handful of batch shapes. Behind a mesh endpoint every bucket is also a
multiple of the endpoint's ``shard_multiple`` (its data-lane count), so
each lane takes an equal share of the rows.
"""

from __future__ import annotations

import queue
import time
from typing import List, Optional, Tuple

import numpy as np

from ..core.bucketing import bucket_cohort, pad_batch

__all__ = ["MicroBatcher"]

# sentinel a stopping engine enqueues so a blocked gather wakes up
STOP = object()


class MicroBatcher:
    def __init__(
        self,
        q: "queue.Queue",
        max_batch: int,
        batch_wait_s: float,
        bucket_policy: str = "pow2",
        shard_multiple: int = 1,
    ) -> None:
        self.queue = q
        self.max_batch = max(1, int(max_batch))
        self.batch_wait_s = max(0.0, float(batch_wait_s))
        self.bucket_policy = str(bucket_policy)
        # mesh endpoints: every bucket must tile the data axis so each
        # lane's share of the rows is whole
        self.shard_multiple = max(1, int(shard_multiple))

    def gather(self, poll_s: float = 0.05) -> Optional[List]:
        """Block for one request (up to ``poll_s``), then drain the
        queue up to ``max_batch`` within the linger window. Returns
        None when nothing arrived (caller loops) or when a STOP
        sentinel was seen (caller checks its own stop flag)."""
        try:
            first = self.queue.get(timeout=poll_s)
        except queue.Empty:
            return None
        if first is STOP:
            return None
        batch = [first]
        t_end = time.monotonic() + self.batch_wait_s
        while len(batch) < self.max_batch:
            try:
                item = self.queue.get_nowait()
            except queue.Empty:
                remaining = t_end - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self.queue.get(timeout=remaining)
                except queue.Empty:
                    break
            if item is STOP:
                break
            batch.append(item)
        return batch

    def pad(self, batch: List) -> Tuple[np.ndarray, np.ndarray, int, int]:
        """Stack the live requests and pad to the bucket:
        ``(padded_x, valid, bucket, n)``."""
        xs = np.stack([r.x for r in batch], axis=0)
        n = xs.shape[0]
        bucket = bucket_cohort(
            n,
            self.bucket_policy,
            max_size=self.max_batch,
            shard_multiple=self.shard_multiple,
        )
        m = self.shard_multiple
        if bucket % m != 0:
            # lift to the next multiple of the mesh's data-lane count
            # (pow2 buckets vs pow2 lane counts never hit this; an
            # 'exact' policy or an odd lane count does)
            bucket = ((bucket + m - 1) // m) * m
        padded, valid = pad_batch(xs, bucket)
        return padded, valid, bucket, n
