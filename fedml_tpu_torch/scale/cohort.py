"""Heterogeneity-aware cohort packing: variable-size clients -> pow2
compile-cache buckets.

The port of ``fedml_tpu/scale/cohort.py``, a numpy copy: its
``CohortPlan``s are the JAX package's field for field. In eager PyTorch
the pow2 shapes are not a compile cache; they bound the distinct group
shapes (and so the distinct kernel launch shapes) a round runs. The
text below is the JAX package's own.

Cohort assembly is a scheduling problem, not a dict lookup (FedML
Parrot's framing). A sampled 10k cohort carries a heavy-tailed
distribution of dataset sizes; packing all of it to one shared
``num_batches`` (the eager loader's shape) pads the median client by
the tail's factor, while packing each client exactly retraces the jit
per shape. This packer bounds both:

1. each client's ``num_batches`` rounds up to a power of two (capped by
   the ``data/packing.bucket_num_batches`` waste-cap rule) and clients
   sharing an nb-bucket form one vmap group;
2. a group whose population exceeds ``max_group_clients`` is split by
   **LPT** (``core/scheduler.greedy_makespan``) on heterogeneity-aware
   workloads — ``num_samples * 2**speed_tier`` — so every dispatch's
   slowest lane is as fast as a greedy makespan allows;
3. each (sub)group's client axis pads up to the shared pow2 cohort
   buckets (``core/bucketing.bucket_cohort``), so the census of
   distinct jit shapes for an 8 -> 512 cohort sweep stays within the
   same <= 7-bucket bound the round pipeline established;
4. within a group, clients are dealt across ``shard_num`` mesh lanes by
   ``core/scheduler.balance_clients_across_shards`` (equal-count,
   near-equal-load boustrophedon) — the consumer that module's
   docstring promised.

Padding waste is measured, not asserted: ``CohortPlan.waste_frac``
feeds the ``cohort_bucket_waste_frac`` telemetry histogram.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.bucketing import bucket_cohort, pad_cohort_idx
from ..core.scheduler import balance_clients_across_shards, greedy_makespan
from ..core.telemetry import Telemetry
from ..data.packing import bucket_num_batches

__all__ = ["CohortGroup", "CohortPlan", "pack_cohort"]


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


@dataclasses.dataclass
class CohortGroup:
    """One jit-shaped dispatch: clients sharing an nb bucket, client
    axis padded to a pow2 cohort bucket."""

    client_idx: np.ndarray  # [bucket] registry indices (pads repeat [0])
    valid: np.ndarray  # [bucket] float32, 0.0 on padded slots
    num_samples: np.ndarray  # [bucket] float32, packed (post-cap) counts
    nb: int  # shared pow2 num_batches for the group
    bucket: int  # padded client-axis size (pow2)
    real_clients: int  # clients before padding
    shards: List[List[int]]  # slot positions per mesh lane (balanced)

    @property
    def shape_key(self) -> Tuple[int, int]:
        """The jit-cache identity of this dispatch."""
        return (self.bucket, self.nb)


@dataclasses.dataclass
class CohortPlan:
    groups: List[CohortGroup]
    cohort_size: int
    waste_frac: float  # padded-capacity fraction carrying no samples
    makespan_splits: int  # groups split by LPT balancing

    @property
    def shape_keys(self) -> List[Tuple[int, int]]:
        return sorted({g.shape_key for g in self.groups})


def pack_cohort(
    sizes: Sequence[int],
    client_idx: Sequence[int],
    batch_size: int,
    speed_tier: Optional[Sequence[int]] = None,
    waste_cap: float = 4.0,
    max_group_clients: int = 4096,
    shard_num: int = 1,
    telemetry=None,
) -> CohortPlan:
    """Pack a sampled cohort (``sizes[i]`` samples for registry client
    ``client_idx[i]``) into pow2-shaped vmap groups.

    Touches ONLY cohort-sized arrays — callers pass the cohort's
    gathered columns, never registry-sized ones."""
    sizes = np.asarray(sizes, dtype=np.int64)
    client_idx = np.asarray(client_idx, dtype=np.int64)
    if sizes.shape != client_idx.shape or sizes.ndim != 1 or not len(sizes):
        raise ValueError("sizes and client_idx must be equal-length 1-D")
    if speed_tier is None:
        tiers = np.zeros(len(sizes), dtype=np.int64)
    else:
        tiers = np.asarray(speed_tier, dtype=np.int64)
    bs = int(batch_size)

    # per-client batch counts under the shared waste-cap rule
    # (waste_cap x median nb truncates the extreme tail), then rounded
    # up to the pow2 nb the group is actually packed with. packed
    # counts are computed against the POW2 nb — the labels a client
    # really trains on are masked at group-nb x bs, so the aggregation
    # weight must agree with that mask, not with the pre-rounding cap
    nb_cap = bucket_num_batches(sizes.tolist(), bs, waste_cap=waste_cap)
    nb = np.minimum(np.maximum(1, -(-sizes // bs)), nb_cap)
    nb_bucket = np.asarray([_next_pow2(int(b)) for b in nb], dtype=np.int64)
    nb_bucket = np.minimum(nb_bucket, _next_pow2(int(nb_cap)))
    packed_samples = np.minimum(sizes, nb_bucket * bs)

    groups: List[CohortGroup] = []
    makespan_splits = 0
    capacity = 0
    useful = int(packed_samples.sum())
    for g_nb in np.unique(nb_bucket):
        pos = np.nonzero(nb_bucket == g_nb)[0]
        # LPT split of an oversized group: heterogeneity-aware workload
        # (a tier-t client is 2**t x slower per sample), balanced so
        # the slowest sub-dispatch is as fast as greedy LPT allows
        if len(pos) > max_group_clients:
            n_res = -(-len(pos) // max_group_clients)
            work = (
                packed_samples[pos].astype(np.float64)
                * np.power(2.0, tiers[pos].astype(np.float64))
            )
            assign, _ = greedy_makespan(work, n_res)
            # LPT balances LOAD, not count: a lane of mostly-light
            # clients can exceed max_group_clients while balancing a
            # few heavy ones, padding to a 2x-wider pow2 bucket than
            # the cap allows. Repair: move the lightest items off
            # overfull lanes onto the least-loaded lane with room
            # (total capacity n_res * cap >= len(pos), so one exists).
            lanes = [list(a) for a in assign]
            loads = [float(work[np.asarray(a, dtype=np.int64)].sum()) for a in lanes]
            for li, lane in enumerate(lanes):
                if len(lane) <= max_group_clients:
                    continue
                lane.sort(key=lambda j: work[j], reverse=True)
                while len(lane) > max_group_clients:
                    j = lane.pop()
                    loads[li] -= work[j]
                    dest = min(
                        (
                            d
                            for d in range(len(lanes))
                            if d != li and len(lanes[d]) < max_group_clients
                        ),
                        key=lambda d: loads[d],
                    )
                    lanes[dest].append(j)
                    loads[dest] += work[j]
            makespan_splits += 1
            sub_positions = [pos[np.asarray(a, dtype=np.int64)] for a in lanes]
        else:
            sub_positions = [pos]
        for sub in sub_positions:
            if not len(sub):
                continue
            # mesh-lane balance (core/scheduler's consumer-ready seam):
            # deal clients boustrophedon across shards, then lay the
            # group out shard-major so a mesh's client axis tiles lanes
            shards = balance_clients_across_shards(
                packed_samples[sub].tolist(), max(1, int(shard_num))
            )
            order = np.asarray(
                [j for lane in shards for j in lane], dtype=np.int64
            )
            sub = sub[order]
            # after the shard-major reorder, lane l's clients occupy the
            # next len(shards[l]) consecutive slots — stored positions
            # must index the arrays AS LAID OUT, not the pre-reorder
            # deal indices
            lane_slots: List[List[int]] = []
            slot0 = 0
            for lane in shards:
                lane_slots.append(list(range(slot0, slot0 + len(lane))))
                slot0 += len(lane)
            bucket = bucket_cohort(len(sub), "pow2")
            idx_padded, valid = pad_cohort_idx(
                client_idx[sub].astype(np.int32), bucket
            )
            ns = np.zeros(bucket, dtype=np.float32)
            ns[: len(sub)] = packed_samples[sub]
            capacity += int(bucket) * int(g_nb) * bs
            groups.append(
                CohortGroup(
                    client_idx=idx_padded.astype(np.int64),
                    valid=valid,
                    num_samples=ns,
                    nb=int(g_nb),
                    bucket=int(bucket),
                    real_clients=int(len(sub)),
                    shards=lane_slots,
                )
            )
    waste_frac = 1.0 - useful / max(capacity, 1)
    if telemetry is None:
        telemetry = Telemetry.get_instance()
    telemetry.observe(
        "cohort_bucket_waste_frac", waste_frac,
        buckets=(0.1, 0.25, 0.5, 0.75, 0.9),
    )
    return CohortPlan(
        groups=groups,
        cohort_size=int(len(sizes)),
        waste_frac=float(waste_frac),
        makespan_splits=makespan_splits,
    )
