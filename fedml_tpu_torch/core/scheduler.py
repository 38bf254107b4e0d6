"""Heterogeneity-aware workload scheduling (port of ``fedml_tpu/core/scheduler.py``).

A numpy copy of the three functions the registry path calls, so that
importing it loads no JAX; their results are bitwise the JAX package's.
``greedy_makespan`` LPT-splits an oversized cohort group on
heterogeneity-aware workloads (``scale/cohort.py``);
``balance_clients_across_shards`` deals a group's clients across lanes
(boustrophedon), and ``assign_by_load`` is its flat-dict face, the edge
tree's load-balanced client -> edge map (``scale/tree.py``). The
memory-constrained ``dp_schedule`` and the native ``best_makespan`` wait
for their consumers.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def greedy_makespan(
    workloads: Sequence[float], num_resources: int
) -> Tuple[List[List[int]], float]:
    """LPT greedy: sort jobs descending, put each on the least-loaded
    resource (the reference's 'serial' DP mode approximation,
    scheduler.py:14-60). Returns (job ids per resource, makespan)."""
    order = np.argsort(-np.asarray(workloads, dtype=np.float64))
    loads = np.zeros(num_resources)
    assign: List[List[int]] = [[] for _ in range(num_resources)]
    for j in order:
        r = int(np.argmin(loads))
        assign[r].append(int(j))
        loads[r] += workloads[j]
    return assign, float(loads.max())


def assign_by_load(
    load_sizes: Sequence[float], num_targets: int
) -> Dict[int, int]:
    """index -> target map over the boustrophedon deal: near-equal
    total load per target with equal counts. The flat-dict face of
    ``balance_clients_across_shards`` — the edge aggregation tree maps
    client ids to edges with it, the serving fleet statically deals a
    request burst across endpoints with it."""
    shards = balance_clients_across_shards(list(load_sizes), int(num_targets))
    return {int(i): t for t, lane in enumerate(shards) for i in lane}


def balance_clients_across_shards(
    client_sizes: Sequence[int], num_shards: int
) -> List[List[int]]:
    """Equal-count, near-equal-load shard assignment: sort clients by
    size descending and deal them boustrophedon (snake) across shards
    (0..S-1, S-1..0, ...). Each shard gets exactly ceil(C/S) clients
    (trailing shards one fewer when C % S != 0) with balanced total
    samples — the mesh-simulator consumer of the makespan idea."""
    order = np.argsort(-np.asarray(client_sizes, dtype=np.float64))
    shards: List[List[int]] = [[] for _ in range(num_shards)]
    forward = True
    for start in range(0, len(order), num_shards):
        block = order[start : start + num_shards]
        targets = range(len(block)) if forward else range(len(block) - 1, -1, -1)
        for j, t in zip(block, targets):
            shards[t].append(int(j))
        forward = not forward
    return shards
