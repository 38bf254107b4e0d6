"""Heterogeneity-aware workload scheduling (port of ``fedml_tpu/core/scheduler.py``).

A numpy copy, so that importing it loads no JAX; its results are
bitwise the JAX package's. ``greedy_makespan`` LPT-splits an oversized
cohort group on heterogeneity-aware workloads (``scale/cohort.py``);
``balance_clients_across_shards`` deals a group's clients across lanes
(boustrophedon), and ``assign_by_load`` is its flat-dict face, the edge
tree's load-balanced client -> edge map (``scale/tree.py``).
``dp_schedule`` is the reference's memory-constrained ``DP_schedule``
(scheduler.py:110-172), and ``best_makespan`` the native exact
branch-and-bound (``core/native.py``) with LPT as its fallback.
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


def dp_schedule(
    workloads: Sequence[float],
    constraints: Sequence[float],
    memory: Sequence[float],
    mode: int = 0,
) -> List[List[int]]:
    """``DP_schedule`` parity (scheduler.py:110-172): jobs with memory
    footprints onto resources with memory caps; mode 0 = serial
    (one bunch per resource, minimize makespan), mode 1 = parallel
    (fill respecting memory, then balance runtime)."""
    n_res = len(constraints)
    order = np.argsort(-np.asarray(workloads, dtype=np.float64))
    loads = np.zeros(n_res)
    mem_used = np.zeros(n_res)
    assign: List[List[int]] = [[] for _ in range(n_res)]
    for j in order:
        # feasible resources by memory constraint
        feasible = [r for r in range(n_res) if mem_used[r] + memory[j] <= constraints[r]]
        if not feasible:
            feasible = list(range(n_res))  # overflow: least loaded anyway
        r = min(feasible, key=lambda r_: loads[r_])
        assign[r].append(int(j))
        loads[r] += workloads[j]
        mem_used[r] += memory[j]
    if mode == 1:
        # parallel mode: interleave large/small jobs inside each bunch so
        # concurrent lanes on one resource start with mixed workloads
        def interleave(b: List[int]) -> List[int]:
            s = sorted(b, key=lambda j_: -workloads[j_])
            out: List[int] = []
            lo, hi = 0, len(s) - 1
            while lo <= hi:
                out.append(s[lo])
                if lo != hi:
                    out.append(s[hi])
                lo += 1
                hi -= 1
            return out

        assign = [interleave(b) for b in assign]
    return assign


def best_makespan(
    workloads: Sequence[float], num_resources: int
) -> Tuple[List[List[int]], float]:
    """Best available schedule: the native exact branch-and-bound
    (core/native.py, C++) when the toolchain is present, else LPT greedy.
    Never worse than greedy either way."""
    from .native import exact_makespan

    native = exact_makespan(workloads, num_resources)
    if native is not None:
        return native
    return greedy_makespan(workloads, num_resources)


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
