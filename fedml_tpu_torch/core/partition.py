"""Non-IID data partitioning (port of ``fedml_tpu/core/partition.py``).

A numpy copy of the JAX package's module: the Latent-Dirichlet
partitioner (per-class Dirichlet(alpha) allocation across clients,
with the bounded min-10-samples retry loop and its deterministic
rebalance) and the ``homo`` uniform split. It runs once on the host at
data-load time and draws from ``np.random.RandomState``, so for the same
seed and labels its index maps are bitwise those of the JAX package.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np


def partition_class_samples_with_dirichlet_distribution(
    N: int,
    alpha: float,
    client_num: int,
    idx_batch: List[List[int]],
    idx_k: np.ndarray,
    rng: np.random.RandomState,
):
    """One class's allocation (noniid_partition.py:81-109): draw
    Dirichlet(alpha) proportions, zero out clients already holding >= N/n
    samples (balance guard), split the class's shuffled indices."""
    rng.shuffle(idx_k)
    raw = rng.dirichlet(np.repeat(alpha, client_num))
    proportions = np.array(
        [p * (len(idx_j) < N / client_num) for p, idx_j in zip(raw, idx_batch)]
    )
    total = proportions.sum()
    if total <= 0:
        # every client is at the N/n balance cap (small-N corner): the
        # guarded proportions are all zero and the reference's formula
        # would divide 0/0 and cast NaN to int. Fall back to the
        # unguarded Dirichlet draw so the split stays well-defined.
        proportions = raw
    else:
        proportions = proportions / total
    proportions = (np.cumsum(proportions) * len(idx_k)).astype(int)[:-1]
    idx_batch = [
        idx_j + idx.tolist()
        for idx_j, idx in zip(idx_batch, np.split(idx_k, proportions))
    ]
    min_size = min(len(idx_j) for idx_j in idx_batch)
    return idx_batch, min_size


def non_iid_partition_with_dirichlet_distribution(
    label_list: np.ndarray,
    client_num: int,
    classes: int,
    alpha: float,
    task: str = "classification",
    seed: int = 0,
) -> Dict[int, np.ndarray]:
    """LDA partition (noniid_partition.py:6-78). Returns
    {client_idx: sample index array}. Retries until every client has
    >= 10 samples (noniid_partition.py:41-43)."""
    net_dataidx_map: Dict[int, np.ndarray] = {}
    rng = np.random.RandomState(seed)
    if classes == 0 or len(label_list) == 0:
        # degenerate: nothing to allocate; every client gets an empty
        # shard (previously this livelocked / raised downstream)
        return {i: np.array([], dtype=np.int64) for i in range(client_num)}
    if task == "segmentation":
        # multi-label: label_list is [classes, ...] of per-class sample
        # index arrays, so len(label_list) is the CLASS count. Size the
        # balance guard / retry target on total assignments instead.
        N = int(sum(len(np.asarray(k)) for k in label_list))
    else:
        N = len(label_list)
    # The reference retries unboundedly until min 10 samples/client
    # (noniid_partition.py:41-43) — which LIVELOCKS when the config makes
    # that nearly/actually infeasible (e.g. 50 clients x 600 samples at
    # alpha=0.1). Bound the retries, keep the best draw, and if the
    # target is still unmet rebalance deterministically from the
    # largest clients to the starved ones.
    target = min(10, N // client_num) if client_num else 0
    best: List[List[int]] = []
    best_min = -1
    max_retries = 100
    for attempt in range(max_retries):
        idx_batch: List[List[int]] = [[] for _ in range(client_num)]
        if task == "segmentation":
            # multi-label: label_list is [classes, ...] of index arrays
            for k in range(classes):
                idx_k = np.asarray(label_list[k])
                idx_batch, min_size = partition_class_samples_with_dirichlet_distribution(
                    N, alpha, client_num, idx_batch, idx_k, rng
                )
        else:
            for k in range(classes):
                idx_k = np.where(np.asarray(label_list) == k)[0]
                idx_batch, min_size = partition_class_samples_with_dirichlet_distribution(
                    N, alpha, client_num, idx_batch, idx_k, rng
                )
        if min_size > best_min:
            best, best_min = idx_batch, min_size
        if min_size >= target:
            break
    else:
        logging.warning(
            "LDA partition: min client size %d < %d after %d draws "
            "(N=%d, clients=%d, alpha=%s); rebalancing from the largest "
            "clients",
            best_min, target, max_retries, N, client_num, alpha,
        )
        idx_batch = best
        sizes = [len(b) for b in idx_batch]
        while min(sizes) < target:
            src = int(np.argmax(sizes))
            dst = int(np.argmin(sizes))
            idx_batch[dst].append(idx_batch[src].pop())
            sizes[src] -= 1
            sizes[dst] += 1
    for i in range(client_num):
        rng.shuffle(idx_batch[i])
        net_dataidx_map[i] = np.array(idx_batch[i], dtype=np.int64)
    return net_dataidx_map


def homo_partition(
    n_samples: int, client_num: int, seed: int = 0
) -> Dict[int, np.ndarray]:
    """IID split (cifar10/data_loader.py ``homo`` branch): shuffle and
    slice into equal shards."""
    rng = np.random.RandomState(seed)
    idxs = rng.permutation(n_samples)
    return {
        i: np.sort(shard).astype(np.int64)
        for i, shard in enumerate(np.array_split(idxs, client_num))
    }


def record_data_stats(
    y_train: np.ndarray, net_dataidx_map: Dict[int, np.ndarray], task="classification"
) -> Dict[int, Dict[int, int]]:
    """Per-client class histogram (noniid_partition.py:112-124)."""
    net_cls_counts: Dict[int, Dict[int, int]] = {}
    for net_i, dataidx in net_dataidx_map.items():
        unq, unq_cnt = np.unique(np.asarray(y_train)[dataidx], return_counts=True)
        net_cls_counts[net_i] = {int(u): int(c) for u, c in zip(unq, unq_cnt)}
    logging.debug("Data statistics: %s", net_cls_counts)
    return net_cls_counts
