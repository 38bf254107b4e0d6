"""The round loop of the algorithms that run their own rounds.

HierFedAvg, DSGD/PushSum, FedGAN, FedNAS, SplitNN, FedGKT and VFL each
define ``run_round(round_idx)`` (one round of training, its summed
metrics left on the device) and ``round_stats(round_idx, summed)`` (the
round's record, evaluation included, fetched to the host); ``train()``
runs ``args.comm_round`` rounds and records every
``frequency_of_the_test``-th and the last, as the JAX package's loops
do, and returns the last record.
"""

from __future__ import annotations

import logging
import time
from typing import Dict

import numpy as np
import torch


def nonempty_batches(mask: torch.Tensor) -> np.ndarray:
    """Which packed batches hold a real example, on the host: ``mask``
    ``[..., nb, bs]`` -> bool ``[..., nb]`` (one read). A fully padded
    batch changes nothing in the JAX package's loops (params and
    optimizer state are kept, its metrics are zero), so the loops here
    skip it."""
    return (mask.sum(dim=-1) > 0).cpu().numpy()


def host_sums(summed: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """A dict of device scalars as host floats (one fetch)."""
    keys = list(summed)
    if not keys:
        return {}
    vals = torch.stack([torch.as_tensor(summed[k], dtype=torch.float64) for k in keys]).cpu()
    return dict(zip(keys, vals.tolist()))


def mean_of(sums: Dict[str, float], key: str, count: str = "count") -> float:
    return sums[key] / max(sums[count], 1.0)


class RoundLoop:
    """Mixin: ``train()`` over ``run_round`` and ``round_stats``."""

    algorithm = ""

    def run_round(self, round_idx: int) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def round_stats(self, round_idx: int, summed: Dict[str, torch.Tensor]) -> Dict[str, float]:
        raise NotImplementedError

    def train(self) -> Dict[str, float]:
        comm_rounds = int(self.args.comm_round)
        freq = max(1, int(getattr(self.args, "frequency_of_the_test", 5)))
        final: Dict[str, float] = {}
        for round_idx in range(comm_rounds):
            t0 = time.perf_counter()
            summed = self.run_round(round_idx)
            if round_idx % freq == 0 or round_idx == comm_rounds - 1:
                stats = {"round": round_idx, **self.round_stats(round_idx, summed)}
                stats["round_time_s"] = time.perf_counter() - t0
                self.history.append(stats)
                final = stats
                logging.info("%s round %d: %s", self.algorithm, round_idx, stats)
        return final
