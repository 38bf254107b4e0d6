"""Two-level (hierarchical) FedAvg (port of ``fedml_tpu/simulation/hierarchical_fl.py``).

The reference's ``hierarchical_fl`` (``Group(FedAvgAPI)`` aggregates
within a group every ``group_comm_round``, ``Trainer(FedAvgAPI)``
aggregates the group models): clients are split into ``group_num``
groups once, from ``RandomState(random_seed)``; every global round each
group starts from the global model and runs ``group_comm_round`` rounds
of the same round engine as flat FedAvg with the group as the cohort,
then the group models are averaged, weighted by the groups' sample
counts. A custom trainer plugs into the group rounds; a custom
aggregator is refused, since the global level is a fixed group-weighted
mean.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core.aggregation import normalize_weights, stack_pytrees, weighted_average
from .fedavg_api import FedAvgAPI
from .round_loop import RoundLoop, host_sums, mean_of


class HierarchicalFLAPI(RoundLoop, FedAvgAPI):
    """args: ``group_num``, ``group_method`` (``random`` or contiguous),
    ``group_comm_round``; ``comm_round`` counts GLOBAL rounds."""

    algorithm = "HierFedAvg"
    _accepts_custom_aggregator = False

    def __init__(self, args, device, dataset, model, client_trainer=None,
                 server_aggregator=None) -> None:
        super().__init__(args, device, dataset, model, client_trainer=client_trainer,
                         server_aggregator=server_aggregator)
        self.groups = self._groups()
        self._nsamples = torch.tensor(np.asarray(dataset.packed_num_samples),
                                      dtype=torch.float32, device=self.device)

    def _groups(self) -> List[np.ndarray]:
        n = self.dataset.client_num
        gnum = int(getattr(self.args, "group_num", 2))
        rng = np.random.RandomState(int(getattr(self.args, "random_seed", 0)))
        method = getattr(self.args, "group_method", "random")
        idxs = rng.permutation(n) if method == "random" else np.arange(n)
        return [g.astype(np.int32) for g in np.array_split(idxs, gnum)]

    def run_round(self, round_idx: int) -> Dict[str, torch.Tensor]:
        """Every group's ``group_comm_round`` rounds from the global
        model, then the group-weighted mean; the summed metrics of each
        group's last round."""
        packed = self.dataset.packed_train
        group_rounds = int(getattr(self.args, "group_comm_round", 1))
        # the round-indexed LR decays with the GLOBAL round
        lr_mult = self._lr_mult(round_idx)
        self._round_idx = round_idx
        group_params, group_weights, summed = [], [], {}
        for g in self.groups:
            idx = torch.as_tensor(g, dtype=torch.int64, device=self.device)
            p, state = self.global_params, self._init_server_state()
            for _ in range(group_rounds):
                p, state, sums = self._round_fn(p, state, packed, self._nsamples, idx,
                                                self._shuffle_uniforms(len(g)), lr_mult)
            group_params.append(p)
            group_weights.append(float(np.asarray(self.dataset.packed_num_samples)[g].sum()))
            summed = {k: summed.get(k, 0.0) + v for k, v in sums.items()}
        weights = normalize_weights(torch.tensor(group_weights, device=self.device))
        self.global_params = weighted_average(stack_pytrees(group_params), weights)
        return summed

    def round_stats(self, round_idx: int, summed) -> Dict[str, float]:
        sums = host_sums(summed)
        return {**self._local_test_on_all_clients(round_idx), "groups": len(self.groups),
                "train_loss_cohort": mean_of(sums, "loss_sum")}
