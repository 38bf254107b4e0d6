"""Decentralized gossip SGD, DSGD and PushSum (port of ``fedml_tpu/simulation/decentralized.py``).

The reference's ``decentralized`` simulators (``ClientDSGD``,
``ClientPushsum``) over the topology managers. All N nodes' params live
stacked on the device, ``[N, ...]``; one gossip round is

1. every node's local training at once (``local_train(...,
   stacked=True)``: each node trains its own row), then
2. one mixing product per leaf, ``theta <- W @ theta`` over the node
   axis (``torch.tensordot`` in the leaf's dtype, under the
   configuration's ``matmul_precision``).

DSGD mixes with the symmetric topology's row-stochastic W. PushSum
keeps a scalar mass per node and mixes with the asymmetric topology's
column-stochastic W: nodes train on the de-biased ``theta / mass`` and
re-bias after, and the mass is pushed with the same W, so its sum is
conserved. Every node takes part in every round (there is no server);
the consensus model, the node mean, is what is evaluated.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.topology import AsymmetricTopologyManager, SymmetricTopologyManager
from .fedavg_api import FedAvgAPI
from .round_loop import RoundLoop, host_sums, mean_of

Params = Dict[str, torch.Tensor]


def _mix(stacked: Params, W: torch.Tensor) -> Params:
    """theta_i <- sum_j W[i, j] theta_j over the stacked node axis."""
    return {k: torch.tensordot(W.to(v.dtype), v, dims=1) for k, v in stacked.items()}


def _per_node(mass: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return mass.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)


def consensus(node_params: Params):
    """(the node mean, the summed squared distance of the nodes from it)."""
    mean = {k: v.mean(dim=0) for k, v in node_params.items()}
    dist = sum(torch.sum(torch.square(v - mean[k][None])) for k, v in node_params.items())
    return mean, dist


class DecentralizedDSGDAPI(RoundLoop, FedAvgAPI):
    """Symmetric gossip (ClientDSGD). args: ``topology_neighbor_num``,
    ``topology_beta`` (the Watts-Strogatz rewiring probability)."""

    algorithm = "DSGD"
    directed = False
    # the node axis is sized by the federation, not padded to a mesh: the
    # mesh simulator refuses it, as the JAX package does
    supports_mesh = False

    def __init__(self, args, device, dataset, model) -> None:
        super().__init__(args, device, dataset, model)
        if self._round_lr is not None:
            raise ValueError(
                "round-indexed lr_schedule is not supported for "
                "decentralized gossip (no server round clock); use "
                "lr_schedule=constant"
            )
        n = dataset.client_num
        packed_rows = int(dataset.packed_train.mask.shape[0])
        if packed_rows != n:
            raise ValueError(
                f"decentralized gossip needs one node per packed client "
                f"(got {packed_rows} packed rows for {n} clients)"
            )
        seed = int(getattr(args, "random_seed", 0))
        neighbors = int(getattr(args, "topology_neighbor_num", 2))
        if self.directed:
            topo = AsymmetricTopologyManager(n, neighbor_num=neighbors, seed=seed)
        else:
            topo = SymmetricTopologyManager(
                n, neighbor_num=neighbors, beta=float(getattr(args, "topology_beta", 0.0)),
                seed=seed)
        topo.generate_topology()
        self.topology = topo
        self.W = topo.mixing_matrix(self.device)
        # every node starts from the same init
        self.node_params = {k: v.expand((n,) + tuple(v.shape)).clone()
                            for k, v in self.global_params.items()}

    def _train_nodes(self, node_params: Params):
        rng = self._shuffle_uniforms(self.dataset.client_num)
        return self._local_train(node_params, self.dataset.packed_train, rng, None,
                                 stacked=True)

    def run_round(self, round_idx: int) -> Dict[str, torch.Tensor]:
        self._round_idx = round_idx
        trained, metrics = self._train_nodes(self.node_params)
        self.node_params = _mix(trained, self.W)
        return {k: v.sum() for k, v in metrics.items()}

    def _debiased(self) -> Params:
        return self.node_params

    def round_stats(self, round_idx: int, summed) -> Dict[str, float]:
        mean, dist = consensus(self._debiased())
        self.global_params = mean
        sums = host_sums({**summed, "consensus_dist": dist})
        return {**self._local_test_on_all_clients(round_idx),
                "consensus_dist": sums["consensus_dist"],
                "train_loss_nodes": mean_of(sums, "loss_sum")}


class DecentralizedPushSumAPI(DecentralizedDSGDAPI):
    """Directed gossip with the PushSum weight correction
    (ClientPushsum): column-stochastic mixing, de-biased by the gossiped
    scalar mass."""

    algorithm = "PushSum"
    directed = True

    def __init__(self, args, device, dataset, model) -> None:
        super().__init__(args, device, dataset, model)
        self.mass = torch.ones(dataset.client_num, device=self.device)

    def run_round(self, round_idx: int) -> Dict[str, torch.Tensor]:
        self._round_idx = round_idx
        mass = self.mass
        # train on the de-biased estimates z / w, re-bias, then push
        debiased = {k: v / _per_node(mass, v) for k, v in self.node_params.items()}
        trained, metrics = self._train_nodes(debiased)
        rebiased = {k: v * _per_node(mass, v) for k, v in trained.items()}
        self.node_params = _mix(rebiased, self.W)
        self.mass = self.W.to(mass.dtype) @ mass
        return {k: v.sum() for k, v in metrics.items()}

    def _debiased(self) -> Params:
        return {k: v / _per_node(self.mass, v) for k, v in self.node_params.items()}
