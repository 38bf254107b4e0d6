"""FedNAS: federated differentiable architecture search (port of ``fedml_tpu/simulation/fednas.py``).

The reference's ``fednas`` with the DARTS search space: in every local
step a client first takes an ARCHITECT step (Adam on the alphas over
its validation half, first-order DARTS: ``architect.py`` with
``unrolled=False``), then a WEIGHT step (momentum SGD on the network
weights over its training half); the server averages weights and
alphas together (``FedNASAggregator``). The cohort trains at once
(``torch.func.vmap``); the weight/alpha split masks gradients by the
alphas' key (``models/darts.py`` ``split_grad_masks``), so aggregation
is the plain weighted mean.

The halves are split along the EXAMPLE axis of every batch (the first
``bs // 2`` examples train, the rest validate), not by batch slot:
padding sits in the tail batches, so halving by slot would hand a small
client an all-padding validation half. A step whose half is all padding
leaves what that half updates as it was.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.aggregation import normalize_weights, weighted_average
from ..core.local_trainer import make_eval_fn
from ..core.losses import softmax_cross_entropy
from ..core.optimizers import adam, sgd
from ..core.types import Batches
from ..device import get_device
from ..models.darts import DARTSNetwork, arch_path, genotype, split_grad_masks
from ..models.spec import FedModel
from .fedavg_api import deterministic_client_sampling
from .round_loop import RoundLoop, host_sums, mean_of, nonempty_batches

Params = Dict[str, torch.Tensor]


def halves(batches: Batches):
    """(train half, validation half) of ``[..., nb, bs, ...]`` batches,
    split along the example axis: the first ``bs // 2`` examples and the
    rest."""
    lead = batches.mask.dim()
    h = batches.mask.shape[-1] // 2

    def cut(t, sl):
        return t[(slice(None),) * (lead - 1) + (sl,)]

    tr = Batches(x=cut(batches.x, slice(None, h)), y=cut(batches.y, slice(None, h)),
                 mask=cut(batches.mask, slice(None, h)))
    va = Batches(x=cut(batches.x, slice(h, None)), y=cut(batches.y, slice(h, None)),
                 mask=cut(batches.mask, slice(h, None)))
    return tr, va


def _keep(cond, new, old):
    return pytree.tree_map(lambda a, b: torch.where(cond, a, b), new, old)


class FedNASAPI(RoundLoop):
    """args: ``nas_width``, ``nas_cells``, ``nas_steps``,
    ``arch_learning_rate`` (the reference's arch_lr), ``learning_rate``.
    The model is ``models.create``'s ``darts`` network when it is one,
    else one built from the same args."""

    algorithm = "FedNAS"

    def __init__(self, args, device, dataset, model=None) -> None:
        self.args = args
        self.device = get_device(device)
        self.dataset = dataset
        self.history: List[Dict[str, float]] = []
        if model is not None and isinstance(getattr(model, "module", None), DARTSNetwork):
            self.model = model
        else:
            img_shape = tuple(dataset.packed_train.x.shape[-3:])
            self.model = FedModel("darts_search", DARTSNetwork(
                dataset.class_num,
                width=int(getattr(args, "nas_width", 16)),
                num_cells=int(getattr(args, "nas_cells", 2)),
                steps=int(getattr(args, "nas_steps", 2)),
                in_channels=img_shape[-1],
            ).to(self.device), example_shape=img_shape)
        self.global_params = self.model.init(
            torch.Generator().manual_seed(int(getattr(args, "random_seed", 0))))
        self._arch_key = arch_path(self.global_params)
        self.w_opt = sgd(float(getattr(args, "learning_rate", 0.025)), momentum=0.9)
        self.a_opt = adam(float(getattr(args, "arch_learning_rate", 3e-4)))
        self.epochs = int(getattr(args, "epochs", 1))
        self._grad = torch.func.grad_and_value(self._loss, has_aux=True)
        self._step = torch.func.vmap(self._client_step, in_dims=(0, 0, 0, 0, 0, None, None))
        self._evaluate = make_eval_fn(self.model.apply, softmax_cross_entropy)
        # per client and batch: does either half hold a real example
        self._nonempty = nonempty_batches(dataset.packed_train.mask)

    def _loss(self, p, x, y, m):
        loss, metrics = softmax_cross_entropy(self.model.apply(p, x), y, m)
        return loss, metrics

    def _client_step(self, p, ws, as_, tr, va, w_mask, a_mask):
        tx, ty, tm = tr
        vx, vy, vm = va
        # architect step: the alphas on the validation half
        g, _ = self._grad(p, vx, vy, vm)
        ua, as_new = self.a_opt.update({k: g[k] * a_mask[k] for k in g}, as_, p)
        has_val = vm.sum() > 0
        p_a = _keep(has_val, {k: p[k] + ua[k] for k in p}, p)
        as_new = _keep(has_val, as_new, as_)
        # weight step: the weights on the training half
        g2, (tl, metrics) = self._grad(p_a, tx, ty, tm)
        uw, ws_new = self.w_opt.update({k: g2[k] * w_mask[k] for k in g2}, ws, p_a)
        has_train = tm.sum() > 0
        p_w = {k: p_a[k] + uw[k] for k in p_a}
        return (_keep(has_train, p_w, p_a), _keep(has_train, ws_new, ws), as_new,
                {"loss_sum": tl * metrics["count"], "correct": metrics["correct"],
                 "count": metrics["count"]})

    def run_round(self, round_idx: int) -> Dict[str, torch.Tensor]:
        args, packed = self.args, self.dataset.packed_train
        idx = deterministic_client_sampling(round_idx, self.dataset.client_num,
                                            int(args.client_num_per_round))
        sel = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        cohort = Batches(x=packed.x.index_select(0, sel), y=packed.y.index_select(0, sel),
                         mask=packed.mask.index_select(0, sel))
        tr, va = halves(cohort)
        C, params = len(idx), self.global_params
        w_mask, a_mask = split_grad_masks(params)

        def stack(tree):
            return pytree.tree_map(lambda t: t.expand((C,) + tuple(t.shape)), tree)

        p, ws, as_ = stack(params), stack(self.w_opt.init(params)), stack(self.a_opt.init(params))
        for _ in range(self.epochs):
            sums = {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
            # a step at which every client's batch is padding changes
            # nothing: it is skipped
            for i in np.flatnonzero(self._nonempty[idx].any(axis=0)):
                p, ws, as_, m = self._step(
                    p, ws, as_, (tr.x[:, i], tr.y[:, i], tr.mask[:, i]),
                    (va.x[:, i], va.y[:, i], va.mask[:, i]), w_mask, a_mask)
                sums = {k: sums[k] + m[k] for k in sums}
        ns = torch.as_tensor(np.asarray(self.dataset.packed_num_samples)[idx], device=self.device)
        # FedNASAggregator: weights and alphas averaged together
        self.global_params = weighted_average(p, normalize_weights(ns))
        return {k: v.sum() for k, v in sums.items()}

    def current_alphas(self) -> torch.Tensor:
        return self.global_params[self._arch_key]

    def current_genotype(self):
        return genotype(self.current_alphas(), steps=int(getattr(self.args, "nas_steps", 2)))

    def round_stats(self, round_idx: int, summed) -> Dict[str, float]:
        sums = host_sums(summed)
        ev = self.model.metrics_from_sums(
            self._evaluate(self.global_params, self.dataset.test_data_global))
        return {"train_loss": mean_of(sums, "loss_sum"), "test_acc": ev["acc"],
                "test_loss": ev["loss"], "genotype": str(self.current_genotype())}
