"""Centralized (non-federated) baseline trainer (port of
``fedml_tpu/centralized.py``).

Parity with the reference's ``centralized/centralized_trainer.py``: plain
training on the coalesced federated dataset, the numeric baseline the
equivalence oracles compare against. It is the clients' own local
trainer (``core/local_trainer.py``) pointed at the global split as a
cohort of one: one epoch a call, then evaluation on both splits, one
history record an epoch. The optimizer is built with ``schedules=True``:
as in the JAX package, a step-indexed schedule (``lr_total_steps``)
counts the steps of each call.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from .core.local_trainer import compute_dtype_from_args, make_eval_fn, make_local_train_fn
from .core.optimizers import create_client_optimizer
from .core.types import Batches
from .device import get_device

__all__ = ["CentralizedTrainer"]


def _as_cohort(b: Batches) -> Batches:
    """``[nb, bs, ...]`` -> a cohort of one ``[1, nb, bs, ...]``."""
    return Batches(x=b.x[None], y=b.y[None], mask=b.mask[None])


class CentralizedTrainer:
    """``CentralizedTrainer(args, device, dataset, model).train()`` trains
    ``args.epochs`` epochs on ``device`` (which must name where the model
    lies) and returns the last epoch's record."""

    def __init__(self, args, device, dataset, model) -> None:
        from .cross_silo import check_device

        self.device = get_device(device)
        check_device(device, model)
        self.args = args
        self.dataset = dataset
        self.model = model
        self.history: List[Dict[str, float]] = []
        seed = int(getattr(args, "random_seed", 0))
        self.params = model.init(torch.Generator().manual_seed(seed))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        dtype = compute_dtype_from_args(args)
        self._train_fn = make_local_train_fn(
            model.apply,
            model.loss_fn,
            create_client_optimizer(args, schedules=True),
            epochs=1,
            shuffle=bool(getattr(args, "shuffle", True)),
            compute_dtype=dtype,
        )
        self._eval = make_eval_fn(model.apply, model.loss_fn, compute_dtype=dtype)

    def uniforms(self, epoch: int) -> torch.Tensor:
        """The shuffle's uniforms of an epoch: ``[1, 1, nb*bs]``."""
        n = self.dataset.train_data_global.mask.numel()
        return torch.rand((1, 1, n), generator=self.generator, device=self.device)

    def train(self) -> Dict[str, float]:
        epochs = int(getattr(self.args, "epochs", 1))
        train, test = self.dataset.train_data_global, self.dataset.test_data_global
        final: Dict[str, float] = {}
        for epoch in range(epochs):
            t0 = time.perf_counter()
            stacked, _ = self._train_fn(self.params, _as_cohort(train), self.uniforms(epoch))
            self.params = {k: v[0] for k, v in stacked.items()}
            tr = self.model.metrics_from_sums(self._eval(self.params, train))
            te = self.model.metrics_from_sums(self._eval(self.params, test))
            final = {
                "epoch": epoch,
                "train_acc": tr["acc"],
                "train_loss": tr["loss"],
                "test_acc": te["acc"],
                "test_loss": te["loss"],
                "epoch_time_s": time.perf_counter() - t0,
            }
            self.history.append(final)
        return final
