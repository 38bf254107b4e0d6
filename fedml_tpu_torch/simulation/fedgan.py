"""Federated GAN training (port of ``fedml_tpu/simulation/fedgan.py``).

The reference's ``fedgan``: each client trains a generator /
discriminator pair locally, alternating a D step and a G step on every
batch, and the server FedAvg's BOTH networks each round. Here the
cohort trains at once (``torch.func.vmap`` over the client axis, epochs
x batches driven from Python); each net has its own Adam (b1 0.5); the
non-saturating loss is the softplus form, masked so that padded
examples add nothing, and a fully padded batch leaves params and
optimizer state as they were.

The noise: the JAX package draws it from threefry keys; the port draws
``[C, epochs, nb, 2, bs, latent]`` a round (z for the D step and for
the G step of every batch) from a ``torch.Generator`` on the device
seeded by ``random_seed``, or takes it from the caller (``run_round(...,
noise=...)``), so that a test can feed both packages the same z.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.aggregation import normalize_weights, weighted_average
from ..core.optimizers import adam
from ..device import get_device
from ..models.gan import Discriminator, Generator
from ..models.spec import FedModel
from .fedavg_api import deterministic_client_sampling
from .round_loop import RoundLoop, host_sums, nonempty_batches

Params = Dict[str, torch.Tensor]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (logaddexp(x, 0)),
    without torch's linear cut-off above 20."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _keep(cond, new, old):
    return pytree.tree_map(lambda a, b: torch.where(cond, a, b), new, old)


class FedGANAPI(RoundLoop):
    """Single-card federated GAN. ``model`` is ignored: the G/D pair is
    ``models.gan``'s (args ``gan_latent_dim``, ``gan_lr_g``,
    ``gan_lr_d``). ``global_params`` is ``{"gen": ..., "disc": ...}``."""

    algorithm = "FedGAN"

    def __init__(self, args, device, dataset, model=None) -> None:
        self.args = args
        self.device = get_device(device)
        self.dataset = dataset
        self.history: List[Dict[str, float]] = []
        self.latent_dim = int(getattr(args, "gan_latent_dim", 64))
        img_shape = tuple(dataset.packed_train.x.shape[-3:])
        self.gen = FedModel("gan_generator", Generator(self.latent_dim).to(self.device),
                            example_shape=(self.latent_dim,))
        self.disc = FedModel("gan_discriminator", Discriminator(img_shape[-1]).to(self.device),
                             example_shape=img_shape)
        seed = int(getattr(args, "random_seed", 0))
        init = torch.Generator().manual_seed(seed)
        self.global_params = {"gen": self.gen.init(init), "disc": self.disc.init(init)}
        self.noise = torch.Generator(device=self.device).manual_seed(seed)
        self.g_opt = adam(float(getattr(args, "gan_lr_g", 2e-4)), b1=0.5)
        self.d_opt = adam(float(getattr(args, "gan_lr_d", 2e-4)), b1=0.5)
        self.epochs = int(getattr(args, "epochs", 1))
        self._grad_d = torch.func.grad_and_value(self._d_loss)
        self._grad_g = torch.func.grad_and_value(self._g_loss)
        self._step = torch.func.vmap(self._client_step)
        self._nonempty = nonempty_batches(dataset.packed_train.mask)

    # -- losses --------------------------------------------------------
    def _d_loss(self, d, g, x, mask, z):
        fake = self.gen.apply(g, z)
        real_logit = self.disc.apply(d, x)
        fake_logit = self.disc.apply(d, fake)
        # BCE(real -> 1) + BCE(fake -> 0), padding masked out
        per = softplus(-real_logit) * mask + softplus(fake_logit)
        return per.sum() / torch.clamp(mask.sum() + mask.shape[0], min=1.0)

    def _g_loss(self, g, d, z):
        return torch.mean(softplus(-self.disc.apply(d, self.gen.apply(g, z))))

    def _client_step(self, g, d, gs, ds, x, m, z):
        dgrads, dl = self._grad_d(d, g, x, m, z[0])
        du, ds_new = self.d_opt.update(dgrads, ds, d)
        d_new = {k: d[k] + du[k] for k in d}
        ggrads, gl = self._grad_g(g, d_new, z[1])
        gu, gs_new = self.g_opt.update(ggrads, gs, g)
        g_new = {k: g[k] + gu[k] for k in g}
        nonempty = m.sum() > 0
        n = nonempty.to(dl.dtype)
        return (_keep(nonempty, g_new, g), _keep(nonempty, d_new, d),
                _keep(nonempty, gs_new, gs), _keep(nonempty, ds_new, ds),
                {"d_loss": dl * n, "g_loss": gl * n, "n": n})

    # -- the round -----------------------------------------------------
    def draw_noise(self, clients: int) -> torch.Tensor:
        nb, bs = self.dataset.packed_train.mask.shape[-2:]
        return torch.randn((clients, self.epochs, nb, 2, bs, self.latent_dim),
                           generator=self.noise, device=self.device)

    def run_round(self, round_idx: int, noise: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
        """One round: the cohort's local D/G training and the FedAvg of
        both nets. ``noise`` ``[C, epochs, nb, 2, bs, latent]`` replaces
        the generator's draws."""
        args, packed = self.args, self.dataset.packed_train
        idx = deterministic_client_sampling(round_idx, self.dataset.client_num,
                                            int(args.client_num_per_round))
        sel = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        x, mask = packed.x.index_select(0, sel), packed.mask.index_select(0, sel)
        if noise is None:
            noise = self.draw_noise(len(idx))
        C = len(idx)

        def stack(tree):
            return pytree.tree_map(lambda t: t.expand((C,) + tuple(t.shape)), tree)

        g, d = stack(self.global_params["gen"]), stack(self.global_params["disc"])
        gs = stack(self.g_opt.init(self.global_params["gen"]))
        ds = stack(self.d_opt.init(self.global_params["disc"]))
        for epoch in range(self.epochs):
            sums = {"d_loss": 0.0, "g_loss": 0.0, "n": 0.0}
            # a step at which every client's batch is padding changes
            # nothing: it is skipped
            for i in np.flatnonzero(self._nonempty[idx].any(axis=0)):
                g, d, gs, ds, m = self._step(g, d, gs, ds, x[:, i], mask[:, i],
                                             noise[:, epoch, i].to(x.dtype))
                sums = {k: sums[k] + m[k] for k in sums}
        ns = torch.as_tensor(np.asarray(self.dataset.packed_num_samples)[idx], device=self.device)
        weights = normalize_weights(ns)
        self.global_params = {"gen": weighted_average(g, weights),
                              "disc": weighted_average(d, weights)}
        return {k: v.sum() for k, v in sums.items()}

    # -- evaluation ----------------------------------------------------
    def evaluate(self) -> Dict[str, float]:
        """The discriminator's real-vs-fake accuracy and the generator's
        loss over the global test split."""
        params, test = self.global_params, self.dataset.test_data_global
        noise = torch.randn((test.mask.shape[0], test.mask.shape[1], self.latent_dim),
                            generator=self.noise, device=self.device)
        parts = []
        with torch.no_grad():
            for i in range(test.mask.shape[0]):
                x, m = test.x[i], test.mask[i]
                fake = self.gen.apply(params["gen"], noise[i].to(x.dtype))
                rl = self.disc.apply(params["disc"], x)
                fl = self.disc.apply(params["disc"], fake)
                some = (m.sum() > 0).to(rl.dtype)
                parts.append(torch.stack([
                    ((rl > 0) * m).sum() + (fl < 0).sum() * some,
                    m.sum() + m.shape[0] * some,
                    softplus(-fl).mean() * some,
                    some,
                ]))
        correct, count, g_loss, batches = torch.stack(parts).sum(0).tolist()
        return {"disc_acc": correct / max(count, 1.0), "test_g_loss": g_loss / max(batches, 1.0)}

    def round_stats(self, round_idx: int, summed) -> Dict[str, float]:
        sums = host_sums(summed)
        n = max(sums["n"], 1.0)
        return {"d_loss": sums["d_loss"] / n, "g_loss": sums["g_loss"] / n, **self.evaluate()}
