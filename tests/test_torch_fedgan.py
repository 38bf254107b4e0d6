"""FedGAN through the port against the JAX package.

One round in float64 from the same initial params, with the JAX
package's noise fed in: the test rebuilds its z by repeating its key
chain. Both nets agree to 1e-10, and so do the round's mean D and G
losses; the port's own draws train to finite params.
"""

from __future__ import annotations

import jax
import numpy as np
import torch
from torch.utils import _pytree as pytree

from fedml_tpu.simulation import fedgan as jax_fedgan
import fedml_tpu_torch
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.simulation import FedGANAPI
from test_torch_hier_decentralized import _f64, _set, _torch, api_pair, assert_params_close
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(dataset="mnist", synthetic_train_size=48, synthetic_test_size=16,
             partition_method="hetero", partition_alpha=0.5, client_num_in_total=3,
             client_num_per_round=2, comm_round=2, epochs=1, batch_size=8,
             learning_rate=0.05, frequency_of_the_test=1, shuffle=False, random_seed=2)


# -- FedGAN --------------------------------------------------------------------------


def _jax_noise(rng, clients, epochs, nb, bs, latent):
    """The JAX FedGAN round's z, [C, epochs, nb, 2, bs, latent]: train()
    splits the API's key for the round (fedgan.py:183), the round splits
    one key per client (:132), and every step splits (key, kz1, kz2)
    from the carried key and draws z1 and z2 (:91-94)."""
    _, r_rng = jax.random.split(rng)
    out = np.zeros((clients, epochs, nb, 2, bs, latent))
    for c, key in enumerate(jax.random.split(r_rng, clients)):
        for e in range(epochs):
            for i in range(nb):
                key, kz1, kz2 = jax.random.split(key, 3)
                out[c, e, i, 0] = np.asarray(jax.random.normal(kz1, (bs, latent)))
                out[c, e, i, 1] = np.asarray(jax.random.normal(kz2, (bs, latent)))
    return out


def test_fedgan_round_matches_jax_with_its_noise():
    kw = dict(SMALL, federated_optimizer="FedGAN", gan_latent_dim=8,
              comm_round=1, gan_lr_g=0.01, gan_lr_d=0.01)
    with jax.enable_x64(True):
        japi, tapi, tds = api_pair(jax_fedgan.FedGANAPI, FedGANAPI, kw)
        japi.global_params = _f64(japi.global_params)
        start = {n: _torch(p) for n, p in japi.global_params.items()}
        nb, bs = tds.packed_train.mask.shape[-2:]
        z = _jax_noise(japi.rng, 2, 1, nb, bs, 8)
        japi.train()
        want = {n: _torch(p) for n, p in japi.global_params.items()}
    tapi.global_params = {n: dict(p) for n, p in start.items()}
    summed = tapi.run_round(0, noise=torch.as_tensor(z))
    for n in ("gen", "disc"):
        assert_params_close(tapi.global_params[n], want[n])
        assert max(float((want[n][k] - start[n][k]).abs().max()) for k in want[n]) > 1e-4
    steps = max(float(summed["n"]), 1.0)
    for key in ("d_loss", "g_loss"):
        np.testing.assert_allclose(float(summed[key]) / steps, japi.history[-1][key], rtol=1e-9)
    stats = tapi.round_stats(0, summed)
    assert 0.0 <= stats["disc_acc"] <= 1.0 and np.isfinite(stats["test_g_loss"])


def test_fedgan_draws_its_own_noise():
    kw = dict(SMALL, federated_optimizer="FedGAN", gan_latent_dim=8)
    args = _set(Arguments(), **kw)
    api = FedGANAPI(args, "cpu", fedml_tpu_torch.data.load(args, device="cpu"))
    assert api.draw_noise(2).shape == (2, 1) + tuple(api.dataset.packed_train.mask.shape[-2:-1]) + (
        2, 8, 8)
    stats = api.train()
    assert np.isfinite(stats["d_loss"]) and np.isfinite(stats["g_loss"])
    assert pytree.tree_all(lambda t: bool(torch.isfinite(t).all()), api.global_params)
