"""FedNAS and FedSeg through the port against the JAX package.

Both packages train on the same packed arrays (the JAX loader's) from
the same initial params (carried across by ``convert.params_from_flax``)
in float64, where they agree to rounding (1e-10): FedNAS (the DARTS
search network, alphas and weights) and FedSeg (DeepLabLite through
FedAvg on the pascal_voc stand-in) for 2 rounds each. FedNAS's
train/validation halves are bitwise the JAX package's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fedml_tpu.simulation import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.simulation import fednas as jax_fednas
from fedml_tpu_torch.core.types import Batches
from fedml_tpu_torch.simulation import FedAvgAPI, FedNASAPI
from fedml_tpu_torch.simulation.fednas import halves
from test_torch_hier_decentralized import (
    _f64,
    _torch,
    api_pair,
    assert_params_close,
    compare_history,
)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CIFAR = dict(dataset="cifar10", synthetic_train_size=48, synthetic_test_size=16,
             partition_method="hetero", partition_alpha=0.5, client_num_in_total=3,
             client_num_per_round=2, comm_round=2, epochs=1, batch_size=8,
             learning_rate=0.05, frequency_of_the_test=1, shuffle=False, random_seed=2)


# -- FedNAS -------------------------------------------------------------------


def test_fednas_halves_are_bitwise():
    rng = np.random.default_rng(0)
    b = Batches(x=torch.as_tensor(rng.normal(size=(3, 2, 6, 4)).astype(np.float32)),
                y=torch.as_tensor(rng.integers(0, 5, (3, 2, 6))),
                mask=torch.as_tensor((rng.random((3, 2, 6)) > 0.3).astype(np.float32)))
    tr, va = halves(b)
    for leaf in ("x", "y", "mask"):
        full = getattr(b, leaf).numpy()
        assert np.array_equal(getattr(tr, leaf).numpy(),
                              np.asarray(jnp.asarray(full)[:, :, :3]))
        assert np.array_equal(getattr(va, leaf).numpy(),
                              np.asarray(jnp.asarray(full)[:, :, 3:]))


def test_fednas_two_rounds_match_jax():
    with jax.enable_x64(True):
        japi, tapi, _ = api_pair(jax_fednas.FedNASAPI, FedNASAPI, CIFAR, with_model=True,
                              federated_optimizer="FedNAS", model="darts", nas_width=4,
                              arch_learning_rate=0.05)
        japi.global_params = _f64(japi.global_params)
        start = _torch(japi.global_params)
        japi.train()
        want = _torch(japi.global_params)
    tapi.global_params = dict(start)
    tapi.train()
    assert float((want["alphas_holder"] - start["alphas_holder"]).abs().max()) > 1e-4
    assert_params_close(tapi.global_params, want)
    compare_history(tapi.history, japi.history, ("train_loss", "test_loss", "test_acc"))
    assert tapi.history[-1]["genotype"] == japi.history[-1]["genotype"]


# -- FedSeg --------------------------------------------------------------------------


def test_fedseg_two_rounds_match_jax():
    kw = dict(CIFAR, dataset="pascal_voc", model="deeplab", seg_width=4,
              synthetic_train_size=18, synthetic_test_size=6, batch_size=4)
    with jax.enable_x64(True):
        japi, tapi, tds = api_pair(JaxFedAvgAPI, FedAvgAPI, kw, with_model=True)
        japi.global_params = _f64(japi.global_params)
        start = _torch(japi.global_params)
        japi.train()
        want = _torch(japi.global_params)
    assert tds.task == "segmentation"
    tapi.global_params = dict(start)
    tapi.train()
    assert_params_close(tapi.global_params, want)
    compare_history(tapi.history, japi.history, ("train_loss", "test_loss", "test_acc"))


