"""FedOpt's server optimizers and FedNova's preconditions in the port.

Each server optimizer (``core/optimizers.py`` ``create_server_optimizer``)
against the optax one the JAX package builds
(``fedml_tpu/core/optimizers.py`` ``create_server_optimizer``), 4 steps
on the same float64 pseudo-gradients: the formulas are the same, so they
agree to float64 rounding (1e-12). End to end, the algorithms are held
to the JAX package in ``test_torch_fedavg_resnet.py``.
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.core.optimizers import create_server_optimizer as jax_server_optimizer
import fedml_tpu_torch
from fedml_tpu_torch import models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.core.optimizers import create_server_optimizer
from fedml_tpu_torch.data import load
from fedml_tpu_torch.simulation import FedNovaAPI
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-12


@pytest.mark.parametrize("name, extra", [
    ("sgd", {}), ("sgd", {"server_momentum": 0.9}), ("adam", {}),
    ("adam", {"server_beta1": 0.8, "server_beta2": 0.99}), ("adagrad", {}), ("yogi", {})])
def test_server_optimizer_matches_optax(name, extra):
    args = argparse.Namespace(server_optimizer=name, server_lr=0.1, **extra)
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(3, 4)), "b": rng.normal(size=(4,))}
    grads = [{k: rng.normal(size=v.shape) for k, v in params.items()} for _ in range(4)]
    with jax.enable_x64(True):
        jtx = jax_server_optimizer(args)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        js = jtx.init(jp)
        for g in grads:
            u, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
            jp = optax.apply_updates(jp, u)
        want = {k: np.asarray(v) for k, v in jp.items()}
    ttx = create_server_optimizer(args)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = ttx.init(tp)
    for g in grads:
        u, ts = ttx.update({k: torch.tensor(v) for k, v in g.items()}, ts, tp)
        tp = {k: tp[k] + u[k] for k in tp}
    for k in want:
        assert tp[k].dtype == torch.float64
        np.testing.assert_allclose(tp[k].numpy(), want[k], atol=ATOL, err_msg=k)
    moved = max(float(np.abs(want[k] - params[k]).max()) for k in want)
    assert moved > 1e-2


def test_unknown_server_optimizer_raises():
    with pytest.raises(ValueError, match="server_optimizer"):
        create_server_optimizer(argparse.Namespace(server_optimizer="lamb"))


def test_fednova_needs_the_vectorized_mode():
    args = Arguments()
    for k, v in dict(dataset="mnist", synthetic_train_size=120, synthetic_test_size=30,
                     model="lr", client_num_in_total=3, client_num_per_round=3,
                     comm_round=1, batch_size=20, sim_mode="sequential",
                     federated_optimizer="FedNova").items():
        setattr(args, k, v)
    args._validate()
    args = fedml_tpu_torch.init(args)
    ds = load(args, device="cpu")
    api = FedNovaAPI(args, "cpu", ds, models.create(args, ds.class_num, device="cpu"))
    with pytest.raises(NotImplementedError, match="vectorized"):
        api.train()
