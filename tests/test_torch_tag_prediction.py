"""Tag prediction (``stackoverflow_lr``): the port against the JAX package.

The multi-label task end to end: the stand-in's multi-hot federation
(bitwise, ``tests/test_torch_fedavg_data.py``), the sigmoid
cross-entropy with its true-positive, false-positive and
false-negative counts, precision, recall and F1 from their sums, the
model factory's task, and FedAvg rounds of logistic regression from the
same start on the same packed arrays in f32.

Tolerance: a logistic regression has no branch a rounding could flip
(no ReLU), so the round is compared in the task's own f32 at 1e-5
relative; measured on these inputs, params within 1.7e-7 of the JAX
package's (relative to each leaf's largest entry), the losses within
2.3e-7 relative, and the tp/fp/fn counts, hence precision, recall and
F1, equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import models as jax_models
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.core import losses as jax_losses
from fedml_tpu.data import load as jax_load
from fedml_tpu.simulation import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu_torch import models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.core import losses
from fedml_tpu_torch.data import load
from fedml_tpu_torch.simulation import FedAvgAPI
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-5
TAGS = dict(dataset="stackoverflow_lr", synthetic_train_size=600, synthetic_test_size=120,
            synthetic_feature_dim=100, model="lr", client_num_in_total=4,
            client_num_per_round=4, comm_round=1, epochs=1, batch_size=16, learning_rate=0.5,
            frequency_of_the_test=1, shuffle=False, partition_method="homo")


def _args(cls, **kw):
    a = cls()
    for k, v in {**TAGS, **kw}.items():
        setattr(a, k, v)
    a._validate()
    return a


def test_loads_multihot():
    args = fedml_tpu_torch.init(_args(Arguments))
    ds = load(args, device="cpu")
    assert ds.task == "tag_prediction" and ds.class_num == 500
    assert ds.packed_train.y.shape[-1] == 500 and ds.packed_train.y.dtype == torch.float32
    assert args.input_dim == 100  # the loader records the realized dim
    model = models.create(args, ds.class_num, device="cpu")
    assert model.task == "tag_prediction" and model.loss_fn is losses.sigmoid_bce
    assert models.create(_args(Arguments, dataset="synthetic", input_dim=60), 10,
                         device="cpu").task == "classification"


@pytest.mark.parametrize("shape", [(16, 40), (3, 8, 40)])
def test_sigmoid_bce_matches_the_references(shape):
    rng = np.random.RandomState(len(shape))
    logits = (rng.randn(*shape) * 4).astype(np.float32)
    labels = (rng.rand(*shape) < 0.2).astype(np.float32)
    mask = (rng.rand(*shape[:-1]) < 0.8).astype(np.float32)
    loss, m = losses.sigmoid_bce(torch.tensor(logits), torch.tensor(labels), torch.tensor(mask))
    jloss, jm = jax_losses.sigmoid_bce(jnp.asarray(logits), jnp.asarray(labels),
                                       jnp.asarray(mask))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert set(m) == set(jm)
    for k in ("tp", "fp", "fn", "count", "correct"):
        assert float(m[k]) == float(jm[k]), k


def test_metrics_from_sums_match_the_references():
    sums = {"loss_sum": 12.5, "correct": 30.0, "count": 50.0, "tp": 30.0, "fp": 10.0,
            "fn": 20.0}
    args = _args(Arguments)
    jargs = _args(JaxArguments)
    args.input_dim = jargs.input_dim = 100
    got = models.create(args, 500, device="cpu").metrics_from_sums(sums)
    want = jax_models.create(jargs, 500).metrics_from_sums(sums)
    assert got == want
    assert got["precision"] == 0.75 and got["recall"] == 0.6
    assert got["acc"] == pytest.approx(2 * 0.75 * 0.6 / 1.35)
    empty = {**sums, "tp": 0.0, "fp": 0.0, "fn": 0.0}
    assert models.create(args, 500, device="cpu").metrics_from_sums(empty)["acc"] == 0.0


def _rounds(rounds: int):
    """``rounds`` FedAvg rounds of both packages from the JAX package's
    initial params, on the same packed stand-in (the loaders are bitwise
    equal). Returns (port API, JAX API)."""
    jargs = fedml_tpu.init(_args(JaxArguments, comm_round=rounds))
    jds = jax_load(jargs)
    japi = JaxFedAvgAPI(jargs, None, jds, jax_models.create(jargs, jds.class_num))
    start = params_from_flax(jax.tree.map(np.asarray, japi.global_params))
    japi.train()
    targs = fedml_tpu_torch.init(_args(Arguments, comm_round=rounds))
    tds = load(targs, device="cpu")
    tapi = FedAvgAPI(targs, "cpu", tds, models.create(targs, tds.class_num, device="cpu"))
    tapi.global_params = start
    tapi.train()
    return tapi, japi


def test_one_round_matches_jax_in_f32():
    tapi, japi = _rounds(1)
    want = params_from_flax(jax.tree.map(np.asarray, japi.global_params))
    assert set(want) == set(tapi.global_params)
    for k in want:
        got = tapi.global_params[k]
        assert got.dtype == torch.float32
        scale = float(want[k].abs().max())
        assert float((got - want[k]).abs().max()) <= RTOL * scale, k
    (h,), (j,) = tapi.history, japi.history
    for key in ("train_loss", "test_loss", "train_loss_cohort"):
        np.testing.assert_allclose(h[key], j[key], rtol=RTOL, err_msg=key)
    # F1 (``acc``) from the tp/fp/fn sums: equal, not close
    assert (h["train_acc"], h["test_acc"]) == (j["train_acc"], j["test_acc"])
    got, ref = tapi.evaluate_global(), japi.evaluate_global()
    for key in ("precision", "recall", "acc", "count"):
        assert got[key] == ref[key], key
        assert 0.0 <= got[key] <= (1.0 if key != "count" else 120.0)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=RTOL)


def test_trains_and_reports_precision_recall():
    tapi, _ = _rounds(4)
    first, last = tapi.history[0], tapi.history[-1]
    assert np.isfinite(last["train_loss"]) and last["train_loss"] < first["train_loss"]
    stats = tapi.evaluate_global()
    assert 0.0 < stats["precision"] <= 1.0 and 0.0 < stats["recall"] <= 1.0
