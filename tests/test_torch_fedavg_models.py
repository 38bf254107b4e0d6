"""The port's FedAvg models against the JAX package's, from the same weights.

Params come from the JAX ``FedModel.init`` and cross through
``convert.params_from_flax`` (conv kernels transposed to OIHW, dense
kernels to [out, in]); logits, the loss and its metrics, and the
gradients of the loss then agree.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu import models as jax_models
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu_torch import models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.convert import params_from_flax
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# f32 in both packages from the same weights; logits and gradients
# differ by summation order only
ATOL = 1e-5

CASES = [  # (model, dataset, classes)
    ("lr", "mnist", 10),
    ("mlp", "mnist", 10),
    ("cnn", "femnist", 62),
    ("cnn", "cifar10", 10),
]


def _args(cls, model, dataset):
    a = cls()
    a.model, a.dataset, a.hidden_dim = model, dataset, 32
    return a


def _pair(model, dataset, classes, seed=0):
    jm = jax_models.create(_args(JaxArguments, model, dataset), classes)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = models.create(_args(Arguments, model, dataset), classes, device="cpu")
    tp = params_from_flax(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _inputs(shape, n=6, classes=10, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n,) + tuple(shape)).astype(np.float32)
    y = rng.integers(0, classes, size=n).astype(np.int64)
    mask = np.ones(n, np.float32)
    mask[-2:] = 0.0  # padded examples
    return x, y, mask


@pytest.mark.parametrize("model, dataset, classes", CASES)
def test_logits_match_jax(model, dataset, classes):
    jm, jp, tm, tp = _pair(model, dataset, classes)
    assert tm.name == jm.name and tuple(tm.example_shape) == tuple(jm.example_shape)
    x, _, _ = _inputs(jm.example_shape)
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(x)))
    got = tm.apply(tp, torch.as_tensor(x)).detach().numpy()
    assert got.shape == want.shape == (len(x), classes)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("model, dataset, classes", CASES)
def test_loss_metrics_and_grads_match_jax(model, dataset, classes):
    jm, jp, tm, tp = _pair(model, dataset, classes, seed=2)
    x, y, mask = _inputs(jm.example_shape, classes=classes, seed=3)

    def jloss(p):
        return jm.loss_fn(jm.apply(p, jnp.asarray(x)), jnp.asarray(y), jnp.asarray(mask))

    (jl, jmetrics), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)

    def tloss(p):
        return tm.loss_fn(tm.apply(p, torch.as_tensor(x)), torch.as_tensor(y),
                          torch.as_tensor(mask))

    tgrads, (tl, tmetrics) = torch.func.grad_and_value(tloss, has_aux=True)(tp)
    assert set(tmetrics) == set(jmetrics) == {"loss", "correct", "count", "acc"}
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), atol=ATOL, err_msg=k)
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL)
    want = params_from_flax(jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(tgrads)
    for k in want:
        np.testing.assert_allclose(tgrads[k].numpy(), want[k].numpy(), atol=ATOL, err_msg=k)


def test_metrics_from_sums_matches_jax():
    jm, _, tm, _ = _pair("lr", "mnist", 10)
    sums = {"loss_sum": 12.5, "correct": 7.0, "count": 20.0}
    assert tm.metrics_from_sums(sums) == jm.metrics_from_sums(
        {k: jnp.float32(v) for k, v in sums.items()})
    assert tm.metrics_from_sums({"loss_sum": 0.0, "correct": 0.0, "count": 0.0})["acc"] == 0.0


def test_conv_kernel_conversion_is_oihw():
    kernel = np.arange(3 * 3 * 2 * 4, dtype=np.float32).reshape(3, 3, 2, 4)
    out = params_from_flax({"Conv_0": {"kernel": kernel, "bias": np.zeros(4, np.float32)}})
    w = out["Conv_0/weight"]
    assert tuple(w.shape) == (4, 2, 3, 3)
    assert float(w[1, 0, 2, 0]) == float(kernel[2, 0, 0, 1])


@pytest.mark.parametrize("model, dataset, classes", CASES)
def test_port_init_matches_module_layout(model, dataset, classes):
    _, _, tm, tp = _pair(model, dataset, classes)
    want = {k.replace(".", "/"): tuple(p.shape) for k, p in tm.module.named_parameters()}
    assert {k: tuple(v.shape) for k, v in tp.items()} == want
    init = tm.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in init.items()} == want
    # lecun-normal scale: a conv kernel's fan_in is in * kh * kw
    for k, v in init.items():
        if v.dim() == 4:
            fan_in = v.shape[1] * v.shape[2] * v.shape[3]
            assert abs(float(v.std()) * fan_in**0.5 - 1.0) < 0.25, k


def test_unported_task_loss_raises():
    # next-token prediction and segmentation are ported (token and pixel
    # cross-entropy); a task no package knows still raises
    tm = models.create(_args(Arguments, "transformer", "shakespeare"), 10, device="cpu")
    assert tm.task == "nwp" and tm.loss_fn is not None
    assert dataclasses.replace(tm, task="segmentation").loss_fn.__name__ == "pixel_cross_entropy"
    other = dataclasses.replace(tm, task="detection")
    with pytest.raises(NotImplementedError, match="task 'detection'"):
        other.loss_fn
