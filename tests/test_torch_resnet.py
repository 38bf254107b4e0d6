"""The GroupNorm ResNets of the port (``fedml_tpu_torch/models/resnet.py``)
against the JAX package's (``fedml_tpu/models/resnet.py``).

Params come from the flax ``init`` and cross through
``convert.params_from_flax``; both packages then compute the same
function on the same seeded numpy images:

- full-width ``resnet18_gn`` and ``resnet56`` logits at batch 2, f32,
  atol 1e-4 (twenty-odd layers of f32 convolutions summed in different
  orders; measured ~1e-5 at logits of magnitude ~7);
- a narrow ResNet (stage sizes (1, 1), channels (8, 16), both block
  kinds): logits and every gradient at 1e-5;
- the stride-2 ``SAME`` padding, which flax puts at (0, 1) on even sizes
  and (1, 1) on odd ones, against ``lax.padtype_to_pads`` and a flax
  ``Conv``;
- a bf16 forward against the JAX bf16 forward (see ``BF16_RTOL``).
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fedml_tpu.models import resnet as jax_resnet
from fedml_tpu_torch import models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.models import resnet
from fedml_tpu_torch.models.spec import FedModel
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

FULL_ATOL = 1e-4
NARROW_ATOL = 1e-5
# bf16 against bf16: both packages round every convolution's and every
# GroupNorm's output to bf16 (a relative step of 2**-8), in different
# orders, so after ~20 layers their logits land a few bf16 steps apart
# (measured 0.0156, one step at |logit| in [2, 4), on resnet18_gn);
# 1% of the largest logit
BF16_RTOL = 1e-2


def _torch_apply(module, params, x):
    named = {k.replace("/", "."): v for k, v in params.items()}
    return torch.func.functional_call(module, named, (x,))


def _flax_pair(jmodule, tmodule, x, seed=0):
    jparams = jax.jit(jmodule.init)(jax.random.PRNGKey(seed), x)["params"]
    tparams = params_from_flax(jax.tree.map(np.asarray, jparams))
    return jparams, tparams


def _images(n, hw, c=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, hw, hw, c)).astype(np.float32)


@pytest.mark.parametrize("name", ["resnet18_gn", "resnet56"])
def test_full_width_logits_match_flax(name):
    x = _images(2, 32)
    jm, tm = getattr(jax_resnet, name)(10), getattr(resnet, name)(10)
    jparams, tparams = _flax_pair(jm, tm, x)
    want = np.asarray(jax.jit(jm.apply)({"params": jparams}, x))
    with torch.no_grad():
        got = _torch_apply(tm, tparams, torch.tensor(x)).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, atol=FULL_ATOL)
    assert set(tparams) == {k.replace(".", "/") for k, _ in tm.named_parameters()}


def test_narrow_resnet_logits_and_gradients_match():
    x, y = _images(3, 9, seed=1), np.array([0, 3, 4])
    jm = jax_resnet.ResNet((1, 1), (8, 16), 5)
    tm = resnet.ResNet((1, 1), (8, 16), 5)
    jparams, tparams = _flax_pair(jm, tm, x, seed=1)

    def jloss(p):
        logits = jm.apply({"params": p}, x)
        return -jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], 1).mean(), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    want = params_from_flax(jax.tree.map(np.asarray, jgrads))

    def tloss(p):
        logits = _torch_apply(tm, p, torch.tensor(x))
        return F.cross_entropy(logits, torch.tensor(y)), logits

    tgrads, tlogits = torch.func.grad(tloss, has_aux=True)(tparams)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), atol=NARROW_ATOL)
    assert set(tgrads) == set(want)
    for k in want:
        np.testing.assert_allclose(tgrads[k].numpy(), want[k].numpy(), atol=NARROW_ATOL,
                                   err_msg=k)
    assert tm.BasicBlock_1.shortcut and not tm.BasicBlock_0.shortcut


@pytest.mark.parametrize("size, pads", [(8, (0, 1)), (32, (0, 1)), (9, (1, 1)), (7, (1, 1))])
def test_stride2_same_padding_matches_flax(size, pads):
    assert resnet.same_pads(size, 3, 2) == pads
    assert [resnet.same_pads(size, 3, 2)] * 2 == [
        tuple(p) for p in jax.lax.padtype_to_pads((size, size), (3, 3), (2, 2), "SAME")]
    assert resnet.same_pads(size, 1, 2) == (0, 0)
    x = _images(2, size, c=4, seed=size)
    jconv = fnn.Conv(6, (3, 3), strides=(2, 2), use_bias=False)
    jparams = jconv.init(jax.random.PRNGKey(0), x)["params"]
    want = np.asarray(jconv.apply({"params": jparams}, x))
    conv = resnet.SameConv2d(4, 6, 3, 2, bias=False)
    w = params_from_flax({"Conv_0": jparams})["Conv_0/weight"]
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = _torch_apply(conv, {"weight": w}, xt).permute(0, 2, 3, 1).numpy()
        symmetric = F.conv2d(xt, w, stride=2, padding=1).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    # torch's symmetric padding=1 has the same shape; on an even size it
    # is shifted by one pixel
    assert symmetric.shape == want.shape
    if pads == (0, 1):
        assert np.abs(symmetric - want).max() > 1e-2
    else:
        np.testing.assert_allclose(symmetric, want, atol=1e-5)


@pytest.mark.parametrize("name", ["resnet18_gn", "narrow"])
def test_bf16_forward_matches_jax_bf16(name):
    x = _images(4, 32 if name == "resnet18_gn" else 16)
    if name == "narrow":
        jm, tm = jax_resnet.ResNet((1, 1), (8, 16), 5), resnet.ResNet((1, 1), (8, 16), 5)
    else:
        jm, tm = jax_resnet.resnet18_gn(10), resnet.resnet18_gn(10)
    jparams, tparams = _flax_pair(jm, tm, x)
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    want = np.asarray(jax.jit(jm.apply)({"params": jb}, x.astype(jnp.bfloat16))
                      .astype(jnp.float32))
    with torch.no_grad():
        got = _torch_apply(tm, {k: v.bfloat16() for k, v in tparams.items()},
                           torch.tensor(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=BF16_RTOL * np.abs(want).max())


def test_group_norm_is_flax_group_norm():
    """epsilon 1e-6, min(32, C) groups, output in the input's dtype,
    statistics in f32 for a bf16 input."""
    for channels in (16, 64):
        gn = resnet.GroupNorm(channels)
        assert gn.num_groups == min(32, channels) and gn.eps == 1e-6
        x = _images(2, 5, c=channels) * 3 + 1
        jgn = fnn.GroupNorm(num_groups=min(32, channels))
        jp = jgn.init(jax.random.PRNGKey(0), x)
        want = np.asarray(jgn.apply(jp, x))
        xt = torch.tensor(x).permute(0, 3, 1, 2)
        got = gn(xt).detach().permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        out = gn(xt.bfloat16())
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().detach().permute(0, 2, 3, 1).numpy(), want,
                                   atol=0.05)


@pytest.mark.parametrize("name, canonical, blocks", [
    ("resnet18", "resnet18_gn", 8), ("resnet18_gn", "resnet18_gn", 8),
    ("resnet56", "resnet56", 27), ("resnet", "resnet56", 27)])
def test_create_builds_the_resnets(name, canonical, blocks, monkeypatch):
    a = Arguments()
    a.model, a.dataset = name, "cifar10"
    m = models.create(a, 10, device="cpu")
    assert isinstance(m, FedModel) and m.name == canonical
    assert m.module.num_blocks == blocks and m.example_shape == (32, 32, 3)
    params = m.init(torch.Generator().manual_seed(0))
    assert m.apply(params, torch.zeros((1, 32, 32, 3))).shape == (1, 10)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        models.create(a, 10)  # the default device is the card


def test_init_is_flax_lecun_normal():
    """Conv and dense kernels: a normal truncated at 2 standard
    deviations, of variance 1/fan_in; GroupNorm scale 1, biases 0."""
    a = Arguments()
    a.model, a.dataset = "resnet18", "cifar10"
    m = models.create(a, 10, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    for k, v in params.items():
        if v.dim() >= 2:
            fan_in = int(np.prod(v.shape[1:]))
            scaled = v * fan_in**0.5
            assert float(scaled.abs().max()) <= 2 / 0.87962566103423978 + 1e-6, k
            if v.numel() > 1000:
                assert abs(float(scaled.std()) - 1.0) < 0.05, k
        elif k.endswith("bias"):
            assert not v.any(), k
        else:
            assert bool((v == 1).all()), k
