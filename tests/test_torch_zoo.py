"""The rest of the GroupNorm CIFAR zoo: VGG, MobileNet v1/v3 and
EfficientNet of the port against the JAX package's.

Params are drawn at the flax tree's shapes (``jax.eval_shape`` of the
flax ``init``, then seeded numpy normals of variance 1/fan_in, which
skips compiling ``init``) and cross through ``convert.params_from_flax``;
both packages compute logits of the same seeded images at batch 2, f32,
atol 1e-4 (measured 1e-6 to 3e-6 at logits of magnitude ~1). Then the
pieces with their own flax definitions: the stride-2 depthwise
convolution's SAME padding, hard-swish and the squeeze-excite gate.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from fedml_tpu.models.efficientnet import efficientnet as jax_efficientnet
from fedml_tpu.models import mobilenet as jax_mobilenet
from fedml_tpu.models.vgg import vgg as jax_vgg
from fedml_tpu_torch import models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.models import mobilenet
from fedml_tpu_torch.models.efficientnet import efficientnet
from fedml_tpu_torch.models.vgg import vgg
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOGITS_ATOL = 1e-4

ZOO = {
    "vgg11": (lambda: jax_vgg("vgg11", 10), lambda: vgg("vgg11", 10)),
    "vgg16": (lambda: jax_vgg("vgg16", 10), lambda: vgg("vgg16", 10)),
    "mobilenet": (lambda: jax_mobilenet.MobileNetV1(10), lambda: mobilenet.MobileNetV1(10)),
    "mobilenet_v3": (lambda: jax_mobilenet.MobileNetV3Small(10),
                     lambda: mobilenet.MobileNetV3Small(10)),
    "efficientnet-b0": (lambda: jax_efficientnet("efficientnet-b0", 10),
                        lambda: efficientnet("efficientnet-b0", 10)),
}


def _flax_params(jmodule, x, seed=0):
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), x)["params"]
    rng = np.random.default_rng(seed)

    def draw(s):
        if len(s.shape) == 1:  # GroupNorm scales and biases, dense biases
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(draw, shapes)


def _torch_apply(module, params, x):
    named = {k.replace("/", "."): v for k, v in params.items()}
    with torch.no_grad():
        return torch.func.functional_call(module, named, (x,))


@pytest.mark.parametrize("name", sorted(ZOO))
def test_logits_match_flax(name):
    make_jax, make_port = ZOO[name]
    jm, tm = make_jax(), make_port()
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jparams = _flax_params(jm, x)
    want = np.asarray(jax.jit(jm.apply)({"params": jparams}, x))
    tparams = params_from_flax(jparams)
    assert set(tparams) == {k.replace(".", "/") for k, _ in tm.named_parameters()}
    got = _torch_apply(tm, tparams, torch.tensor(x)).numpy()
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL)


@pytest.mark.parametrize("name, canonical", [
    ("vgg11", "vgg11"), ("vgg16", "vgg16"), ("mobilenet", "mobilenet"),
    ("mobilenet_v3", "mobilenet_v3"), ("mobilenetv3", "mobilenet_v3"),
    ("efficientnet-b0", "efficientnet-b0")])
def test_create_builds_the_zoo(name, canonical):
    a = Arguments()
    a.model, a.dataset = name, "cifar10"
    m = models.create(a, 10, device="cpu")
    assert m.name == canonical and m.example_shape == (32, 32, 3)
    params = m.init(torch.Generator().manual_seed(0))
    assert m.apply(params, torch.zeros((1, 32, 32, 3))).shape == (1, 10)


def test_unknown_variants_raise():
    with pytest.raises(ValueError, match="vgg"):
        vgg("vgg12", 10)
    with pytest.raises(ValueError, match="efficientnet"):
        efficientnet("efficientnet-b9", 10)


@pytest.mark.parametrize("size", [8, 9])
def test_stride2_depthwise_same_padding(size):
    """MobileNet's stride-2 depthwise convolution: flax pads (0, 1) on
    an even size and (1, 1) on an odd one."""
    x = np.random.default_rng(size).normal(size=(2, size, size, 6)).astype(np.float32)
    jconv = fnn.Conv(6, (3, 3), strides=(2, 2), feature_group_count=6, use_bias=False)
    jparams = jconv.init(jax.random.PRNGKey(0), x)["params"]
    want = np.asarray(jconv.apply({"params": jparams}, x))
    w = params_from_flax({"Conv_0": jparams})["Conv_0/weight"]
    assert tuple(w.shape) == (6, 1, 3, 3)
    conv = mobilenet.SameConv2d(6, 6, 3, 2, groups=6, bias=False)
    got = _torch_apply(conv, {"weight": w}, torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)


def test_hardswish_and_squeeze_excite_match_flax():
    x = np.linspace(-5, 5, 2 * 16 * 3 * 3, dtype=np.float32).reshape(2, 3, 3, 16)
    want = np.asarray(jax_mobilenet._hardswish(x))
    got = mobilenet.hardswish(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    jse = jax_mobilenet.SqueezeExcite(reduce=4)
    jparams = _flax_params(jse, x)
    want = np.asarray(jse.apply({"params": jparams}, x))
    se = mobilenet.SqueezeExcite(16, reduce=4)
    got = _torch_apply(se, params_from_flax(jparams), torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)
    # GroupNorm's group count: the largest divisor of the width <= 32
    assert [mobilenet.gn(c).num_groups for c in (16, 40, 88, 576, 96)] == [16, 20, 22, 32, 32]
