"""The ninth slice's models and data against the JAX package's.

From the same weights (flax params carried across by
``convert.params_from_flax``), in f32: the GAN pair (the generator's
transposed convolutions need the kernel flipped in space, told apart
from a ``Conv`` by module name), DeepLabLite at 64x64 and 32x32 (flax
``SAME`` on the stride-2 convolutions, bilinear resize), the DARTS
search network (the raw ``alphas_holder`` leaf, counted padding in the
average pool), the GKT client and server and the VFL party and top
models agree to 1e-5 of the output's largest magnitude. Bitwise: the
segmentation stand-in and its multi-label partition, ``vertical_split``,
``genotype`` and ``split_grad_masks``, the loss of a segmentation batch
to 1e-6.
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu import models as jax_models
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.core import losses as jax_losses
from fedml_tpu.data import load as jax_load
from fedml_tpu.data import synthetic as jax_synthetic
from fedml_tpu.models import darts as jax_darts
from fedml_tpu.models.gan import Discriminator as JaxDisc, Generator as JaxGen
from fedml_tpu.models.gkt import GKTClientNet as JaxGKTClient, GKTServerNet as JaxGKTServer
from fedml_tpu.models.vfl import GuestTopModel as JaxTop, PartyLocalModel as JaxParty
from fedml_tpu.simulation.split_learning import vertical_split as jax_vertical_split
import fedml_tpu_torch
from fedml_tpu_torch import models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.core.losses import LOSSES
from fedml_tpu_torch.data import load
from fedml_tpu_torch.data import synthetic
from fedml_tpu_torch.models import darts
from fedml_tpu_torch.models.gan import Discriminator, FlaxConvTranspose2d, Generator
from fedml_tpu_torch.models.gkt import GKTClientNet, GKTServerNet
from fedml_tpu_torch.models.spec import FedModel
from fedml_tpu_torch.models.vfl import GuestTopModel, PartyLocalModel
from fedml_tpu_torch.simulation.split_learning import vertical_split
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# f32 in both packages from the same weights: summation order only
RTOL_OF_MAX = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def close(got: torch.Tensor, want, what=""):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL_OF_MAX * scale, (what, err, scale)


def _fed(module, shape=()):
    return FedModel(name="m", module=module, example_shape=shape)


def _init(jmodule, x, seed=0):
    """The flax module's params (jitted: eager init compiles op by op)."""
    return jax.jit(jmodule.init)(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]


def _run(jmodule, tmodule, x, seed=0):
    """(port output, JAX output) from the JAX init's weights."""
    jp = _init(jmodule, x, seed)
    tp = params_from_flax(_np(jp))
    want = jmodule.apply({"params": jp}, jnp.asarray(x))
    got = _fed(tmodule).apply(tp, torch.as_tensor(x))
    return got, want


def _images(shape, n=3, seed=1):
    return np.random.default_rng(seed).normal(size=(n,) + tuple(shape)).astype(np.float32)


# -- the GAN pair -----------------------------------------------------------


class _JaxConvT(nn.Module):
    features: int

    @nn.compact
    def __call__(self, x):
        return nn.ConvTranspose(self.features, (4, 4), strides=(2, 2))(x)


class _ConvT(torch.nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.ConvTranspose_0 = FlaxConvTranspose2d(cin, cout)

    def forward(self, x):
        return self.ConvTranspose_0(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("cin, cout, side", [(6, 4, 7), (5, 5, 6)])
def test_conv_transpose_matches_flax(cin, cout, side):
    """in != out and in == out: a kernel carried across unflipped, or
    with in and out swapped, cannot pass both."""
    x = _images((side, side, cin))
    got, want = _run(_JaxConvT(cout), _ConvT(cin, cout), x)
    assert got.shape == (3, 2 * side, 2 * side, cout)
    close(got, want, "conv transpose")
    # the flip matters: the same weights unflipped are far off
    jp = _init(_JaxConvT(cout), x)
    tp = params_from_flax(_np(jp))
    tp["ConvTranspose_0/weight"] = tp["ConvTranspose_0/weight"].flip(2, 3)
    off = _fed(_ConvT(cin, cout)).apply(tp, torch.as_tensor(x))
    assert float((off - torch.as_tensor(np.array(want))).abs().max()) > 1e-2


def test_generator_and_discriminator_match_flax():
    z = np.random.default_rng(2).normal(size=(4, 16)).astype(np.float32)
    got, want = _run(JaxGen(latent_dim=16), Generator(16), z)
    assert got.shape == (4, 28, 28, 1)
    close(got, want, "generator")
    got, want = _run(JaxDisc(), Discriminator(), _images((28, 28, 1), n=4))
    assert got.shape == (4,)
    close(got, want, "discriminator")


# -- DeepLabLite --------------------------------------------------------------


@pytest.mark.parametrize("side", [64, 32])
def test_deeplab_matches_flax(side):
    ja, ta = JaxArguments(), Arguments()
    for a in (ja, ta):
        a.model, a.dataset, a.seg_width = "deeplab", "pascal_voc", 8
    jm = jax_models.create(ja, 21)
    tm = models.create(ta, 21, device="cpu")
    assert tm.task == jm.task == "segmentation"
    x = _images((side, side, 3), n=2)
    got, want = _run(jm.module, tm.module, x)
    assert got.shape == (2, side, side, 21)
    close(got, want, f"deeplab {side}")


# -- DARTS ----------------------------------------------------------------------


def _darts_pair(width=8, cells=2, steps=2):
    ja, ta = JaxArguments(), Arguments()
    for a in (ja, ta):
        a.model, a.dataset = "darts", "cifar10"
        a.nas_width, a.nas_cells, a.nas_steps = width, cells, steps
    return jax_models.create(ja, 10), models.create(ta, 10, device="cpu")


@pytest.mark.parametrize("cells, steps", [(2, 2), (3, 3)])
def test_darts_network_matches_flax(cells, steps):
    jm, tm = _darts_pair(8, cells, steps)
    x = _images((32, 32, 3), n=2)
    jp = _init(jm.module, x)
    # alphas far from uniform, so every candidate op's weight matters
    jp = dict(jp, alphas_holder=jnp.asarray(
        np.random.default_rng(3).normal(size=jp["alphas_holder"].shape), jnp.float32))
    tp = params_from_flax(_np(jp))
    names = {k.replace(".", "/") for k in tm.module.state_dict()}
    assert set(tp) == names and "alphas_holder" in tp
    close(tm.apply(tp, torch.as_tensor(x)), jm.module.apply({"params": jp}, jnp.asarray(x)),
          "darts")
    # genotype and the masks, on the same alphas
    assert darts.genotype(tp["alphas_holder"], steps) == jax_darts.genotype(
        jp["alphas_holder"], steps)
    w_mask, a_mask = darts.split_grad_masks(tp)
    jw, ja_ = jax_darts.split_grad_masks(jp)
    jw, ja_ = params_from_flax(_np(jw)), params_from_flax(_np(ja_))
    for k in tp:
        assert torch.equal(w_mask[k], jw[k]) and torch.equal(a_mask[k], ja_[k]), k
    assert darts.arch_path(tp) == "/".join(jax_darts.arch_path(jp)) == "alphas_holder"


def test_genotype_ties_and_none():
    a = np.zeros((3, 6), np.float32)
    a[0, 0] = 5.0  # 'none' is never chosen
    a[1, [2, 4]] = 1.0  # the first maximum wins
    a[2, 5] = -1.0
    assert darts.genotype(torch.as_tensor(a), 2) == jax_darts.genotype(jnp.asarray(a), 2)


def test_darts_init_scales_the_alphas():
    _, tm = _darts_pair()
    p = tm.init(torch.Generator().manual_seed(0))
    assert float(p["alphas_holder"].abs().max()) < 1e-2 < float(p["Conv_0/weight"].abs().max())


# -- the GKT pair and the VFL models ------------------------------------------


def test_gkt_client_and_server_match_flax():
    x = _images((16, 16, 3), n=3)
    jc = JaxGKTClient(output_dim=10)
    jp = _init(jc, x)
    jf, jl = jc.apply({"params": jp}, jnp.asarray(x))
    tf, tl = _fed(GKTClientNet(10)).apply(params_from_flax(_np(jp)), torch.as_tensor(x))
    close(tf.permute(0, 2, 3, 1), jf, "client features")
    close(tl, jl, "client logits")
    js = JaxGKTServer(output_dim=10, stage_sizes=(2, 1, 1))
    sp = _init(js, jf, seed=1)
    got = _fed(GKTServerNet(10, stage_sizes=(2, 1, 1))).apply(params_from_flax(_np(sp)), tf)
    close(got, js.apply({"params": sp}, jf), "server logits")


def test_vfl_party_and_top_match_flax():
    x = _images((20,), n=5)
    got, want = _run(JaxParty(output_dim=8), PartyLocalModel(20, output_dim=8), x)
    close(got, want, "party")
    rep = _images((8,), n=5)
    got, want = _run(JaxTop(output_dim=4), GuestTopModel(8, 4), rep)
    close(got, want, "top")


def test_stacked_params_from_flax():
    """A leading client axis on every leaf (FedGKT's personal nets):
    each client's slice maps as one model's would."""
    x = jnp.zeros((1, 8, 8, 3))
    jc = JaxGKTClient(output_dim=5)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    stacked = jax.jit(jax.vmap(lambda k: jc.init(k, x)["params"]))(keys)
    got = params_from_flax(_np(stacked), stacked=True)
    for c in range(3):
        one = params_from_flax(_np(jax.tree.map(lambda a: a[c], stacked)))
        assert set(one) == set(got)
        for k in one:
            assert torch.equal(got[k][c], one[k]), k
    with pytest.raises(ValueError, match="kernel"):
        params_from_flax({"Dense_0": {"kernel": np.zeros((2, 3, 4))}})


# -- segmentation data and loss ---------------------------------------------


def test_segmentation_standin_is_bitwise():
    want = jax_synthetic.synthetic_segmentation(12, 21, (16, 16, 3), seed=4)
    got = synthetic.synthetic_segmentation(12, 21, (16, 16, 3), seed=4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    x4, _ = synthetic.synthetic_segmentation(3, 4, (8, 8, 4), seed=1)
    assert x4.shape == (3, 8, 8, 4)


SEG = dict(synthetic_train_size=60, synthetic_test_size=12, client_num_in_total=4,
           client_num_per_round=2, batch_size=8, partition_alpha=0.5, random_seed=1)


@pytest.mark.parametrize("dataset, method", [("pascal_voc", "hetero"), ("fets2021", "homo"),
                                             ("cityscapes", "hetero")])
def test_segmentation_federation_is_bitwise(dataset, method):
    ja, ta = JaxArguments(), Arguments()
    for a in (ja, ta):
        for k, v in dict(SEG, dataset=dataset, partition_method=method).items():
            setattr(a, k, v)
        a._validate()
    want, got = jax_load(ja), load(ta, device="cpu")
    assert got.task == want.task == "segmentation" and got.class_num == want.class_num
    for split in ("packed_train", "packed_test", "train_data_global", "test_data_global"):
        g, w = getattr(got, split), getattr(want, split)
        for leaf in ("x", "y", "mask"):
            assert np.array_equal(getattr(g, leaf).numpy(), np.asarray(getattr(w, leaf))), (
                split, leaf)
    assert np.array_equal(np.asarray(got.packed_num_samples),
                          np.asarray(want.packed_num_samples))


def test_pixel_cross_entropy_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 6, 6, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=(3, 6, 6)).astype(np.int64)
    labels[0, :2] = 255  # void pixels
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    jl, jm = jax_losses.pixel_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                            jnp.asarray(mask))
    tl, tm = LOSSES["segmentation"](torch.as_tensor(logits), torch.as_tensor(labels),
                                    torch.as_tensor(mask))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for k in ("correct", "count"):
        assert float(tm[k]) == float(jm[k]), k
    assert float(tm["count"]) == 2 * 36 - 12


def test_vertical_split_is_bitwise():
    x = np.arange(5 * 7 * 3, dtype=np.float32).reshape(5, 7, 3)
    for parties in (2, 3, 4):
        for g, w in zip(vertical_split(x, parties), jax_vertical_split(x, parties)):
            assert np.array_equal(g, w)


def test_create_builds_the_new_models():
    for name, ds, task in (("deeplab", "fets2021", "segmentation"),
                           ("darts", "cifar10", "classification")):
        a = Arguments()
        a.model, a.dataset, a.seg_width, a.nas_width = name, ds, 8, 8
        m = models.create(a, 4, device="cpu")
        assert m.task == task
        p = m.init(torch.Generator().manual_seed(0))
        x = torch.zeros((2,) + m.example_shape)
        assert torch.isfinite(m.apply(p, x)).all()
    assert fedml_tpu_torch is not None
