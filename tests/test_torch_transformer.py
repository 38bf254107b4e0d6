"""The port's TransformerLM against the JAX package's, from the same weights.

Params come from the JAX ``FedModel.init`` and cross to the port through
``fedml_tpu_torch.convert.params_from_flax``; the logits of both
packages then agree for ``attention_impl`` full and flash.
"""

from __future__ import annotations

import argparse
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu import models as jax_models
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.cross_device.model_file import (
    model_bytes_to_params,
    params_to_model_bytes,
)
from fedml_tpu_torch import models as torch_models
from fedml_tpu_torch.arguments import Arguments, load_arguments
from fedml_tpu_torch.convert import params_from_flax
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "fedml_tpu_torch", "configs", "serve_transformer_flash.yaml",
)
# both packages compute in f32 from the same weights; the logits differ
# by summation order only (~2e-6 observed at these sizes)
LOGITS_ATOL = 1e-4
VOCAB, T = 50, 64


def _args(cls, impl, num_layers=2):
    a = cls()
    a.model = "transformer"
    a.vocab_size, a.embed_dim, a.num_heads = VOCAB, 64, 4
    a.num_layers, a.seq_len, a.max_len = num_layers, T, T
    a.attention_impl = impl
    return a


def _jax_model_and_params(impl, seed=0, num_layers=2):
    model = jax_models.create(_args(JaxArguments, impl, num_layers), 10)
    # jitted: eager flax init runs op by op and takes seconds
    params = jax.jit(model.init)(jax.random.PRNGKey(seed))
    return model, params


@pytest.mark.parametrize("impl", ["full", "flash"])
def test_logits_match_jax(impl):
    jmodel, jparams = _jax_model_and_params(impl)
    tokens = np.random.default_rng(1).integers(0, VOCAB, size=(3, T))
    want = np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(tokens)))

    tmodel = torch_models.create(_args(Arguments, impl), 10, device="cpu")
    params = params_from_flax(jax.tree.map(np.asarray, jparams))
    assert tmodel.param_count(params) == jmodel.param_count(jparams)
    got = tmodel.apply(params, torch.as_tensor(tokens)).numpy()
    assert got.shape == (3, T, VOCAB)
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL)


def test_converter_takes_nested_or_slash_joined_trees():
    """The npz model-file form (slash-joined keys) converts to exactly
    the params the nested tree does."""
    _, jparams = _jax_model_and_params("full", seed=2, num_layers=1)
    flat = np.load(io.BytesIO(params_to_model_bytes(jparams)))
    from_flat = params_from_flax({k: flat[k] for k in flat.files})
    from_nested = params_from_flax(
        model_bytes_to_params(params_to_model_bytes(jparams))
    )
    assert sorted(from_flat) == sorted(from_nested)
    for key in from_flat:
        assert torch.equal(from_flat[key], from_nested[key]), key
    kernel = np.asarray(jparams["Block_0"]["Dense_0"]["kernel"])
    assert torch.equal(from_flat["Block_0/Dense_0/weight"], torch.tensor(kernel.T))
    assert "Embed_0/weight" in from_flat and "LayerNorm_0/weight" in from_flat


def test_converter_rejects_unknown_leaves_and_conv_kernels():
    with pytest.raises(ValueError, match="unknown leaf"):
        params_from_flax({"Dense_0": {"mean": np.zeros(3, np.float32)}})
    # 2-D Conv kernels carry across (tests/test_torch_fedavg_models.py);
    # a 1-D Conv's [k, in, out] kernel has no counterpart yet
    with pytest.raises(ValueError, match="only Dense"):
        params_from_flax({"Conv_0": {"kernel": np.zeros((3, 1, 4), np.float32)}})


def test_port_params_match_module_layout():
    """Converted params cover exactly the port module's parameters, at
    their shapes (``apply`` is strict about it)."""
    _, jparams = _jax_model_and_params("flash", seed=3, num_layers=1)
    tmodel = torch_models.create(_args(Arguments, "flash", 1), 10, device="cpu")
    params = params_from_flax(jax.tree.map(np.asarray, jparams))
    want = {k.replace(".", "/"): tuple(p.shape)
            for k, p in tmodel.module.named_parameters()}
    assert {k: tuple(v.shape) for k, v in params.items()} == want
    init = tmodel.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in init.items()} == want


def test_slice_config_reads_the_same_in_both_packages():
    ns = argparse.Namespace(yaml_config_file=REPO_CONFIG)
    ja, ta = JaxArguments(ns), load_arguments(REPO_CONFIG)
    for key in ("model", "vocab_size", "embed_dim", "num_heads", "num_layers",
                "seq_len", "max_len", "attention_impl", "serve_max_batch",
                "random_seed", "dataset"):
        assert getattr(ta, key) == getattr(ja, key), key
    assert (ta.embed_dim, ta.num_heads, ta.seq_len, ta.attention_impl) == (
        512, 8, 4096, "flash"
    )


def test_create_builds_moe_transformer_as_jax_does():
    """``moe_transformer`` builds (it raised until the distributed slice):
    the same parameter names and shapes as the JAX package's, and the
    same logits from the same weights."""
    kw = dict(model="moe_transformer", dataset="shakespeare", embed_dim=32, num_heads=2,
              num_layers=2, num_experts=4, seq_len=16, max_len=16)
    ja, ta = JaxArguments(), Arguments()
    for a in (ja, ta):
        for k, v in kw.items():
            setattr(a, k, v)
    jm, tm = jax_models.create(ja, 10), torch_models.create(ta, 10, device="cpu")
    assert tm.name == jm.name == "moe_transformer_lm"
    tokens = np.random.default_rng(0).integers(0, 10, (2, 16)).astype(np.int32)
    jparams = jm.module.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    params = params_from_flax(jax.tree.map(np.asarray, jparams))
    want = {k.replace(".", "/"): tuple(p.shape) for k, p in tm.module.named_parameters()}
    assert {k: tuple(v.shape) for k, v in params.items()} == want
    got = tm.apply(params, torch.tensor(tokens))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jm.module.apply({"params": jparams}, tokens)),
                               atol=1e-5)


@pytest.mark.parametrize(
    "knob, value", [("dtype", "float16"), ("serve_bucket", "pow3"),
                    ("serve_max_batch", 0), ("serve_deadline_ms", -1.0)]
)
def test_arguments_validation_matches_jax(knob, value):
    for cls in (JaxArguments, Arguments):
        a = cls()
        setattr(a, knob, value)
        with pytest.raises(ValueError):
            a._validate()
