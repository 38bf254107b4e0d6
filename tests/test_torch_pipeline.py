"""The pipeline mode (``mesh_shape {pp}`` / ``{dp, pp}``): the port's GPipe
schedule and ``DistributedTrainer``'s pipeline mode against the JAX
package's, on the CPU.

``pipeline_apply`` runs in spawned gloo worlds of S ranks, one stage a
rank (``torch_world.py``), against ``fedml_tpu.parallel.pipeline``'s on
S of the test process's 8 virtual CPU devices and against the stages
applied one after another. The trainer runs as ``test_torch_distributed``
runs the other modes: the JAX package's ``{outer, stages}`` start params
carried across with ``convert.params_from_flax``, its epoch permutations
handed in, f32 to ``PARAM_ATOL`` / ``LOSS_RTOL`` (2e-5; the differences
are f32 summation order).
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import torch_world
from fedml_tpu import data as jax_data
from fedml_tpu import models as jax_models
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.distributed import DistributedTrainer as JaxTrainer
from fedml_tpu.parallel.mesh import build_mesh as jax_build_mesh
from fedml_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from fedml_tpu_torch.arguments import load_arguments
from fedml_tpu_torch.convert import opt_state_from_flax, params_from_flax
from fedml_tpu_torch.distributed import pipeline_params
from fedml_tpu_torch.parallel import pipeline as pp
from test_torch_distributed import (BASE, LOSS_RTOL, PARAM_ATOL, _set, assert_same_training,
                                    jax_run, port_run)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

PP = dict(BASE, model="transformer", num_layers=4)


# -- the schedule ----------------------------------------------------------------


@pytest.mark.parametrize("S, M", [(2, 3), (4, 4), (8, 2)])
def test_pipeline_apply_matches_jax_and_the_sequential_stack(S, M, tmp_path):
    """Forward and gradients: every rank's output is the JAX schedule's and
    the stages applied in turn; the stage gradients (each rank's own row)
    and the input's (only stage 0 reads it) summed over the ranks are
    JAX's."""
    rng = np.random.RandomState(S)
    D, mb = 6, 3
    w = (rng.randn(S, D, D) * 0.5).astype(np.float32)
    b = (rng.randn(S, D) * 0.1).astype(np.float32)
    x = rng.randn(M, mb, D).astype(np.float32)
    g = rng.randn(M, mb, D).astype(np.float32)
    mesh = jax_build_mesh(devices=jax.devices()[:S], mesh_shape={"pp": S})

    def loss(params, x):
        out = jax_pipeline_apply(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]), params, x, mesh)
        return (out * g).sum(), out

    (_, want), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        {"w": w, "b": b}, x)
    seq = x
    for s in range(S):
        seq = np.tanh(seq @ w[s] + b[s])
    got = torch_world.run_world(torch_world.pipeline_op, S,
                                {"w": w, "b": b, "x": x, "g": g}, tmp_path, 60)
    for r in got:
        np.testing.assert_allclose(r["out"], np.asarray(want), atol=1e-6)
        np.testing.assert_allclose(r["out"], seq, atol=1e-6)
    for s, r in enumerate(got):  # a rank's gradient reaches its own stage only
        others = [i for i in range(S) if i != s]
        assert not np.any(r["w"][others]) and not np.any(r["b"][others])
        if s:
            assert not np.any(r["x"])
    for key, want_g in (("w", grads[0]["w"]), ("b", grads[0]["b"]), ("x", grads[1])):
        np.testing.assert_allclose(sum(r[key] for r in got), np.asarray(want_g), atol=1e-5,
                                   err_msg=key)


def test_schedule_refusals_match_jax_word_for_word():
    """A stage stack whose leading axis is not S, a batch the microbatches
    do not divide, a data axis that does not divide the microbatch."""
    mesh = jax_build_mesh(devices=jax.devices()[:2], mesh_shape={"dp": 1, "pp": 2})
    cases = [
        (lambda: jax_pipeline_apply(lambda p, h: h, {"w": jnp.zeros((3, 2))},
                                    jnp.zeros((2, 2, 2)), mesh),
         lambda: pp.check_stage_stack({"w": torch.zeros(3, 2)}, 2)),
        (lambda: fedml_tpu.parallel.pipeline.split_microbatches(jnp.zeros((6, 2)), 4),
         lambda: pp.split_microbatches(torch.zeros(6, 2), 4)),
    ]
    mesh_dp = jax_build_mesh(devices=jax.devices()[:4], mesh_shape={"dp": 2, "pp": 2})
    cases.append((
        lambda: jax_pipeline_apply(lambda p, h: h, {"w": jnp.zeros((2, 2))},
                                   jnp.zeros((2, 3, 2)), mesh_dp, batch_axis="dp"),
        lambda: pp.check_microbatch(3, "dp", 2)))
    for jax_fn, port_fn in cases:
        with pytest.raises(ValueError) as want:
            jax_fn()
        with pytest.raises(ValueError) as got:
            port_fn()
        assert str(got.value) == str(want.value)


# -- the trainer against the JAX package -------------------------------------------


@pytest.mark.parametrize("world, shape, extra", [
    (4, {"pp": 4}, {}),
    (8, {"dp": 2, "pp": 4}, {}),
    (2, {"pp": 2}, {"grad_accum_steps": 2, "lr_schedule": "cosine", "lr_total_steps": 6}),
])
def test_pipeline_mode_matches_jax(world, shape, extra, tmp_path):
    """The dense transformer, 4 blocks cut into stages: 2 epochs, shuffled;
    every stage ends with the same embeddings, LayerNorm and head (the
    embedding's gradient reached every stage; the head's was not summed
    over them)."""
    knobs = dict(PP, mesh_shape=shape, **extra)
    want = jax_run(knobs)
    assert {k.split("/")[0] for k in want["start"]} == {"outer", "stages"}
    ranks = torch_world.run_world(torch_world.train_ranks, world, {"runs": [
        {"args": knobs, "params": want["start"], "perms": want["perms"]}]}, tmp_path, 150)
    assert_same_training(ranks[0][0], want)
    S = shape["pp"]
    for r, (got,) in enumerate(ranks):
        for k, v in want["end"].items():
            if k.startswith("outer/"):
                np.testing.assert_allclose(got["local"][k], v, atol=PARAM_ATOL, err_msg=(r, k))
        stage = r % S  # pp is the last mesh axis: rank r holds stage r mod S
        for k, v in want["end"].items():
            if k.startswith("stages/"):
                assert got["local"][k].shape == (1,) + v.shape[1:]
                np.testing.assert_allclose(got["local"][k][0], v[stage], atol=PARAM_ATOL)


def test_pipeline_equals_the_plain_model_and_remat_is_bitwise(tmp_path):
    """{pp: 2} from the same start as the unpipelined model (dp 1): the
    same training to f32 rounding; remat gives the same bits."""
    knobs = dict(PP, shuffle=False, epochs=1)
    plain, piped, remat = port_run(2, [
        {"args": dict(knobs, mesh_shape={"dp": 2})},
        {"args": dict(knobs, mesh_shape={"pp": 2})},
        {"args": dict(knobs, mesh_shape={"pp": 2}, remat=True)},
    ], tmp_path)
    stacked = pipeline_params({k: torch.tensor(v) for k, v in plain["params"].items()}, 4, 2)
    assert set(piped["params"]) == set(stacked)
    for k, v in piped["params"].items():
        np.testing.assert_allclose(v, stacked[k].numpy(), atol=PARAM_ATOL, err_msg=k)
        np.testing.assert_array_equal(remat["params"][k], v, err_msg=k)
    np.testing.assert_allclose(piped["stats"]["train_loss"], plain["stats"]["train_loss"],
                               rtol=LOSS_RTOL)


def test_pipeline_resume_is_bitwise(tmp_path):
    """{dp: 2, pp: 2}, adam: 3 epochs straight, and 2 then resumed to 3."""
    ckpt = str(tmp_path / "ckpt")
    knobs = dict(PP, mesh_shape={"dp": 2, "pp": 2}, client_optimizer="adam",
                 learning_rate=0.01, epochs=3)
    straight, _, resumed = port_run(4, [
        {"args": knobs},
        {"args": dict(knobs, epochs=2, checkpoint_dir=ckpt)},
        {"args": dict(knobs, checkpoint_dir=ckpt)},
    ], tmp_path)
    for k in straight["params"]:
        np.testing.assert_array_equal(resumed["params"][k], straight["params"][k], err_msg=k)
    assert resumed["stats"]["test_loss"] == straight["stats"]["test_loss"]


@pytest.mark.parametrize("knobs, match", [
    (dict(PP, model="moe_transformer", mesh_shape={"pp": 2}), "plain TransformerLM"),
    (dict(PP, num_layers=3, mesh_shape={"pp": 2}), "must divide num_layers"),
    (dict(PP, mesh_shape={"dp": 2, "pp": 2}, batch_size=6, pp_microbatches=2),
     "must divide microbatch"),
    (dict(PP, mesh_shape={"pp": 2}, pp_microbatches=3), "not divisible by 3 microbatches"),
])
def test_trainer_refusals_match_jax_word_for_word(knobs, match, tmp_path):
    """The reference's refusals: a routed model, a pp that does not divide
    the layers, a dp that does not divide the microbatch (batch 6 in 2
    microbatches of 3 over dp 2), microbatches that do not divide the
    batch. The JAX package raises at construction or at its first step,
    the port at construction."""
    args = fedml_tpu.init(_set(JaxArguments(), **knobs))
    ds = jax_data.load(args)
    with pytest.raises(ValueError) as want:
        trainer = JaxTrainer(args, None, ds, jax_models.create(args, ds.class_num))
        trainer.run()
    world = int(np.prod(list(knobs["mesh_shape"].values())))
    with pytest.raises(AssertionError) as got:
        port_run(world, [{"args": knobs}], tmp_path, 60)
    assert match in str(want.value)
    assert str(want.value) in str(got.value)


def test_convert_carries_the_pipeline_tree_and_its_optimizer_state():
    """JAX's {outer, stages} params and adam state after one epoch land in
    the port's pipeline layout, leaf for leaf."""
    knobs = dict(PP, mesh_shape={"pp": 2}, client_optimizer="adam", learning_rate=0.01,
                 epochs=1)
    args = fedml_tpu.init(_set(JaxArguments(), **knobs))
    ds = jax_data.load(args)
    trainer = JaxTrainer(args, None, ds, jax_models.create(args, ds.class_num))
    trainer.run()
    params = params_from_flax(jax.tree.map(np.asarray, trainer.params))
    assert params["stages/Dense_0/weight"].shape == (2, 2, 48, 16)  # [S, L/S, 3C, C]
    np.testing.assert_array_equal(
        params["stages/Dense_0/weight"].numpy(),
        np.swapaxes(np.asarray(trainer.params["stages"]["Dense_0"]["kernel"]), -1, -2))
    assert params["outer/Embed_0/weight"].shape == (90, 16)
    state = opt_state_from_flax(jax.tree.map(np.asarray, trainer.opt_state))
    adam, lr = state
    assert lr == () and int(adam["count"]) == int(np.asarray(trainer.opt_state[0].count)) > 0
    for part in ("mu", "nu"):
        assert set(adam[part]) == set(params)
        for k, v in adam[part].items():
            assert v.shape == params[k].shape, (part, k)
    # a carried stack of 2 stages does not run at pp 4
    with pytest.raises(ValueError, match=r"^stage_params leading axis 2 != pp axis 4$"):
        pipeline_params(params, 4, 4)


def test_config_reads_the_same_in_both_packages():
    path = "fedml_tpu_torch/configs/distributed_shakespeare_transformer_pp_bf16.yaml"
    ja = JaxArguments(argparse.Namespace(yaml_config_file=path))
    ta = load_arguments(path)
    for key in ("model", "training_type", "mesh_shape", "num_layers", "num_heads",
                "embed_dim", "seq_len", "batch_size", "grad_accum_steps", "dtype",
                "attention_impl", "pp_microbatches", "learning_rate", "lr_schedule",
                "lr_total_steps", "epochs", "remat", "synthetic_train_size"):
        assert getattr(ta, key) == getattr(ja, key), key
    assert ta.mesh_shape == {"pp": 1} and ta.num_layers == 8 and ta.embed_dim == 512
