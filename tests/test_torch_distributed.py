"""``training_type: distributed``: the port's ``DistributedTrainer`` and
``run_distributed`` against the JAX package's, on the CPU.

The JAX side runs ``fedml_tpu.distributed.DistributedTrainer`` (what
``fedml_tpu.run_distributed`` builds) on the test process's 8 virtual CPU
devices with the same ``mesh_shape``; the port runs in a spawned world of
as many gloo ranks (``torch_world.py``), the JAX package's initial
weights carried across with ``convert.params_from_flax`` and, where the
run shuffles, the JAX package's per-epoch permutations handed in. Both
use the same synthetic Shakespeare stand-in (bitwise the same in both
packages, ``test_torch_nwp.py``).

Tolerances. Both packages compute the loss from f32 logits and route
experts from an f32 softmax whatever the params' dtype, so runs are held
in f32: after a few optimizer steps the params agree to ``PARAM_ATOL``
(measured 1.7e-6 at {dp: 2, tp: 2, ep: 2}), the losses to ``LOSS_RTOL``.
The differences are f32 summation order: the all-reduces add the ranks'
partial products in another order than XLA's partitioned dots.
"""

from __future__ import annotations

import argparse

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
import torch_world
from fedml_tpu import data as jax_data
from fedml_tpu import models as jax_models
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.distributed import DistributedTrainer as JaxTrainer
from fedml_tpu.distributed import _resolve_mesh
from fedml_tpu_torch.arguments import Arguments, load_yaml_arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.parallel.mesh import resolve_mesh_shape
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

PARAM_ATOL = 2e-5
LOSS_RTOL = 2e-5

BASE = dict(
    training_type="distributed", dataset="shakespeare", model="moe_transformer",
    num_layers=2, num_heads=2, embed_dim=16, seq_len=16, batch_size=8,
    client_num_in_total=2, client_num_per_round=2, synthetic_train_size=2,
    synthetic_test_size=2, epochs=2, learning_rate=0.1, num_experts=4,
    capacity_factor=0.5, frequency_of_the_test=1, log_metrics=False, random_seed=0,
)


def _set(a, **kw):
    for k, v in kw.items():
        setattr(a, k, v)
    a._validate()
    return a


def jax_run(knobs: dict) -> dict:
    """The JAX package's distributed run: start and end params (the
    port's layout), the epochs' permutations and the stats."""
    args = fedml_tpu.init(_set(JaxArguments(), **knobs))
    ds = jax_data.load(args)
    model = jax_models.create(args, ds.class_num)
    trainer = JaxTrainer(args, None, ds, model)
    start = params_from_flax(jax.tree.map(np.asarray, trainer.params))
    n = int(np.asarray(ds.train_data_global.mask).size)
    perms = [np.asarray(jax.random.permutation(jax.random.fold_in(trainer._shuffle_key, ep), n))
             for ep in range(int(knobs["epochs"]))]
    stats = trainer.run()
    end = params_from_flax(jax.tree.map(np.asarray, trainer.params))
    return {"start": {k: v.numpy() for k, v in start.items()},
            "end": {k: v.numpy() for k, v in end.items()}, "perms": perms, "stats": stats}


def port_run(world: int, runs: list, tmp_path, timeout: float = 150.0) -> list:
    """Rank 0's results of each run of ``runs`` in one spawned world."""
    return torch_world.run_world(torch_world.train, world, {"runs": runs}, tmp_path,
                                 timeout)[0]


def assert_same_training(got: dict, want: dict, atol=PARAM_ATOL, rtol=LOSS_RTOL,
                         keys=("train_loss", "test_loss", "train_acc", "test_acc")):
    assert set(got["params"]) == set(want["end"])
    err = max(float(np.abs(got["params"][k] - want["end"][k]).max()) for k in want["end"])
    assert err <= atol, err
    for key in keys:
        np.testing.assert_allclose(got["stats"][key], want["stats"][key], rtol=rtol, atol=1e-6,
                                   err_msg=key)
    assert got["stats"]["epoch"] == want["stats"]["epoch"]


# -- the mesh ------------------------------------------------------------------


@pytest.mark.parametrize("shape", [
    {"dp": 2, "xx": 2},
    {"sp": 2, "tp": 2},
    {"pp": 2, "ep": 2},
    {"dp": 4, "tp": 4},
])
def test_mesh_refusals_match_jax_word_for_word(shape):
    """Unknown axes, sp/pp beside anything but dp, more ranks than the
    world (8 here, the JAX side's 8 CPU devices)."""
    with pytest.raises(ValueError) as want:
        _resolve_mesh(argparse.Namespace(mesh_shape=shape))
    with pytest.raises(ValueError) as got:
        resolve_mesh_shape(shape, 8)
    assert str(got.value) == str(want.value)


def test_mesh_defaults_and_must_span_the_world():
    assert resolve_mesh_shape(None, 4) == {"dp": 4}
    assert resolve_mesh_shape({"tp": 2, "dp": 2}, 4) == {"tp": 2, "dp": 2}  # YAML order kept
    with pytest.raises(ValueError, match="must span all 8"):
        resolve_mesh_shape({"dp": 2}, 8)


# -- each mode against the JAX package ----------------------------------------


def test_sharded_dp_tp_ep_eight_ranks_matches_jax(tmp_path):
    """moe_transformer over {dp: 2, tp: 2, ep: 2}: the batch over dp, the
    Megatron layout over tp, the experts over ep; 2 epochs of 2 steps,
    each in 2 accumulation chunks, shuffled, cosine LR, the aux loss on
    and capacity tight enough to drop tokens, so the global routing pool
    matters."""
    knobs = dict(BASE, mesh_shape={"dp": 2, "tp": 2, "ep": 2}, grad_accum_steps=2,
                 lr_schedule="cosine", lr_total_steps=6, moe_aux_weight=0.1)
    want = jax_run(knobs)
    got = port_run(8, [{"args": knobs, "params": want["start"], "perms": want["perms"]}],
                   tmp_path)[0]
    # the test metrics too: both evaluate each whole test batch, one
    # routing pool, whatever the accumulation
    assert_same_training(got, want)
    local = got["local_shapes"]
    assert local["Block_1/SwitchFFN_0/wi"] == (2, 16, 64)  # 4 experts over ep 2
    assert local["Block_0/Dense_0/weight"] == (24, 16)  # q, k, v of one head of 2
    assert local["Block_0/Dense_1/weight"] == (16, 8)  # row-parallel
    assert local["Block_0/Dense_2/weight"] == (32, 16)
    assert local["Dense_0/weight"] == (45, 16)  # 90 tokens' head over tp 2
    for occ in got["occupancy"]:
        assert set(np.unique(occ)) <= {0.0, 1.0}
    assert any(occ.sum() < occ.size for occ in got["occupancy"])  # tokens were dropped


@pytest.mark.parametrize("strategy, world, shape, extra", [
    ("ring", 2, {"sp": 2}, {"sp_ring_block": 4}),
    ("ulysses", 4, {"dp": 2, "sp": 2}, {}),
])
def test_sequence_mode_matches_jax(strategy, world, shape, extra, tmp_path):
    """The dense transformer with its token axis over sp: ring attention
    (K/V in chunks of 4) and Ulysses beside dp; 2 epochs, shuffled."""
    knobs = dict(BASE, model="transformer", mesh_shape=shape, sp_strategy=strategy, **extra)
    want = jax_run(knobs)
    got = port_run(world, [{"args": knobs, "params": want["start"], "perms": want["perms"]}],
                   tmp_path)[0]
    assert_same_training(got, want)


@pytest.mark.parametrize("strategy, world, shape, extra", [
    ("ring", 2, {"sp": 2}, {"sp_ring_block": 4}),
    ("ulysses", 4, {"dp": 2, "sp": 2}, {}),
])
def test_sequence_mode_moe_matches_jax(strategy, world, shape, extra, tmp_path):
    """moe_transformer with its token axis over sp (and the batch over dp):
    the routing pool of a chunk spans every sp shard of its examples, so
    each shard's capacity positions are offset by the tokens of the
    examples and shards before it; capacity tight enough to drop
    tokens; 2 epochs, shuffled, with the aux loss on."""
    knobs = dict(BASE, mesh_shape=shape, sp_strategy=strategy, moe_aux_weight=0.1, **extra)
    want = jax_run(knobs)
    got = port_run(world, [{"args": knobs, "params": want["start"], "perms": want["perms"]}],
                   tmp_path)[0]
    assert_same_training(got, want)
    for occ in got["occupancy"]:
        assert set(np.unique(occ)) <= {0.0, 1.0}
    assert any(occ.sum() < occ.size for occ in got["occupancy"])  # tokens were dropped


def test_moe_evaluation_routes_the_whole_batch_as_jax_does(tmp_path):
    """With ``grad_accum_steps`` 2 over {dp: 2}, the port evaluates MoE one
    whole test batch a forward pass (one routing pool), as the JAX
    package's ``_evaluate`` does: the same test metrics on the same
    weights. Chunked evaluation read test_loss 4.99236536 here against
    the reference's 4.9955864."""
    knobs = dict(BASE, mesh_shape={"dp": 2}, grad_accum_steps=2)
    args = fedml_tpu.init(_set(JaxArguments(), **knobs))
    ds = jax_data.load(args)
    trainer = JaxTrainer(args, None, ds, jax_models.create(args, ds.class_num))
    start = params_from_flax(jax.tree.map(np.asarray, trainer.params))
    with trainer.mesh:
        want = trainer._evaluate(trainer._place_data(ds.test_data_global))
    got = torch_world.run_world(torch_world.evaluate, 2, {"runs": [
        {"args": knobs, "params": {k: v.numpy() for k, v in start.items()}}]}, tmp_path)[0][0]
    assert want["test_loss"] == pytest.approx(4.9955864, abs=1e-6)
    for key in ("test_loss", "test_acc"):
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("accum, pinned", [
    (8, (4.4434128, 5.1364646)),  # chunks of 1 example over dp 2
    (2, None),  # chunks of 4: dp divides them
])
def test_dp_over_accumulation_chunks_matches_jax(accum, pinned, tmp_path):
    """{dp: 2} with MoE (4 experts, capacity 0.5) and ``grad_accum_steps``
    chunks of batch 8, one epoch: a dp that divides the batch but not the
    chunk trains the reference's count-weighted full-batch gradient (a
    rank holding none of a chunk's examples joins its collectives with
    masked rows that take no expert capacity), and a dp that divides the
    chunk still does."""
    knobs = dict(BASE, mesh_shape={"dp": 2}, grad_accum_steps=accum, epochs=1)
    want = jax_run(knobs)
    if pinned is not None:
        assert want["stats"]["train_loss"] == pytest.approx(pinned[0], abs=1e-6)
        assert want["stats"]["test_loss"] == pytest.approx(pinned[1], abs=1e-6)
    got = port_run(2, [{"args": knobs, "params": want["start"], "perms": want["perms"]}],
                   tmp_path)[0]
    assert_same_training(got, want)
    for occ in got["occupancy"]:
        assert set(np.unique(occ)) <= {0.0, 1.0}
    with pytest.raises(AssertionError, match="must divide batch_size 8"):
        port_run(2, [{"args": dict(knobs, mesh_shape={"dp": 2}, grad_accum_steps=3)}],
                 tmp_path, 60)


def test_dp_routing_pool_and_one_rank_match_jax(tmp_path):
    """{dp: 2} with MoE against the JAX package, and the same run on one
    rank (dp 1): data parallelism does not change the function, the
    routing pool staying the global batch."""
    knobs = dict(BASE, mesh_shape={"dp": 2}, shuffle=False)
    want = jax_run(knobs)
    got = port_run(2, [{"args": knobs, "params": want["start"]}], tmp_path)[0]
    assert_same_training(got, want)
    one = port_run(1, [{"args": dict(knobs, mesh_shape={"dp": 1}), "params": want["start"]}],
                   tmp_path)[0]
    assert_same_training(one, want)


# -- the trainer's own behaviour, in the port ----------------------------------


def test_grad_accumulation_is_the_unchunked_step_and_aux_loss_moves_training(tmp_path):
    """Dense: 4 chunks = 1 chunk to f32 rounding. MoE: the aux loss
    weight changes the router's training and nothing else of step 0's
    loss."""
    dense = dict(BASE, model="transformer", mesh_shape={"dp": 1}, shuffle=False)
    moe = dict(BASE, mesh_shape={"dp": 1}, shuffle=False, epochs=1)
    one, four, aux0, aux1 = port_run(1, [
        {"args": dict(dense, grad_accum_steps=1)},
        {"args": dict(dense, grad_accum_steps=4)},
        {"args": dict(moe, moe_aux_weight=0.0)},
        {"args": dict(moe, moe_aux_weight=1.0)},
    ], tmp_path)
    err = max(float(np.abs(one["params"][k] - four["params"][k]).max()) for k in one["params"])
    assert err <= 1e-6, err
    router = "Block_1/SwitchFFN_0/router/weight"
    assert np.abs(aux0["params"][router] - aux1["params"][router]).max() > 1e-4


def test_cosine_schedule_is_optax(tmp_path):
    import optax

    from fedml_tpu_torch.core import optimizers

    args = _set(Arguments(), learning_rate=0.5, lr_schedule="cosine", lr_total_steps=5,
                warmup_steps=2, client_optimizer="sgd", momentum=0.9)
    tx = optimizers.create_client_optimizer(args, schedules=True)
    jtx = optax.sgd(optax.warmup_cosine_decay_schedule(0.0, 0.5, 2, 5), momentum=0.9)
    p = {"w": torch.ones(3, dtype=torch.float64)}
    jp = {"w": np.ones(3)}
    s, js = tx.init(p), jtx.init(jp)
    with jax.enable_x64(True):
        for step in range(7):
            g = {"w": torch.full((3,), float(step + 1), dtype=torch.float64)}
            u, s = tx.update(g, s, p)
            ju, js = jtx.update({"w": np.full(3, float(step + 1))}, js, jp)
            np.testing.assert_allclose(u["w"].numpy(), np.asarray(ju["w"]), rtol=1e-12)
    with pytest.raises(NotImplementedError, match="distributed trainer"):
        optimizers.create_client_optimizer(args)  # the federated trainers decay by round


def test_resume_is_bitwise_and_a_completed_run_does_not_retrain(tmp_path):
    """{dp: 2}, adam: 3 epochs straight; 2 epochs, then the same run
    resumed from the checkpoint to 3; then once more with all 3 done,
    which only evaluates."""
    ckpt = str(tmp_path / "ckpt")
    knobs = dict(BASE, mesh_shape={"dp": 2}, client_optimizer="adam", learning_rate=0.01,
                 epochs=3)
    straight, first, resumed, done = port_run(2, [
        {"args": knobs},
        {"args": dict(knobs, epochs=2, checkpoint_dir=ckpt)},
        {"args": dict(knobs, checkpoint_dir=ckpt)},
        {"args": dict(knobs, checkpoint_dir=ckpt)},
    ], tmp_path)
    for k in straight["params"]:
        np.testing.assert_array_equal(resumed["params"][k], straight["params"][k], err_msg=k)
        np.testing.assert_array_equal(done["params"][k], straight["params"][k], err_msg=k)
    for key in ("train_loss", "test_loss", "epoch"):
        assert resumed["stats"][key] == straight["stats"][key], key
    assert "train_loss" not in done["stats"] and done["stats"]["epoch"] == 2
    assert done["stats"]["test_loss"] == straight["stats"]["test_loss"]
    assert first["stats"]["epoch"] == 1


def test_run_distributed_entry(tmp_path):
    """``fedml_tpu_torch.run_distributed``: in a world the caller set up
    (2 gloo ranks, sharded over tp), alone as a world of one rank, and
    never on a card that is not there."""
    knobs = dict(BASE, mesh_shape={"tp": 2}, epochs=1)
    stats = torch_world.run_world(torch_world.run_api, 2, {"args": knobs}, tmp_path)
    assert stats[0]["train_loss"] == stats[1]["train_loss"] and np.isfinite(stats[0]["train_loss"])
    import torch.distributed as dist

    alone = fedml_tpu_torch.run_distributed(_set(Arguments(), **dict(knobs, mesh_shape=None)),
                                            device="cpu")
    assert np.isfinite(alone["test_loss"]) and not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fedml_tpu_torch.run_distributed(_set(Arguments(), **knobs))


def test_configs_read_the_same_in_both_packages(tmp_path):
    for name in ("distributed_shakespeare_moe_transformer_bf16.yaml",
                 "distributed_shakespeare_transformer_sp_bf16.yaml",
                 "distributed_shakespeare_transformer_pp_bf16.yaml"):
        path = f"fedml_tpu_torch/configs/{name}"
        ja = JaxArguments(argparse.Namespace(yaml_config_file=path))
        ta = load_yaml_arguments(path)
        for key in ("model", "training_type", "mesh_shape", "num_layers", "num_heads",
                    "embed_dim", "seq_len", "batch_size", "grad_accum_steps", "dtype",
                    "attention_impl", "sp_strategy", "sp_ring_block", "num_experts",
                    "capacity_factor", "moe_every", "learning_rate", "lr_schedule",
                    "lr_total_steps", "epochs", "pp_microbatches"):
            assert getattr(ta, key) == getattr(ja, key), (name, key)
    # the fed mesh's knobs: the headline FedAvg config with a (data, fsdp)
    # mesh, as the mesh simulator reads it
    from fedml_tpu.parallel.layout import fed_mesh_shape as jax_fed
    from fedml_tpu_torch.parallel.layout import fed_mesh_shape

    src = open("fedml_tpu_torch/configs/fedavg_femnist_cnn.yaml").read()
    path = tmp_path / "fed_mesh.yaml"
    path.write_text(src + "\nmesh_args: {mesh_shape: {data: 4, fsdp: 2}}\n")
    ja = JaxArguments(argparse.Namespace(yaml_config_file=str(path)))
    ta = load_yaml_arguments(str(path))
    for key in ("mesh_shape", "federated_optimizer", "client_num_per_round", "model"):
        assert getattr(ta, key) == getattr(ja, key), key
    assert ta.mesh_shape == {"data": 4, "fsdp": 2}
    assert fed_mesh_shape(ta.mesh_shape) and jax_fed(ja.mesh_shape)
    # the serve and comm knobs: the serving config with a fleet, a mesh
    # and a lossy, reliable comm stack, and every default
    src = open("fedml_tpu_torch/configs/serve_transformer_flash.yaml").read()
    path = tmp_path / "serve_comm.yaml"
    path.write_text(src + (
        "fleet_args: {serve_fleet_size: 2, serve_mesh: {data: 2, fsdp: 1},\n"
        "             serve_route_policy: static, serve_route_slo_ms: 250,\n"
        "             serve_route_failover: 2, serve_watch_interval_s: 0.5}\n"
        "comm_args: {grpc_port_base: 9100, grpc_send_timeout_s: 30, trpc_port_base: 9200,\n"
        "            reliable_comm: true, comm_retry_max: 3, comm_retry_base_s: 0.1,\n"
        "            heartbeat_interval_s: 1, heartbeat_timeout_s: 4, broker_port: 1883,\n"
        "            fault_injection: {drop_prob: 0.1, seed: 2}, run_id: serve7}\n"))
    knobs = ("serve_max_batch", "serve_queue_size", "serve_batch_wait_ms", "serve_deadline_ms",
             "serve_bucket", "serve_fleet_size", "serve_mesh", "serve_route_policy",
             "serve_route_slo_ms", "serve_route_failover", "serve_watch_interval_s",
             "grpc_port_base", "grpc_send_timeout_s", "grpc_ipconfig_path", "trpc_port_base",
             "trpc_ipconfig_path", "reliable_comm", "comm_retry_max", "comm_retry_base_s",
             "heartbeat_interval_s", "heartbeat_timeout_s", "broker_host", "broker_port",
             "payload_store_dir", "fault_injection", "run_id", "telemetry")
    for p in (path, "fedml_tpu_torch/configs/serve_transformer_flash.yaml"):
        ja = JaxArguments(argparse.Namespace(yaml_config_file=str(p)))
        ta = load_yaml_arguments(str(p))
        for key in knobs:
            assert getattr(ta, key) == getattr(ja, key), (p, key)
            assert type(getattr(ta, key)) is type(getattr(ja, key)), (p, key)
