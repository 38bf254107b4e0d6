"""The transformer slice as a whole: FedAvg of a narrow flash TransformerLM
through the port's ``FedAvgAPI.train()`` against the JAX one, and the two
trainer repairs the slice needed.

Both packages train 3 rounds on the Shakespeare stand-in (the port's own
loader, bitwise the JAX loader's) from the same initial params, with
``shuffle=False``, 3 of 6 clients per round so the pow2 bucket pads the
cohort to 4. They run in float64, where they agree to rounding: the JAX
side with ``attention_impl: full`` (its Pallas kernel and ``_bwd``
compute in f32 whatever the input; the JAX package's own test holds
flash equal to full to 2e-5), the port with ``flash`` (its plain
versions keep float64 inputs in float64), so 1e-9 leaves room for
summation order and nothing else. ``tests/test_torch_flash_backward.py``
holds the port's flash against the JAX kernel itself.
"""

from __future__ import annotations

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
from fedml_tpu import models as jax_models
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.core.local_trainer import make_local_train_fn as jax_make_local_train_fn
from fedml_tpu.core import optimizers as jax_optimizers
from fedml_tpu.core.types import Batches as JaxBatches
from fedml_tpu.data import load as jax_load
from fedml_tpu.simulation import FedAvgAPI as JaxFedAvgAPI
import fedml_tpu_torch
from fedml_tpu_torch import data, models
from fedml_tpu_torch.arguments import Arguments, load_arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.core import local_trainer, optimizers
from fedml_tpu_torch.core.types import Batches
from fedml_tpu_torch.data.packing import pack_clients
from fedml_tpu_torch.simulation import FedAvgAPI
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "fedml_tpu_torch", "configs",
                      "fedavg_shakespeare_transformer_flash_bf16.yaml")
PARAMS_ATOL = 1e-9
# the cohort's training loss is summed in f32 in both packages, and XLA
# and torch add the clients in different orders: a few f32 ulps
COHORT_LOSS_RTOL = 1e-6

SLICE = dict(dataset="shakespeare", model="transformer", embed_dim=32, num_heads=2,
             num_layers=1, seq_len=32, max_len=32, synthetic_train_size=48,
             synthetic_test_size=16, partition_method="homo", client_num_in_total=6,
             client_num_per_round=3, comm_round=3, epochs=1, batch_size=4,
             learning_rate=0.05, frequency_of_the_test=1, shuffle=False, random_seed=1)


def _set(a, **kw):
    for k, v in kw.items():
        setattr(a, k, v)
    a._validate()
    return a


_JAX_RUN = {}


def _jax_run():
    """The JAX package's 3 rounds in float64, computed once: (its
    dataset, start params, final params, history, pipeline stats)."""
    if not _JAX_RUN:
        with jax.enable_x64(True):
            jargs = fedml_tpu.init(_set(JaxArguments(), **SLICE, attention_impl="full"))
            jds = jax_load(jargs)
            japi = JaxFedAvgAPI(jargs, None, jds, jax_models.create(jargs, jds.class_num))
            japi.global_params = jax.tree.map(lambda a: a.astype(jnp.float64),
                                              japi.global_params)
            start = params_from_flax(jax.tree.map(np.asarray, japi.global_params))
            japi.train()
            want = params_from_flax(jax.tree.map(np.asarray, japi.global_params))
        _JAX_RUN.update(jds=jds, start=start, want=want, history=japi.history,
                        stats=japi.pipeline_stats)
    return _JAX_RUN


@pytest.mark.parametrize("mode, depth", [("vectorized", 1), ("vectorized", 4),
                                         ("sequential", 1)])
def test_three_rounds_match_jax(mode, depth):
    run = _jax_run()
    targs = fedml_tpu_torch.init(_set(Arguments(), **SLICE, attention_impl="flash",
                                      sim_mode=mode, pipeline_depth=depth))
    tds = data.load(targs, device="cpu")
    for split in ("packed_train", "packed_test"):
        got, want = getattr(tds, split), getattr(run["jds"], split)
        np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
        np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    tapi = FedAvgAPI(targs, "cpu", tds, models.create(targs, tds.class_num, device="cpu"))
    tapi.global_params = dict(run["start"])
    tapi.train()

    want, start = run["want"], run["start"]
    assert set(want) == set(tapi.global_params)
    assert max(float((want[k] - start[k]).abs().max()) for k in want) > 1e-3
    for k in want:
        assert tapi.global_params[k].dtype == torch.float64, k
        np.testing.assert_allclose(tapi.global_params[k].numpy(), want[k].numpy(),
                                   atol=PARAMS_ATOL, err_msg=k)
    if mode == "vectorized":
        assert tapi.pipeline_stats["bucket"] == run["stats"]["bucket"] == 4
    jhist = run["history"]
    assert [h["round"] for h in tapi.history] == [h["round"] for h in jhist] == [0, 1, 2]
    for th, jh in zip(tapi.history, jhist):
        for key in ("train_acc", "test_acc"):
            np.testing.assert_almost_equal(th[key], jh[key], decimal=6, err_msg=key)
        for key in ("train_loss", "test_loss"):
            np.testing.assert_allclose(th[key], jh[key], rtol=1e-9, err_msg=key)
        np.testing.assert_allclose(th["train_loss_cohort"], jh["train_loss_cohort"],
                                   rtol=COHORT_LOSS_RTOL)
        # counted in tokens: 3 clients x 8 sequences x 32 tokens
        assert th["cohort_samples"] == 3 * 8 * 32
    assert tapi.history[-1]["train_loss"] < tapi.history[0]["train_loss"]


# -- repair: only floating inputs are cast to the compute dtype ----------------

# bf16 compute over f32 masters: each package rounds activations and
# gradients to bf16 in its own places and orders, so after 4 steps at lr
# 0.5 the params differ by up to a few bf16 steps of the updates
BF16_ATOL = 1e-2
VOCAB = 10004  # stackoverflow_nwp's vocabulary: ids well above bf16's 256


def _lm_args(cls):
    return _set(cls(), dataset="stackoverflow_nwp", model="transformer", embed_dim=32,
                num_heads=2, num_layers=1, seq_len=16, max_len=16, attention_impl="flash",
                dtype="bfloat16", learning_rate=0.5)


def test_bf16_training_on_large_token_ids_matches_jax():
    """Token ids stay integers under ``dtype: bfloat16`` (cast to bf16,
    ids above 256 would round, and the embedding refuses float ids)."""
    jargs, targs = _lm_args(JaxArguments), _lm_args(Arguments)
    jm = jax_models.create(jargs, VOCAB)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(4))
    tm = models.create(targs, VOCAB, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.integers(0, VOCAB, size=(14, 16))
    assert (x > 256).mean() > 0.9
    y = rng.integers(0, VOCAB, size=(14, 16))
    packed, _ = pack_clients([x], [y], 4, num_batches=5, x_dtype=torch.int32, device="cpu")

    jfn = jax_make_local_train_fn(jm.apply, jm.loss_fn,
                                  jax_optimizers.create_client_optimizer(jargs), epochs=1,
                                  shuffle=False, compute_dtype=jnp.bfloat16)
    jb = JaxBatches(x=jnp.asarray(packed.x[0].numpy()), y=jnp.asarray(packed.y[0].numpy()),
                    mask=jnp.asarray(packed.mask[0].numpy()))
    jout, jmetrics = jax.jit(jfn)(jp, jb, jax.random.PRNGKey(0))
    tfn = local_trainer.make_local_train_fn(
        tm.apply, tm.loss_fn, optimizers.create_client_optimizer(targs), epochs=1,
        shuffle=False, compute_dtype=torch.bfloat16)
    start = params_from_flax(jax.tree.map(np.asarray, jp))
    tout, tmetrics = tfn(start, packed)
    want = params_from_flax(jax.tree.map(np.asarray, jout))
    moved = max(float((want[k] - start[k]).abs().max()) for k in want)
    assert moved > 10 * BF16_ATOL
    for k in want:
        assert tout[k].dtype == torch.float32, k  # f32 masters
        np.testing.assert_allclose(tout[k][0].numpy(), want[k].numpy(), atol=BF16_ATOL,
                                   err_msg=k)
    assert float(tmetrics["count"][0]) == float(jmetrics["count"]) == 14 * 16
    np.testing.assert_allclose(float(tmetrics["loss_sum"][0]), float(jmetrics["loss_sum"]),
                               rtol=1e-3)


# -- repair: evaluation chunks by elements, not examples -----------------------


def test_evaluation_chunks_by_elements(monkeypatch):
    """A T-1024 model evaluates a few packed batches per forward pass
    (each within the element budget), and the sums equal one pass over
    everything; image batches keep 4096 examples per pass."""
    args = _set(Arguments(), dataset="shakespeare", model="transformer", embed_dim=16,
                num_heads=2, num_layers=1, seq_len=1024, max_len=1024,
                attention_impl="flash")
    model = models.create(args, 90, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.integers(0, 90, size=(4, 4, 2, 1024)), dtype=torch.int32)
    y = torch.tensor(rng.integers(0, 90, size=(4, 4, 2, 1024)))
    mask = torch.ones((4, 4, 2))
    mask[3, 2:] = 0.0
    batches = Batches(x=x, y=y, mask=mask)

    per = local_trainer.eval_batches_per_pass(batches)
    assert per == 6  # 2 x 1024 x 1024 elements per batch
    assert per * 2 * 1024 * 1024 <= local_trainer.EVAL_ELEMENTS
    passes = []

    def apply(p, xb):
        passes.append(xb.shape[0])
        return model.apply(p, xb)

    chunked = local_trainer.make_eval_fn(apply, model.loss_fn)(params, batches)
    assert passes == [12, 12, 8]
    monkeypatch.setattr(local_trainer, "EVAL_ELEMENTS", 1 << 40)
    assert local_trainer.eval_batches_per_pass(batches) >= 16  # one pass
    whole = local_trainer.make_eval_fn(model.apply, model.loss_fn)(params, batches)
    assert float(chunked["count"]) == float(whole["count"]) == 28 * 1024
    assert float(chunked["correct"]) == float(whole["correct"])
    np.testing.assert_allclose(float(chunked["loss_sum"]), float(whole["loss_sum"]),
                               rtol=1e-6)


@pytest.mark.parametrize("feat, bs, per", [((28, 28, 1), 32, 128), ((32, 32, 3), 64, 64)])
def test_image_evaluation_keeps_4096_examples_per_pass(feat, bs, per):
    b = Batches(x=torch.zeros((2, 3, bs) + feat), y=torch.zeros((2, 3, bs), dtype=torch.int64),
                mask=torch.ones((2, 3, bs)))
    assert local_trainer.eval_batches_per_pass(b) == per == 4096 // bs


# -- the configuration -----------------------------------------------------------


def test_config_reads_the_same_in_both_packages():
    ja = JaxArguments(argparse.Namespace(yaml_config_file=CONFIG))
    ta = load_arguments(CONFIG)
    keys = ("dataset", "model", "attention_impl", "embed_dim", "num_heads", "num_layers",
            "seq_len", "max_len", "synthetic_train_size", "synthetic_test_size",
            "partition_method", "client_num_in_total", "client_num_per_round", "epochs",
            "batch_size", "client_optimizer", "learning_rate", "dtype", "comm_round",
            "matmul_precision", "federated_optimizer", "random_seed", "pipeline_depth",
            "frequency_of_the_test")
    for key in keys:
        assert getattr(ta, key) == getattr(ja, key), key
    # bench.py run_longctx's shape (H8, D64, T4096, B4, bf16) at embed 512
    assert (ta.num_heads, ta.embed_dim // ta.num_heads, ta.seq_len, ta.batch_size,
            ta.dtype) == (8, 64, 4096, 4, "bfloat16")
    assert (ta.partition_method, ta.client_num_in_total, ta.client_num_per_round) == (
        "homo", 32, 8)


def test_config_runs_shrunk_on_the_cpu(tmp_path):
    """The configuration at a small width and length through
    run_simulation on the CPU: bf16 over f32 masters through the flash
    functions' plain versions, metrics counted in tokens."""
    args = _set(load_arguments(CONFIG), embed_dim=32, num_heads=2, seq_len=32, max_len=32,
                synthetic_train_size=64, synthetic_test_size=16, client_num_in_total=8,
                client_num_per_round=4, comm_round=2, frequency_of_the_test=1,
                metrics_jsonl_path=str(tmp_path / "m.jsonl"))
    stats = fedml_tpu_torch.run_simulation(device="cpu", args=args)
    assert stats["round"] == 1 and np.isfinite(stats["train_loss"])
    lines = [json.loads(line) for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert lines[-1]["kind"] == "pipeline" and lines[-1]["bucket"] == 4
    # 4 clients x 8 sequences x 32 tokens per round
    assert [r["cohort_samples"] for r in lines[:-1]] == [4 * 8 * 32] * 2
    assert lines[-1]["round_samples"] == [32, 32]  # sequences


def test_remat_is_not_ported():
    """The name is kept from when ``remat`` raised; it is ported now: the
    factory builds the rematerialized model, with the plain model's
    parameter names (``tests/test_torch_remat.py`` holds its numbers)."""
    args = _set(Arguments(), model="transformer", remat=True)
    model = models.create(args, 90, device="cpu")
    assert model.module.remat is True
    plain = models.create(_set(Arguments(), model="transformer"), 90, device="cpu")
    assert [k for k, _ in model.module.named_parameters()] == [
        k for k, _ in plain.module.named_parameters()]
