"""The federated RNNs of the port against the JAX package's.

- Both models, from the same flax params carried across by
  ``params_from_flax``: logits and gradients within 1e-5 in f32.
- FedAvg of the Shakespeare LSTM, 3 rounds through both packages'
  ``FedAvgAPI`` from the same start in float64: params within 1e-9
  (summation order and nothing else; the nwp data path is bitwise the
  JAX package's).
- The factory's vocabulary floor, the converter's LSTM mapping and its
  refusal of leaves it does not know, the two configurations read alike
  by both packages, and the vmapped step batching every LSTM op.
"""

from __future__ import annotations

import argparse
import functools
import os
import warnings

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import models as jax_models
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.data import load as jax_load
from fedml_tpu.models.rnn import RNNOriginalFedAvg as JaxShakespeare
from fedml_tpu.models.rnn import RNNStackOverflow as JaxStackOverflow
from fedml_tpu.simulation import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu_torch import data, models
from fedml_tpu_torch.arguments import Arguments, load_yaml_arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.core import optimizers
from fedml_tpu_torch.core.local_trainer import make_local_train_fn
from fedml_tpu_torch.core.types import Batches
from fedml_tpu_torch.models.rnn import RNNOriginalFedAvg, RNNStackOverflow
from fedml_tpu_torch.models.spec import FedModel
from fedml_tpu_torch.simulation import FedAvgAPI, SimulatorSingleProcess
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "fedml_tpu_torch", "configs")
# f32, the same weights: the two packages' products round differently
F32_ATOL = 1e-5
PARAMS_ATOL = 1e-9

# (JAX module, port module, vocab, sequence length); Stack Overflow at a
# small vocabulary (its width is the test's, its shapes the model's)
MODELS = {
    "shakespeare": (JaxShakespeare, RNNOriginalFedAvg, 90, 16),
    "stackoverflow": (JaxStackOverflow, RNNStackOverflow, 300, 10),
}


def _set(a, **kw):
    for k, v in kw.items():
        setattr(a, k, v)
    a._validate()
    return a


def _seeded_params(jm, x, rng):
    """Normal params of the flax tree's shapes (``eval_shape``: flax's own
    init compiles an orthogonal initializer for seconds), each weight
    scaled by 1/sqrt(its rows)."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x, jnp.int32))
    return jax.tree.map(
        lambda s: jnp.asarray(rng.normal(size=s.shape) / np.sqrt(s.shape[0] if len(s.shape) > 1
                                                                  else 10), jnp.float32),
        shapes["params"])


def _nwp_loss(logp, labels):
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], -1))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_and_gradients_match_flax(name):
    jcls, tcls, vocab, T = MODELS[name]
    rng = np.random.default_rng(3)
    x = rng.integers(0, vocab, (3, T))
    y = rng.integers(0, vocab, (3, T))
    jm = jcls(vocab_size=vocab)
    jp = _seeded_params(jm, x, rng)

    def jloss(p):
        return _nwp_loss(jax.nn.log_softmax(jm.apply({"params": p}, jnp.asarray(x, jnp.int32))),
                         jnp.asarray(y))

    jlogits = np.asarray(jax.jit(jm.apply)({"params": jp}, jnp.asarray(x, jnp.int32)))
    jgrads = params_from_flax(jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(jp)))

    model = FedModel(name, tcls(vocab_size=vocab), task="nwp")
    tp = params_from_flax(jax.tree.map(np.asarray, jp))
    assert set(tp) == {k.replace(".", "/") for k, _ in model.module.named_parameters()}
    xt = torch.tensor(x, dtype=torch.int32)
    np.testing.assert_allclose(model.apply(tp, xt).detach().numpy(), jlogits, atol=F32_ATOL)

    def tloss(p):
        logp = torch.log_softmax(model.apply(p, xt), -1)
        return -logp.gather(-1, torch.tensor(y)[..., None]).mean()

    tgrads = torch.func.grad(tloss)(tp)
    assert max(float(g.abs().max()) for g in tgrads.values()) > 1e-3
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k].numpy(), jgrads[k].numpy(), atol=F32_ATOL,
                                   err_msg=k)


def test_published_param_counts():
    counts = {name: sum(p.numel() for p in cls().parameters())
              for name, cls in (("shakespeare", RNNOriginalFedAvg),
                                ("stackoverflow", RNNStackOverflow))}
    assert counts == {"shakespeare": 820_522, "stackoverflow": 4_050_748}


SLICE = dict(dataset="fed_shakespeare", model="rnn", seq_len=12, synthetic_train_size=60,
             synthetic_test_size=20, partition_method="homo", client_num_in_total=6,
             client_num_per_round=3, comm_round=3, epochs=1, batch_size=4,
             learning_rate=1.0, frequency_of_the_test=1, shuffle=False, random_seed=1)


# the JAX side's run, made once for both modes
_JAX_RUN = {}


@pytest.mark.parametrize("mode", ["vectorized", "sequential"])
def test_three_fedavg_rounds_match_jax(mode, monkeypatch):
    """The Shakespeare LSTM: 3 rounds of 3 of 6 clients (the pow2 bucket
    pads 3 to 4), float64 on both sides. flax starts an LSTM's carry in
    the cell's ``param_dtype`` (f32 by default), which a float64 scan
    refuses, so the JAX side's cells are built with ``param_dtype``
    float64: it sets the carry's and the initial params' dtype and
    nothing else (the start params are the same either way, below)."""
    if not _JAX_RUN:
        monkeypatch.setattr(flax.linen, "OptimizedLSTMCell",
                            functools.partial(flax.linen.OptimizedLSTMCell,
                                              param_dtype=jnp.float64))
        with jax.enable_x64(True):
            jargs = fedml_tpu.init(_set(JaxArguments(), **SLICE))
            jds = jax_load(jargs)
            japi = JaxFedAvgAPI(jargs, None, jds, jax_models.create(jargs, jds.class_num))
            japi.global_params = jax.tree.map(lambda a: a.astype(jnp.float64),
                                              japi.global_params)
            start = params_from_flax(jax.tree.map(np.asarray, japi.global_params))
            japi.train()
            want = params_from_flax(jax.tree.map(np.asarray, japi.global_params))
        _JAX_RUN.update(jds=jds, start=start, want=want, history=japi.history)
    jds, start, want = _JAX_RUN["jds"], _JAX_RUN["start"], _JAX_RUN["want"]

    targs = fedml_tpu_torch.init(_set(Arguments(), **SLICE, sim_mode=mode))
    tds = data.load(targs, device="cpu")
    np.testing.assert_array_equal(tds.packed_train.x.numpy(), np.asarray(jds.packed_train.x))
    tmodel = models.create(targs, tds.class_num, device="cpu")
    assert tmodel.name == "rnn_fedavg"
    tapi = FedAvgAPI(targs, "cpu", tds, tmodel)
    tapi.global_params = dict(start)
    tapi.train()
    assert max(float((want[k] - start[k]).abs().max()) for k in want) > 1e-2
    for k in want:
        assert tapi.global_params[k].dtype == torch.float64, k
        np.testing.assert_allclose(tapi.global_params[k].numpy(), want[k].numpy(),
                                   atol=PARAMS_ATOL, err_msg=k)
    jhist = _JAX_RUN["history"]
    assert [h["round"] for h in tapi.history] == [h["round"] for h in jhist] == [0, 1, 2]
    for th, jh in zip(tapi.history, jhist):
        for key in ("train_loss", "test_loss"):
            np.testing.assert_allclose(th[key], jh[key], rtol=1e-9, err_msg=key)
        np.testing.assert_almost_equal(th["train_acc"], jh["train_acc"], decimal=6)


@pytest.mark.parametrize("dataset, vocab_size, class_num, want_name, want_vocab, want_T", [
    ("fed_shakespeare", 0, 90, "rnn_fedavg", 90, 80),
    ("shakespeare", 0, 120, "rnn_fedavg", 120, 80),
    ("shakespeare", 200, 90, "rnn_fedavg", 200, 80),
    ("stackoverflow_nwp", 0, 10004, "rnn_stackoverflow", 10004, 20),
    ("stackoverflow_nwp", 0, 10100, "rnn_stackoverflow", 10100, 20),
])
def test_factory_vocab_floor(dataset, vocab_size, class_num, want_name, want_vocab, want_T):
    """The vocabulary is the model's default or ``vocab_size``, never
    below the dataset's class count; both packages build the same."""
    kw = dict(model="rnn", dataset=dataset, vocab_size=vocab_size)
    jm = jax_models.create(_set(JaxArguments(), **kw), class_num)
    tm = models.create(_set(Arguments(), **kw), class_num, device="cpu")
    assert (tm.name, tm.task, tm.example_shape) == (jm.name, jm.task, jm.example_shape)
    assert (tm.name, tm.input_bound, tm.example_shape) == (want_name, want_vocab, (want_T,))
    assert tm.example_dtype == torch.int32
    assert tm.module.Embed_0.num_embeddings == jm.module.vocab_size == want_vocab


def test_converter_stacks_the_gates_in_order():
    """Gate k of flax's cell lands in rows [k*H, (k+1)*H) of the port's
    stacked weights, k over i, f, g, o."""
    H, n_in = 3, 2
    rng = np.random.default_rng(0)
    cell = {}
    for g in "ifgo":
        cell[f"i{g}"] = {"kernel": rng.normal(size=(n_in, H))}
        cell[f"h{g}"] = {"kernel": rng.normal(size=(H, H)), "bias": rng.normal(size=(H,))}
    out = params_from_flax({"OptimizedLSTMCell_3": cell, "Dense_0": {
        "kernel": np.ones((H, 4)), "bias": np.zeros(4)}})
    assert set(out) == {"OptimizedLSTMCell_3/ih/weight", "OptimizedLSTMCell_3/hh/weight",
                        "OptimizedLSTMCell_3/hh/bias", "Dense_0/weight", "Dense_0/bias"}
    for k, g in enumerate("ifgo"):
        rows = slice(k * H, (k + 1) * H)
        np.testing.assert_array_equal(out["OptimizedLSTMCell_3/ih/weight"][rows].numpy(),
                                      cell[f"i{g}"]["kernel"].T)
        np.testing.assert_array_equal(out["OptimizedLSTMCell_3/hh/weight"][rows].numpy(),
                                      cell[f"h{g}"]["kernel"].T)
        np.testing.assert_array_equal(out["OptimizedLSTMCell_3/hh/bias"][rows].numpy(),
                                      cell[f"h{g}"]["bias"])


def _cell(H=2, n_in=2):
    cell = {f"i{g}": {"kernel": np.zeros((n_in, H))} for g in "ifgo"}
    cell.update({f"h{g}": {"kernel": np.zeros((H, H)), "bias": np.zeros(H)} for g in "ifgo"})
    return cell


@pytest.mark.parametrize("break_it, match", [
    (lambda c: c["ii"].update(bias=np.zeros(2)), "unknown LSTM cell leaf"),
    (lambda c: c.update(hx={"kernel": np.zeros((2, 2))}), "unknown LSTM cell leaf"),
    (lambda c: c["hg"].pop("bias"), "missing"),
    (lambda c: c.pop("io"), "missing"),
    (lambda c: c["hf"].update(scale=np.ones(2)), "unknown LSTM cell leaf"),
])
def test_converter_refuses_unknown_and_missing_leaves(break_it, match):
    cell = _cell()
    break_it(cell)
    with pytest.raises(ValueError, match=match):
        params_from_flax({"OptimizedLSTMCell_0": cell})
    with pytest.raises(ValueError, match="unknown leaf"):
        params_from_flax({"RNN_0": {"carry": np.zeros(2)}})


def test_init_follows_flax_distributions():
    """Hidden kernels orthogonal per gate, input kernels lecun-normal,
    biases zero."""
    model = models.create(_set(Arguments(), model="rnn", dataset="shakespeare"), 90,
                          device="cpu")
    p = model.init(torch.Generator().manual_seed(0))
    hh = p["OptimizedLSTMCell_1/hh/weight"]
    for k in range(4):
        block = hh[k * 256:(k + 1) * 256]
        torch.testing.assert_close(block @ block.T, torch.eye(256), atol=1e-5, rtol=0)
    assert not torch.equal(hh[:256], hh[256:512])
    assert torch.equal(p["OptimizedLSTMCell_0/hh/bias"], torch.zeros(1024))
    ih = p["OptimizedLSTMCell_0/ih/weight"]
    assert ih.shape == (1024, 8) and 0.2 < float(ih.std()) * 8 ** 0.5 < 1.5


def test_vmapped_step_batches_every_op():
    """The trainer's vmap(grad) runs the LSTM as batched products: no op
    falls back to a per-client loop (functorch warns when one does;
    ``nn.LSTM``'s fused kernel would)."""
    model = models.create(_set(Arguments(), model="rnn", dataset="shakespeare", seq_len=6),
                          90, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    step = make_local_train_fn(model.apply, model.loss_fn, optimizers.sgd(1.0), epochs=1,
                               shuffle=False)
    gen = torch.Generator().manual_seed(2)
    batches = Batches(x=torch.randint(0, 90, (3, 2, 4, 6), generator=gen, dtype=torch.int32),
                      y=torch.randint(0, 90, (3, 2, 4, 6), generator=gen),
                      mask=torch.ones(3, 2, 4))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        new, metrics = step(params, batches)
    assert not [w for w in caught if "batching rule" in str(w.message)]
    assert all(v.shape[0] == 3 for v in new.values())
    assert metrics["count"].tolist() == [48.0, 48.0, 48.0]


@pytest.mark.parametrize("config, want", [
    ("fedavg_shakespeare_rnn.yaml",
     dict(dataset="fed_shakespeare", seq_len=80, client_num_in_total=715,
          client_num_per_round=10, batch_size=4, learning_rate=1.0,
          synthetic_train_size=16000, synthetic_test_size=2000)),
    ("fedavg_stackoverflow_rnn.yaml",
     dict(dataset="stackoverflow_nwp", seq_len=20, client_num_in_total=1000,
          client_num_per_round=50, batch_size=16, learning_rate=10 ** -0.5,
          synthetic_train_size=40000)),
])
def test_configs_read_the_same_in_both_packages(config, want):
    path = os.path.join(CONFIGS, config)
    ja = JaxArguments(argparse.Namespace(yaml_config_file=path))
    ta = load_yaml_arguments(path)
    for key in ("dataset", "model", "seq_len", "client_num_in_total", "client_num_per_round",
                "epochs", "batch_size", "learning_rate", "partition_method", "dtype",
                "synthetic_train_size", "federated_optimizer", "comm_round",
                "frequency_of_the_test", "matmul_precision", "random_seed"):
        assert getattr(ta, key) == getattr(ja, key), key
    for key, value in want.items():
        assert getattr(ta, key) == pytest.approx(value), key
    assert (ta.model, ta.partition_method, ta.epochs, ta.dtype) == (
        "rnn", "homo", 1, "float32")


def test_shakespeare_config_trains_shrunk_on_the_cpu():
    """The configuration through run_simulation at its widths, its
    federation and sequences shrunk: the train loss falls."""
    args = _set(load_yaml_arguments(os.path.join(CONFIGS, "fedavg_shakespeare_rnn.yaml")),
                seq_len=10, synthetic_train_size=160, synthetic_test_size=40,
                client_num_in_total=8, client_num_per_round=4, comm_round=3,
                frequency_of_the_test=1, log_metrics=False)
    args = fedml_tpu_torch.init(args)
    ds = data.load(args, device="cpu")
    sim = SimulatorSingleProcess(args, "cpu", ds, models.create(args, ds.class_num,
                                                                device="cpu"))
    assert sim.run()["round"] == 2
    losses = [h["train_loss"] for h in sim.fl_trainer.history]
    assert len(losses) == 3 and np.isfinite(losses).all() and losses[-1] < losses[0]
