"""The FedAvg slice as a whole: the port's ``FedAvgAPI`` against the JAX one.

Both packages train 3 rounds of the CNN on the same packed arrays (the
JAX loader's, features included) from the same initial params, with
``shuffle=False`` and a cohort smaller than the federation; final params
and every round's accuracies agree. Then the port's own oracles:
FedAvg equals centralized full-batch GD, vectorized equals sequential;
client sampling is bitwise the reference's; and ``run_simulation``
obeys the device rule.
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
import fedml_tpu_torch
from fedml_tpu import models as jax_models
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.data import load as jax_load
from fedml_tpu.simulation import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.simulation.fedavg_api import (
    deterministic_client_sampling as jax_sampling,
)
from fedml_tpu_torch import models
from fedml_tpu_torch.arguments import Arguments, load_yaml_arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.core.types import Batches, flat_examples
from fedml_tpu_torch.data import load
from fedml_tpu_torch.data.loader import FederatedDataset
from fedml_tpu_torch.simulation import FedAvgAPI, FedProxAPI, SimulatorSingleProcess
from fedml_tpu_torch.simulation.fedavg_api import deterministic_client_sampling
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "fedml_tpu_torch", "configs", "fedavg_femnist_cnn.yaml")
# 3 rounds x 4 clients x 2 epochs from the same start, in float64 on both
# sides (see test_three_rounds_match_jax): the packages agree to ~1e-16
# there, so 1e-9 leaves room for summation order and nothing else
PARAMS_ATOL = 1e-9
# FedAvg vs centralized GD, and vectorized vs sequential: the reference's
# own tolerance (tests/test_fedavg_oracle.py)
ORACLE_ATOL = 1e-5


def _set(a, **kw):
    for k, v in kw.items():
        setattr(a, k, v)
    a._validate()
    return a


SLICE = dict(dataset="femnist", model="cnn", synthetic_train_size=480,
             synthetic_test_size=120, partition_method="hetero", partition_alpha=0.5,
             client_num_in_total=6, client_num_per_round=4, comm_round=3, epochs=2,
             batch_size=20, learning_rate=0.03, frequency_of_the_test=1,
             shuffle=False, random_seed=1)


def _to_f64(b):
    return b.replace(x=b.x.astype(jnp.float64))


def _port_dataset(jds) -> FederatedDataset:
    """The JAX loader's packed federation as torch tensors on the CPU
    (features included, so both packages see the same images)."""

    def cv(b):
        return Batches(x=torch.tensor(np.asarray(b.x)),
                       y=torch.tensor(np.asarray(b.y), dtype=torch.int64),
                       mask=torch.tensor(np.asarray(b.mask)))

    return FederatedDataset(
        train_data_num=jds.train_data_num, test_data_num=jds.test_data_num,
        train_data_global=cv(jds.train_data_global), test_data_global=cv(jds.test_data_global),
        train_data_local_num_dict=dict(jds.train_data_local_num_dict),
        train_data_local_dict={}, test_data_local_dict={}, class_num=jds.class_num,
        packed_train=cv(jds.packed_train), packed_num_samples=np.asarray(jds.packed_num_samples),
        packed_test=cv(jds.packed_test), client_num=jds.client_num, task=jds.task,
    )


def test_three_rounds_match_jax():
    """In float64 on both sides. In f32 the two packages' rounding can
    flip a ReLU whose input is within an ulp of zero, and one flipped
    example moves a client's step by O(lr): on this data the JAX
    package's own vectorized and sequential modes end 8e-4 apart in f32.
    In f64 the comparison measures the algorithm (sampling, packing,
    masking, optimizer, weighting, evaluation), not the rounding."""
    with jax.enable_x64(True):
        jargs = fedml_tpu.init(_set(JaxArguments(), **SLICE))
        jds = jax_load(jargs)
        for split in ("packed_train", "packed_test", "train_data_global", "test_data_global"):
            setattr(jds, split, _to_f64(getattr(jds, split)))
        japi = JaxFedAvgAPI(jargs, None, jds, jax_models.create(jargs, jds.class_num))
        japi.global_params = jax.tree.map(lambda a: a.astype(jnp.float64), japi.global_params)
        start = params_from_flax(jax.tree.map(np.asarray, japi.global_params))
        japi.train()
        jglob = japi.evaluate_global()
        want = params_from_flax(jax.tree.map(np.asarray, japi.global_params))

    targs = fedml_tpu_torch.init(_set(Arguments(), **SLICE))
    tds = _port_dataset(jds)
    tapi = FedAvgAPI(targs, "cpu", tds, models.create(targs, tds.class_num, device="cpu"))
    tapi.global_params = start
    tapi.train()

    assert set(want) == set(tapi.global_params)
    moved = max(float((want[k] - start[k]).abs().max()) for k in want)
    assert moved > 1e-2
    for k in want:
        assert tapi.global_params[k].dtype == torch.float64
        np.testing.assert_allclose(tapi.global_params[k].numpy(), want[k].numpy(),
                                   atol=PARAMS_ATOL, err_msg=k)
    assert [h["round"] for h in tapi.history] == [h["round"] for h in japi.history] == [0, 1, 2]
    for th, jh in zip(tapi.history, japi.history):
        for key in ("train_acc", "test_acc"):
            np.testing.assert_almost_equal(th[key], jh[key], decimal=3, err_msg=key)
        for key in ("train_loss", "test_loss", "train_loss_cohort"):
            np.testing.assert_allclose(th[key], jh[key], rtol=1e-9, err_msg=key)
    assert tapi.history[-1]["train_loss"] < tapi.history[0]["train_loss"]
    np.testing.assert_almost_equal(tapi.evaluate_global()["acc"], jglob["acc"], decimal=3)


def test_client_sampling_bitwise():
    for r in range(20):
        for total, per in ((100, 10), (32, 32), (7, 3), (1000, 64)):
            got = deterministic_client_sampling(r, total, per)
            want = jax_sampling(r, total, per)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


ORACLE = dict(dataset="mnist", synthetic_train_size=400, synthetic_test_size=100,
              model="lr", partition_method="homo", client_num_in_total=4,
              client_num_per_round=4, comm_round=3, epochs=1, batch_size=100,
              learning_rate=0.1, momentum=0.0, weight_decay=0.0,
              frequency_of_the_test=1, shuffle=False)


def _api(cls=FedAvgAPI, **kw):
    args = fedml_tpu_torch.init(_set(Arguments(), **kw))
    ds = load(args, device="cpu")
    return cls(args, "cpu", ds, models.create(args, ds.class_num, device="cpu"))


def test_fedavg_equals_centralized_gd():
    """Full-batch clients, 1 epoch, all clients, plain SGD: FedAvg is
    full-batch GD on the union (tests/test_fedavg_oracle.py:67-91)."""
    api = _api(**ORACLE)
    params = {k: v.clone() for k, v in api.global_params.items()}
    api.train()
    g = flat_examples(api.dataset.train_data_global)
    keep = g.mask > 0
    x, y = g.x[keep], g.y[keep]
    for _ in range(ORACLE["comm_round"]):
        def loss(p):
            logits = api.model.apply(p, x)
            return api.model.loss_fn(logits, y, torch.ones(len(y)))[0]

        grads = torch.func.grad(loss)(params)
        params = {k: params[k] - ORACLE["learning_rate"] * grads[k] for k in params}
    for k in params:
        np.testing.assert_allclose(api.global_params[k].numpy(), params[k].numpy(),
                                   atol=ORACLE_ATOL, err_msg=k)
    logits = api.model.apply(params, x)
    central_acc = float((logits.argmax(-1) == y).float().mean())
    assert round(api.history[-1]["train_acc"], 3) == round(central_acc, 3)


def _as_float64(api):
    api.global_params = {k: v.double() for k, v in api.global_params.items()}
    for split in ("packed_train", "packed_test"):
        b = getattr(api.dataset, split)
        setattr(api.dataset, split, Batches(x=b.x.double(), y=b.y, mask=b.mask.double()))
    return api


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("model", ["lr", "cnn"])
def test_vectorized_equals_sequential(model, shuffle):
    """Both modes draw the round's shuffle uniforms once for the cohort,
    so they agree with the shuffle on, too. The linear model runs in f32,
    as the reference's own oracle does. The CNN runs in float64: in f32
    its vmapped (grouped) and single-client convolutions round
    differently, and an example whose ReLU input lands within that
    rounding of zero changes its client's step by O(lr) (observed: 3e-3
    on this data with the shuffle on)."""
    out = {}
    for mode in ("vectorized", "sequential"):
        kw = dict(ORACLE, partition_method="hetero", batch_size=20, comm_round=2, epochs=2,
                  sim_mode=mode, momentum=0.9, shuffle=shuffle)
        if model == "cnn":
            kw.update(model="cnn", dataset="femnist")
        api = _api(**kw)
        if model == "cnn":
            _as_float64(api)
        api.train()
        out[mode] = api
    v, s = out["vectorized"], out["sequential"]
    for k in v.global_params:
        np.testing.assert_allclose(v.global_params[k].numpy(), s.global_params[k].numpy(),
                                   atol=ORACLE_ATOL, err_msg=k)
    for hv, hs in zip(v.history, s.history):
        np.testing.assert_allclose(hv["train_loss_cohort"], hs["train_loss_cohort"], rtol=1e-5)


def test_fedprox_pulls_clients_toward_the_global_model():
    kw = dict(ORACLE, batch_size=20, epochs=3, comm_round=1, learning_rate=0.1)
    plain = _api(**kw)
    start = {k: v.clone() for k, v in plain.global_params.items()}
    plain.train()
    prox = _api(FedProxAPI, fedprox_mu=1.0, **kw)
    prox.train()

    def dist(api):
        return sum(float(((api.global_params[k] - start[k]) ** 2).sum()) for k in start)

    assert 0 < dist(prox) < dist(plain)


def test_run_simulation_on_the_cpu_writes_metrics_and_a_profile(tmp_path):
    args = load_yaml_arguments(CONFIG)
    _set(args, client_num_in_total=4, client_num_per_round=3, synthetic_train_size=240,
         synthetic_test_size=60, epochs=1, comm_round=2,
         metrics_jsonl_path=str(tmp_path / "metrics.jsonl"),
         telemetry_dir=str(tmp_path / "tel"), profile_rounds="1")
    stats = fedml_tpu_torch.run_simulation(device="cpu", args=args)
    assert stats["round"] == 1 and 0.0 <= stats["test_acc"] <= 1.0
    assert stats["round_time_s"] >= stats["train_time_s"] > 0
    lines = [json.loads(l) for l in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["round"] for r in lines if r["kind"] == "server_train"] == [0, 1]
    # the round pipeline's own record closes the file
    assert lines[-1]["kind"] == "pipeline" and lines[-1]["rounds"] == 2
    summary = json.loads((tmp_path / "tel" / "profile" / "round_0001" / "summary.json").read_text())
    assert summary["round"] == 1 and summary["wall_s"] > 0
    assert summary["device_busy_s"] == 0.0  # no card: no device events
    assert (tmp_path / "tel" / "profile" / "round_0001" / "trace.json").exists()


def test_run_simulation_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _set(Arguments(), **ORACLE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fedml_tpu_torch.run_simulation(args=args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load(args)
    assert fedml_tpu_torch.run_simulation(device="cpu", args=args)["round"] == 2


@pytest.mark.parametrize("knob, value, match", [
    ("metrics_port", 9100, "telemetry"),
    ("stall_timeout_s", 5.0, "telemetry"),
    ("preempt_signal", "round:1", "elastic"),
])
def test_later_knobs_raise(knob, value, match, tmp_path, monkeypatch):
    """The knobs that raised before their slice arrived now take effect,
    as in the JAX package: the /metrics server and the stall watchdog run
    for the run's lifetime (and stop with it), and the preemption signal
    ends the run at its round with ``Preempted``."""
    from fedml_tpu_torch.core.telemetry import Telemetry
    from fedml_tpu_torch.parallel.elastic import Preempted

    Telemetry.reset()
    tel = Telemetry.get_instance()
    started = []
    for name in ("maybe_start_metrics_server", "maybe_start_watchdog"):
        real = getattr(tel, name)

        def spy(args, _real=real, _name=name):
            started.append((_name, getattr(args, knob)))
            return _real(args)

        monkeypatch.setattr(tel, name, spy)
    api = _api(**dict(ORACLE, checkpoint_dir=str(tmp_path), **{knob: value}))
    if match == "elastic":
        with pytest.raises(Preempted) as e:
            api.train()
        assert e.value.round_idx == 1 and e.value.ckpt_step == 1
    else:
        api.train()
        assert tel._watchdog is None and tel._metrics_server is None  # stopped with the run
    assert [v for _, v in started] == [value, value]


@pytest.mark.parametrize("name, exc", [("HierFedAvg", NotImplementedError),
                                       ("DSGD", NotImplementedError),
                                       ("SplitNN", NotImplementedError),
                                       ("NoSuchAlg", ValueError)])
def test_unported_algorithms_raise(name, exc):
    """An unknown name raises ``ValueError``; every algorithm of the JAX
    package's registry builds on one card (HierFedAvg, DSGD and SplitNN
    since the ninth slice), and the mesh backend runs them in a world of
    one rank, DSGD refusing it in the JAX package's words."""
    args = fedml_tpu_torch.init(_set(Arguments(), **ORACLE))
    args.federated_optimizer = name
    ds = load(args, device="cpu")
    if exc is ValueError:
        with pytest.raises(ValueError, match="not supported"):
            SimulatorSingleProcess(args, "cpu", ds, models.create(args, 10, device="cpu"))
    else:
        sim = SimulatorSingleProcess(args, "cpu", ds, models.create(args, 10, device="cpu"))
        assert sim.fl_trainer.algorithm == name
    if exc is ValueError or name == "DSGD":
        with pytest.raises(ValueError, match="not supported|does not support the MESH"):
            fedml_tpu_torch.run_simulation(backend="MESH", device="cpu", args=args)
    else:
        stats = fedml_tpu_torch.run_simulation(backend="MESH", device="cpu", args=args)
        assert np.isfinite(stats["test_loss"])


def test_init_maps_matmul_precision_onto_tf32():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        fedml_tpu_torch.init(_set(Arguments(), matmul_precision="default"))
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        fedml_tpu_torch.init(_set(Arguments(), matmul_precision="highest"))
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        with pytest.raises(ValueError, match="matmul_precision"):
            _set(Arguments(), matmul_precision="fast")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def test_headline_config_reads_the_same_in_both_packages():
    ja = JaxArguments(argparse.Namespace(yaml_config_file=CONFIG))
    ta = load_yaml_arguments(CONFIG)
    keys = ("dataset", "model", "client_num_in_total", "client_num_per_round",
            "synthetic_train_size", "synthetic_test_size", "partition_method",
            "partition_alpha", "epochs", "batch_size", "learning_rate", "comm_round",
            "dtype", "matmul_precision", "federated_optimizer", "random_seed")
    for key in keys:
        assert getattr(ta, key) == getattr(ja, key), key
    assert (ta.client_num_in_total, ta.epochs, ta.batch_size, ta.synthetic_train_size) == (
        32, 5, 32, 32 * 600)
    assert ta.matmul_precision == "highest"
