"""The dense slice as a whole: FedAvg, FedOpt and FedNova of a GroupNorm
ResNet through the port's ``FedAvgAPI.train()`` against the JAX one.

Both packages train 3 rounds of a narrow ResNet (the full network's
blocks and GroupNorms at stage sizes (1, 1), channels (8, 16)) on the
same packed CIFAR-10-shaped arrays (the JAX loader's) from the same
initial params, with ``shuffle=False``, 3 of 6 clients per round so the
pow2 bucket pads the cohort to 4. The JAX side runs its round pipeline
(``fedml_tpu/core/round_pipeline.py``); the port runs its own at depth 1
and at depth 4. Both run in float64, where they agree to rounding: 1e-9
leaves room for summation order and nothing else (f32 parity of a ReLU
network over several steps is not a 1e-5 property; ROADMAP.md's facts).
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
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.data import load as jax_load
from fedml_tpu.models.resnet import ResNet as JaxResNet
from fedml_tpu.models.spec import FedModel as JaxFedModel
from fedml_tpu.simulation import fedavg_api as jax_api
import fedml_tpu_torch
from fedml_tpu_torch.arguments import Arguments, load_arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.core.types import Batches
from fedml_tpu_torch.data.loader import FederatedDataset
from fedml_tpu_torch.models.resnet import ResNet
from fedml_tpu_torch.models.spec import FedModel
from fedml_tpu_torch.simulation import FedAvgAPI, FedNovaAPI, FedOptAPI
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

PARAMS_ATOL = 1e-9
# the cohort's training loss is summed in f32 in both packages (the
# reference casts each client's sums to f32, then sums the clients), and
# XLA and torch add the clients in different orders: a few f32 ulps
COHORT_LOSS_RTOL = 1e-6
STAGES, CHANNELS = (1, 1), (8, 16)

SLICE = dict(dataset="cifar10", synthetic_train_size=144, synthetic_test_size=48,
             partition_method="hetero", partition_alpha=0.5, client_num_in_total=6,
             client_num_per_round=3, comm_round=3, epochs=1, batch_size=16,
             learning_rate=0.05, frequency_of_the_test=1, shuffle=False, random_seed=2)

ALGORITHMS = {
    "FedAvg": (jax_api.FedAvgAPI, FedAvgAPI, {}),
    "FedOpt": (jax_api.FedOptAPI, FedOptAPI,
               dict(server_optimizer="adam", server_lr=0.01)),
    "FedNova": (jax_api.FedNovaAPI, FedNovaAPI, {}),
}


def _set(a, **kw):
    for k, v in kw.items():
        setattr(a, k, v)
    a._validate()
    return a


def _port_dataset(jds) -> FederatedDataset:
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


_JAX_RUNS = {}


def _jax_run(algorithm):
    """The JAX package's 3 rounds in float64: (start params, final
    params, history, pipeline stats), computed once per algorithm."""
    if algorithm not in _JAX_RUNS:
        jcls, _, extra = ALGORITHMS[algorithm]
        with jax.enable_x64(True):
            jargs = fedml_tpu.init(_set(JaxArguments(), **SLICE, **extra))
            jds = jax_load(jargs)
            for split in ("packed_train", "packed_test", "train_data_global",
                          "test_data_global"):
                b = getattr(jds, split)
                setattr(jds, split, b.replace(x=b.x.astype(jnp.float64)))
            model = JaxFedModel(name="resnet_narrow",
                                module=JaxResNet(STAGES, CHANNELS, jds.class_num),
                                example_shape=(32, 32, 3))
            japi = jcls(jargs, None, jds, model)
            japi.global_params = jax.tree.map(lambda a: a.astype(jnp.float64),
                                              japi.global_params)
            # rebuilt on the float64 params (FedOpt's moments)
            japi.server_state = japi._init_server_state()
            start = params_from_flax(jax.tree.map(np.asarray, japi.global_params))
            japi.train()
            want = params_from_flax(jax.tree.map(np.asarray, japi.global_params))
        _JAX_RUNS[algorithm] = (jds, start, want, japi.history, japi.pipeline_stats)
    return _JAX_RUNS[algorithm]


def _port_run(algorithm, depth, jds, start):
    _, tcls, extra = ALGORITHMS[algorithm]
    targs = fedml_tpu_torch.init(_set(Arguments(), **SLICE, **extra, pipeline_depth=depth))
    tds = _port_dataset(jds)
    model = FedModel(name="resnet_narrow", module=ResNet(STAGES, CHANNELS, tds.class_num),
                     example_shape=(32, 32, 3))
    tapi = tcls(targs, "cpu", tds, model)
    tapi.global_params = dict(start)
    tapi.server_state = tapi._init_server_state()
    tapi.train()
    return tapi


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("algorithm", sorted(ALGORITHMS))
def test_three_rounds_match_jax(algorithm, depth):
    jds, start, want, jhist, jstats = _jax_run(algorithm)
    tapi = _port_run(algorithm, depth, jds, start)
    assert tapi.pipeline_stats["bucket"] == jstats["bucket"] == 4
    assert tapi.pipeline_stats["depth"] == depth
    moved = max(float((want[k] - start[k]).abs().max()) for k in want)
    assert moved > 1e-3
    for k in want:
        assert tapi.global_params[k].dtype == torch.float64, k
        np.testing.assert_allclose(tapi.global_params[k].numpy(), want[k].numpy(),
                                   atol=PARAMS_ATOL, err_msg=k)
    assert [h["round"] for h in tapi.history] == [h["round"] for h in jhist] == [0, 1, 2]
    for th, jh in zip(tapi.history, jhist):
        for key in ("train_acc", "test_acc"):
            np.testing.assert_almost_equal(th[key], jh[key], decimal=6, err_msg=key)
        for key in ("train_loss", "test_loss"):
            np.testing.assert_allclose(th[key], jh[key], rtol=1e-9, err_msg=key)
        np.testing.assert_allclose(th["train_loss_cohort"], jh["train_loss_cohort"],
                                   rtol=COHORT_LOSS_RTOL)


DENSE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "fedml_tpu_torch", "configs", "fedavg_cifar10_resnet18_bf16.yaml")


def test_dense_config_reads_the_same_in_both_packages():
    ja = JaxArguments(argparse.Namespace(yaml_config_file=DENSE))
    ta = load_arguments(DENSE)
    keys = ("dataset", "model", "client_num_in_total", "client_num_per_round",
            "synthetic_train_size", "synthetic_test_size", "partition_method",
            "partition_alpha", "epochs", "batch_size", "learning_rate", "comm_round",
            "dtype", "matmul_precision", "federated_optimizer", "random_seed",
            "pipeline_depth", "pipeline_bucket", "frequency_of_the_test")
    for key in keys:
        assert getattr(ta, key) == getattr(ja, key), key
    # bench.py run_dense's cohort
    assert (ta.client_num_in_total, ta.client_num_per_round, ta.synthetic_train_size,
            ta.epochs, ta.batch_size, ta.learning_rate, ta.model, ta.dtype) == (
        100, 10, 100 * 500, 1, 64, 0.03, "resnet18", "bfloat16")


def test_dense_config_runs_shrunk_on_the_cpu(tmp_path):
    """The dense configuration at full model width with a tiny
    federation, through run_simulation on the CPU: bf16 over f32
    masters, the padded pow2 bucket, and the pipeline's record."""
    args = load_arguments(DENSE)
    _set(args, client_num_in_total=5, client_num_per_round=3, synthetic_train_size=60,
         synthetic_test_size=16, batch_size=8, comm_round=2, frequency_of_the_test=1,
         metrics_jsonl_path=str(tmp_path / "m.jsonl"))
    stats = fedml_tpu_torch.run_simulation(device="cpu", args=args)
    assert stats["round"] == 1 and np.isfinite(stats["train_loss"])
    lines = [json.loads(line) for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert lines[-1]["kind"] == "pipeline" and lines[-1]["bucket"] == 4
    assert [r["round"] for r in lines[:-1]] == [0, 1]
    assert all(r["cohort_samples"] > 0 for r in lines[:-1])
