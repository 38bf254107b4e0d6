"""The reference's default-dtype training path: FedAvg of the flash
TransformerLM in f32 through both packages' ``run_simulation``.

``fedml_tpu_torch/configs/fedavg_shakespeare_transformer_flash.yaml`` is
the bf16 transformer configuration at the reference's default ``dtype:
float32``, where the JAX package's Pallas kernel and its ``_bwd`` compute
in f32; on the card it runs the port's f32 flash kernels. Here both
packages read it alike, and one round of it at CPU widths (2 layers,
embed 32, 4 heads, T 128) through each package's ``run_simulation`` from
the same start agrees: the JAX side runs the Pallas kernel in interpret
mode with its ``_bwd``, the port its flash functions' plain versions on
CPU tensors.
"""

from __future__ import annotations

import argparse
import os

import jax
import numpy as np
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.simulation import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu_torch.arguments import load_arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.simulation import FedAvgAPI
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "fedml_tpu_torch", "configs",
                      "fedavg_shakespeare_transformer_flash.yaml")
BF16_CONFIG = os.path.join(REPO, "fedml_tpu_torch", "configs",
                           "fedavg_shakespeare_transformer_flash_bf16.yaml")
# the configuration at CPU widths: one round, 4 of 8 clients, 2 local
# steps each (8 sequences a client, batch 4)
CPU_WIDTHS = dict(embed_dim=32, num_heads=4, num_layers=2, seq_len=128, max_len=128,
                  synthetic_train_size=64, synthetic_test_size=16, client_num_in_total=8,
                  client_num_per_round=4, comm_round=1, frequency_of_the_test=1,
                  shuffle=False, log_metrics=False)
# Both packages compute in f32 from the same start on the same data, so
# they differ by f32 rounding in another summation order: XLA's fused
# products and the Pallas kernel's online softmax against torch's
# products and the port's dense plain forward (the backward is the same
# blockwise recompute in both). After one round of 2 steps at lr 0.05 the
# params differed by at most 6e-8 (f32 ulps) when this test was written,
# against updates of up to 1.3e-2; the tolerance is 1e-5, and the round
# must move them by more than 1e-3, so a wrong gradient cannot hide under
# it. The losses: 1e-5 relative.
PARAMS_ATOL = 1e-5
LOSS_RTOL = 1e-5


def _cpu_args(cls_args):
    for key, value in CPU_WIDTHS.items():
        setattr(cls_args, key, value)
    cls_args._validate()
    return cls_args


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
    # the reference's default dtype and precision, at run_longctx's shape
    assert ta.dtype == JaxArguments().dtype == "float32"
    assert ta.matmul_precision == "highest"
    assert (ta.attention_impl, ta.num_heads, ta.embed_dim // ta.num_heads, ta.seq_len,
            ta.batch_size, ta.num_layers) == ("flash", 8, 64, 4096, 4, 2)
    # everything else is the bf16 configuration's
    bf16 = load_arguments(BF16_CONFIG)
    for key in keys:
        if key != "dtype":
            assert getattr(bf16, key) == getattr(ta, key), key


def test_one_round_through_run_simulation_matches_jax(monkeypatch):
    """One FedAvg round of the configuration at CPU widths through both
    packages' ``run_simulation``: the port starts from the JAX package's
    initial params (converted), and its final params and stats match."""
    held = {}
    jax_train, port_train = JaxFedAvgAPI.train, FedAvgAPI.train

    def jax_side(self):
        held["start"] = params_from_flax(jax.tree.map(np.asarray, self.global_params))
        out = jax_train(self)
        held["jax"] = params_from_flax(jax.tree.map(np.asarray, self.global_params))
        return out

    def port_side(self):
        assert set(self.global_params) == set(held["start"])
        self.global_params = {k: v.clone() for k, v in held["start"].items()}
        out = port_train(self)
        held["port"] = {k: v.detach().clone() for k, v in self.global_params.items()}
        return out

    jargs = _cpu_args(JaxArguments(argparse.Namespace(yaml_config_file=CONFIG)))
    real_init = fedml_tpu.init
    monkeypatch.setattr(fedml_tpu, "init", lambda args=None: real_init(jargs))
    monkeypatch.setattr(JaxFedAvgAPI, "train", jax_side)
    monkeypatch.setattr(FedAvgAPI, "train", port_side)
    want = fedml_tpu.run_simulation()
    got = fedml_tpu_torch.run_simulation(device="cpu", args=_cpu_args(load_arguments(CONFIG)))

    start, jp, tp = held["start"], held["jax"], held["port"]
    assert max(float((jp[k] - start[k]).abs().max()) for k in jp) > 1e-3
    for k in jp:
        assert tp[k].dtype == torch.float32, k
        np.testing.assert_allclose(tp[k].numpy(), jp[k].numpy(), atol=PARAMS_ATOL, err_msg=k)
    assert got["round"] == want["round"] == 0
    for key in ("train_loss", "test_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL, err_msg=key)
    for key in ("train_acc", "test_acc"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, err_msg=key)


def test_f32_flash_reaches_the_f32_plain_versions(monkeypatch):
    """In f32 on CPU tensors the transformer's attention runs the flash
    functions' plain versions in f32 (no cast to another dtype): one
    forward and one backward a layer and step."""
    from fedml_tpu_torch.ops import flash_attention as fa

    seen = []
    forward, backward = fa.flash_attention_reference, fa._flash_backward

    def spy(tag, fn):
        def call(q, *rest, **kw):
            seen.append((tag, q.dtype))
            return fn(q, *rest, **kw)
        return call

    monkeypatch.setattr(fa, "flash_attention_reference", spy("forward", forward))
    monkeypatch.setattr(fa, "_flash_backward", spy("backward", backward))
    args = _cpu_args(load_arguments(CONFIG))
    args.frequency_of_the_test = 5  # evaluation only after the last round
    fedml_tpu_torch.run_simulation(device="cpu", args=args)
    assert {dtype for _, dtype in seen} == {torch.float32}
    backwards = sum(tag == "backward" for tag, _ in seen)
    assert backwards == args.num_layers * 2  # 2 layers x 2 steps for the whole cohort
