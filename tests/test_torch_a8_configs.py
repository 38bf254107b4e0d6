"""The ninth slice's configurations and entry points on the CPU.

Each YAML under ``fedml_tpu_torch/configs`` for the other simulation
algorithms reads the same through both packages' ``Arguments``, and,
shrunk (few clients and samples; widths kept where the CPU allows),
runs one round through ``fedml_tpu_torch.run_simulation(device="cpu")``;
so do the four segmentation datasets through DeepLabLite. Without a card
and without ``device="cpu"`` the entry point raises.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import pytest
import torch

import fedml_tpu_torch
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu_torch.arguments import Arguments, load_yaml_arguments
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "fedml_tpu_torch", "configs")

SMALL = dict(synthetic_train_size=64, synthetic_test_size=16, comm_round=1, epochs=1)
CASES = {  # config -> (algorithm, shrink)
    "hierfedavg_femnist_cnn.yaml": ("HierFedAvg", dict(client_num_in_total=4,
                                                       client_num_per_round=4, group_num=2)),
    "dsgd_femnist_cnn.yaml": ("DSGD", dict(client_num_in_total=4, client_num_per_round=4)),
    "turboaggregate_femnist_cnn.yaml": ("TurboAggregate", dict(client_num_in_total=4,
                                                               client_num_per_round=4)),
    "fedgan_mnist.yaml": ("FedGAN", dict(client_num_in_total=4, client_num_per_round=2,
                                         batch_size=16)),
    "fednas_cifar10_darts.yaml": ("FedNAS", dict(client_num_in_total=2, client_num_per_round=1,
                                                 nas_width=4, batch_size=16)),
    "fedseg_pascal_voc_deeplab.yaml": ("FedAvg", dict(client_num_in_total=2,
                                                      client_num_per_round=2, seg_width=4,
                                                      synthetic_train_size=16,
                                                      synthetic_test_size=4, batch_size=4)),
    "splitnn_cifar10.yaml": ("SplitNN", dict(client_num_in_total=2, client_num_per_round=2,
                                             batch_size=16)),
    "fedgkt_cifar10.yaml": ("FedGKT", dict(client_num_in_total=2, client_num_per_round=2,
                                           gkt_server_stages=(1, 1, 1), batch_size=16)),
    "vfl_mnist_leaf.yaml": ("VFL", dict(data_cache_dir=os.path.join(REPO, "fedml_data"))),
}
KEYS = ("dataset", "model", "federated_optimizer", "client_num_in_total",
        "client_num_per_round", "epochs", "batch_size", "learning_rate", "comm_round",
        "partition_method", "random_seed", "dtype", "matmul_precision", "group_num",
        "group_comm_round", "topology_neighbor_num", "topology_beta", "ta_groups",
        "ta_quant_scale", "gan_latent_dim", "gan_lr_g", "gan_lr_d", "nas_width", "nas_cells",
        "nas_steps", "arch_learning_rate", "seg_width", "splitnn_stages",
        "gkt_server_stages", "gkt_alpha", "gkt_temperature", "gkt_server_epochs",
        "vfl_parties", "vfl_rep_dim", "momentum")


def _shrunk(path, **kw):
    args = load_yaml_arguments(path)
    for k, v in dict(SMALL, **kw).items():
        setattr(args, k, v)
    args._validate()
    return args


@pytest.mark.parametrize("config", sorted(CASES))
def test_config_reads_the_same_and_runs_a_round(config):
    path = os.path.join(CONFIGS, config)
    ja = JaxArguments(argparse.Namespace(yaml_config_file=path))
    ta = load_yaml_arguments(path)
    for key in KEYS:
        got, want = getattr(ta, key, None), getattr(ja, key, None)
        if isinstance(want, (list, tuple)):
            got, want = tuple(got), tuple(want)
        assert got == want, key
    algorithm, shrink = CASES[config]
    assert ta.federated_optimizer == algorithm
    stats = fedml_tpu_torch.run_simulation(device="cpu", args=_shrunk(path, **shrink))
    assert stats["round"] == 0
    assert all(np.isfinite(v) for v in stats.values() if isinstance(v, float))


def test_pushsum_by_override_runs():
    path = os.path.join(CONFIGS, "dsgd_femnist_cnn.yaml")
    args = _shrunk(path, federated_optimizer="PushSum", client_num_in_total=4,
                   client_num_per_round=4)
    stats = fedml_tpu_torch.run_simulation(device="cpu", args=args)
    assert stats["consensus_dist"] >= 0 and np.isfinite(stats["train_loss"])


@pytest.mark.parametrize("dataset", ["pascal_voc", "coco_seg", "cityscapes", "fets2021"])
def test_segmentation_datasets_run_through_deeplab(dataset):
    a = Arguments()
    for k, v in dict(SMALL, dataset=dataset, model="deeplab", seg_width=4,
                     synthetic_train_size=12, synthetic_test_size=4, batch_size=4,
                     client_num_in_total=2, client_num_per_round=2,
                     partition_method="homo").items():
        setattr(a, k, v)
    a._validate()
    stats = fedml_tpu_torch.run_simulation(device="cpu", args=a)
    assert 0.0 <= stats["test_acc"] <= 1.0 and np.isfinite(stats["train_loss"])


def test_entry_point_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = os.path.join(CONFIGS, "vfl_mnist_leaf.yaml")
    args = _shrunk(path, data_cache_dir=os.path.join(REPO, "fedml_data"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fedml_tpu_torch.run_simulation(args=args)
