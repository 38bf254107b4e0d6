"""Poisoned worlds: the port's attacks and loader wiring against the JAX package's.

``data/poison.py`` is host numpy drawn from ``RandomState`` in both
packages, so every comparison here is bitwise: the four attacks, the
trigger, the per-client seeds, the edge-case fallback and a real
edge-case archive, the loader's attacker draw and the packed poisoned
federation, and the loader's and the arguments' errors word for word.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest

from fedml_tpu import constants as jax_constants
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.data import load as jax_load
from fedml_tpu.data import loader as jax_loader
from fedml_tpu.data import poison as jax_poison
from fedml_tpu_torch import constants
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.data import load, loader, poison
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

KINDS = ("label_flip", "targeted_flip", "backdoor_pattern", "edge_case")


def _images(seed=0, n=60, shape=(28, 28, 1), classes=10):
    rng = np.random.RandomState(seed)
    return rng.rand(n, *shape).astype(np.float32), rng.randint(0, classes, n).astype(np.int64)


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_vocabularies_are_the_references():
    assert constants.POISON_TYPES == jax_constants.POISON_TYPES == poison.POISON_TYPES
    assert constants.DEFENSE_TYPES == jax_constants.DEFENSE_TYPES


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.01])
@pytest.mark.parametrize("kind", KINDS)
def test_each_attack_is_bitwise_the_references(kind, fraction):
    x, y = _images(3)
    kw = dict(target_label=2, source_label=1, fraction=fraction, trigger_size=3, seed=11)
    got = poison.poison_dataset(x, y, kind, 10, **kw)
    want = jax_poison.poison_dataset(x, y, kind, 10, **kw)
    for g, w in zip(got, want):
        _bitwise(g, w)
    # the inputs are never written to
    _bitwise(x, _images(3)[0])


def test_trigger_and_backdoor_success_rate_are_the_references():
    x, y = _images(5, n=40)
    for size, value in ((4, None), (2, 0.5)):
        _bitwise(poison.stamp_trigger(x, size, value), jax_poison.stamp_trigger(x, size, value))

    def predict(batch):  # sends a stamped corner to class 0, else its mean bucket
        return np.where(batch[:, -1, -1, 0] >= batch.max() - 1e-6, 0,
                        (batch.mean(axis=(1, 2, 3)) * 10).astype(int) % 10)

    for target in (0, 3):
        assert poison.backdoor_attack_success_rate(predict, x, y, target) == \
            jax_poison.backdoor_attack_success_rate(predict, x, y, target)
    assert poison.backdoor_attack_success_rate(predict, x, np.zeros(40, int), 0) == 0.0


def test_backdoor_needs_images_and_unknown_types_raise():
    with pytest.raises(ValueError, match=r"backdoor_pattern needs image data \[N, H, W, C\]"):
        poison.poison_dataset(np.zeros((4, 5), np.float32), np.zeros(4, int), "backdoor_pattern", 3)
    with pytest.raises(ValueError, match="not in"):
        poison.poison_dataset(np.zeros((4, 5), np.float32), np.zeros(4, int), "nope", 3)


@pytest.mark.parametrize("types", ["backdoor_pattern", ["label_flip", "edge_case", "targeted_flip"]])
def test_poison_clients_is_bitwise_the_references(types):
    data = [_images(s, n=20 + s) for s in range(6)]
    xs, ys = [d[0] for d in data], [d[1] for d in data]
    idxs = [4, 0, 2]
    got = poison.poison_clients(xs, ys, types, 10, idxs, target_label=1, fraction=0.5)
    want = jax_poison.poison_clients(xs, ys, types, 10, idxs, target_label=1, fraction=0.5)
    assert got[2] == want[2] == idxs
    for i in range(6):
        _bitwise(got[0][i], want[0][i])
        _bitwise(got[1][i], want[1][i])
    for i in (1, 3, 5):  # clean clients unchanged
        _bitwise(got[0][i], xs[i])
    with pytest.raises(ValueError, match="pair them 1:1"):
        poison.poison_clients(xs, ys, ["label_flip"], 10, idxs)


def test_a_real_edge_case_archive_is_injected_as_the_reference_does(tmp_path):
    rng = np.random.RandomState(0)
    root = tmp_path / "edge_case_examples"
    root.mkdir()
    with open(root / "southwest_images_new_train.pkl", "wb") as f:
        pickle.dump((rng.rand(7, 32, 32, 3) * 255).astype(np.uint8), f)
    x, y = _images(1, n=30, shape=(32, 32, 3))
    got_arr = poison.load_edge_case_arrays(str(tmp_path), "southwest")
    _bitwise(got_arr, jax_poison.load_edge_case_arrays(str(tmp_path), "southwest"))
    assert got_arr.max() <= 1.0
    kw = dict(target_label=4, fraction=0.3, seed=9, data_cache_dir=str(tmp_path))
    got = poison.poison_dataset(x, y, "edge_case", 10, **kw)
    want = jax_poison.poison_dataset(x, y, "edge_case", 10, **kw)
    _bitwise(got[0], want[0])
    _bitwise(got[1], want[1])
    # the rows injected are the archive's, not far-tail noise
    assert got[0].max() <= 1.0
    assert poison.load_edge_case_arrays(str(tmp_path / "absent"), "southwest") is None
    assert poison.load_edge_case_arrays(None, "southwest") is None


def _args(cls, **kw):
    a = cls()
    base = dict(dataset="femnist", synthetic_train_size=960, synthetic_test_size=200,
                client_num_in_total=8, client_num_per_round=4, batch_size=16,
                partition_method="hetero", partition_alpha=0.5, random_seed=3,
                poison_type="backdoor_pattern", poisoned_client_fraction=0.25,
                target_label=0, poison_sample_fraction=0.5, data_cache_dir=None)
    base.update(kw)
    for k, v in base.items():
        setattr(a, k, v)
    a._validate()
    return a


def _same_federation(got, want):
    for split in ("packed_train", "packed_test", "train_data_global", "test_data_global"):
        g, w = getattr(got, split), getattr(want, split)
        for leaf in ("x", "y", "mask"):
            gv, wv = getattr(g, leaf).numpy(), np.asarray(getattr(w, leaf))
            assert gv.shape == wv.shape, (split, leaf)
            _bitwise(gv.astype(np.float32), wv.astype(np.float32))
    np.testing.assert_array_equal(got.packed_num_samples, want.packed_num_samples)
    for key in ("train_data_num", "test_data_num", "class_num", "client_num",
                "train_data_local_num_dict"):
        assert getattr(got, key) == getattr(want, key), key


@pytest.mark.parametrize("kw", [
    dict(),
    dict(poison_type="edge_case", poison_sample_fraction=1.0, target_label=5),
    dict(poison_type=["label_flip", "backdoor_pattern"], poisoned_client_idxs=[6, 1],
         poisoned_client_fraction=0.0),
    dict(dataset="synthetic", poison_type="label_flip", input_dim=20, output_dim=5,
         model="lr"),
])
def test_the_poisoned_federation_is_bitwise_the_references(kw):
    got = load(_args(Arguments, **kw), device="cpu")
    want = jax_load(_args(JaxArguments, **kw))
    _same_federation(got, want)


def test_the_attacker_draw_is_the_references_and_attackers_differ():
    a, ja = _args(Arguments, client_num_in_total=64), _args(JaxArguments, client_num_in_total=64)
    for seed in (0, 3, 11):
        got = loader._resolve_poisoned_idxs(a, 64, seed)
        assert got == jax_loader._resolve_poisoned_idxs(ja, 64, seed)
        assert len(got) == 16 and got == sorted(got)
    args = _args(Arguments)
    xs, ys, _, _, class_num, task, _ = loader._partitioned_clients(args, 8, 3)
    dirty_x, dirty_y = loader._maybe_poison_clients(args, xs, ys, class_num, 3, task)
    attackers = loader._resolve_poisoned_idxs(args, 8, 3)
    assert len(attackers) == 2
    for i in range(8):
        same = np.array_equal(xs[i], dirty_x[i]) and np.array_equal(ys[i], dirty_y[i])
        assert same == (i not in attackers), i


@pytest.mark.parametrize("kw, match", [
    (dict(target_label=62), "target_label=62 out of range for 62 classes"),
    (dict(poisoned_client_fraction=0.0), "no attacker clients are configured"),
    (dict(poisoned_client_idxs=[1, 1]), "contains duplicates"),
    (dict(poisoned_client_idxs=[3, 9]), r"poisoned_client_idxs \[9\] out of range for 8"),
    (dict(dataset="shakespeare", poison_type="label_flip"), "classification datasets only"),
])
def test_the_loaders_errors_are_the_references(kw, match):
    with pytest.raises(ValueError, match=match) as want:
        jax_load(_args(JaxArguments, **kw))
    with pytest.raises(ValueError, match=match) as got:
        load(_args(Arguments, **kw), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(poison_type=["label_flip"], poisoned_client_idxs=None),
    dict(poison_type="nope"),
    dict(defense_type="krum"),
    dict(norm_bound=0), dict(norm_bound=None), dict(stddev=-1.0),
    dict(defense_anomaly_threshold=-0.5), dict(defense_quarantine_rounds=0),
    dict(defense_quarantine_rounds="x"), dict(poisoned_client_fraction=1.5),
    dict(poison_sample_fraction=0.0),
])
def test_the_knob_errors_are_the_references(kw):
    with pytest.raises(ValueError) as want:
        _args(JaxArguments, **kw)
    with pytest.raises(ValueError) as got:
        _args(Arguments, **kw)
    assert str(got.value) == str(want.value)


def test_the_robustness_defaults_are_the_references():
    a, ja = Arguments(), JaxArguments()
    for key in ("defense_type", "norm_bound", "stddev", "defense_anomaly_threshold",
                "defense_quarantine_rounds", "poison_type", "poisoned_client_idxs",
                "poisoned_client_fraction", "target_label", "poison_sample_fraction",
                "compression", "compression_topk_ratio", "sfedavg_alpha", "sfedavg_beta",
                "sampling_filter", "score_method", "sv_tol", "sv_max_perms", "valid_batches",
                "hs_L", "hs_momentum"):
        assert getattr(a, key) == getattr(ja, key), key
    assert (a.norm_bound, a.stddev, a.hs_momentum, a.sv_tol, a.valid_batches) == \
        (5.0, 0.158, 0.1, 0.005, 4)


def test_the_poisoned_config_reads_the_same_in_both_packages():
    import argparse
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "fedml_tpu_torch", "configs", "fedavg_femnist_cnn_poisoned.yaml")
    a = Arguments(argparse.Namespace(yaml_config_file=path))
    ja = JaxArguments(argparse.Namespace(yaml_config_file=path))
    for key in ("dataset", "model", "client_num_in_total", "client_num_per_round",
                "synthetic_train_size", "epochs", "batch_size", "learning_rate",
                "partition_alpha", "poison_type", "poisoned_client_fraction", "target_label",
                "poison_sample_fraction", "defense_type", "norm_bound", "dtype",
                "matmul_precision"):
        assert getattr(a, key) == getattr(ja, key), key
    assert (a.client_num_in_total, a.client_num_per_round, a.synthetic_train_size) == \
        (64, 32, 38400)
    assert a.synthetic_train_size // a.client_num_in_total == 600
