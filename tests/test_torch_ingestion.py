"""Real-file ingestion: the port's readers and loader against the JAX package's.

Every case of ``tests/test_data_ingestion.py`` that reads files
(LEAF json, TFF h5 for fed_cifar100 / fed_shakespeare / Stack Overflow,
CIFAR python batches, image folders, the Landmarks CSV, VFL party CSVs,
the Stack Overflow and Shakespeare preprocessing, the user fold) runs
here through both packages on the same files, written by that module's
own writers into ``tmp_path``. The readers are numpy in both packages,
so their arrays, and the packed federations the loaders build from
them, must be bitwise equal: features, labels, masks, sample counts,
the global views and the metadata.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
import test_data_ingestion as ref_tests
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.data import ingest as jax_ingest
from fedml_tpu.data import leaf as jax_leaf
from fedml_tpu.data import load as jax_load
from fedml_tpu_torch import models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.data import ingest, leaf, load
from fedml_tpu_torch.simulation import FedAvgAPI
from test_torch_fedavg_data import _same_federation
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _args(cls, **kw):
    """``tests/test_data_ingestion.py``'s ``_args``, for either package."""
    a = cls()
    base = dict(dataset="mnist", model="lr", client_num_in_total=4, client_num_per_round=4,
                comm_round=2, epochs=1, batch_size=8, learning_rate=0.1,
                frequency_of_the_test=1, shuffle=False)
    base.update(kw)
    for k, v in base.items():
        setattr(a, k, v)
    a._validate()
    return a


def _both(**kw):
    """The same config loaded by both packages: (port dataset, its args,
    JAX dataset, its args)."""
    ja = fedml_tpu.init(_args(JaxArguments, **kw))
    pa = fedml_tpu_torch.init(_args(Arguments, **kw))
    return load(pa, device="cpu"), pa, jax_load(ja), ja


def _same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, (list, tuple)):
            _same_arrays(g, w)
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


# -- LEAF json ------------------------------------------------------------
@pytest.mark.parametrize("clients", [4, 2, 9])
def test_leaf_fixture_federation_is_bitwise_the_references(clients, caplog):
    """The checked-in LEAF split (4 users, 46 samples): as it is, folded
    onto 2 clients, and capped when 9 are asked for."""
    with caplog.at_level(logging.WARNING):
        got, pa, want, ja = _both(data_cache_dir=FIXTURES, client_num_in_total=clients,
                                  client_num_per_round=clients)
    assert "synthetic stand-in" not in caplog.text
    _same_federation(got, want)
    assert got.client_num == min(clients, 4) and sum(got.train_data_local_num_dict.values()) == 46
    assert (pa.client_num_in_total, pa.client_num_per_round) == (
        ja.client_num_in_total, ja.client_num_per_round) == (min(clients, 4),) * 2


def test_leaf_readers_are_bitwise_the_references():
    root = os.path.join(FIXTURES, "mnist")
    users, data = leaf.read_leaf_dir(os.path.join(root, "train"))
    jusers, jdata = jax_leaf.read_leaf_dir(os.path.join(root, "train"))
    assert users == jusers and data == jdata
    for shape, cap in ((None, None), ((28, 28, 1), 3)):
        _same_arrays(leaf.load_leaf(root, shape, cap), jax_leaf.load_leaf(root, shape, cap))
    assert leaf.leaf_available(root) and not leaf.leaf_available(FIXTURES)


def test_leaf_fixture_trains_end_to_end():
    args = fedml_tpu_torch.init(_args(Arguments, data_cache_dir=FIXTURES))
    ds = load(args, device="cpu")
    api = FedAvgAPI(args, "cpu", ds, models.create(args, ds.class_num, device="cpu"))
    stats = api.train()
    assert np.isfinite(stats["train_loss"])


# -- TFF h5 ---------------------------------------------------------------
def test_tff_fed_cifar100_is_bitwise_the_references(tmp_path):
    ref_tests._write_tff_cifar100(str(tmp_path / "fed_cifar100"))
    d = str(tmp_path / "fed_cifar100")
    _same_arrays(ingest.load_tff_h5(d, "fed_cifar100"), jax_ingest.load_tff_h5(d, "fed_cifar100"))
    got, _, want, _ = _both(dataset="fed_cifar100", data_cache_dir=str(tmp_path),
                            client_num_in_total=3, client_num_per_round=3, model="cnn")
    _same_federation(got, want)
    assert got.client_num == 3 and got.class_num == 100


def test_tff_fed_shakespeare_is_bitwise_the_references(tmp_path):
    import h5py

    d = tmp_path / "fed_shakespeare"
    os.makedirs(d)
    lines = [b"To be, or not to be, that is the question:",
             b"Whether 'tis nobler in the mind to suffer",
             b"The slings and arrows of outrageous fortune,"]
    for split, k in (("train", 3), ("test", 1)):
        with h5py.File(os.path.join(d, f"shakespeare_{split}.h5"), "w") as f:
            g = f.create_group("examples")
            for c in range(2):
                g.create_group(f"bard_{c}").create_dataset("snippets", data=lines[:k])
    _same_arrays(ingest.load_tff_h5(str(d), "fed_shakespeare"),
                 jax_ingest.load_tff_h5(str(d), "fed_shakespeare"))
    got, _, want, _ = _both(dataset="fed_shakespeare", data_cache_dir=str(tmp_path),
                            client_num_in_total=2, client_num_per_round=2, model="rnn")
    _same_federation(got, want)
    assert got.task == "nwp" and got.packed_train.x.dtype == torch.int32
    assert got.packed_train.x.shape[-1] == 80


@pytest.mark.parametrize("dataset", ["stackoverflow_nwp", "stackoverflow_lr"])
def test_stackoverflow_h5_is_bitwise_the_references(tmp_path, dataset):
    ref_tests._write_stackoverflow(str(tmp_path / dataset))
    d = str(tmp_path / dataset)
    _same_arrays(ingest.load_tff_h5(d, dataset), jax_ingest.load_tff_h5(d, dataset))
    assert ingest.load_so_word_vocab(d) == jax_ingest.load_so_word_vocab(d)
    assert ingest.load_so_tag_vocab(d) == jax_ingest.load_so_tag_vocab(d)
    got, pa, want, ja = _both(dataset=dataset, data_cache_dir=str(tmp_path),
                              client_num_in_total=3, client_num_per_round=3,
                              model="rnn" if dataset.endswith("nwp") else "lr")
    _same_federation(got, want)
    if dataset == "stackoverflow_lr":
        # the bag of words over the fixture's 8 words, multi-hot over its 3 tags
        assert pa.input_dim == ja.input_dim == 8 and got.packed_train.y.shape[-1] == 3
        assert got.task == "tag_prediction"
    else:
        assert got.packed_train.x.shape[-1] == 20 and got.packed_train.x.dtype == torch.int32


@pytest.mark.parametrize("case", [
    ("nwp", ["how to sort quickly"], ["how", "to", "sort"]),
    ("nwp", ["w " * 50], ["w"]),
    ("nwp", [], ["w"]),
    ("features", ["a b unknown", "b b"], ["a", "b"]),
    ("targets", ["a|c|a", "b", "c"], ["a", "b"]),
    ("shakespeare", ["ab", "z" * 200, "é oov"], None),
    ("shakespeare", [], None),
])
def test_preprocessing_is_bitwise_the_references(case):
    kind, text, vocab = case
    fn = {"nwp": "so_nwp_to_sequences", "features": "so_lr_features",
          "targets": "so_lr_targets", "shakespeare": "shakespeare_to_sequences"}[kind]
    call = (lambda m: getattr(m, fn)(text)) if vocab is None else (
        lambda m: getattr(m, fn)(text, vocab))
    got, want = call(ingest), call(jax_ingest)
    _same_arrays(got if isinstance(got, tuple) else [got],
                 want if isinstance(want, tuple) else [want])
    if kind == "nwp" and text and len(text[0].split()) > 20:
        # a truncated sentence gets no EOS (eos id = len(vocab) + 2)
        assert 3 not in got[1][0] and (got[1][0] != 0).all()


# -- CIFAR batches, image folders, the Landmarks CSV ------------------------
def test_cifar_batches_are_bitwise_the_references(tmp_path):
    ref_tests._write_cifar10_batches(str(tmp_path / "cifar10"))
    d = str(tmp_path / "cifar10")
    _same_arrays(ingest.load_cifar_batches(d, "cifar10"),
                 jax_ingest.load_cifar_batches(d, "cifar10"))
    got, _, want, _ = _both(dataset="cifar10", data_cache_dir=str(tmp_path), model="cnn",
                            partition_method="homo")
    _same_federation(got, want)
    assert (got.train_data_num, got.test_data_num) == (80, 20)
    hetero, _, jhetero, _ = _both(dataset="cifar10", data_cache_dir=str(tmp_path), model="cnn",
                                  partition_method="hetero")
    _same_federation(hetero, jhetero)


def test_image_folder_is_bitwise_the_references(tmp_path):
    rng = np.random.RandomState(0)
    d = tmp_path / "imagenet"
    for split, n in (("train", 6), ("val", 2)):
        for cls in ("n01440764", "n01443537", "n01484850"):
            (d / split / cls).mkdir(parents=True, exist_ok=True)
            for i in range(n):
                ref_tests._write_png(str(d / split / cls / f"img_{i}.png"), rng)
    _same_arrays(ingest.load_image_folder(str(d), (32, 32)),
                 jax_ingest.load_image_folder(str(d), (32, 32)))
    got, _, want, _ = _both(dataset="imagenet", data_cache_dir=str(tmp_path), model="cnn",
                            client_num_in_total=3, client_num_per_round=3,
                            partition_method="homo", image_size=32)
    _same_federation(got, want)
    assert got.class_num == 3 and got.packed_train.x.shape[-3:] == (32, 32, 3)


def test_landmarks_csv_is_bitwise_the_references(tmp_path):
    import csv

    rng = np.random.RandomState(1)
    d = tmp_path / "gld23k"
    (d / "images").mkdir(parents=True)
    rows = []
    for u in range(3):
        for i in range(4 + u):
            img_id = f"u{u}_img{i}"
            ref_tests._write_png(str(d / "images" / f"{img_id}.jpg"), rng)
            rows.append({"user_id": str(u), "image_id": img_id, "class": str(rng.randint(0, 5))})
    for name, part in (("train.csv", rows), ("test.csv", rows[::4])):
        with open(d / name, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["user_id", "image_id", "class"])
            w.writeheader()
            w.writerows(part)
    _same_arrays(ingest.load_landmarks_csv(str(d), (32, 32)),
                 jax_ingest.load_landmarks_csv(str(d), (32, 32)))
    got, _, want, _ = _both(dataset="gld23k", data_cache_dir=str(tmp_path), model="cnn",
                            client_num_in_total=3, client_num_per_round=3, image_size=32)
    _same_federation(got, want)
    assert sorted(got.train_data_local_num_dict.values()) == [4, 5, 6]


# -- VFL party CSVs, the user fold ----------------------------------------
def test_vfl_party_csvs_are_bitwise_the_references(tmp_path):
    d = tmp_path / "nus_wide"
    y = ref_tests.TestVflPartyCsv._write_parties(None, d)
    feats, labels = ingest.load_vfl_party_csvs(str(d))
    _same_arrays([feats, labels], list(jax_ingest.load_vfl_party_csvs(str(d))))
    assert [f.shape[1] for f in feats] == [2, 3, 1] and np.array_equal(labels, y)
    _same_arrays(ingest.vfl_train_test_split(feats, labels, 3),
                 jax_ingest.vfl_train_test_split(feats, labels, 3))
    # the loader's horizontal view: the parties' columns side by side
    got, pa, want, ja = _both(dataset="nus_wide", data_cache_dir=str(tmp_path), batch_size=16)
    _same_federation(got, want)
    assert pa.input_dim == ja.input_dim == 6 and got.class_num == 2
    _same_arrays(list(got.vfl_parties), list(want.vfl_parties))


def test_party_csv_gap_rejected(tmp_path):
    import csv

    d = tmp_path / "gappy"
    d.mkdir()
    for k in (0, 1, 3):  # party_2 missing
        with open(d / f"party_{k}.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=(["label"] if k == 0 else []) + ["x0"])
            w.writeheader()
            w.writerow({"x0": "1.0", **({"label": "0"} if k == 0 else {})})
    for module in (ingest, jax_ingest):
        with pytest.raises(ValueError, match="contiguously"):
            module.load_vfl_party_csvs(str(d))


@pytest.mark.parametrize("n", [2, 5, 7])
def test_regroup_clients_is_bitwise_the_references(n):
    xs = [np.full((i + 1, 2), i, np.float32) for i in range(5)]
    ys = [np.full((i + 1,), i, np.int64) for i in range(5)]
    got, want = ingest.regroup_clients(xs, ys, n), jax_ingest.regroup_clients(xs, ys, n)
    _same_arrays(got, want)
    assert sum(len(a) for a in got[0]) == 15
