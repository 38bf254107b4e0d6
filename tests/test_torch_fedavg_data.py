"""The port's data path against the JAX package's, on the same seeds.

Packing, bucketing, the LDA and homo partitions, the host synthetic
generator and the stand-ins' labels, masks and sample counts must be
bitwise the JAX package's: they are numpy in both. The device twin's
features are drawn from PyTorch's stream, so they are held to the shape,
dtype and class means of the JAX package's instead.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.core import partition as jax_partition
from fedml_tpu.data import load as jax_load
from fedml_tpu.data import packing as jax_packing
from fedml_tpu.data import synthetic as jax_synthetic
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.core import partition
from fedml_tpu_torch.core.types import Batches, flat_examples, rebatch
from fedml_tpu_torch.data import load, packing, synthetic
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# per-class mean of the device twin's features against the class means
# both packages share: sigma 1 noise averaged over >= MIN_PER_CLASS
# examples and 784 features; the max over 784 dims of a mean of n
# N(0, 1) draws stays under 5/sqrt(n)
MIN_PER_CLASS = 40
MEAN_ATOL = 5 / np.sqrt(MIN_PER_CLASS)


def _ragged(seed=0, sizes=(5, 37, 12, 64, 1, 30), feat=(3, 2)):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(n,) + feat).astype(np.float32) for n in sizes]
    ys = [rng.integers(0, 7, size=n).astype(np.int64) for n in sizes]
    return xs, ys


@pytest.mark.parametrize("num_batches", [None, 2])
def test_pack_clients_bitwise(num_batches):
    xs, ys = _ragged()
    want, want_n = jax_packing.pack_clients(xs, ys, 8, num_batches=num_batches)
    got, got_n = packing.pack_clients(xs, ys, 8, num_batches=num_batches, device="cpu")
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert got.y.dtype == torch.int64 and got.x.dtype == torch.float32


def test_pack_one_and_labels_bitwise():
    xs, ys = _ragged(1)
    want = jax_packing.pack_one(xs[1], ys[1], 8)
    got = packing.pack_one(xs[1], ys[1], 8, device="cpu")
    for a, b in ((got.x, want.x), (got.y, want.y), (got.mask, want.mask)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for nb in (None, 3):
        for g, w in zip(packing.pack_labels_np(ys, 8, nb), jax_packing.pack_labels_np(ys, 8, nb)):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    with pytest.raises(ValueError, match="too small"):
        packing.pack_one(xs[3], ys[3], 8, num_batches=2, device="cpu")


@pytest.mark.parametrize("waste_cap", [4.0, 1.5, float("inf")])
def test_bucket_num_batches_bitwise(waste_cap):
    sizes = [3, 900, 40, 41, 64, 65, 500, 17]
    assert packing.bucket_num_batches(sizes, 32, waste_cap) == (
        jax_packing.bucket_num_batches(sizes, 32, waste_cap)
    )


@pytest.mark.parametrize("alpha, clients", [(0.5, 8), (0.1, 20), (100.0, 5)])
def test_lda_partition_bitwise(alpha, clients):
    labels = np.random.RandomState(3).randint(0, 10, 1000)
    want = jax_partition.non_iid_partition_with_dirichlet_distribution(
        labels, clients, 10, alpha, seed=7
    )
    got = partition.non_iid_partition_with_dirichlet_distribution(
        labels, clients, 10, alpha, seed=7
    )
    assert sorted(got) == sorted(want)
    for i in want:
        np.testing.assert_array_equal(got[i], want[i])
        assert got[i].dtype == want[i].dtype


def test_homo_partition_bitwise():
    for n, c, seed in ((1000, 7, 0), (19200, 32, 1), (10, 4, 5)):
        want = jax_partition.homo_partition(n, c, seed)
        got = partition.homo_partition(n, c, seed)
        for i in want:
            np.testing.assert_array_equal(got[i], want[i])


def test_host_synthetic_classification_bitwise():
    for shape in ((28, 28, 1), (60,)):
        want = jax_synthetic.synthetic_classification(300, 10, shape, seed=4, sigma=0.7)
        got = synthetic.synthetic_classification(300, 10, shape, seed=4, sigma=0.7)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    np.testing.assert_array_equal(
        synthetic._class_means(62, 784, 1234), jax_synthetic._class_means(62, 784, 1234)
    )


def _standin_args(cls, dataset, method, **kw):
    a = cls()
    base = dict(dataset=dataset, synthetic_train_size=1600, synthetic_test_size=320,
                client_num_in_total=8, client_num_per_round=8, batch_size=32,
                partition_method=method, partition_alpha=0.5, random_seed=3)
    base.update(kw)
    for k, v in base.items():
        setattr(a, k, v)
    a._validate()
    return a


@pytest.mark.parametrize("dataset, method", [("mnist", "homo"), ("femnist", "hetero"),
                                             ("mnist", "hetero")])
def test_standin_labels_masks_counts_bitwise(dataset, method):
    want = jax_load(_standin_args(JaxArguments, dataset, method))
    got = load(_standin_args(Arguments, dataset, method), device="cpu")
    for split in ("packed_train", "packed_test"):
        g, w = getattr(got, split), getattr(want, split)
        np.testing.assert_array_equal(g.y.numpy(), np.asarray(w.y))
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
        # same layout (NHWC), shape and dtype; the noise is PyTorch's
        assert tuple(g.x.shape) == tuple(w.x.shape) and g.x.dtype == torch.float32
    np.testing.assert_array_equal(got.packed_num_samples, want.packed_num_samples)
    assert got.packed_num_samples.dtype == want.packed_num_samples.dtype
    for key in ("train_data_num", "test_data_num", "class_num", "client_num", "task",
                "train_data_local_num_dict"):
        assert getattr(got, key) == getattr(want, key), key
    np.testing.assert_array_equal(got.train_data_global.mask.numpy(),
                                  np.asarray(want.train_data_global.mask))
    np.testing.assert_array_equal(got.train_data_local_dict[2].y.numpy(),
                                  np.asarray(want.train_data_local_dict[2].y))
    assert len(got.to_list()) == 8


def test_device_twin_features_follow_the_class_means():
    got = load(_standin_args(Arguments, "femnist", "homo", synthetic_train_size=6200,
                             synthetic_sigma=1.0), device="cpu")
    means = synthetic._class_means(62, 784, 1234)
    x = got.packed_train.x.reshape(-1, 784).numpy()
    y = got.packed_train.y.reshape(-1).numpy()
    real = got.packed_train.mask.reshape(-1).numpy() > 0
    checked = 0
    for k in range(62):
        sel = real & (y == k)
        if sel.sum() < MIN_PER_CLASS:
            continue
        np.testing.assert_allclose(x[sel].mean(0), means[k], atol=MEAN_ATOL)
        checked += 1
    assert checked >= 40
    # the same seed draws the same features; another seed other noise
    again = synthetic.synthetic_classification_device(
        got.packed_train.y.numpy(), (28, 28, 1), 62, seed=3, device="cpu")
    assert torch.equal(again, got.packed_train.x)
    other = synthetic.synthetic_classification_device(
        got.packed_train.y.numpy(), (28, 28, 1), 62, seed=4, device="cpu")
    assert not torch.equal(other, got.packed_train.x)
    bf16 = load(_standin_args(Arguments, "mnist", "homo", dtype="bfloat16"), device="cpu")
    assert bf16.packed_train.x.dtype == torch.bfloat16


@pytest.mark.parametrize("knob, value, dataset", [
    ("download", True, "mnist"),
])
def test_download_without_a_local_copy_asks_for_the_archives(knob, value, dataset, tmp_path,
                                                             monkeypatch):
    """``download: true`` with no local copy fetches the dataset's
    archives (here a stand-in fetcher that finds none, as offline), then
    loads the stand-in as without the knob."""
    from fedml_tpu_torch.data import download

    calls = []
    monkeypatch.setattr(download, "download_dataset", lambda *a: calls.append(a) or False)
    a = _standin_args(Arguments, dataset, "homo", data_cache_dir=str(tmp_path))
    setattr(a, knob, value)
    got = load(a, device="cpu")
    assert calls == [(dataset, str(tmp_path))]
    setattr(a, knob, False)
    _same_federation(got, load(a, device="cpu"))


def _same_federation(got, want):
    """Every packed leaf, count and view of two datasets, bitwise."""
    for split in ("packed_train", "packed_test", "train_data_global", "test_data_global"):
        g, w = getattr(got, split), getattr(want, split)
        for leaf in ("x", "y", "mask"):
            gv, wv = getattr(g, leaf), np.asarray(getattr(w, leaf))
            assert tuple(gv.shape) == wv.shape, (split, leaf)
            np.testing.assert_array_equal(gv.float().numpy(), wv.astype(np.float32),
                                          err_msg=f"{split}.{leaf}")
    np.testing.assert_array_equal(got.packed_num_samples, want.packed_num_samples)
    for key in ("train_data_num", "test_data_num", "class_num", "client_num", "task",
                "train_data_local_num_dict"):
        assert getattr(got, key) == getattr(want, key), key


def test_fedprox_synthetic_is_bitwise_the_references():
    kw = dict(client_num_in_total=12, input_dim=20, output_dim=5, synthetic_alpha=0.5,
              synthetic_beta=1.5, batch_size=10)
    ja, pa = _standin_args(JaxArguments, "synthetic", "homo", **kw), _standin_args(
        Arguments, "synthetic", "homo", **kw)
    want, got = jax_load(ja), load(pa, device="cpu")
    _same_federation(got, want)
    xs, ys = synthetic.synthetic_fedprox(num_clients=7, alpha=1.0, beta=1.0, seed=4)
    jxs, jys = jax_synthetic.synthetic_fedprox(num_clients=7, alpha=1.0, beta=1.0, seed=4)
    for a, b in zip(xs + ys, jxs + jys):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_tag_prediction_standin_is_bitwise_the_references():
    kw = dict(synthetic_train_size=300, synthetic_test_size=60, synthetic_feature_dim=40,
              client_num_in_total=5, batch_size=16)
    for method in ("homo", "hetero"):
        ja, pa = _standin_args(JaxArguments, "stackoverflow_lr", method, **kw), _standin_args(
            Arguments, "stackoverflow_lr", method, **kw)
        want, got = jax_load(ja), load(pa, device="cpu")
        _same_federation(got, want)
        assert got.task == "tag_prediction" and got.packed_train.y.dtype == torch.float32
        assert pa.input_dim == ja.input_dim == 40
    x, y = synthetic.synthetic_multilabel(50, 30, (4, 5), seed=2)
    jx, jy = jax_synthetic.synthetic_multilabel(50, 30, (4, 5), seed=2)
    assert np.array_equal(x, jx) and np.array_equal(y, jy) and x.shape == (50, 4, 5)


def test_real_files_raise(tmp_path):
    (tmp_path / "cifar10" / "cifar-10-batches-py").mkdir(parents=True)
    (tmp_path / "cifar10" / "cifar-10-batches-py" / "data_batch_1").write_bytes(b"")
    a = _standin_args(Arguments, "cifar10", "homo", data_cache_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="partial CIFAR copy"):
        load(a, device="cpu")
    with pytest.raises(ValueError, match="unknown dataset"):
        load(_standin_args(Arguments, "nope", "homo"), device="cpu")


def test_npz_drop_in_is_bitwise_the_references(tmp_path):
    rng = np.random.RandomState(5)
    (tmp_path / "mnist").mkdir()
    for split, n in (("train", 90), ("test", 30)):
        np.savez(tmp_path / "mnist" / f"{split}.npz",
                 x=rng.rand(n, 28, 28, 1).astype(np.float32),
                 y=rng.randint(0, 12, n).astype(np.int64))  # ids past 9: the head widens
    for method in ("homo", "hetero"):
        kw = dict(data_cache_dir=str(tmp_path), client_num_in_total=4, batch_size=8)
        want = jax_load(_standin_args(JaxArguments, "mnist", method, **kw))
        got = load(_standin_args(Arguments, "mnist", method, **kw), device="cpu")
        _same_federation(got, want)
        assert got.class_num == 12


def test_flat_examples_and_rebatch_round_trip():
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    b = Batches(x=x, y=torch.zeros(2, 3, 4, dtype=torch.int64), mask=torch.ones(2, 3, 4))
    f = flat_examples(b)
    assert tuple(f.x.shape) == (2, 12, 5) and tuple(f.mask.shape) == (2, 12)
    back = rebatch(f, 3, 4)
    assert torch.equal(back.x, x) and (b.num_batches, b.batch_size) == (3, 4)
    assert b.num_samples().tolist() == [12.0, 12.0]
