"""The real-data path: the download seam and the repo's LEAF files, port against reference.

The ``file://`` seam cases of ``tests/test_real_data.py`` run through
both packages' ``data/download.py`` on the same archives written to
``tmp_path``: what each extracts must be the same files, byte for byte.
The port keeps the JAX package's table of archives; with ``download``,
its loader fetches a dataset it has no local copy of from there.
No test fetches from a network: a URL is a ``file://`` path, a port on
``127.0.0.1`` that refuses the connection (the offline grace), or an
``http.server`` on ``127.0.0.1`` serving what the test wrote, the table
pointed at it by monkeypatch. Then
the repo's real files, ``fedml_data/mnist`` (100 LEAF users, sklearn's
digits), and the digits written by ``materialize_real_digits`` load as
the same packed federation in both packages, bitwise.
"""

from __future__ import annotations

import contextlib
import filecmp
import http.server
import json
import logging
import os
import tarfile
import threading
import zipfile

import numpy as np
import pytest

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.data import download as jax_download
from fedml_tpu.data import load as jax_load
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.data import download, load
from fedml_tpu_torch.data.leaf import leaf_available
from test_torch_fedavg_data import _same_federation
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEDML_DATA = os.path.join(REPO, "fedml_data")
REFUSED = "http://127.0.0.1:9/missing.tar.bz2"  # nothing listens: refused at once


def _args(cls, **kw):
    a = cls()
    base = dict(dataset="mnist", model="lr", client_num_in_total=2, client_num_per_round=2,
                batch_size=8, synthetic_train_size=64, synthetic_test_size=32)
    base.update(kw)
    for k, v in base.items():
        setattr(a, k, v)
    a._validate()
    return a


def _same_tree(a: str, b: str) -> None:
    """Two directories hold the same names, links and file bytes."""
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only and not cmp.funny_files, (a, b)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files, shallow=False)
    assert not mismatch and not errors
    for sub in cmp.common_dirs:
        _same_tree(os.path.join(a, sub), os.path.join(b, sub))


def _mnist_zip(tmp_path) -> str:
    rng = np.random.RandomState(0)
    zip_path = tmp_path / "archive.zip"
    with zipfile.ZipFile(zip_path, "w") as zf:
        for split, n in (("train", 20), ("test", 8)):
            blob = {"users": ["u0", "u1"], "num_samples": [n, n], "user_data": {}}
            for u in ("u0", "u1"):
                blob["user_data"][u] = {"x": rng.rand(n, 784).round(3).tolist(),
                                        "y": rng.randint(0, 10, n).tolist()}
            zf.writestr(f"MNIST/{split}/all_data_0.json", json.dumps(blob))
    return str(zip_path)


def _tarball(tmp_path, name: str, files: dict, nest: str = "") -> str:
    src = tmp_path / f"src_{name}"
    for rel, data in files.items():
        path = src / nest / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
    tar_path = tmp_path / f"{name}.tar.bz2"
    with tarfile.open(tar_path, "w:bz2") as tf:
        for entry in sorted(os.listdir(src)):
            tf.add(str(src / entry), arcname=entry)
    return str(tar_path)


def test_offline_grace_returns_false(tmp_path):
    for module, sub in ((download, "port"), (jax_download, "jax")):
        assert module.download_dataset("mnist", str(tmp_path / sub),
                                       urls=("http://127.0.0.1:9/MNIST.zip",)) is False
    assert not os.path.exists(tmp_path / "port" / "mnist")


def test_file_url_download_extracts_what_the_reference_does(tmp_path):
    url = f"file://{_mnist_zip(tmp_path)}"
    for module, sub in ((download, "port"), (jax_download, "jax")):
        assert module.download_dataset("mnist", str(tmp_path / sub), urls=(url,)) is True
    assert leaf_available(str(tmp_path / "port" / "mnist"))
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    got = load(_args(Arguments, data_cache_dir=str(tmp_path / "port")), device="cpu")
    want = jax_load(_args(JaxArguments, data_cache_dir=str(tmp_path / "jax")))
    _same_federation(got, want)


def test_tff_tarball_download_hoists_nesting_as_the_reference_does(tmp_path):
    import h5py

    payload = {}
    rng = np.random.RandomState(0)
    for split, n in (("train", 6), ("test", 2)):
        path = tmp_path / f"fed_cifar100_{split}.h5"
        with h5py.File(str(path), "w") as f:
            g = f.create_group("examples")
            for c in range(2):
                cg = g.create_group(f"client_{c}")
                cg.create_dataset("image", data=rng.randint(0, 256, (n, 32, 32, 3), np.uint8))
                cg.create_dataset("label", data=rng.randint(0, 100, (n, 1), np.int64))
        payload[f"fed_cifar100_{split}.h5"] = path.read_bytes()
    url = f"file://{_tarball(tmp_path, 'fed_cifar100', payload, nest='nested')}"
    for module, sub in ((download, "port"), (jax_download, "jax")):
        (tmp_path / sub).mkdir()
        assert module.download_dataset("fed_cifar100", str(tmp_path / sub), urls=(url,)) is True
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    kw = dict(dataset="fed_cifar100", model="cnn", batch_size=4)
    got = load(_args(Arguments, data_cache_dir=str(tmp_path / "port"), **kw), device="cpu")
    want = jax_load(_args(JaxArguments, data_cache_dir=str(tmp_path / "jax"), **kw))
    _same_federation(got, want)
    assert got.client_num == 2 and got.class_num == 100


def test_partial_multi_archive_download_leaves_nothing(tmp_path):
    url = f"file://{_tarball(tmp_path, 'so', {'stackoverflow_train.h5': b'extractable'})}"
    for module, sub in ((download, "port"), (jax_download, "jax")):
        cache = tmp_path / sub
        assert module.download_dataset("fed_cifar100", str(cache), urls=(url, REFUSED)) is False
        assert not os.path.exists(cache / "fed_cifar100")
        assert not any(p.name.startswith(".staging") for p in cache.iterdir())
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_a_present_copy_is_kept_and_no_url_fetches_nothing(tmp_path):
    url = f"file://{_tarball(tmp_path, 'cifar', {'fed_cifar100_train.h5': b'payload'})}"
    for module, sub in ((download, "port"), (jax_download, "jax")):
        cache = tmp_path / sub
        assert module.download_dataset("fed_cifar100", str(cache), urls=()) is False
        assert not cache.exists() or not any(cache.iterdir())
        assert module.download_dataset("fed_cifar100", str(cache), urls=(url,)) is True
        # present: kept as it is, the refused URL never tried
        assert module.download_dataset("fed_cifar100", str(cache), urls=(REFUSED,)) is True
        assert (cache / "fed_cifar100" / "fed_cifar100_train.h5").read_bytes() == b"payload"
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_loader_attempts_download_only_when_asked(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(download, "download_dataset",
                        lambda *a, **k: calls.append(a) or False)
    args = _args(Arguments, data_cache_dir=str(tmp_path))
    load(args, device="cpu")  # download defaults to off: the stand-in, nothing fetched
    assert calls == []
    args.download = True
    # no local copy: the loader asks for the archives, then (offline here)
    # takes the stand-in
    assert load(args, device="cpu").source.startswith("synthetic")
    assert calls == [("mnist", str(tmp_path))]
    # with a local copy, download asks for nothing
    with zipfile.ZipFile(_mnist_zip(tmp_path)) as zf:
        zf.extractall(tmp_path / "unzipped")
    os.rename(tmp_path / "unzipped" / "MNIST", tmp_path / "mnist")
    assert load(args, device="cpu").source.startswith("LEAF json")
    assert calls == [("mnist", str(tmp_path))]


def test_archive_table_is_the_references():
    assert download.DATASET_ARCHIVES == jax_download.DATASET_ARCHIVES
    for name in ("mnist", "stackoverflow_lr", "shakespeare", "cifar10"):
        assert download.dataset_downloadable(name) == jax_download.dataset_downloadable(name)


@contextlib.contextmanager
def _local_server(root, fail_first: int = 0):
    """An ``http.server`` on 127.0.0.1 serving the files under ``root``;
    its first ``fail_first`` requests answer 503. Yields (base URL,
    list of the request paths it saw)."""
    seen = []

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **k):
            super().__init__(*a, directory=str(root), **k)

        def do_GET(self):
            seen.append(self.path)
            if len(seen) <= fail_first:
                self.send_error(503, "busy")
                return
            super().do_GET()

        def log_message(self, *a):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", seen
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_loader_fetches_a_missing_dataset_from_the_table(tmp_path, monkeypatch):
    """``download: true`` and no local copy: the loader fetches the
    table's archive (served from 127.0.0.1) and reads the extracted LEAF
    files; the JAX package's seam extracts the same bytes from it."""
    served = tmp_path / "served"
    served.mkdir()
    os.replace(_mnist_zip(tmp_path), served / "MNIST.zip")
    with _local_server(served) as (base, seen):
        monkeypatch.setitem(download.DATASET_ARCHIVES, "mnist", (f"{base}/MNIST.zip",))
        args = _args(Arguments, data_cache_dir=str(tmp_path / "port"), download=True)
        got = load(args, device="cpu")
        assert jax_download.download_dataset("mnist", str(tmp_path / "jax"),
                                             urls=(f"{base}/MNIST.zip",))
    assert seen == ["/MNIST.zip"] * 2
    assert got.source.startswith("LEAF json") and got.client_num == 2
    _same_tree(str(tmp_path / "port" / "mnist"), str(tmp_path / "jax" / "mnist"))


def test_transient_failure_is_retried(tmp_path, monkeypatch, caplog):
    """A 503 is transient: the fetch waits and asks again, and the second
    answer lands; a refused connection past the retries is the offline
    grace (False)."""
    monkeypatch.setattr(download, "_FETCH_RETRY_BASE_S", 0.01)
    served = tmp_path / "served"
    served.mkdir()
    _tarball(served, "fed_cifar100", {"fed_cifar100_train.h5": b"payload"})
    with _local_server(served, fail_first=1) as (base, seen), caplog.at_level(logging.WARNING):
        ok = download.download_dataset("fed_cifar100", str(tmp_path / "cache"),
                                       urls=(f"{base}/fed_cifar100.tar.bz2",))
    assert ok and seen == ["/fed_cifar100.tar.bz2"] * 2
    assert "retry 1/2" in caplog.text
    assert (tmp_path / "cache" / "fed_cifar100" / "fed_cifar100_train.h5").read_bytes() == (
        b"payload")
    assert download._transient_fetch_error(ConnectionRefusedError()) is True
    assert download.download_dataset("mnist", str(tmp_path / "off"), urls=(REFUSED,)) is False


def test_stackoverflow_tasks_share_one_extraction(tmp_path, monkeypatch):
    """Both Stack Overflow tasks read one ``stackoverflow`` directory,
    linked under each name, as the JAX package lays them out."""
    served = tmp_path / "served"
    served.mkdir()
    names = [u.rsplit("/", 1)[1] for u in download.DATASET_ARCHIVES["stackoverflow_lr"]]
    for i, name in enumerate(names):
        _tarball(served, name[:-len(".tar.bz2")], {f"part{i}.bin": bytes([i]) * 8})
    with _local_server(served) as (base, seen):
        urls = tuple(f"{base}/{n}" for n in names)
        for module, sub in ((download, "port"), (jax_download, "jax")):
            for task in ("stackoverflow_lr", "stackoverflow_nwp"):
                assert module.download_dataset(task, str(tmp_path / sub), urls=urls)
    assert len(seen) == 2 * len(names)  # the second task finds the shared copy
    for sub in ("port", "jax"):
        assert os.readlink(tmp_path / sub / "stackoverflow_lr") == "stackoverflow"
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


# -- the repo's real files --------------------------------------------------
@pytest.mark.parametrize("clients, method", [(100, "hetero"), (10, "homo"), (150, "hetero")])
def test_fedml_data_mnist_federation_is_bitwise_the_references(clients, method, caplog):
    """``fedml_data/mnist``: 100 LEAF users of sklearn's digits, as they
    are, folded onto 10 clients, and capped when 150 are asked for."""
    kw = dict(data_cache_dir=FEDML_DATA, client_num_in_total=clients,
              client_num_per_round=min(clients, 10), partition_method=method, batch_size=10)
    with caplog.at_level(logging.WARNING):
        got = load(fedml_tpu_torch.init(_args(Arguments, **kw)), device="cpu")
    assert "synthetic stand-in" not in caplog.text
    want = jax_load(fedml_tpu.init(_args(JaxArguments, **kw)))
    _same_federation(got, want)
    assert got.client_num == min(clients, 100) and got.train_data_num == 1395
    assert tuple(got.packed_train.x.shape[-3:]) == (28, 28, 1)


def test_materialized_digits_are_the_references_files(tmp_path):
    for module, sub in ((download, "port"), (jax_download, "jax")):
        root = module.materialize_real_digits(str(tmp_path / sub), n_users=12, seed=2)
        assert root == os.path.join(str(tmp_path / sub), "mnist")
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    blob = json.load(open(tmp_path / "port" / "mnist" / "_source.json"))
    assert blob == {"source": "sklearn_digits", "real_data": True, "is_mnist": False}


# -- the slice's configurations ---------------------------------------------
@pytest.mark.parametrize("name, shrink", [
    ("fedprox_synthetic_1_1", {}),
    ("fedavg_mnist_leaf_lr", {"data_cache_dir": FEDML_DATA}),
    # the tag stand-in at CPU size: its widths as the config sets them,
    # its example counts cut 20x
    ("fedavg_stackoverflow_lr", {"synthetic_train_size": 2000, "synthetic_test_size": 400,
                                 "client_num_in_total": 20}),
])
def test_slice_configs_load_the_same_federation_in_both_packages(name, shrink):
    import argparse

    from fedml_tpu_torch.arguments import load_yaml_arguments

    path = os.path.join(REPO, "fedml_tpu_torch", "configs", f"{name}.yaml")
    ja, pa = JaxArguments(argparse.Namespace(yaml_config_file=path)), load_yaml_arguments(path)
    for a in (ja, pa):
        for k, v in shrink.items():
            setattr(a, k, v)
        a._validate()
    got = load(fedml_tpu_torch.init(pa), device="cpu")
    want = jax_load(fedml_tpu.init(ja))
    _same_federation(got, want)
    if name == "fedavg_stackoverflow_lr":
        assert pa.input_dim == 10_000 and got.packed_train.x.shape[-1] == 10_000
        assert got.class_num == 500 and set(got.train_data_local_num_dict.values()) == {100}
    if name == "fedprox_synthetic_1_1":
        assert got.client_num == 30 and got.task == "classification"
