"""Dataset dispatcher (port of ``fedml_tpu/data/loader.py``, stand-in branch).

``load(args, device=...)`` returns a :class:`FederatedDataset`: the
reference's 8-tuple (``to_list()``) plus the packed federation on the
device (``packed_train`` / ``packed_test``, leaves ``[C, nb, bs, ...]``)
that the simulators consume.

Ported: the synthetic stand-ins, the path the JAX package takes when no
local copy exists.

- Classification: labels are drawn and partitioned on the host (numpy,
  bitwise the JAX package's), packed, and only they cross to the
  device, where the features are made
  (``synthetic_classification_device``). Images keep the JAX package's
  NHWC layout, ``x[C, nb, bs, 28, 28, 1]`` for MNIST.
- Next-token prediction (``shakespeare``, ``fed_shakespeare``,
  ``stackoverflow_nwp``): the JAX package's host path, token streams
  from ``synthetic_sequences`` (``args.seq_len`` sets their length),
  partitioned, packed with int32 tokens, and copied to the device
  whole; packed federation, masks and counts bitwise the JAX
  package's.

- The client registry (``client_registry_size > 0``,
  ``_registry_dataset``): the population is not materialized here; the
  dataset carries the task's geometry and fixed-size global evaluation
  holdouts only, and ``scale/`` makes each round's cohort on demand.

Every other source (real files on disk, VFL party CSVs, poisoned
worlds, ``synthetic`` FedProx data, tag-prediction and segmentation
tasks) raises ``NotImplementedError`` naming the slice that brings it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import constants
from ..core.partition import (
    homo_partition,
    non_iid_partition_with_dirichlet_distribution,
    record_data_stats,
)
from ..core.types import Batches
from ..device import DeviceLike, get_device
from .packing import bucket_num_batches, pack_clients, pack_labels_np, pack_one
from .synthetic import (
    synthetic_classification,
    synthetic_classification_device,
    synthetic_sequences,
)

_DATASET_META = {
    # name: (feature_shape, class_num, train_n, test_n, task)
    "mnist": ((28, 28, 1), 10, 60000, 10000, "classification"),
    "femnist": ((28, 28, 1), 62, 40000, 8000, "classification"),
    "fashion_mnist": ((28, 28, 1), 10, 60000, 10000, "classification"),
    "cifar10": ((32, 32, 3), 10, 50000, 10000, "classification"),
    "cifar100": ((32, 32, 3), 100, 50000, 10000, "classification"),
    "fed_cifar100": ((32, 32, 3), 100, 50000, 10000, "classification"),
    "cinic10": ((32, 32, 3), 10, 90000, 90000, "classification"),
    "shakespeare": ((80,), 90, 16000, 2000, "nwp"),
    "fed_shakespeare": ((80,), 90, 16000, 2000, "nwp"),
    "stackoverflow_nwp": ((20,), 10004, 40000, 8000, "nwp"),
    "stackoverflow_lr": ((10000,), 500, 40000, 8000, "tag_prediction"),
    "imagenet": ((64, 64, 3), 1000, 20000, 2000, "classification"),
    "gld23k": ((64, 64, 3), 203, 23080, 1000, "classification"),
    "gld160k": ((64, 64, 3), 2028, 164172, 1000, "classification"),
    "pascal_voc": ((64, 64, 3), 21, 4000, 800, "segmentation"),
    "coco_seg": ((64, 64, 3), 81, 4000, 800, "segmentation"),
    "cityscapes": ((64, 64, 3), 19, 3000, 500, "segmentation"),
    "fets2021": ((64, 64, 4), 4, 2000, 400, "segmentation"),
}

_DATA_SLICE = "the data-ingestion slice (ROADMAP.md, queue A item 5)"


@dataclasses.dataclass
class FederatedDataset:
    train_data_num: int
    test_data_num: int
    train_data_global: Batches
    test_data_global: Batches
    train_data_local_num_dict: Dict[int, int]
    train_data_local_dict: Dict[int, Batches]
    test_data_local_dict: Dict[int, Optional[Batches]]
    class_num: int
    # the packed federation on the device (client axis leading)
    packed_train: Batches = None
    packed_num_samples: np.ndarray = None
    packed_test: Optional[Batches] = None
    client_num: int = 0
    task: str = "classification"

    def to_list(self) -> List:
        """Reference 8-tuple."""
        return [
            self.train_data_num,
            self.test_data_num,
            self.train_data_global,
            self.test_data_global,
            self.train_data_local_num_dict,
            self.train_data_local_dict,
            self.test_data_local_dict,
            self.class_num,
        ]


def _standin_shape_and_sizes(args, name: str):
    """Stand-in geometry: the dataset's feature shape (resized-image
    datasets follow ``args.image_size``) and the synthetic train/test
    sizes with their default caps."""
    shape, class_num, train_n, test_n, task = _DATASET_META[name]
    if name in ("imagenet", "gld23k", "gld160k"):
        hw = int(getattr(args, "image_size", 64) or 64)
        shape = (hw, hw, 3)
    if task == "nwp" and getattr(args, "seq_len", None):
        shape = (int(args.seq_len),)
    train_n = int(getattr(args, "synthetic_train_size", min(train_n, 20000)))
    test_n = int(getattr(args, "synthetic_test_size", min(test_n, 4000)))
    return shape, class_num, train_n, test_n, task


def _client_view(stacked: Batches, i: int) -> Batches:
    return Batches(x=stacked.x[i], y=stacked.y[i], mask=stacked.mask[i])


def _device_synth_classification(
    args, name: str, client_num: int, batch_size: int, seed: int,
    device: torch.device,
) -> FederatedDataset:
    """Labels partitioned and packed on the host, features made on the
    device. The labels, masks and sample counts are bitwise the JAX
    package's for the same args."""
    shape, class_num, train_n, test_n, task = _standin_shape_and_sizes(args, name)
    logging.warning(
        "dataset %s: no local copy under data_cache_dir; using synthetic "
        "stand-in with identical shapes/classes (features generated "
        "on-device)", name,
    )
    rng = np.random.RandomState(seed)
    y_tr = rng.randint(0, class_num, train_n).astype(np.int64)
    y_te = np.random.RandomState(seed + 1).randint(0, class_num, test_n).astype(
        np.int64
    )

    idx_map = _partition(args, y_tr, client_num, class_num, seed)
    ys_tr = [y_tr[idx_map[i]] for i in range(client_num)]
    te_map = homo_partition(test_n, client_num, seed + 1)
    ys_te = [y_te[te_map[i]] for i in range(client_num)]

    waste_cap = float(getattr(args, "packing_waste_cap", 4.0) or 4.0)
    x_dtype = (
        torch.bfloat16
        if str(getattr(args, "dtype", "float32") or "float32") == "bfloat16"
        else torch.float32
    )
    sigma = float(getattr(args, "synthetic_sigma", 1.0) or 1.0)

    def build(ys, gen_seed):
        nb = bucket_num_batches([len(y) for y in ys], batch_size, waste_cap=waste_cap)
        y_p, mask, num_samples = pack_labels_np(ys, batch_size, num_batches=nb)
        x = synthetic_classification_device(
            y_p, shape, class_num, seed=gen_seed, sigma=sigma, dtype=x_dtype,
            device=device,
        )
        packed = Batches(
            x=x,
            y=torch.as_tensor(y_p, dtype=torch.int64, device=device),
            mask=torch.as_tensor(mask, device=device),
        )
        return packed, num_samples

    packed_train, num_samples = build(ys_tr, seed)
    packed_test, test_num_samples = build(ys_te, seed + 1)

    def flat(p: Batches) -> Batches:
        # the global view is the packed federation flattened on the
        # device: exactly the packed samples, padding masked out
        C, nb = p.mask.shape[0], p.mask.shape[1]
        return Batches(
            x=p.x.reshape((C * nb,) + tuple(p.x.shape[2:])),
            y=p.y.reshape((C * nb,) + tuple(p.y.shape[2:])),
            mask=p.mask.reshape(C * nb, -1),
        )

    # counts follow the packed federation (after truncation), so every
    # view of this dataset agrees with its metadata
    sizes = [int(n) for n in num_samples]
    return FederatedDataset(
        train_data_num=int(sum(sizes)),
        test_data_num=int(test_num_samples.sum()),
        train_data_global=flat(packed_train),
        test_data_global=flat(packed_test),
        train_data_local_num_dict={i: int(s) for i, s in enumerate(sizes)},
        train_data_local_dict={
            i: _client_view(packed_train, i) for i in range(client_num)
        },
        test_data_local_dict={
            i: _client_view(packed_test, i) for i in range(client_num)
        },
        class_num=class_num,
        packed_train=packed_train,
        packed_num_samples=np.asarray(num_samples),
        packed_test=packed_test,
        client_num=client_num,
        task=task,
    )


def _partition(args, labels: np.ndarray, client_num: int, class_num: int, seed: int):
    """The training split's client index map: ``homo``, else the LDA
    partition on ``labels`` (the JAX package's, bitwise)."""
    method = getattr(args, "partition_method", constants.PARTITION_HETERO)
    if method == constants.PARTITION_HOMO:
        return homo_partition(len(labels), client_num, seed)
    idx_map = non_iid_partition_with_dirichlet_distribution(
        labels, client_num, class_num,
        float(getattr(args, "partition_alpha", 0.5)), seed=seed,
    )
    record_data_stats(labels, idx_map)
    return idx_map


def _host_synth_sequences(
    args, name: str, client_num: int, batch_size: int, seed: int,
    device: torch.device,
) -> FederatedDataset:
    """The next-token stand-ins on the JAX package's host path
    (``_raw_data``'s ``nwp`` branch and ``load``'s partition and
    packing): token streams partitioned, packed with int32 tokens and
    int64 next-token labels, then copied to the device. Under ``hetero``
    the LDA partition receives the [N, T] label matrix as the reference
    hands it, so a sequence's index repeats once per token of each class
    (ROADMAP.md §C records that fault of the reference; ``homo`` does not
    meet it)."""
    shape, class_num, train_n, test_n, task = _standin_shape_and_sizes(args, name)
    logging.warning(
        "dataset %s: no local copy under data_cache_dir; using synthetic "
        "stand-in with identical shapes/classes", name,
    )
    seq_len = shape[0]
    x_tr, y_tr = synthetic_sequences(train_n, seq_len, class_num, seed)
    x_te, y_te = synthetic_sequences(test_n, seq_len, class_num, seed + 1)
    idx_map = _partition(args, y_tr, client_num, class_num, seed)
    xs_tr = [x_tr[idx_map[i]] for i in range(client_num)]
    ys_tr = [y_tr[idx_map[i]] for i in range(client_num)]
    te_map = homo_partition(len(y_te), client_num, seed + 1)
    xs_te = [x_te[te_map[i]] for i in range(client_num)]
    ys_te = [y_te[te_map[i]] for i in range(client_num)]

    waste_cap = float(getattr(args, "packing_waste_cap", 4.0) or 4.0)
    sizes = [len(x) for x in xs_tr]
    tokens = dict(x_dtype=torch.int32, device=device)
    packed_train, num_samples = pack_clients(
        xs_tr, ys_tr, batch_size,
        num_batches=bucket_num_batches(sizes, batch_size, waste_cap=waste_cap), **tokens,
    )
    packed_test, _ = pack_clients(
        xs_te, ys_te, batch_size,
        num_batches=bucket_num_batches([len(x) for x in xs_te], batch_size,
                                       waste_cap=waste_cap), **tokens,
    )
    y_te_all = np.concatenate(ys_te)
    return FederatedDataset(
        train_data_num=int(sum(sizes)),
        test_data_num=int(len(y_te_all)),
        train_data_global=pack_one(np.concatenate(xs_tr), np.concatenate(ys_tr),
                                   batch_size, **tokens),
        test_data_global=pack_one(np.concatenate(xs_te), y_te_all, batch_size, **tokens),
        train_data_local_num_dict={i: int(s) for i, s in enumerate(sizes)},
        train_data_local_dict={
            i: _client_view(packed_train, i) for i in range(client_num)
        },
        test_data_local_dict={
            i: _client_view(packed_test, i) for i in range(client_num)
        },
        class_num=class_num,
        packed_train=packed_train,
        packed_num_samples=num_samples.cpu().numpy(),
        packed_test=packed_test,
        client_num=client_num,
        task=task,
    )


def _registry_dataset(args, device: torch.device) -> FederatedDataset:
    """Slim dataset for the registry path (``scale/``): no per-client
    arrays, no packed federation, no local dicts proportional to
    ``client_registry_size``. It carries the task's geometry (class
    count; feature shape through the evaluation packs) and fixed-size
    global holdouts on ``device``, bitwise the JAX package's."""
    name = str(getattr(args, "dataset", "synthetic")).lower()
    seed = int(getattr(args, "random_seed", 0))
    registry_size = int(args.client_registry_size)
    if getattr(args, "poison_type", None):
        raise ValueError(
            "poison_type is not supported with client_registry_size: "
            "registry cohorts synthesize data on demand and the "
            "attacks mutate eagerly-materialized shards"
        )
    if name.startswith("synthetic"):
        shape = (int(getattr(args, "input_dim", 60)),)
        class_num = int(getattr(args, "output_dim", 10))
    else:
        if name not in _DATASET_META:
            raise ValueError(f"unknown dataset {name!r}")
        shape, class_num, _, _, task = _standin_shape_and_sizes(args, name)
        if task != "classification":
            raise ValueError(
                f"client_registry_size supports classification datasets "
                f"only (dataset {name!r} is task={task!r})"
            )
    # fixed-size eval holdouts (a registry run's eval cost must not
    # scale with the population); synthetic_*_size caps still win down
    train_n = min(int(getattr(args, "synthetic_train_size", 4096)), 4096)
    test_n = min(int(getattr(args, "synthetic_test_size", 2048)), 2048)
    sigma = float(getattr(args, "synthetic_sigma", 1.0) or 1.0)
    x_tr, y_tr = synthetic_classification(train_n, class_num, shape, seed=seed + 3, sigma=sigma)
    x_te, y_te = synthetic_classification(test_n, class_num, shape, seed=seed + 4, sigma=sigma)
    x_dtype = (
        torch.bfloat16
        if str(getattr(args, "dtype", "float32") or "float32") == "bfloat16"
        else torch.float32
    )
    batch_size = int(args.batch_size)
    logging.warning(
        "dataset %s: client_registry_size=%d active — population lives "
        "as columnar registry state, per-round cohorts are materialized "
        "on demand; this dataset object carries eval holdouts only",
        name, registry_size,
    )
    return FederatedDataset(
        train_data_num=train_n,
        test_data_num=test_n,
        train_data_global=pack_one(x_tr, y_tr, batch_size, x_dtype=x_dtype, device=device),
        test_data_global=pack_one(x_te, y_te, batch_size, x_dtype=x_dtype, device=device),
        train_data_local_num_dict={},
        train_data_local_dict={},
        test_data_local_dict={},
        class_num=class_num,
        packed_train=None,
        packed_num_samples=None,
        packed_test=None,
        client_num=registry_size,
        task="classification",
    )


def _has_local_copy(args, name: str) -> bool:
    cache = getattr(args, "data_cache_dir", None)
    d = os.path.join(cache, name) if cache else None
    return bool(d) and os.path.isdir(d) and bool(os.listdir(d))


def load(args, device: DeviceLike = "cuda") -> FederatedDataset:
    """Load + partition + pack the dataset ``args.dataset`` names, its
    packed federation on ``device``."""
    dev = get_device(device)
    name = str(getattr(args, "dataset", "synthetic")).lower()
    if int(getattr(args, "client_registry_size", 0) or 0) > 0:
        # the planet-scale registry (scale/): NEVER build per-client
        # state proportional to the registered population
        return _registry_dataset(args, dev)
    if name.startswith("synthetic"):
        raise NotImplementedError(
            f"dataset {name!r}: the FedProx synthetic generator arrives with "
            f"{_DATA_SLICE}; ported: the classification and next-token stand-ins "
            f"{sorted(n for n, m in _DATASET_META.items() if m[4] in ('classification', 'nwp'))}"
        )
    if name not in _DATASET_META:
        raise ValueError(f"unknown dataset {name!r}")
    task = _DATASET_META[name][4]
    if task not in ("classification", "nwp"):
        raise NotImplementedError(
            f"dataset {name!r} (task {task!r}): only the classification and "
            "next-token stand-ins are ported; tag and segmentation data "
            "arrive with the slices that train those models (ROADMAP.md, queue A)"
        )
    if _has_local_copy(args, name):
        raise NotImplementedError(
            f"dataset {name!r}: a local copy under data_cache_dir="
            f"{args.data_cache_dir!r} would be used by the JAX package; "
            f"reading real files arrives with {_DATA_SLICE}"
        )
    if getattr(args, "poison_type", None):
        raise NotImplementedError(
            "poison_type: poisoned worlds arrive with the robustness planes "
            "(ROADMAP.md, queue A item 5)"
        )
    build = _host_synth_sequences if task == "nwp" else _device_synth_classification
    return build(
        args, name, int(args.client_num_in_total), int(args.batch_size),
        int(getattr(args, "random_seed", 0)), dev,
    )
