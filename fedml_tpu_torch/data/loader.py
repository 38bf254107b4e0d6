"""Dataset dispatcher (port of ``fedml_tpu/data/loader.py``).

``load(args, device=...)`` returns a :class:`FederatedDataset`: the
reference's 8-tuple (``to_list()``) plus the packed federation on the
device (``packed_train`` / ``packed_test``, leaves ``[C, nb, bs, ...]``)
that the simulators consume.

The resolution order is the JAX package's, under
``<data_cache_dir>/<dataset>/``:

1. naturally federated files: LEAF json split directories, TFF h5 and
   the Landmarks CSV (``data/leaf.py``, ``data/ingest.py``); the files'
   users are the partition, folded round-robin onto fewer clients or
   capping ``client_num_in_total`` when they hold fewer users; with
   ``download: true`` a missing copy raises, since the port names no
   archive host (``data/download.py`` fetches the archives a caller
   names);
2. global files: CIFAR python batches, image folders, a
   ``{train,test}.npz`` drop-in; the LDA or homo partition applies;
3. the synthetic stand-ins, with a warning.

``synthetic*`` datasets are FedProx's synthetic(alpha, beta) federation;
VFL party CSVs (``party_K.csv``) under a dataset's directory define it
whatever its name (its horizontal view; ``simulation/split_learning.py``
``VFLAPI`` trains on the per-party arrays it carries).

Real arrays are read and packed on the host (numpy, bitwise the JAX
package's) and moved to the device whole. Classification stand-ins draw
and partition their labels on the host and make the features on the
device (``synthetic_classification_device``). Images keep the JAX
package's NHWC layout, ``x[C, nb, bs, 28, 28, 1]`` for MNIST.

The client registry (``client_registry_size > 0``, ``_registry_dataset``)
materializes no population here: the dataset carries the task's geometry
and fixed-size global evaluation holdouts, and ``scale/`` makes each
round's cohort on demand.

Poisoned worlds (``poison_type``): the attacks of ``data/poison.py``
apply to the attacker clients' train shards after the partition and
before packing, as in the JAX package; the features are then made on
the host (the attacks mutate them), and the poisoned federation is
bitwise the JAX package's.

Segmentation datasets (pascal_voc, coco_seg, cityscapes, fets2021) are
the blob-mask stand-in unless real files exist, split by the
partitioner's multi-label LDA (every image listed under each class it
holds, deduplicated per client), bitwise the JAX package's.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional, Tuple

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
    synthetic_fedprox,
    synthetic_multilabel,
    synthetic_segmentation,
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
    # vertically partitioned source (party CSVs): ([feats_k [N, d_k]...],
    # labels [N]); horizontal consumers see the concatenation
    vfl_parties: Optional[Tuple[List[np.ndarray], np.ndarray]] = None
    # what the data was read or made from (the port's own field): the
    # reader and its directory, or the generator
    source: str = ""

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


def _try_load_real(name: str, cache_dir: str, args=None, probe: bool = False):
    """Global real data: CIFAR python batches, ImageNet-style image
    folders, else the generic ``{train,test}.npz`` drop-in, with the
    files' description; ``probe`` answers whether one is on disk through
    the same branches."""
    d = os.path.join(cache_dir or "", name)
    if name in ("cifar10", "cifar100"):
        from .ingest import cifar_batches_available, load_cifar_batches

        if cifar_batches_available(d, name):
            return True if probe else (load_cifar_batches(d, name), f"CIFAR batches under {d}")
    from .ingest import image_folder_available, load_image_folder

    if image_folder_available(d):
        if probe:
            return True
        hw = int(getattr(args, "image_size", 64) or 64) if args else 64
        # 5-tuple: the folder structure is authoritative for the class
        # count (truncated ImageNet copies carry fewer classes)
        return load_image_folder(d, (hw, hw)), f"image folders under {d}"
    tr, te = os.path.join(d, "train.npz"), os.path.join(d, "test.npz")
    if os.path.exists(tr) and os.path.exists(te):
        if probe:
            return True
        a, b = np.load(tr), np.load(te)
        return (a["x"], a["y"], b["x"], b["y"]), f"npz files under {d}"
    return False if probe else None


def _try_load_federated(name: str, cache_dir: str, args=None):
    """Naturally federated files: LEAF json dirs, TFF h5, the Landmarks
    CSV. Returns per-client ``(xs_tr, ys_tr, xs_te, ys_te)`` and the
    files' description, or None. With ``args.download`` a dataset with
    no local copy is first fetched from its archives
    (``data/download.py``)."""
    if name not in _DATASET_META:
        return None
    d = os.path.join(cache_dir or "", name)
    shape, _class_num, _, _, task = _DATASET_META[name]
    from . import ingest
    from .leaf import leaf_available, load_leaf

    if cache_dir and bool(getattr(args, "download", False)):
        from .download import dataset_downloadable, download_dataset

        # a LEAF json dir counts as a local copy only for tasks that
        # read it (the nwp path ignores LEAF json, below), so it must not
        # suppress the h5 download
        has_local = ingest.tff_h5_available(d, name) or (
            task != "nwp" and leaf_available(d)
        )
        if dataset_downloadable(name) and not has_local:
            # the reference's auto-fetch of the dataset's archives
            # (data/<ds>/download*.sh; MNIST data_loader.py:17-29), with
            # offline grace
            download_dataset(name, cache_dir)

    out, source = None, ""
    if leaf_available(d):
        if task == "nwp":
            # LEAF shakespeare stores raw strings with single-char
            # targets, another task shape than the per-token TFF
            # pipeline: nwp datasets read the TFF h5 artifact
            logging.warning(
                "dataset %s: LEAF json found but nwp ingestion uses the "
                "TFF h5 artifact; ignoring the json dir", name,
            )
        else:
            out, source = load_leaf(d, feature_shape=shape), f"LEAF json under {d}"
    if out is None and ingest.tff_h5_available(d, name):
        out, source = ingest.load_tff_h5(d, name), f"TFF h5 under {d}"
    if out is None and ingest.landmarks_csv_available(d):
        hw = int(getattr(args, "image_size", 64) or 64)
        out, source = ingest.load_landmarks_csv(d, (hw, hw)), f"Landmarks CSV under {d}"
    if out is None:
        return None
    logging.info("dataset %s: %d users read from %s", name, len(out[0]), source)
    xs_tr, ys_tr, xs_te, ys_te = out
    if task == "classification" and xs_tr and xs_tr[0].ndim == len(shape):
        # h5 images stored [N, H, W] (fed_emnist 'pixels') -> add a channel
        xs_tr = [x.reshape(x.shape + (1,)) for x in xs_tr]
        xs_te = [x.reshape(x.shape + (1,)) for x in xs_te]
    return (xs_tr, ys_tr, xs_te, ys_te), source


def _widen_class_num(name: str, class_num: int, observed: int) -> int:
    """Files may carry class ids beyond the canonical count: widen the
    head rather than train on degenerate one-hots."""
    if observed > class_num:
        logging.warning(
            "dataset %s: observed class id %d >= canonical class count "
            "%d; widening to %d", name, observed - 1, class_num, observed,
        )
        return observed
    return class_num


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
) -> Optional[FederatedDataset]:
    """Labels partitioned and packed on the host, features made on the
    device; None where the path does not apply (another task, or real
    files on disk). The labels, masks and sample counts are bitwise the
    JAX package's for the same args."""
    shape, class_num, train_n, test_n, task = _standin_shape_and_sizes(args, name)
    if task != "classification":
        return None
    if _try_load_real(name, getattr(args, "data_cache_dir", None), args, probe=True):
        return None
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
        source="synthetic stand-in (features made on the device)",
    )


def _resolve_poisoned_idxs(args, client_num: int, seed: int) -> List[int]:
    """Which client indexes are attackers: an explicit
    ``poisoned_client_idxs`` list (in the user's order, which a
    ``poison_type`` list pairs with) wins; else
    ``poisoned_client_fraction`` of the federation, drawn with
    ``RandomState(seed + 77)`` and sorted."""
    idxs = getattr(args, "poisoned_client_idxs", None)
    if idxs:
        out = [int(i) for i in idxs]
        if len(set(out)) != len(out):
            raise ValueError(f"poisoned_client_idxs {out} contains duplicates")
        bad = [i for i in out if not 0 <= i < client_num]
        if bad:
            raise ValueError(
                f"poisoned_client_idxs {bad} out of range for {client_num} clients"
            )
        return out
    frac = float(getattr(args, "poisoned_client_fraction", 0.0) or 0.0)
    if frac <= 0:
        return []
    k = min(client_num, max(1, int(round(frac * client_num))))
    return sorted(np.random.RandomState(seed + 77).choice(client_num, k, replace=False).tolist())


def _maybe_poison_clients(args, xs_tr, ys_tr, class_num: int, seed: int, task: str):
    """The poisoned world ``args.poison_type`` names: the attacks of
    ``data/poison.py`` on the attacker clients' train shards (one type
    for every attacker, or a list paired with ``poisoned_client_idxs``).
    Logs who is poisoned with what."""
    ptype = getattr(args, "poison_type", None) or None
    if ptype is None:
        return xs_tr, ys_tr
    if task != "classification":
        raise ValueError(
            f"poison_type={ptype!r} supports classification datasets "
            f"only (got task={task!r})"
        )
    target = int(getattr(args, "target_label", 0) or 0)
    if not 0 <= target < class_num:
        # an out-of-head target would one-hot to an all-zero row
        raise ValueError(f"target_label={target} out of range for {class_num} classes")
    from .poison import poison_clients

    if isinstance(ptype, (list, tuple)) and not getattr(args, "poisoned_client_idxs", None):
        raise ValueError(
            "poison_type as a list pairs 1:1 with poisoned_client_idxs; "
            "set the idxs explicitly (poisoned_client_fraction draws an "
            "arbitrary attacker set)"
        )
    idxs = _resolve_poisoned_idxs(args, len(xs_tr), seed)
    if not idxs:
        raise ValueError(
            "poison_type is set but no attacker clients are configured; "
            "set poisoned_client_idxs or poisoned_client_fraction"
        )
    xs_tr, ys_tr, _ = poison_clients(
        xs_tr, ys_tr, ptype, class_num, idxs,
        target_label=target,
        fraction=float(getattr(args, "poison_sample_fraction", 1.0) or 1.0),
        data_cache_dir=getattr(args, "data_cache_dir", None),
    )
    logging.warning("POISONED WORLD: clients %s carry %s (target_label=%s)", idxs, ptype, target)
    return xs_tr, ys_tr


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


def _segmentation_partition(args, y_tr: np.ndarray, client_num: int, class_num: int,
                            seed: int):
    """A segmentation training split's client index map: ``homo``, else
    the partitioner's multi-label LDA over, per class, the images that
    hold it (void labels >= ``class_num`` excluded), each client's
    indexes deduplicated (an image holds several classes)."""
    if getattr(args, "partition_method", constants.PARTITION_HETERO) == constants.PARTITION_HOMO:
        return homo_partition(len(y_tr), client_num, seed)
    flat = y_tr.reshape(len(y_tr), -1)
    per_class = [np.where([(row == k).any() for row in flat])[0] for k in range(class_num)]
    idx_map = non_iid_partition_with_dirichlet_distribution(
        per_class, client_num, class_num, float(getattr(args, "partition_alpha", 0.5)),
        task="segmentation", seed=seed,
    )
    return {i: np.unique(v) for i, v in idx_map.items()}


def _raw_data(args):
    """Global arrays ``(x_tr, y_tr, x_te, y_te, class_num, task, source)``:
    real files (``_try_load_real``), else the host stand-ins of the JAX
    package (next-token streams, multi-hot tags, classification blobs),
    bitwise its arrays."""
    name = str(getattr(args, "dataset", "synthetic")).lower()
    seed = int(getattr(args, "random_seed", 0))
    shape, class_num, train_n, test_n, task = _standin_shape_and_sizes(args, name)
    real = _try_load_real(name, getattr(args, "data_cache_dir", None), args)
    if real is not None:
        real, source = real
        if len(real) == 5:  # the loader knows its own class count
            x_tr, y_tr, x_te, y_te, class_num = real
        else:
            x_tr, y_tr, x_te, y_te = real
        return x_tr, y_tr, x_te, y_te, class_num, task, source
    logging.warning(
        "dataset %s: no local copy under data_cache_dir; using synthetic "
        "stand-in with identical shapes/classes", name,
    )
    if task == "nwp":
        x_tr, y_tr = synthetic_sequences(train_n, shape[0], class_num, seed)
        x_te, y_te = synthetic_sequences(test_n, shape[0], class_num, seed + 1)
    elif task == "tag_prediction":
        dim = int(getattr(args, "synthetic_feature_dim", 2000))
        x_tr, y_tr = synthetic_multilabel(train_n, class_num, (dim,), seed)
        x_te, y_te = synthetic_multilabel(test_n, class_num, (dim,), seed + 1)
    elif task == "segmentation":
        x_tr, y_tr = synthetic_segmentation(train_n, class_num, shape, seed)
        x_te, y_te = synthetic_segmentation(test_n, class_num, shape, seed + 1)
    else:
        x_tr, y_tr = synthetic_classification(train_n, class_num, shape, seed)
        x_te, y_te = synthetic_classification(test_n, class_num, shape, seed + 1)
    return x_tr, y_tr, x_te, y_te, class_num, task, "synthetic stand-in"


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
        source="client registry (cohorts made on demand)",
    )


def _fedprox_clients(args, client_num: int, seed: int):
    """FedProx's synthetic(alpha, beta) federation, 80/20 per client."""
    xs, ys = synthetic_fedprox(
        num_clients=client_num,
        alpha=float(getattr(args, "synthetic_alpha", 1.0)),
        beta=float(getattr(args, "synthetic_beta", 1.0)),
        input_dim=int(getattr(args, "input_dim", 60)),
        num_classes=int(getattr(args, "output_dim", 10)),
        seed=seed,
    )
    xs_tr, ys_tr, xs_te, ys_te = [], [], [], []
    for x, y in zip(xs, ys):
        k = max(1, int(0.8 * len(x)))
        xs_tr.append(x[:k])
        ys_tr.append(y[:k])
        xs_te.append(x[k:])
        ys_te.append(y[k:])
    return xs_tr, ys_tr, xs_te, ys_te


def _natural_clients(args, name: str, fed, client_num: int):
    """A file federation's users onto ``client_num`` clients: folded
    round-robin, or the config capped to the users there are."""
    from .ingest import regroup_clients

    _, class_num, _, _, task = _DATASET_META[name]
    xs_tr, ys_tr, xs_te, ys_te = fed
    if task == "tag_prediction" and xs_tr:
        # the model factory sizes the input layer off args
        args.input_dim = int(xs_tr[0].shape[-1])
    n_users = len(xs_tr)
    if client_num > n_users:
        logging.warning(
            "dataset %s has %d users < client_num_in_total=%d; capping",
            name, n_users, client_num,
        )
        client_num = n_users
        args.client_num_in_total = n_users
        args.client_num_per_round = min(int(args.client_num_per_round), n_users)
    xs_tr, ys_tr = regroup_clients(xs_tr, ys_tr, client_num)
    xs_te, ys_te = regroup_clients(xs_te, ys_te, client_num)
    if task == "classification":
        observed = max((int(y.max()) for y in ys_tr + ys_te if len(y)), default=-1) + 1
        class_num = _widen_class_num(name, class_num, observed)
    return xs_tr, ys_tr, xs_te, ys_te, class_num, task, client_num


def _partitioned_clients(args, client_num: int, seed: int):
    """Global arrays (``_raw_data``) split over clients: train by
    ``homo`` or LDA (on the dominant tag for multi-hot labels), test
    sharded uniformly."""
    name = str(getattr(args, "dataset", "synthetic")).lower()
    x_tr, y_tr, x_te, y_te, class_num, task, source = _raw_data(args)
    if task == "classification":
        observed = int(max(y_tr.max(initial=-1), y_te.max(initial=-1))) + 1
        class_num = _widen_class_num(name, class_num, observed)
    if task == "tag_prediction":
        # the model factory sizes the input layer off args
        args.input_dim = int(x_tr.shape[-1])
    if task == "segmentation":
        idx_map = _segmentation_partition(args, y_tr, client_num, class_num, seed)
    else:
        labels = np.argmax(y_tr, axis=-1) if task == "tag_prediction" else y_tr
        idx_map = _partition(args, labels, client_num, class_num, seed)
    xs_tr = [x_tr[idx_map[i]] for i in range(client_num)]
    ys_tr = [y_tr[idx_map[i]] for i in range(client_num)]
    te_map = homo_partition(len(y_te), client_num, seed + 1)
    xs_te = [x_te[te_map[i]] for i in range(client_num)]
    ys_te = [y_te[te_map[i]] for i in range(client_num)]
    return xs_tr, ys_tr, xs_te, ys_te, class_num, task, source


def _pack_federation(args, xs_tr, ys_tr, xs_te, ys_te, class_num: int, task: str,
                     client_num: int, device: torch.device, source: str) -> FederatedDataset:
    """Per-client host arrays packed on the host and moved to ``device``:
    the packed federation, its global views and counts, bitwise the JAX
    package's."""
    if task == "nwp":
        x_dtype = torch.int32
    elif str(getattr(args, "dtype", "float32") or "float32") == "bfloat16":
        x_dtype = torch.bfloat16
    else:
        x_dtype = torch.float32
    batch_size = int(args.batch_size)
    waste_cap = float(getattr(args, "packing_waste_cap", 4.0) or 4.0)
    sizes = [len(x) for x in xs_tr]
    kw = dict(x_dtype=x_dtype, device=device)
    packed_train, num_samples = pack_clients(
        xs_tr, ys_tr, batch_size,
        num_batches=bucket_num_batches(sizes, batch_size, waste_cap=waste_cap), **kw)
    packed_test, _ = pack_clients(
        xs_te, ys_te, batch_size,
        num_batches=bucket_num_batches([len(x) for x in xs_te], batch_size,
                                       waste_cap=waste_cap), **kw)
    y_te_all = np.concatenate(ys_te)
    return FederatedDataset(
        train_data_num=int(sum(sizes)),
        test_data_num=int(len(y_te_all)),
        train_data_global=pack_one(np.concatenate(xs_tr), np.concatenate(ys_tr),
                                   batch_size, **kw),
        test_data_global=pack_one(np.concatenate(xs_te), y_te_all, batch_size, **kw),
        train_data_local_num_dict={i: int(s) for i, s in enumerate(sizes)},
        train_data_local_dict={i: _client_view(packed_train, i) for i in range(client_num)},
        test_data_local_dict={i: _client_view(packed_test, i) for i in range(client_num)},
        class_num=class_num,
        packed_train=packed_train,
        packed_num_samples=num_samples.cpu().numpy(),
        packed_test=packed_test,
        client_num=client_num,
        task=task,
        source=source,
    )


def _load_vfl_dataset(args, vfl_dir: str, client_num: int, seed: int,
                      device: torch.device) -> FederatedDataset:
    """Party CSVs -> the horizontal view: the parties' columns side by
    side, split train/test by ``vfl_train_test_split``, ``homo``
    partitioned; the per-party arrays ride on ``vfl_parties``."""
    from .ingest import load_vfl_party_csvs, vfl_train_test_split

    feats, labels = load_vfl_party_csvs(vfl_dir)
    class_num = int(labels.max()) + 1
    f_tr, y_tr, f_te, y_te = vfl_train_test_split(feats, labels, seed)
    x_tr = np.concatenate([f.reshape(len(f), -1) for f in f_tr], axis=1)
    x_te = np.concatenate([f.reshape(len(f), -1) for f in f_te], axis=1)
    args.input_dim = int(x_tr.shape[1])
    idx_map = homo_partition(len(y_tr), client_num, seed)
    te_map = homo_partition(len(y_te), client_num, seed + 1)
    batch_size = int(args.batch_size)
    xs_tr = [x_tr[idx_map[i]] for i in range(client_num)]
    xs_te = [x_te[te_map[i]] for i in range(client_num)]
    sizes = [len(x) for x in xs_tr]
    packed_train, num_samples = pack_clients(
        xs_tr, [y_tr[idx_map[i]] for i in range(client_num)], batch_size,
        num_batches=bucket_num_batches(sizes, batch_size), device=device)
    packed_test, _ = pack_clients(
        xs_te, [y_te[te_map[i]] for i in range(client_num)], batch_size,
        num_batches=bucket_num_batches([len(x) for x in xs_te], batch_size), device=device)
    return FederatedDataset(
        train_data_num=int(len(y_tr)),
        test_data_num=int(len(y_te)),
        train_data_global=pack_one(x_tr, y_tr, batch_size, device=device),
        test_data_global=pack_one(x_te, y_te, batch_size, device=device),
        train_data_local_num_dict={i: int(s) for i, s in enumerate(sizes)},
        train_data_local_dict={i: _client_view(packed_train, i) for i in range(client_num)},
        test_data_local_dict={i: _client_view(packed_test, i) for i in range(client_num)},
        class_num=class_num,
        packed_train=packed_train,
        packed_num_samples=num_samples.cpu().numpy(),
        packed_test=packed_test,
        client_num=client_num,
        task="classification",
        vfl_parties=(feats, labels),
        source=f"VFL party CSVs under {vfl_dir}",
    )


def load(args, device: DeviceLike = "cuda") -> FederatedDataset:
    """Load + partition + pack the dataset ``args.dataset`` names, its
    packed federation on ``device``."""
    dev = get_device(device)
    name = str(getattr(args, "dataset", "synthetic")).lower()
    if int(getattr(args, "client_registry_size", 0) or 0) > 0:
        # the planet-scale registry (scale/): NEVER build per-client
        # state proportional to the registered population
        return _registry_dataset(args, dev)
    client_num = int(args.client_num_in_total)
    seed = int(getattr(args, "random_seed", 0))
    poisoned = getattr(args, "poison_type", None)
    cache = getattr(args, "data_cache_dir", None)
    if cache:
        from .ingest import vfl_party_csvs_available

        vfl_dir = os.path.join(cache, name)
        if vfl_party_csvs_available(vfl_dir):
            if poisoned:
                # the attacks mutate horizontal per-client shards, which
                # a vertical party split does not have
                raise ValueError(
                    f"poison_type={args.poison_type!r} is not supported "
                    f"for VFL party-CSV datasets (found {vfl_dir!r})"
                )
            # party CSVs define the data whatever the dataset's name
            return _load_vfl_dataset(args, vfl_dir, client_num, seed, dev)
    if name.startswith("synthetic"):
        xs_tr, ys_tr, xs_te, ys_te = _fedprox_clients(args, client_num, seed)
        class_num, task = int(getattr(args, "output_dim", 10)), "classification"
        source = "FedProx synthetic(alpha, beta)"
    elif name not in _DATASET_META:
        raise ValueError(f"unknown dataset {name!r}")
    elif (fed := _try_load_federated(name, cache, args)) is not None:
        # naturally federated: the files' per-user split is the partition
        fed, source = fed
        xs_tr, ys_tr, xs_te, ys_te, class_num, task, client_num = _natural_clients(
            args, name, fed, client_num)
    else:
        # a poisoned world needs the features on the host (the attacks
        # stamp triggers and inject samples), so the stand-in's features
        # are not made on the device then
        dev_ds = None if poisoned else _device_synth_classification(
            args, name, client_num, int(args.batch_size), seed, dev)
        if dev_ds is not None:
            return dev_ds
        xs_tr, ys_tr, xs_te, ys_te, class_num, task, source = _partitioned_clients(
            args, client_num, seed)
    # after the partition (attacks are per client), before packing
    xs_tr, ys_tr = _maybe_poison_clients(args, xs_tr, ys_tr, class_num, seed, task)
    return _pack_federation(args, xs_tr, ys_tr, xs_te, ys_te, class_num, task,
                            client_num, dev, source)
