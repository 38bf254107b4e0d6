"""Real on-disk dataset ingestion (port of ``fedml_tpu/data/ingest.py``).

Plain numpy (``h5py`` for TFF h5, PIL for images), kept as the port's
own copy: every reader's arrays are bitwise the JAX package's for the
same files, and the loader (``data/loader.py``) packs them on the host
before moving them to the device. The VFL party readers are here; the
VFL training API (``simulation/split_learning.py`` ``VFLAPI``) reads
them. The text below is the JAX package's own.

TFF h5, CIFAR binary batches, image folders, the Landmarks CSV and VFL
party CSVs. Reference loaders this replaces (same on-disk formats, converted into
the packed-federation layout instead of torch DataLoaders):

- TFF h5 (``data/fed_cifar100/data_loader.py``, ``data/fed_shakespeare/
  data_loader.py``): one h5 file per split, group ``examples`` ->
  per-client-id group -> datasets ``image``/``label`` (fed_cifar100) or
  ``snippets`` (fed_shakespeare). These are NATURALLY federated — the
  per-client grouping IS the partition, so LDA is bypassed.
- CIFAR python batches (``data/cifar10/data_loader.py:106-120`` via
  torchvision's unpickling): ``cifar-10-batches-py/data_batch_{1..5}``
  + ``test_batch`` dicts with ``data`` [N,3072] uint8 and ``labels``;
  cifar-100 ships ``train``/``test`` with ``fine_labels``. Global
  arrays -> the standard LDA partition applies.

Deviations by design: the reference's random crop/flip augmentation
(``fed_cifar100/utils.py``) is a per-step training-time op, not an
ingestion op — here ingestion produces deterministic [0,1]-scaled
tensors and augmentation belongs in the training pipeline.

Shakespeare preprocessing follows the TFF recipe the reference follows
(``fed_shakespeare/utils.py``: BOS + chars + EOS, pad to a multiple of
SEQ_LEN+1, split into windows; x = w[:-1], y = w[1:]).
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

SHAKESPEARE_SEQ_LEN = 80
# TFF character vocabulary (fed_shakespeare/utils.py CHAR_VOCAB); ids:
# 0 = pad, 1..86 = chars, 87 = bos, 88 = eos, 89 = oov -> vocab 90
_CHAR_VOCAB = list(
    "dhlptx@DHLPTX $(,048cgkoswCGKOSW[_#'/37;?bfjnrvzBFJNRVZ\"&*.26:\naeimquyAEIMQUY]!%)-159\r"
)
_CHAR_TO_ID = {c: i + 1 for i, c in enumerate(_CHAR_VOCAB)}
_BOS = len(_CHAR_VOCAB) + 1
_EOS = len(_CHAR_VOCAB) + 2
_OOV = len(_CHAR_VOCAB) + 3
SHAKESPEARE_VOCAB = _OOV + 1  # 90


def shakespeare_to_sequences(snippets: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Snippet strings -> (x [N,80] int32, y [N,80] int32)."""
    win = SHAKESPEARE_SEQ_LEN + 1
    windows: List[List[int]] = []
    for s in snippets:
        toks = [_BOS] + [_CHAR_TO_ID.get(c, _OOV) for c in s] + [_EOS]
        pad = (-len(toks)) % win
        toks = toks + [0] * pad
        windows.extend(toks[i : i + win] for i in range(0, len(toks), win))
    if not windows:
        e = np.zeros((0, SHAKESPEARE_SEQ_LEN), np.int32)
        return e, e.copy()
    arr = np.asarray(windows, dtype=np.int32)
    return arr[:, :-1], arr[:, 1:]


# -- stackoverflow (TFF h5 + side vocab files) ------------------------
#
# Reference: data/stackoverflow_nwp/{utils,dataset}.py and
# data/stackoverflow_lr/{utils,dataset}.py. Both tasks read the same
# stackoverflow_{train,test}.h5 (group examples/<client>/ with string
# datasets ``tokens``, ``title``, ``tags``) plus two side files in the
# data dir: ``stackoverflow.word_count`` (text lines "word count"; top
# 10000 words are the vocabulary) and ``stackoverflow.tag_count`` (JSON
# ordered dict; first 500 keys are the label tags).

SO_SEQ_LEN = 20  # stackoverflow_nwp/utils.py tokenizer max_seq_len
SO_VOCAB_WORDS = 10000
SO_TAG_COUNT = 500


def load_so_word_vocab(data_dir: str, vocab_size: int = SO_VOCAB_WORDS) -> List[str]:
    """Top-``vocab_size`` words from ``stackoverflow.word_count``
    (stackoverflow_nwp/utils.py get_most_frequent_words)."""
    path = os.path.join(data_dir, "stackoverflow.word_count")
    words: List[str] = []
    with open(path) as f:
        for line in f:
            if len(words) >= vocab_size:
                break
            parts = line.split()
            if parts:
                words.append(parts[0])
    return words


def load_so_tag_vocab(data_dir: str, tag_size: int = SO_TAG_COUNT) -> List[str]:
    """First ``tag_size`` tags from ``stackoverflow.tag_count``
    (stackoverflow_lr/utils.py get_tags; insertion-ordered JSON)."""
    import json

    path = os.path.join(data_dir, "stackoverflow.tag_count")
    with open(path) as f:
        return list(json.load(f).keys())[:tag_size]


def so_nwp_to_sequences(
    sentences: List[str], words: List[str], word_id: Optional[Dict] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Sentences -> (x [N,20], y [N,20]) next-word-prediction pairs.

    Token ids follow stackoverflow_nwp/utils.py exactly: pad=0, words
    1..V, bos=V+1, eos=V+2, oov=V+3 (one OOV bucket); each sentence is
    truncated to 20 words, gets EOS only if shorter, BOS prepended,
    padded to 21; x = w[:-1], y = w[1:]. Pass a precomputed ``word_id``
    ({word: id starting at 1}) when calling per-client — the real
    dataset has 342k clients and a fresh 10k-entry dict per call is
    pure waste."""
    if word_id is None:
        word_id = {w: i + 1 for i, w in enumerate(words)}
    bos, eos, oov = len(words) + 1, len(words) + 2, len(words) + 3
    win = SO_SEQ_LEN + 1
    seqs: List[List[int]] = []
    for s in sentences:
        toks = [word_id.get(t, oov) for t in s.split(" ")[:SO_SEQ_LEN]]
        if len(toks) < SO_SEQ_LEN:
            toks.append(eos)
        toks = [bos] + toks
        toks += [0] * (win - len(toks))
        seqs.append(toks)
    if not seqs:
        e = np.zeros((0, SO_SEQ_LEN), np.int32)
        return e, e.copy()
    arr = np.asarray(seqs, np.int32)
    return arr[:, :-1], arr[:, 1:]


def so_lr_features(
    sentences: List[str], words: List[str], word_id: Optional[Dict] = None
) -> np.ndarray:
    """tokens+title strings -> mean bag-of-words [N, V] over the word
    vocabulary (stackoverflow_lr/utils.py preprocess_inputs: the OOV
    bucket participates in the mean but is sliced off). ``word_id``
    ({word: 0-based id}) as in :func:`so_nwp_to_sequences`."""
    if word_id is None:
        word_id = {w: i for i, w in enumerate(words)}
    v = len(words)
    out = np.zeros((len(sentences), v), np.float32)
    for n, s in enumerate(sentences):
        toks = s.split(" ")
        if not toks:
            continue
        for t in toks:
            i = word_id.get(t)
            if i is not None:
                out[n, i] += 1.0
        out[n] /= float(len(toks))
    return out


def so_lr_targets(
    tag_strs: List[str], tags: List[str], tag_id: Optional[Dict] = None
) -> np.ndarray:
    """'|'-joined tag strings -> multi-hot [N, T]
    (stackoverflow_lr/utils.py preprocess_targets; the reference emits
    raw per-tag counts incl. an OOV bucket — here clipped to {0,1} over
    the T label tags, which is what its 500-way sigmoid head consumes)."""
    if tag_id is None:
        tag_id = {t: i for i, t in enumerate(tags)}
    out = np.zeros((len(tag_strs), len(tags)), np.float32)
    for n, ts in enumerate(tag_strs):
        for t in ts.split("|"):
            i = tag_id.get(t)
            if i is not None:
                out[n, i] = 1.0
    return out


def _so_examples_group(f):
    # canonical TFF layout uses "examples"; the reference's reader keys
    # on "examples.md" (stackoverflow_nwp/dataset.py:21) — accept both
    for key in ("examples", "examples.md"):
        if key in f:
            return f[key]
    raise KeyError("no 'examples' group in stackoverflow h5")


def _read_stackoverflow_split(
    path: str, task: str, words: List[str], tags: List[str]
):
    """One stackoverflow h5 split -> (client_ids, xs, ys)."""
    import h5py

    def dec(v) -> str:
        return v.decode("utf8") if isinstance(v, bytes) else str(v)

    # id maps built ONCE, not per client (342k clients on the real set)
    if task == "nwp":
        word_id = {w: i + 1 for i, w in enumerate(words)}
    else:
        word_id = {w: i for i, w in enumerate(words)}
        tag_id = {t: i for i, t in enumerate(tags)}
    ids, xs, ys = [], [], []
    with h5py.File(path, "r") as f:
        examples = _so_examples_group(f)
        for cid in sorted(examples.keys()):
            g = examples[cid]
            toks = [dec(s) for s in g["tokens"][()]]
            if task == "nwp":
                x, y = so_nwp_to_sequences(toks, words, word_id)
            else:
                titles = [dec(s) for s in g["title"][()]]
                sents = [" ".join([t, ti]) for t, ti in zip(toks, titles)]
                x = so_lr_features(sents, words, word_id)
                y = so_lr_targets(
                    [dec(s) for s in g["tags"][()]], tags, tag_id
                )
            ids.append(cid)
            xs.append(x)
            ys.append(y)
    return ids, xs, ys


def _h5_split_path(data_dir: str, candidates: List[str]) -> Optional[str]:
    for name in candidates:
        p = os.path.join(data_dir, name)
        if os.path.exists(p):
            return p
    return None


def _read_tff_split(path: str, image_key: str):
    """One TFF h5 split -> (client_ids, xs, ys) with per-client arrays."""
    import h5py

    xs, ys, ids = [], [], []
    with h5py.File(path, "r") as f:
        examples = f["examples"]
        for cid in sorted(examples.keys()):
            g = examples[cid]
            if image_key == "snippets":
                snippets = [
                    s.decode("utf8") if isinstance(s, bytes) else str(s)
                    for s in g["snippets"][()]
                ]
                x, y = shakespeare_to_sequences(snippets)
            else:
                x = np.asarray(g[image_key][()], dtype=np.float32) / 255.0
                y = np.asarray(g["label"][()]).reshape(-1).astype(np.int64)
            ids.append(cid)
            xs.append(x)
            ys.append(y)
    return ids, xs, ys


def tff_h5_available(data_dir: str, dataset: str) -> bool:
    return _h5_split_path(data_dir, _tff_names(dataset, "train")) is not None


def _tff_names(dataset: str, split: str) -> List[str]:
    # canonical TFF artifact names (reference DEFAULT_TRAIN_FILE) plus
    # the <dataset>_<split>.h5 convention
    names = [f"{dataset}_{split}.h5"]
    if dataset == "fed_shakespeare":
        names.append(f"shakespeare_{split}.h5")
    if dataset == "fed_cifar100":
        names.append(f"fed_cifar100_{split}.h5")
    if dataset == "fed_emnist" or dataset == "femnist":
        names.append(f"fed_emnist_{split}.h5")
    if dataset.startswith("stackoverflow"):
        # both SO tasks read the same artifact (reference
        # stackoverflow_nwp/data_loader.py DEFAULT_TRAIN_FILE)
        names.append(f"stackoverflow_{split}.h5")
    return names


def load_tff_h5(
    data_dir: str, dataset: str
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """TFF h5 train/test -> per-client arrays (naturally federated).

    Train clients define the federation (reference: train/test client
    id sets differ in size, fed_cifar100 500/100); a train client with
    no test group gets an empty test set."""
    train_path = _h5_split_path(data_dir, _tff_names(dataset, "train"))
    test_path = _h5_split_path(data_dir, _tff_names(dataset, "test"))
    if train_path is None:
        raise FileNotFoundError(f"no TFF h5 train split for {dataset} in {data_dir}")
    if dataset.startswith("stackoverflow"):
        task = "nwp" if dataset.endswith("nwp") else "lr"
        words = load_so_word_vocab(data_dir)
        tags = load_so_tag_vocab(data_dir) if task == "lr" else []
        read = lambda p: _read_stackoverflow_split(p, task, words, tags)
    else:
        image_key = "snippets" if "shakespeare" in dataset else (
            "pixels" if "emnist" in dataset else "image"
        )
        read = lambda p: _read_tff_split(p, image_key)
    ids, xs_tr, ys_tr = read(train_path)
    test_map = {}
    if test_path is not None:
        te_ids, xs_te, ys_te = read(test_path)
        test_map = {c: (x, y) for c, x, y in zip(te_ids, xs_te, ys_te)}
    xs_te_out, ys_te_out = [], []
    for cid, x, y0 in zip(ids, xs_tr, ys_tr):
        if cid in test_map:
            xt, yt = test_map[cid]
        else:
            xt = np.zeros((0,) + x.shape[1:], x.dtype)
            yt = np.zeros((0,) + y0.shape[1:], y0.dtype)
        xs_te_out.append(xt)
        ys_te_out.append(yt)
    logging.info(
        "TFF h5 %s: %d clients, %d train samples",
        dataset, len(ids), sum(len(x) for x in xs_tr),
    )
    return xs_tr, ys_tr, xs_te_out, ys_te_out


# -- CIFAR python batches ---------------------------------------------


def _cifar_dir(data_dir: str, dataset: str) -> Optional[str]:
    sub = "cifar-10-batches-py" if dataset == "cifar10" else "cifar-100-python"
    for d in (os.path.join(data_dir, sub), data_dir):
        probe = "data_batch_1" if dataset == "cifar10" else "train"
        if os.path.isfile(os.path.join(d, probe)):
            return d
    return None


def cifar_batches_available(data_dir: str, dataset: str) -> bool:
    return _cifar_dir(data_dir, dataset) is not None


def _unpickle(path: str) -> dict:
    # the canonical CIFAR distribution is python-pickled (the reference
    # unpickles via torchvision); trusted local dataset files only
    with open(path, "rb") as f:
        return pickle.load(f, encoding="bytes")


def _batch_arrays(blob: dict, label_key: bytes) -> Tuple[np.ndarray, np.ndarray]:
    data = np.asarray(blob[b"data"], dtype=np.uint8)
    x = data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NHWC
    y = np.asarray(blob[label_key], dtype=np.int64)
    return x, y


def load_cifar_batches(
    data_dir: str, dataset: str
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """CIFAR-10/100 python batches -> global arrays (x in [0,1] NHWC).

    Format parity: ``cifar10/data_loader.py:106-120`` (via torchvision
    CIFAR10's unpickling of data_batch_1..5 / test_batch)."""
    d = _cifar_dir(data_dir, dataset)
    if d is None:
        raise FileNotFoundError(f"no CIFAR batches for {dataset} in {data_dir}")
    if dataset == "cifar10":
        label_key = b"labels"
        train_files = [f"data_batch_{i}" for i in range(1, 6)]
        train_files = [f for f in train_files if os.path.isfile(os.path.join(d, f))]
        test_files = ["test_batch"]
    else:
        label_key = b"fine_labels"
        train_files = ["train"]
        test_files = ["test"]
    test_files = [f for f in test_files if os.path.isfile(os.path.join(d, f))]
    if not train_files or not test_files:
        raise FileNotFoundError(
            f"partial CIFAR copy in {d}: need train batches AND the test "
            f"file (have train={train_files}, test={test_files})"
        )
    xs, ys = zip(*(_batch_arrays(_unpickle(os.path.join(d, f)), label_key)
                   for f in train_files))
    x_tr = np.concatenate(xs).astype(np.float32) / 255.0
    y_tr = np.concatenate(ys)
    xt, yt = zip(*(_batch_arrays(_unpickle(os.path.join(d, f)), label_key)
                   for f in test_files))
    x_te = np.concatenate(xt).astype(np.float32) / 255.0
    y_te = np.concatenate(yt)
    logging.info(
        "CIFAR batches %s: %d train / %d test", dataset, len(y_tr), len(y_te)
    )
    return x_tr, y_tr, x_te, y_te


def regroup_clients(
    xs: List[np.ndarray], ys: List[np.ndarray], n: int
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Fold a naturally-federated user list onto n logical clients
    (round-robin merge), for configs asking for fewer clients than the
    dataset has users — the reference maps users 1:1 and asserts; this
    keeps any n <= len(xs) runnable without discarding users."""
    if n >= len(xs):
        return xs, ys
    out_x: List[List[np.ndarray]] = [[] for _ in range(n)]
    out_y: List[List[np.ndarray]] = [[] for _ in range(n)]
    for i, (x, y) in enumerate(zip(xs, ys)):
        out_x[i % n].append(x)
        out_y[i % n].append(y)
    return (
        [np.concatenate(b) for b in out_x],
        [np.concatenate(b) for b in out_y],
    )


# -- image-folder (ImageNet-style) and Landmarks CSV ------------------


def _decode_image(path: str, hw: Tuple[int, int]) -> np.ndarray:
    """Decode + resize one image to [H, W, 3] float32 in [0,1]."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((hw[1], hw[0]))
        return np.asarray(im, dtype=np.float32) / 255.0


_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")


def image_folder_available(data_dir: str) -> bool:
    """ImageNet-style layout: <dir>/train/<class_name>/<img>."""
    train = os.path.join(data_dir, "train")
    if not os.path.isdir(train):
        return False
    for cls in os.listdir(train):
        d = os.path.join(train, cls)
        if os.path.isdir(d) and any(
            f.lower().endswith(_IMAGE_EXTS) for f in os.listdir(d)
        ):
            return True
    return False


def load_image_folder(
    data_dir: str, image_hw: Tuple[int, int] = (64, 64)
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """ImageNet-style class-per-directory ingestion (the reference's
    truncated-ImageNet datasets, ``data/ImageNet/``): <dir>/{train,val
    or test}/<class_name>/*.jpg -> global arrays + class count. Class
    ids follow sorted class-name order (torchvision convention)."""
    train_dir = os.path.join(data_dir, "train")
    test_dir = next(
        (
            os.path.join(data_dir, s)
            for s in ("val", "test")
            if os.path.isdir(os.path.join(data_dir, s))
        ),
        None,
    )
    classes = sorted(
        c for c in os.listdir(train_dir)
        if os.path.isdir(os.path.join(train_dir, c))
    )
    cls_id = {c: i for i, c in enumerate(classes)}

    def read_split(split_dir):
        xs, ys = [], []
        for c in classes:
            d = os.path.join(split_dir, c)
            if not os.path.isdir(d):
                continue
            for f in sorted(os.listdir(d)):
                if f.lower().endswith(_IMAGE_EXTS):
                    xs.append(_decode_image(os.path.join(d, f), image_hw))
                    ys.append(cls_id[c])
        if not xs:
            return (
                np.zeros((0,) + image_hw + (3,), np.float32),
                np.zeros((0,), np.int64),
            )
        return np.stack(xs), np.asarray(ys, np.int64)

    x_tr, y_tr = read_split(train_dir)
    x_te, y_te = read_split(test_dir) if test_dir else (
        np.zeros((0,) + image_hw + (3,), np.float32), np.zeros((0,), np.int64)
    )
    logging.info(
        "image folder %s: %d classes, %d train / %d test",
        data_dir, len(classes), len(y_tr), len(y_te),
    )
    return x_tr, y_tr, x_te, y_te, len(classes)


def landmarks_csv_available(data_dir: str) -> bool:
    return os.path.isfile(os.path.join(data_dir, "train.csv")) and os.path.isdir(
        os.path.join(data_dir, "images")
    )


def load_landmarks_csv(
    data_dir: str, image_hw: Tuple[int, int] = (64, 64)
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """Landmarks-style naturally-federated CSV mapping (reference
    ``data/Landmarks/data_loader.py:120-160``): ``train.csv`` rows
    ``user_id,image_id,class`` with images at ``images/<image_id>.jpg``
    (any supported extension). An optional ``test.csv`` (no user
    grouping required) supplies held-out data, sharded uniformly across
    users like the reference's test loaders."""
    import csv

    def read_rows(path):
        with open(path) as f:
            return list(csv.DictReader(f))

    img_dir = os.path.join(data_dir, "images")

    def img(image_id):
        for ext in _IMAGE_EXTS:
            p = os.path.join(img_dir, image_id + ext)
            if os.path.isfile(p):
                return _decode_image(p, image_hw)
        raise FileNotFoundError(f"image {image_id} not under {img_dir}")

    rows = read_rows(os.path.join(data_dir, "train.csv"))
    if not rows:
        raise ValueError(f"{data_dir}/train.csv has no data rows")
    per_user: Dict[str, List] = {}
    for r in rows:
        per_user.setdefault(r["user_id"], []).append(r)
    # numeric ids in numeric order, then non-numeric lexicographically
    # (mixed id kinds must not break the sort)
    users = sorted(
        per_user, key=lambda u: (0, int(u), "") if u.isdigit() else (1, 0, u)
    )
    xs_tr = [np.stack([img(r["image_id"]) for r in per_user[u]]) for u in users]
    ys_tr = [
        np.asarray([int(r["class"]) for r in per_user[u]], np.int64) for u in users
    ]

    test_path = os.path.join(data_dir, "test.csv")
    n = len(users)
    if os.path.isfile(test_path):
        te_rows = read_rows(test_path)
        x_te = [img(r["image_id"]) for r in te_rows]
        y_te = [int(r["class"]) for r in te_rows]
        xs_te = [
            np.stack(x_te[i::n]) if x_te[i::n] else
            np.zeros((0,) + xs_tr[0].shape[1:], np.float32)
            for i in range(n)
        ]
        ys_te = [np.asarray(y_te[i::n], np.int64) for i in range(n)]
    else:
        xs_te = [np.zeros((0,) + xs_tr[0].shape[1:], np.float32)] * n
        ys_te = [np.zeros((0,), np.int64)] * n
    logging.info(
        "landmarks csv %s: %d users, %d train samples",
        data_dir, n, sum(len(y) for y in ys_tr),
    )
    return xs_tr, ys_tr, xs_te, ys_te


# -- vertical-FL party CSVs -------------------------------------------


def vfl_party_csvs_available(data_dir: str) -> bool:
    """NUS-WIDE / lending-club style party split: party_0.csv (guest,
    carries the label column) + party_1.csv.. (host features)."""
    return os.path.isfile(os.path.join(data_dir, "party_0.csv"))


def load_vfl_party_csvs(
    data_dir: str,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Row-aligned party feature CSVs -> ([feats_k [N, d_k]...], labels).

    Reference analog: the vertically-split finance/CV datasets
    (``data/NUS_WIDE/``, ``data/lending_club_loan/``, ``data/UCI/``)
    where each organization holds its own feature columns for the same
    sample population. party_0.csv must carry the label column
    (``label`` or ``y``, case-insensitive); an ``id`` column, if
    present, is dropped everywhere (rows must already be aligned —
    private set intersection is upstream of ingestion)."""
    import csv as _csv

    import glob as _glob
    import re as _re

    present = sorted(
        int(m.group(1))
        for p in _glob.glob(os.path.join(data_dir, "party_*.csv"))
        if (m := _re.fullmatch(r"party_(\d+)\.csv", os.path.basename(p)))
    )
    if not present:
        raise ValueError(f"no party_K.csv files under {data_dir}")
    if present != list(range(len(present))):
        raise ValueError(
            f"party CSVs in {data_dir} must be contiguously numbered "
            f"party_0..party_K; found indices {present}"
        )
    feats: List[np.ndarray] = []
    labels: Optional[np.ndarray] = None
    for k in present:
        with open(os.path.join(data_dir, f"party_{k}.csv")) as f:
            rows = list(_csv.DictReader(f))
        if not rows:
            raise ValueError(f"party_{k}.csv has no data rows")
        cols = list(rows[0].keys())
        # only the guest (party_0) carries labels; a host column that
        # happens to be named 'label'/'y' is an ordinary feature
        label_col = (
            next((c for c in cols if c.lower() in ("label", "y")), None)
            if k == 0
            else None
        )
        if k == 0 and label_col is None:
            raise ValueError("party_0.csv must carry a 'label' (or 'y') column")
        feat_cols = [
            c for c in cols if c != label_col and c.lower() != "id"
        ]
        feats.append(
            np.asarray(
                [[float(r[c]) for c in feat_cols] for r in rows], np.float32
            )
        )
        if label_col is not None:
            labels = np.asarray([int(float(r[label_col])) for r in rows], np.int64)
            if labels.min() < 0:
                raise ValueError(
                    "party_0.csv labels must be non-negative class ids "
                    "(found %d); re-encode -1/+1 style labels as 0/1"
                    % labels.min()
                )
    k = len(present)
    n = len(feats[0])
    for i, fmat in enumerate(feats):
        if len(fmat) != n:
            raise ValueError(
                f"party_{i}.csv has {len(fmat)} rows, party_0 has {n}; "
                "party files must be row-aligned"
            )
    logging.info(
        "vfl party csvs %s: %d parties, %d samples, dims %s",
        data_dir, k, n, [f.shape[1] for f in feats],
    )
    return feats, labels


def vfl_train_test_split(
    feats: List[np.ndarray], labels: np.ndarray, seed: int, train_frac: float = 0.8
):
    """THE canonical row split for vertically-partitioned data — both
    the loader's horizontal view and the VFL engine's party view must
    use this one function or their test rows would silently diverge
    (train/test leakage between the two views of the same CSVs).
    Returns (feats_tr, labels_tr, feats_te, labels_te), row-shuffled
    with a seeded permutation (published extracts are often
    label-sorted)."""
    n = len(labels)
    perm = np.random.RandomState(int(seed)).permutation(n)
    feats = [f[perm] for f in feats]
    labels = labels[perm]
    n_tr = max(1, int(train_frac * n))
    return (
        [f[:n_tr] for f in feats],
        labels[:n_tr],
        [f[n_tr:] for f in feats],
        labels[n_tr:],
    )
