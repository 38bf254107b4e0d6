"""Dataset download seam with offline grace + bundled real-data path.

The port of ``fedml_tpu/data/download.py``:
``download_dataset(name, data_cache_dir, urls=None)`` fetches the
dataset's archives (``urls``, or by default the reference's own, kept in
``DATASET_ARCHIVES``), extracts them into a staging directory, hoists
their nesting, and moves the result into ``<data_cache_dir>/<name>/``
only when every archive landed (both Stack Overflow tasks share one
``stackoverflow`` directory, linked under each name). Each fetch retries
a transient failure (a timeout, a reset, a refused connection, a 5xx)
twice, after 1 s and 2 s; a 4xx or a local error fails at once. Any
failure that remains logs a warning and returns False (offline grace:
the loader, ``data/loader.py``, then takes its synthetic stand-in).
Plain Python, the same files as the JAX package's for the same archives.

**Bundled real data**: :func:`materialize_real_digits` writes the UCI ML
hand-written digits set (1797 REAL handwritten digit images, shipped
inside scikit-learn — available with zero egress) into the exact MNIST
LEAF json layout: 8x8 images are upsampled to 28x28, scaled to [0,1],
flattened to 784 like the reference's MNIST json, and split across
users with a Dirichlet label skew so the federation is naturally
non-IID. This is NOT MNIST — file/metric names say "digits" wherever
the distinction matters — but it IS genuinely real data in the
reference's on-disk format.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import time
import urllib.request
import zipfile
from typing import Optional, Sequence

from ..constants import FEDML_DATA_MNIST_URL

_DOWNLOAD_TIMEOUT_S = 15
# bounded retry around each fetch before the offline-grace fallback: one
# transient blip (DNS hiccup, connection reset) must not degrade a run to
# the stand-in
_FETCH_RETRIES = 2
_FETCH_RETRY_BASE_S = 1.0

# dataset -> archives, the reference's download scripts'
# (data/<ds>/download*.sh): the same hosts and artifact names. Both Stack
# Overflow tasks share the h5 and its two vocabulary side files.
_SO_ARCHIVES = (
    "https://fedml.s3-us-west-1.amazonaws.com/stackoverflow.tar.bz2",
    "https://fedml.s3-us-west-1.amazonaws.com/stackoverflow.word_count.tar.bz2",
    "https://fedml.s3-us-west-1.amazonaws.com/stackoverflow.tag_count.tar.bz2",
)
DATASET_ARCHIVES = {
    "mnist": (FEDML_DATA_MNIST_URL,),
    "fed_cifar100": (
        "https://fedml.s3-us-west-1.amazonaws.com/fed_cifar100.tar.bz2",
    ),
    "fed_shakespeare": (
        "https://fedml.s3-us-west-1.amazonaws.com/shakespeare.tar.bz2",
    ),
    "femnist": (
        "https://fedml.s3-us-west-1.amazonaws.com/fed_emnist.tar.bz2",
    ),
    "stackoverflow_nwp": _SO_ARCHIVES,
    "stackoverflow_lr": _SO_ARCHIVES,
    # the FeTS2021 training archive (data/FeTS2021/download.sh)
    "fets2021": (
        "https://fedcv.s3.us-west-1.amazonaws.com/MICCAI_FeTS2021_TrainingData.zip",
    ),
    # the real edge-case attack sets (data/edge_case_examples/get_data.sh),
    # read by poison.load_edge_case_arrays, not the dataset loader
    "edge_case_examples": (
        "http://pages.cs.wisc.edu/~hongyiwang/edge_case_attack/edge_case_examples.zip",
    ),
}


def _backoff_delay_s(attempt: int, base_s: float) -> float:
    """``base_s * 2^attempt``: the JAX package's comm backoff with its
    jitter at 0 (one downloader has no retry storm to spread)."""
    return float(base_s) * (2.0 ** int(attempt))


def _transient_fetch_error(e: Exception) -> bool:
    """Retry only what a second attempt can plausibly fix: timeouts,
    resets, DNS blips, 5xx. A 4xx (a gone or renamed archive) or a local
    write error fails the same way every time."""
    import urllib.error

    if isinstance(e, urllib.error.HTTPError):
        return e.code >= 500
    return isinstance(e, (urllib.error.URLError, TimeoutError, ConnectionError))


def _fetch(url: str, dest: str) -> None:
    """Stream ``url`` to ``dest`` atomically (no partial files), retrying
    a transient failure ``_FETCH_RETRIES`` times with backoff; the last
    failure propagates (the caller's offline grace picks the fallback)."""
    last_err: Optional[Exception] = None
    for attempt in range(_FETCH_RETRIES + 1):
        if attempt:
            delay = _backoff_delay_s(attempt - 1, _FETCH_RETRY_BASE_S)
            logging.warning(
                "fetch %s failed (%s: %s); retry %d/%d in %.1fs",
                url, type(last_err).__name__, last_err, attempt, _FETCH_RETRIES, delay,
            )
            time.sleep(delay)
        try:
            _fetch_once(url, dest)
            return
        except Exception as e:  # noqa: BLE001 — classified below
            last_err = e
            if not _transient_fetch_error(e):
                raise
    raise last_err


def _fetch_once(url: str, dest: str) -> None:
    tmp_name = None
    try:
        with urllib.request.urlopen(
            url, timeout=_DOWNLOAD_TIMEOUT_S
        ) as r, tempfile.NamedTemporaryFile(
            dir=os.path.dirname(dest), delete=False
        ) as tmp:
            tmp_name = tmp.name
            shutil.copyfileobj(r, tmp)
        os.replace(tmp_name, dest)
        tmp_name = None
    finally:
        if tmp_name is not None:  # failed mid-copy: no orphans
            try:
                os.unlink(tmp_name)
            except OSError:
                logging.debug(
                    "download: temp %s cleanup failed", tmp_name,
                    exc_info=True,
                )


def _extract(archive: str, out_dir: str) -> None:
    import tarfile

    if archive.endswith(".zip"):
        with zipfile.ZipFile(archive, "r") as zf:
            zf.extractall(out_dir)
    else:
        with tarfile.open(archive, "r:*") as tf:
            tf.extractall(out_dir, filter="data")


def _fetch_and_extract(url: str, cache_dir: str, out_dir: str) -> None:
    """Download (cached) + extract one archive, refetching once when a
    previously-interrupted download left a corrupt file behind."""
    import tarfile

    archive = os.path.join(cache_dir, os.path.basename(url))
    if not os.path.exists(archive):
        _fetch(url, archive)
    try:
        _extract(archive, out_dir)
    except (zipfile.BadZipFile, tarfile.TarError, EOFError):
        logging.warning("corrupt %s; re-downloading", archive)
        os.unlink(archive)
        _fetch(url, archive)
        _extract(archive, out_dir)


def _normalize_layout(root: str) -> None:
    """Archives differ in nesting (MNIST.zip carries ``MNIST/``, the
    TFF tarballs a dataset-named dir): hoist any single-level nesting
    so the loader's probes (<root>/train/*.json, <root>/*_{train,
    test}.h5, side files) find the artifacts."""
    if not os.path.isdir(root):
        return
    for sub in list(os.listdir(root)):
        subdir = os.path.join(root, sub)
        if not os.path.isdir(subdir) or sub in ("train", "test"):
            continue
        for inner in os.listdir(subdir):
            target = os.path.join(root, inner)
            if not os.path.exists(target):
                os.rename(os.path.join(subdir, inner), target)
        if not os.listdir(subdir):
            os.rmdir(subdir)


# both Stack Overflow tasks read the same artifacts: extracted once into
# one shared directory (the reference's layout), the per-dataset names
# linked onto it
_SHARED_EXTRACT_ROOT = {
    "stackoverflow_nwp": "stackoverflow",
    "stackoverflow_lr": "stackoverflow",
}


def dataset_downloadable(name: str) -> bool:
    return name in DATASET_ARCHIVES


def download_dataset(name: str, data_cache_dir: str,
                     urls: Optional[Sequence[str]] = None) -> bool:
    """Fetch + extract ``urls`` (default: ``name``'s archives in
    ``DATASET_ARCHIVES``) into ``<data_cache_dir>/<name>/`` unless that
    directory exists; False on any failure (offline grace: the caller
    picks the fallback) or when no source is known.

    All-or-nothing: archives extract into a staging dir that only moves
    into place once EVERY archive landed, so a partial multi-archive
    download (e.g. stackoverflow's h5 without its vocab side files) can
    never leave a half-usable dataset dir that suppresses retries.
    """
    if urls is None:
        urls = DATASET_ARCHIVES.get(name)
    if not urls:
        logging.warning("dataset %s: no download source known", name)
        return False
    shared = _SHARED_EXTRACT_ROOT.get(name, name)
    root = os.path.join(data_cache_dir, shared)
    staging = os.path.join(data_cache_dir, f".staging_{shared}")
    os.makedirs(data_cache_dir, exist_ok=True)
    if not os.path.isdir(root):
        try:
            shutil.rmtree(staging, ignore_errors=True)
            os.makedirs(staging)
            for url in urls:
                _fetch_and_extract(url, data_cache_dir, staging)
            _normalize_layout(staging)
            os.rename(staging, root)
        except Exception as e:  # noqa: BLE001 — offline grace is the point
            shutil.rmtree(staging, ignore_errors=True)
            logging.warning(
                "%s download unavailable (%s: %s); proceeding without it",
                name, type(e).__name__, e,
            )
            return False
    if shared != name:
        link = os.path.join(data_cache_dir, name)
        if not os.path.exists(link):
            os.symlink(shared, link)
    return True


def download_mnist(data_cache_dir: str, url: str = FEDML_DATA_MNIST_URL) -> bool:
    """The reference's entry (data/MNIST/data_loader.py:17-29): fetch and
    extract the MNIST LEAF archive; False on any failure."""
    ok = download_dataset("mnist", data_cache_dir, urls=(url,))
    return ok and os.path.isdir(os.path.join(data_cache_dir, "mnist", "train"))


def materialize_real_digits(
    data_cache_dir: str,
    n_users: int = 100,
    alpha: float = 0.5,
    seed: int = 0,
    name: str = "mnist",
) -> Optional[str]:
    """Write the sklearn real-digits set as a MNIST-format LEAF dir.

    Returns the dataset dir (``<cache>/<name>``), or None when sklearn
    is unavailable. ~1437 train / 360 test real images over ``n_users``
    Dirichlet(alpha)-skewed users.
    """
    try:
        from sklearn.datasets import load_digits
    except Exception:  # noqa: BLE001 — optional dependency
        logging.warning("scikit-learn unavailable; no bundled real digits")
        return None
    import numpy as np

    d = load_digits()
    x = d.data.reshape(-1, 8, 8).astype(np.float32) / 16.0
    # upsample 8x8 -> 28x28 (nearest via index map; no PIL dependency)
    idx = (np.arange(28) * 8) // 28
    x = x[:, idx][:, :, idx].reshape(len(x), 784)
    y = d.target.astype(np.int64)

    rng = np.random.RandomState(seed)
    perm = rng.permutation(len(x))
    x, y = x[perm], y[perm]

    # Dirichlet label skew over users FIRST (the LEAF per-user grouping
    # IS the partition, so the non-IID is baked into the user split),
    # then an 80/20 per-user train/test split — train and test share
    # the same user set, the reference read_data assumption
    # (data/MNIST/data_loader.py:37-38).
    user_of = np.empty(len(y), np.int64)
    for c in range(10):
        rows = np.where(y == c)[0]
        p = rng.dirichlet([alpha] * n_users)
        user_of[rows] = rng.choice(n_users, size=len(rows), p=p)

    blobs = {
        s: {"users": [], "num_samples": [], "user_data": {}}
        for s in ("train", "test")
    }
    for u in range(n_users):
        rows = np.where(user_of == u)[0]
        if len(rows) == 0:
            continue
        uid = f"u_{u:05d}"
        k = max(1, int(0.8 * len(rows)))
        for split, sel in (("train", rows[:k]), ("test", rows[k:])):
            blobs[split]["users"].append(uid)
            blobs[split]["num_samples"].append(int(len(sel)))
            blobs[split]["user_data"][uid] = {
                "x": [[round(float(v), 4) for v in row] for row in x[sel]],
                "y": [int(v) for v in y[sel]],
            }

    root = os.path.join(data_cache_dir, name)
    for split, blob in blobs.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        with open(os.path.join(root, split, "all_data_0.json"), "w") as f:
            json.dump(blob, f)
    # provenance marker: later runs must never mistake this subset for
    # the real MNIST archive
    with open(os.path.join(root, "_source.json"), "w") as f:
        json.dump(
            {"source": "sklearn_digits", "real_data": True,
             "is_mnist": False},
            f,
        )
    logging.info(
        "materialized real digits (sklearn) as LEAF %s: %d train users",
        root, len(json.load(open(os.path.join(root, "train",
                                              "all_data_0.json")))["users"]),
    )
    return root
