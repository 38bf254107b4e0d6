"""The planet-scale population plane of the port (``fedml_tpu_torch/scale/``)
against the JAX package's (``fedml_tpu/scale/``).

- the registry's columns, cohorts (plain and availability-aware), labels
  and memmap mode, and ``pack_cohort``'s plans, are bitwise the JAX
  package's;
- the per-client feature generator keeps the registry's contract (a
  client's sample ``s`` has the same features whatever its slot, group
  shape or cohort) and its features have the class means and ``sigma``
  as their statistics;
- the edge tree finalizes bitwise as the flat fold, and as the JAX
  package's tree;
- the registry simulation at CPU size (registry 600, cohort 64, 4 edges,
  3 rounds) lands within 1e-5 of the JAX package's params when both get
  the same features (the test hands the port the JAX generator's
  output), tree == flat bitwise, deterministic, a resumed run bitwise
  the straight one; the knob validation and the round loop's refusals
  are the JAX package's, word for word.

The int8-quantized tree is held to the flat fold in
``tests/test_torch_robust_fold.py``, the cross-silo aggregator's edge
tier in ``tests/test_torch_hierarchical.py``; the registry loop preempted and
resumed in ``tests/test_torch_elastic.py``.
"""

from __future__ import annotations

import argparse
import os
import tracemalloc
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import models as jax_models
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.data import load as jax_load
from fedml_tpu.data.synthetic import (
    synthetic_classification_device_per_client as jax_device_per_client,
)
from fedml_tpu.scale import ClientRegistry as JaxRegistry
from fedml_tpu.scale import EdgeAggregationTree as JaxTree
from fedml_tpu.scale import pack_cohort as jax_pack_cohort
from fedml_tpu.scale.engine import PlanetRoundLoop as JaxLoop
from fedml_tpu.simulation import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu_torch import models
from fedml_tpu_torch.arguments import Arguments, load_arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.core import devtime
from fedml_tpu_torch.core.aggregation import StreamingAccumulator
from fedml_tpu_torch.core.sys_stats import current_rss_bytes, peak_rss_bytes
from fedml_tpu_torch.core.telemetry import Telemetry
from fedml_tpu_torch.core.topology import EdgeTreeTopology
from fedml_tpu_torch.data import load
from fedml_tpu_torch.data.synthetic import (
    _class_means,
    synthetic_classification_device_per_client,
)
from fedml_tpu_torch.ops import synth_features
from fedml_tpu_torch.scale import ClientRegistry, EdgeAggregationTree, pack_cohort
from fedml_tpu_torch.scale import engine, registry as registry_module
from fedml_tpu_torch.simulation import FedAvgAPI, FedOptAPI
from tests.conftest import make_args
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANET_CONFIG = os.path.join(REPO, "fedml_tpu_torch", "configs", "fedavg_planet_lr.yaml")
COLUMNS = ("num_samples", "speed_tier", "shard_offset", "client_seed", "availability",
           "last_checkin")
# 3 rounds of logistic regression from the same start on the same
# features, f32 on both sides: local SGD and the edge sums round in
# another order in each package (measured ~6e-8)
PARAMS_ATOL = 1e-5
# K2's features: the noise over C*S*dim = 64*64*60 = 245,760 draws has
# standard error 1/sqrt(245,760) = 0.002 on its mean and ~0.0014 on its
# standard deviation; 0.01 is 5-7 of them
STAT_ATOL = 0.01

SIM = dict(dataset="synthetic", model="lr", client_registry_size=600, cohort_size=64,
           edge_num=4, client_num_in_total=600, client_num_per_round=64, comm_round=3,
           epochs=1, batch_size=32, learning_rate=0.1, frequency_of_the_test=1,
           synthetic_train_size=128, synthetic_test_size=64, shuffle=False)


def _args(**kw) -> Arguments:
    a = Arguments()
    for k, v in kw.items():
        setattr(a, k, v)
    a._validate()
    return a


def _api(cls=FedAvgAPI, **kw):
    args = fedml_tpu_torch.init(_args(**dict(SIM, **kw)))
    ds = load(args, device="cpu")
    return cls(args, "cpu", ds, models.create(args, ds.class_num, device="cpu"))


def _params_equal(a, b) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


# -- the registry ------------------------------------------------------------

@pytest.mark.parametrize("size, seed", [(1, 0), (5000, 3), (100_003, 11)])
def test_columns_are_bitwise_the_references(size, seed):
    mine, ref = ClientRegistry(size, seed=seed), JaxRegistry(size, seed=seed)
    for col in COLUMNS:
        a, b = getattr(mine, col), getattr(ref, col)
        assert a.dtype == b.dtype and np.array_equal(a, b), col
    assert mine.nbytes() == ref.nbytes() == 22 * size
    assert mine.total_samples == ref.total_samples
    assert (mine.num_samples >= 20).all() and (mine.num_samples <= 400).all()


def test_shard_offsets_are_prefix_sums():
    r = ClientRegistry(100, seed=0)
    assert r.shard_slice(0) == (0, int(r.num_samples[0]))
    for i in range(1, 100):
        o_prev, n_prev = r.shard_slice(i - 1)
        assert r.shard_slice(i)[0] == o_prev + n_prev
    assert r.total_samples == int(r.num_samples.sum())


def test_cohorts_are_bitwise_the_references():
    mine, ref = ClientRegistry(10_000, seed=1), JaxRegistry(10_000, seed=1)
    for round_idx in (0, 7, 8, 123):
        for k in (1, 256, 10_000):
            a, b = mine.sample_cohort(round_idx, k), ref.sample_cohort(round_idx, k)
            assert a.dtype == b.dtype and np.array_equal(a, b)
        a = mine.sample_available_cohort(round_idx, 256)
        assert np.array_equal(a, ref.sample_available_cohort(round_idx, 256))
        assert np.array_equal(mine.sample_available_cohort(round_idx, 64, hour=5),
                              ref.sample_available_cohort(round_idx, 64, hour=5))
    a = mine.sample_cohort(7, 256)
    assert len(np.unique(a)) == 256 and np.array_equal(a, np.sort(a))
    assert not np.array_equal(a, mine.sample_cohort(8, 256))


def test_sampling_memory_is_o_cohort_on_1m_registry():
    """Floyd's algorithm and the availability sampler never build an
    arange or a mask over the registry (~8 MB and ~1 MB here)."""
    reg = ClientRegistry(1_000_000, seed=0)
    reg.sample_cohort(0, 1000)
    reg.sample_available_cohort(0, 1000)
    for sample in (reg.sample_cohort, reg.sample_available_cohort):
        tracemalloc.start()
        sample(1, 1000)
        _, peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        assert peak < 512 * 1024, f"{sample.__name__} peak {peak} bytes"


def test_client_labels_are_bitwise_the_references():
    mine, ref = ClientRegistry(2000, seed=5), JaxRegistry(2000, seed=5)
    for i in mine.sample_cohort(0, 32):
        a, b = mine.client_labels(int(i), 10), ref.client_labels(int(i), 10)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(a, mine.client_labels(int(i), 10))


def test_memmap_registry_matches_in_ram_and_the_reference(tmp_path):
    ram = ClientRegistry(1_000, seed=9)
    mm = ClientRegistry(1_000, seed=9, memmap_dir=str(tmp_path / "port"))
    ref = JaxRegistry(1_000, seed=9, memmap_dir=str(tmp_path / "jax"))
    for col in COLUMNS:
        assert np.array_equal(getattr(mm, col), getattr(ram, col)), col
        assert np.array_equal(getattr(mm, col), getattr(ref, col)), col
        assert (tmp_path / "port" / f"{col}.npy").exists()
    assert np.array_equal(mm.sample_cohort(3, 64), ref.sample_cohort(3, 64))
    avail = mm.sample_available_cohort(0, 8)
    assert np.array_equal(avail, ref.sample_available_cohort(0, 8))
    mm.record_checkin(int(avail[0]), 4)
    reopened = np.load(tmp_path / "port" / "last_checkin.npy", mmap_mode="r")
    assert int(reopened[int(avail[0])]) == 4
    assert int(ram.last_checkin[int(avail[0])]) == -1


def test_availability_and_checkins():
    reg = ClientRegistry(5_000, seed=3)
    a = reg.is_available(np.arange(5_000), 7)
    assert np.array_equal(a, JaxRegistry(5_000, seed=3).is_available(np.arange(5_000), 7))
    assert 0.5 < float(a.mean()) < 0.68
    assert sum(int(reg.is_available(17, h)) for h in range(24)) == reg.duty_hours
    assert bool(reg.is_available(reg.sample_available_cohort(5, 256), 5).all())
    reg.record_checkin(np.asarray([3, 7]), 12)
    assert int(reg.last_checkin[3]) == int(reg.last_checkin[7]) == 12
    assert (np.delete(reg.last_checkin, [3, 7]) == -1).all()
    with pytest.raises(ValueError, match="sample_available_cohort"):
        ClientRegistry(64, seed=0, duty_hours=1).sample_available_cohort(0, 60, max_draw_factor=2)


def test_registry_validation_and_gauge():
    for kw in (dict(size=0), dict(size=10, min_samples=50, max_samples=20),
               dict(size=10, speed_tiers=0), dict(size=10, duty_hours=25)):
        with pytest.raises(ValueError):
            ClientRegistry(**kw)
    reg = ClientRegistry(100)
    for k in (101, 0):
        with pytest.raises(ValueError, match="out of range"):
            reg.sample_cohort(0, k)
    Telemetry.reset()
    try:
        ClientRegistry(12_345, seed=0)
        assert Telemetry.get_instance()._gauges[("registry_clients", ())] == 12_345
    finally:
        Telemetry.reset()


# -- cohort packing ----------------------------------------------------------

def _plans_equal(a, b) -> None:
    assert (a.cohort_size, a.waste_frac, a.makespan_splits) == (
        b.cohort_size, b.waste_frac, b.makespan_splits)
    assert len(a.groups) == len(b.groups) and a.shape_keys == b.shape_keys
    for g, h in zip(a.groups, b.groups):
        for field in ("client_idx", "valid", "num_samples"):
            x, y = getattr(g, field), getattr(h, field)
            assert x.dtype == y.dtype and np.array_equal(x, y), field
        assert (g.nb, g.bucket, g.real_clients, g.shards) == (h.nb, h.bucket, h.real_clients,
                                                              h.shards)


@pytest.mark.parametrize("case", ["random", "lpt", "lpt_overfull", "shards", "registry"])
def test_pack_cohort_plans_are_the_references(case):
    rng = np.random.RandomState(0)
    kw = {}
    if case == "random":
        sizes, idx = rng.randint(20, 400, 100), rng.permutation(100_000)[:100]
    elif case in ("lpt", "lpt_overfull"):
        n = 64 if case == "lpt" else 96
        sizes, idx = np.full(n, 100), np.arange(n)
        tiers = np.zeros(n, dtype=np.int64)
        tiers[:8 if case == "lpt" else 4] = 2 if case == "lpt" else 4
        kw = dict(speed_tier=tiers, max_group_clients=16)
    elif case == "shards":
        sizes, idx, kw = rng.randint(20, 400, 32), np.arange(32), dict(shard_num=4)
    else:
        reg = ClientRegistry(100_000, seed=0)
        idx = reg.sample_cohort(0, 10_000)
        sizes, kw = reg.num_samples[idx], dict(speed_tier=reg.speed_tier[idx])
    Telemetry.reset()
    try:
        _plans_equal(pack_cohort(sizes, idx, 32, **kw), jax_pack_cohort(sizes, idx, 32, **kw))
    finally:
        Telemetry.reset()
    if case == "lpt_overfull":
        assert all(g.real_clients <= 16 for g in pack_cohort(sizes, idx, 32, **kw).groups)


def test_pow2_census_8_to_512_and_waste_histogram():
    Telemetry.reset()
    try:
        keys = set()
        for cohort in (8, 12, 32, 48, 100, 256, 400, 512):
            keys |= set(pack_cohort(np.full(cohort, 100), np.arange(cohort), 32).shape_keys)
        assert len(keys) <= 7, sorted(keys)
        assert any(k[0] == "cohort_bucket_waste_frac" for k in Telemetry.get_instance()._hists)
    finally:
        Telemetry.reset()


# -- the per-client feature generator (K2's plain version) -------------------

def test_features_are_a_function_of_the_client_and_the_sample():
    reg = ClientRegistry(2_000, seed=5)
    idx = reg.sample_cohort(0, 16)
    b1, ns1 = reg.materialize_group(idx, 4, 32, (12,), 10, device="cpu")
    b2, ns2 = reg.materialize_group(idx, 4, 32, (12,), 10, device="cpu")
    assert np.array_equal(ns1, ns2) and torch.equal(b1.x, b2.x)
    # client idx[3] alone, in another slot of another cohort, at another nb
    other = np.concatenate([reg.sample_cohort(9, 5), idx[3:4]])
    b3, ns3 = reg.materialize_group(other, 8, 32, (12,), 10, device="cpu")
    n = int(ns1[3])
    assert int(ns3[-1]) == n
    a = b1.x[3].reshape(-1, 12)[:n]
    b = b3.x[-1].reshape(-1, 12)[:n]
    assert torch.equal(a, b)
    assert torch.equal(b1.y[3].reshape(-1)[:n], b3.y[-1].reshape(-1)[:n])


def test_materialized_labels_and_masks_are_the_references():
    mine, ref = ClientRegistry(2_000, seed=5), JaxRegistry(2_000, seed=5)
    idx = mine.sample_cohort(2, 24)
    b, ns = mine.materialize_group(idx, 8, 16, (60,), 10, device="cpu")
    jb, jns = ref.materialize_group(idx, 8, 16, (60,), 10)
    assert np.array_equal(ns, jns)
    assert np.array_equal(b.y.numpy(), np.asarray(jb.y)) and b.y.dtype == torch.int64
    assert np.array_equal(b.mask.numpy(), np.asarray(jb.mask))
    assert tuple(b.x.shape) == tuple(jb.x.shape) == (24, 8, 16, 60)


@pytest.mark.parametrize("seed", range(4))
def test_label_packing_is_bitwise_the_references(seed):
    """``pack_labels_np`` fills preallocated arrays; the JAX package pads
    and stacks. Ragged, empty, truncated, int32/int64 and 2-D labels."""
    from fedml_tpu.data.packing import pack_labels_np as jax_pack_labels
    from fedml_tpu_torch.data.packing import pack_labels_np

    rng = np.random.RandomState(seed)
    for trial in range(12):
        C = rng.randint(1, 20)
        if trial % 4 == 3:
            ys = [rng.rand(rng.randint(1, 50), 3).astype(np.float32) for _ in range(C)]
        else:
            ys = [rng.randint(0, 10, rng.randint(0, 100)).astype(
                np.int64 if rng.rand() < 0.5 else np.int32) for _ in range(C)]
        nb = None if trial % 3 == 0 else rng.randint(1, 4)
        for got, want in zip(pack_labels_np(ys, 8, nb), jax_pack_labels(ys, 8, nb)):
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_features_have_the_class_means_and_sigma():
    rng = np.random.RandomState(0)
    y = rng.randint(0, 10, (64, 64))
    seeds = rng.randint(0, 2**31 - 1, 64).astype(np.uint32)
    for sigma in (1.0, 0.5):
        x = synthetic_classification_device_per_client(y, (60,), 10, seeds, sigma=sigma,
                                                       device="cpu")
        means = torch.tensor(_class_means(10, 60, 1234))
        noise = (x - means[torch.tensor(y)]) / sigma
        assert abs(float(noise.mean())) < STAT_ATOL
        assert abs(float(noise.std()) - 1.0) < STAT_ATOL
        # and across the dims of one sample, so the Box-Muller pairs are
        # not correlated: 4,096 samples a dim give each correlation a
        # standard error of 1/64; 0.08 is 5 of them (max of 1,770 pairs)
        corr = np.corrcoef(noise.reshape(-1, 60).numpy().T)
        assert np.abs(corr - np.eye(60)).max() < 0.08
    bf = synthetic_classification_device_per_client(y, (6, 10), 10, seeds, dtype=torch.bfloat16,
                                                    device="cpu")
    assert bf.dtype == torch.bfloat16 and tuple(bf.shape) == (64, 64, 6, 10)


def test_philox_is_the_published_generator_and_the_words_feed_the_features():
    """Random123's known-answer vectors for Philox4x32-10, then one
    element's features rebuilt by hand from its words."""
    t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    for ctr, key, want in (
            ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
            ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6,
                                                     0x6D5451FD)),
            ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
             (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))):
        got = synth_features.philox4x32_10(tuple(map(t, ctr)), tuple(map(t, key)))
        assert [int(w) for w in got] == list(want)
    seeds = torch.tensor([3, 2**32 - 1])
    words = synth_features.philox_words_reference(seeds, 5, 3)
    assert tuple(words.shape) == (2, 5, 3, 4)
    c, s, j = 1, 4, 1
    direct = synth_features.philox4x32_10((t(s), t(j), t(0), t(0)), (t(2**32 - 1), t(0)))
    assert [int(w) for w in direct] == words[c, s, j].tolist()
    y = torch.tensor([[1, 2, 3, 4, 5], [6, 7, 8, 9, 0]])
    means = torch.tensor(_class_means(10, 10, 1234))
    x = synth_features.synth_features_reference(y, means, seeds, 0.5)
    w = words[c, s, j]
    noise = torch.cat([*synth_features.box_muller(w[0:1], w[1:2]),
                       *synth_features.box_muller(w[2:3], w[3:4])])
    assert torch.equal(x[c, s, 4 * j:4 * j + 4],
                       means[y[c, s], 4 * j:4 * j + 4] + noise * torch.tensor(0.5))


def test_feature_wrapper_takes_cpu_tensors_and_refuses_them_in_the_kernel():
    synth_features.SYNTH_KERNEL.reset_launches()
    y = torch.zeros(2, 3, dtype=torch.int64)
    out = synth_features.synth_features(y, torch.zeros(10, 8), torch.tensor([1, 2]), 1.0)
    assert tuple(out.shape) == (2, 3, 8) and synth_features.SYNTH_KERNEL.launches == 0
    with pytest.raises(ValueError, match="one CUDA device"):
        synth_features.SYNTH_KERNEL(y, torch.zeros(10, 8), torch.tensor([1, 2]), 1.0)


@pytest.mark.parametrize("clients, samples, dim, ok", [
    (2**16, 2**15 - 1, 60, True),     # 2^31 - 2^16 rows
    (1, 2**31 - 1, 60, True),         # the grid's last row
    (2**16, 2**15, 60, False),        # 2^31 rows: one past it
    (4096, 128, 2**31 - 4, True),     # (dim + 3) / 4 still fits a 32-bit int
    (4096, 128, 2**31 - 3, False),
])
def test_feature_kernel_shape_check_pins_the_grid_limits(clients, samples, dim, ok):
    """The kernel runs one (client, sample) row per thread group with rows
    on the grid's x dimension (up to 2^31 - 1 of them, indexed in 32
    bits); its wrapper raises past that, before anything launches."""
    if ok:
        synth_features.check_shape(clients, samples, dim)
    else:
        with pytest.raises(ValueError, match="exceed"):
            synth_features.check_shape(clients, samples, dim)


def _row_div(s: int):
    """``row_div`` of ``csrc/synth_features.cu``: l = ceil(log2 s), m =
    floor(2^32 (2^l - s) / s) + 1, in exact integers as the host does."""
    l = 0
    while (1 << l) < s:
        l += 1
    return ((1 << 32) * ((1 << l) - s)) // s + 1, l


def _row_split(rows: np.ndarray, s: int):
    """``row_split`` in uint32 arithmetic, emulated in uint64: the
    client (umulhi(m, row) + row) >> l and the sample row - client * s."""
    m, l = _row_div(s)
    assert 0 < m < 2**32
    hi = (np.uint64(m) * rows) >> np.uint64(32)
    total = hi + rows
    assert int(total.max()) < 2**32, "the sum must stay in 32 bits"
    client = (total & np.uint64(0xFFFFFFFF)) >> np.uint64(l)
    return client, (rows - client * np.uint64(s)) & np.uint64(0xFFFFFFFF)


@pytest.mark.parametrize("divisors", [
    [1, 3, 7, 100, 3000, 60_000],
    [2**k - 1 for k in range(2, 31)],
    [2**k + 1 for k in range(1, 31)],
    [2**k for k in range(0, 31)],
    [2**31 - 1, 2**31 - 2, 2**30 + 12_345, 1_000_003],
], ids=["small", "pow2-1", "pow2+1", "pow2", "large"])
def test_feature_kernel_row_division_is_exact(divisors):
    """The kernels split a row of the ``[C * S]`` rows into (client,
    sample) by a multiply-high with a constant the host computes, not a
    division. Emulated here, it equals exact division for every divisor
    and every row the grid can hold (rows below 2^31 - 1): edges, the
    multiples of ``S`` and their neighbours up to the last row, and
    random rows. The card check's ``S = 100`` case holds the kernel's
    own words to the plain version."""
    rng = np.random.default_rng(0)
    last = 2**31 - 2
    for s in divisors:
        mult = np.arange(1, 50, dtype=np.uint64) * np.uint64(s)
        top = last // s * s
        rows = np.concatenate([
            np.array([0, 1, 2, last - 1, last], dtype=np.uint64),
            np.array([s - 1, s, s + 1], dtype=np.uint64),
            mult - np.uint64(1), mult, mult + np.uint64(1),
            np.array([max(top - 1, 0), top, min(top + 1, last)], dtype=np.uint64),
            rng.integers(0, last + 1, 20_000, dtype=np.uint64),
        ])
        rows = rows[rows <= np.uint64(last)]
        client, sample = _row_split(rows, s)
        np.testing.assert_array_equal(client, rows // np.uint64(s), err_msg=f"S {s}")
        np.testing.assert_array_equal(sample, rows % np.uint64(s), err_msg=f"S {s}")
    with open(os.path.join(REPO, "fedml_tpu_torch", "ops", "csrc", "synth_features.cu")) as f:
        src = f.read()
    for line in ("const uint64_t m = ((1ull << 32) * ((1ull << l) - s)) / s + 1;",
                 "ci = (__umulhi(d.m, row) + row) >> d.l;", "si = row - ci * d.s;"):
        assert line in src, f"the kernel's row division changed: {line!r} not in the source"


# -- the edge tree -----------------------------------------------------------

def _template():
    return {"w": torch.zeros(13, 5), "b": torch.zeros(7)}


def _uploads(n: int, seed: int):
    rng = np.random.RandomState(seed)
    return [({"w": rng.normal(0, 1, (13, 5)).astype(np.float32),
              "b": rng.normal(0, 1, (7,)).astype(np.float32)}, float(w))
            for w in rng.randint(1, 300, n)]


def _port(theta):
    return {k: torch.tensor(v) for k, v in theta.items()}


def test_tree_is_bitwise_the_flat_fold_and_the_references_tree():
    uploads = _uploads(20, 2)
    flat = StreamingAccumulator(_template())
    for theta, w in uploads:
        flat.fold(_port(theta), w)
    want = flat.finalize()
    rng = np.random.RandomState(2)
    for edges in (2, 3, 8):
        tree = EdgeAggregationTree(_template(), edges)
        jtree = JaxTree({k: jax.numpy.zeros(v.shape) for k, v in _template().items()}, edges)
        for i in rng.permutation(len(uploads)):
            theta, w = uploads[i]
            tree.acc_for(int(i)).fold(_port(theta), w)
            jtree.acc_for(int(i)).fold({k: jax.numpy.asarray(v) for k, v in theta.items()}, w)
        got, ref = tree.finalize(), jtree.finalize()
        for k in want:
            assert torch.equal(got[k], want[k]), (edges, k)
            assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), (edges, k)


def test_tree_totals_empty_edges_and_assignment():
    tree = EdgeAggregationTree(_template(), 5)
    tree.acc_for(0).fold(_port(_uploads(1, 0)[0][0]), 10.0)
    tree.acc_for(1).fold(_port(_uploads(1, 1)[0][0]), 20.0)
    assert tree.count == 2 and tree.total_w == 30.0
    mean = tree.running_mean()
    assert set(mean) == {"w", "b"} and tree.edge_of(6) == 1
    out = tree.finalize()  # 3 empty edges must not poison the root
    assert all(torch.isfinite(v).all() for v in out.values())
    tree.reset()
    assert tree.count == 0 and tree.running_mean() is None
    with pytest.raises(RuntimeError):
        tree.finalize()
    asn = EdgeAggregationTree.assign_by_load([100, 90, 5, 5, 5, 5], 2)
    assert asn == JaxTree.assign_by_load([100, 90, 5, 5, 5, 5], 2)
    assert EdgeAggregationTree(_template(), 2, assignment=asn).edge_of(0) == asn[0]
    topo = EdgeTreeTopology(4)
    topo.generate_topology()
    assert topo.get_in_neighbor_idx_list(0) == [1, 2, 3, 4]
    assert topo.get_out_neighbor_idx_list(2) == [0] and topo.get_in_neighbor_idx_list(3) == []
    assert topo.topology[0][0] == 0 and np.allclose(topo.topology[0][1:], 0.25)
    with pytest.raises(ValueError):
        EdgeTreeTopology(0)


# -- the registry simulation -------------------------------------------------

def _jax_features(y, feature_shape, num_classes, client_seeds, sigma=1.0, means_seed=1234,
                  dtype=None, device="cpu"):
    """The JAX package's per-client features for the same labels and
    seeds, handed to the port in place of its own generator."""
    x = jax_device_per_client(np.asarray(y), tuple(feature_shape), num_classes,
                              np.asarray(client_seeds), sigma=sigma, means_seed=means_seed)
    return torch.tensor(np.asarray(x), device=device).to(dtype or torch.float32)


def test_three_rounds_match_the_reference_on_the_same_features(monkeypatch):
    jargs = fedml_tpu.init(make_args(**SIM))
    jds = jax_load(jargs)
    japi = JaxFedAvgAPI(jargs, None, jds, jax_models.create(jargs, jds.class_num))
    start = params_from_flax(jax.tree.map(np.asarray, japi.global_params))
    japi.train()
    want = params_from_flax(jax.tree.map(np.asarray, japi.global_params))

    monkeypatch.setattr(registry_module, "synthetic_classification_device_per_client",
                        _jax_features)
    api = _api()
    for split in ("train_data_global", "test_data_global"):
        a, b = getattr(api.dataset, split), getattr(jds, split)
        assert np.array_equal(a.x.numpy(), np.asarray(b.x))
        assert np.array_equal(a.y.numpy(), np.asarray(b.y))
    api.global_params = {k: v.clone() for k, v in start.items()}
    api.train()
    moved = max(float((want[k] - start[k]).abs().max()) for k in want)
    assert moved > 1e-2
    for k in want:
        np.testing.assert_allclose(api.global_params[k].numpy(), want[k].numpy(),
                                   atol=PARAMS_ATOL, err_msg=k)
    assert [h["round"] for h in api.history] == [h["round"] for h in japi.history] == [0, 1, 2]
    for h, j in zip(api.history, japi.history):
        for key in ("train_loss", "test_loss", "train_loss_cohort"):
            np.testing.assert_allclose(h[key], j[key], rtol=1e-5, err_msg=key)
    stats, jstats = api.pipeline_stats, japi.pipeline_stats
    for key in ("registry_clients", "registry_bytes", "cohort_size", "edge_num", "rounds",
                "trace_count", "shape_keys", "waste_frac_mean"):
        assert stats[key] == jstats[key], key


def test_tree_equals_flat_and_runs_are_deterministic():
    tree = _api(shuffle=True)
    tree.train()
    again = _api(shuffle=True)
    again.train()
    flat = _api(shuffle=True, edge_flat_fold=True)
    flat.train()
    assert _params_equal(tree.global_params, again.global_params)
    assert _params_equal(tree.global_params, flat.global_params)
    assert tree.history[-1]["train_loss"] < tree.history[0]["train_loss"]
    # the tree folds each edge's term, then merges each non-empty edge
    assert [f - 4 for f in tree.pipeline_stats["round_folds"]] == flat.pipeline_stats[
        "round_folds"]


def test_resumed_run_is_bitwise_the_straight_run(tmp_path):
    straight = _api(shuffle=True)
    straight.train()
    stopped = _api(shuffle=True, comm_round=2, checkpoint_dir=str(tmp_path), checkpoint_freq=1)
    stopped.train()
    assert sorted(os.listdir(tmp_path)) == ["0", "1"]
    resumed = _api(shuffle=True, checkpoint_dir=str(tmp_path), checkpoint_freq=1)
    resumed.train()
    assert _params_equal(resumed.global_params, straight.global_params)
    assert [h["round"] for h in resumed.history] == [2]
    strip = lambda h: {k: v for k, v in h.items()  # noqa: E731
                       if k not in ("round_time_s", "train_time_s")}
    assert strip(resumed.history[0]) == strip(straight.history[-1])


def test_stats_spans_and_a_warm_rerun_adds_no_shape():
    devtime.reset()
    api = _api(comm_round=2, edge_num=0)
    api.train()
    stats = api.pipeline_stats
    assert stats["loop"] == "planet" and stats["registry_clients"] == 600
    assert stats["edge_num"] == 0 and stats["rounds"] == 2
    assert stats["trace_count"] == len(stats["shape_keys"]) > 0
    assert len(stats["round_spans_s"]) == len(stats["round_samples"]) == 2
    names = {e["executable"] for e in devtime.ring_snapshot()}
    assert {"planet.group_fn", "agg.fold_tree"} <= names
    traces = stats["trace_count"]
    api.train()
    assert api.pipeline_stats["trace_count"] == traces
    assert api._planet_loop is not None
    # the flat fold: one fold per group (edge_num 0 routes all to edge 0)
    groups = sum(1 for e in devtime.ring_snapshot() if e["executable"] == "planet.group_fn")
    assert sum(api.pipeline_stats["round_folds"]) + sum(stats["round_folds"]) == groups


def test_group_fn_matches_the_edge_einsum_and_runs_on_a_mesh():
    api = _api()
    loop = engine.PlanetRoundLoop(api)
    idx = np.asarray([5, 6, 7])
    group = pack_cohort(loop.registry.num_samples[idx], idx, 32).groups[0]
    batches, _ = loop.registry.materialize_group(group.client_idx, group.nb, 32, (60,), 10,
                                                 device="cpu")
    fn = engine.build_group_fn(api._local_train)
    onehot = torch.zeros(group.bucket, 2)
    onehot[torch.arange(group.bucket), torch.as_tensor(group.client_idx % 2)] = 1.0
    ns, valid = torch.tensor(group.num_samples), torch.tensor(group.valid)
    gp, terms, edge_w, summed = fn(api.global_params, batches, ns, valid, onehot, None)
    assert gp is api.global_params
    stacked, _ = api._local_train(api.global_params, batches, None, None)
    w = ns * valid
    for e in range(2):
        want = torch.cat([(w[:, None] * stacked[k].reshape(group.bucket, -1)
                           * onehot[:, e:e + 1]).sum(0) for k in gp])
        torch.testing.assert_close(terms[e], want)
    assert edge_w.tolist() == ((group.num_samples * group.valid) @ onehot.numpy()).tolist()
    assert float(summed["count"]) == float(group.num_samples.sum())
    # on a fed mesh of one rank (its lane the whole group): the same terms
    import torch.distributed as dist

    from fedml_tpu_torch.parallel.layout import build_fed_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = build_fed_mesh({"data": 1, "fsdp": 1}, 1, "cpu")
        on_mesh = engine.build_group_fn(api._local_train, mesh=mesh, at_use=lambda p: p)
        _, mterms, medge_w, msummed = on_mesh(api.global_params, batches, ns, valid, onehot,
                                              None)
    finally:
        dist.destroy_process_group()
    assert torch.equal(mterms, terms) and torch.equal(medge_w, edge_w)
    assert float(msummed["count"]) == float(summed["count"])


@pytest.mark.parametrize("kw", [
    dict(client_registry_size=100, cohort_size=200),
    dict(client_registry_size=100, cohort_size=10, edge_num=11),
    dict(training_type="cross_silo", backend="LOCAL", client_registry_size=100),
    dict(client_registry_size="nope"),
    dict(edge_num=-1),
    dict(edge_plane="bogus"),
])
def test_knob_validation_is_the_references(kw):
    with pytest.raises(ValueError) as want:
        make_args(**kw)
    with pytest.raises(ValueError) as got:
        _args(**kw)
    assert str(got.value) == str(want.value)


def test_knobs_that_validate_and_the_ones_that_wait():
    assert _args(training_type="cross_silo", edge_num=4).edge_num == 4
    a = _args(client_registry_size="600", cohort_size=64, client_num_per_round=8)
    assert (a.client_registry_size, a.cohort_size, a.edge_plane) == (600, 64, "inproc")
    # the edge tier over ranks is the cross-silo scenario's: simulation
    # refuses it with the JAX package's words, cross-silo takes it
    with pytest.raises(ValueError, match="edge_plane=ranks needs training_type=cross_silo"):
        _args(edge_plane="ranks")
    assert _args(training_type="cross_silo", edge_plane="ranks", edge_num=2).edge_plane == "ranks"


_FAKE = dict(server_aggregator=None, robust=None, _keep_stacked=False, algorithm="FedAvg",
             mesh=None)


@pytest.mark.parametrize("kw", [
    dict(server_aggregator=object()),
    dict(robust=object()),
    dict(_keep_stacked=True, algorithm="SFedAvg"),
    dict(sim_mode="sequential"),
    dict(algorithm="FedOpt"),
    dict(task="nwp"),
    dict(server_aggregator=object(), robust=object(), sim_mode="sequential", task="nwp",
         algorithm="FedNova"),
])
def test_round_loop_refusals_are_the_references_word_for_word(kw):
    fields = dict(_FAKE, **{k: v for k, v in kw.items() if k in _FAKE})
    api = SimpleNamespace(
        args=SimpleNamespace(defense_type="median", sim_mode=kw.get("sim_mode", "vectorized")),
        dataset=SimpleNamespace(task=kw.get("task", "classification")), **fields)
    with pytest.raises(ValueError) as want:
        JaxLoop._validate(api)
    with pytest.raises(ValueError) as got:
        engine.PlanetRoundLoop._validate(api)
    assert str(got.value) == str(want.value)


def test_unsupported_api_raises_and_a_supported_one_does_not():
    args = fedml_tpu_torch.init(_args(**dict(SIM, federated_optimizer="FedOpt", server_lr=0.1)))
    ds = load(args, device="cpu")
    api = FedOptAPI(args, "cpu", ds, models.create(args, ds.class_num, device="cpu"))
    with pytest.raises(ValueError, match="FedOpt"):
        api.train()
    assert engine.planet_knobs_active(args) and not engine.planet_knobs_active(_args())
    engine.PlanetRoundLoop(_api(federated_optimizer="FedProx", fedprox_mu=0.1))


def test_loader_builds_no_per_client_state_and_its_holdouts_are_the_references():
    kw = dict(dataset="synthetic", model="lr", client_registry_size=50_000, cohort_size=100,
              client_num_in_total=50_000, client_num_per_round=100, batch_size=32)
    tracemalloc.start()
    ds = load(_args(**kw), device="cpu")
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert ds.client_num == 50_000 and ds.packed_train is None
    assert ds.train_data_local_dict == {} and ds.train_data_local_num_dict == {}
    assert peak < 64 * 1024 * 1024, peak
    jds = jax_load(make_args(**kw))
    for split in ("train_data_global", "test_data_global"):
        a, b = getattr(ds, split), getattr(jds, split)
        for field in ("x", "y", "mask"):
            assert np.array_equal(getattr(a, field).numpy(), np.asarray(getattr(b, field)))
    mnist = load(_args(**dict(kw, dataset="mnist")), device="cpu")
    assert tuple(mnist.test_data_global.x.shape[2:]) == (28, 28, 1)


@pytest.mark.parametrize("kw, match", [
    (dict(dataset="shakespeare", model="rnn"), "classification"),
    (dict(dataset="synthetic", poison_type="label_flip"), "poison_type"),
])
def test_registry_dataset_refusals(kw, match):
    args = _args(**dict(kw, client_registry_size=1000, cohort_size=10,
                        client_num_per_round=10, batch_size=8))
    with pytest.raises(ValueError, match=match):
        load(args, device="cpu")


def test_1m_registry_round_memory_is_o_cohort():
    """A 1M-client registry round: the columns cost 22 MB, and sampling,
    packing and materializing a 1k cohort stays under a cohort-scale RSS
    bound (nothing the size of the registry materializes)."""
    reg = ClientRegistry(1_000_000, seed=0)
    assert reg.nbytes() == 22_000_000
    idx = reg.sample_cohort(0, 1000)
    plan = pack_cohort(reg.num_samples[idx], idx, 32, speed_tier=reg.speed_tier[idx])
    rss0 = current_rss_bytes()
    for g in plan.groups:
        reg.materialize_group(g.client_idx, g.nb, 32, (12,), 10, device="cpu")
    assert rss0 > 0 and peak_rss_bytes() >= rss0
    # the cohort's features are ~25 MB; the plain generator's int64
    # temporaries a few times that. An O(registry x data) path would be GBs
    assert current_rss_bytes() - rss0 < 256 * 1024 * 1024


def test_planet_config_is_the_benchs_and_needs_a_card_unless_told(monkeypatch):
    a = load_arguments(PLANET_CONFIG)
    want = dict(dataset="synthetic", model="lr", client_registry_size=1_000_000,
                cohort_size=10_000, edge_num=4, client_num_in_total=1_000_000,
                client_num_per_round=10_000, epochs=1, batch_size=32, learning_rate=0.1,
                synthetic_train_size=512, synthetic_test_size=256, matmul_precision="default")
    assert {k: getattr(a, k) for k in want} == want
    ja = JaxArguments(argparse.Namespace(yaml_config_file=PLANET_CONFIG))
    assert {k: getattr(ja, k) for k in want} == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = _args(**dict(SIM, comm_round=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fedml_tpu_torch.run_simulation(args=small)
    assert fedml_tpu_torch.run_simulation(device="cpu", args=small)["round"] == 0
