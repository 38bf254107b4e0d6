"""The robust aggregation planes: the port's ``RobustAggregator`` against the JAX one.

The clip (one K3 launch on the card, the plain version here) within
1e-6 of the JAX package's largest magnitude in f32 (XLA may contract
``g + d * s`` into an FMA; the norms are reduced in another order), and
every clipped delta's norm at most the bound; weak DP at stddev 0 the
clip bitwise within the port and the JAX package's to the same 1e-6;
the coordinate-wise median bitwise the JAX package's for odd and even
cohorts (``(lo + hi) * 0.5``, as ``jnp.median``). Weak DP's noise comes
from a generator seeded by (run seed, round): the same pair draws the
same noise, another round other noise. Two FedAvg rounds with clipping
and with the median run in float64 in both packages and agree to 1e-12.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import models as jax_models
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.core import aggregation as jagg
from fedml_tpu.data import load as jax_load
from fedml_tpu.simulation import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu_torch import models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.core import aggregation as agg
from fedml_tpu_torch.ops import robust_term as rt
from fedml_tpu_torch.simulation import FedAvgAPI
from test_torch_fedavg_api import SLICE, _port_dataset, _set, _to_f64
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = {"a": (4, 3), "b": (3,), "c": (2, 5, 2)}
TOL = 1e-6
# float64 on both sides: the packages agree to rounding, far below this
PARAMS_ATOL = 1e-12


def _stacked(C, seed=0, spread=(0.05, 3.0)):
    rng = np.random.RandomState(seed)
    g = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    scale = rng.choice(spread, size=C).astype(np.float32)
    st = {k: (g[k][None] + rng.normal(size=(C,) + s).astype(np.float32)
              * scale.reshape((-1,) + (1,) * len(s))).astype(np.float32)
          for k, s in SHAPES.items()}
    w = rng.randint(1, 100, C).astype(np.float32)
    return g, st, w / w.sum()


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _args(**kw):
    base = dict(defense_type="norm_diff_clipping", norm_bound=2.0, stddev=0.0)
    base.update(kw)
    return SimpleNamespace(**base)


def _close(got, want):
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=TOL, atol=TOL * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.parametrize("C", [1, 5, 32])
def test_the_clip_is_the_references_and_bounds_every_delta(C):
    g, st, _ = _stacked(C, seed=C)
    port, ref = agg.RobustAggregator(_args()), jagg.RobustAggregator(_args())
    got = port.clip_updates(_t(st), _t(g))
    _close(got, ref.clip_updates(_j(st), _j(g)))
    flat = torch.cat([(got[k] - torch.tensor(g[k])[None]).reshape(C, -1) for k in SHAPES], 1)
    before = torch.cat([(torch.tensor(st[k]) - torch.tensor(g[k])[None]).reshape(C, -1)
                        for k in SHAPES], 1)
    norms, raw = flat.norm(dim=1), before.norm(dim=1)
    assert bool((norms <= 2.0 * (1 + 1e-6)).all())
    keep = raw <= 2.0  # deltas inside the bound pass through as they were
    assert torch.equal(flat[keep], before[keep])
    assert rt.TERM_KERNEL.launches == 0


@pytest.mark.parametrize("C", [3, 4, 32])
def test_weak_dp_at_zero_is_the_clip_bitwise_and_the_references(C):
    g, st, w = _stacked(C, seed=10 + C)
    clip = agg.RobustAggregator(_args()).aggregate(_t(st), torch.tensor(w), _t(g))
    dp = agg.RobustAggregator(_args(defense_type="weak_dp")).aggregate(
        _t(st), torch.tensor(w), _t(g), agg.derive_defense_rng(0, 3, device="cpu"))
    for k in SHAPES:
        assert torch.equal(clip[k], dp[k])
    want = jagg.RobustAggregator(_args(defense_type="weak_dp")).aggregate(
        _j(st), jnp.asarray(w), _j(g), jax.random.PRNGKey(0))
    _close(dp, want)


@pytest.mark.parametrize("C", [1, 2, 5, 8, 32])
def test_the_median_is_the_references_bitwise(C):
    _, st, w = _stacked(C, seed=20 + C)
    got = agg.RobustAggregator(_args(defense_type="median")).aggregate(
        _t(st), torch.tensor(w), _t(_stacked(C)[0]))
    want = jagg.RobustAggregator(_args(defense_type="median")).aggregate(
        _j(st), jnp.asarray(w), _j(_stacked(C)[0]))
    for k in SHAPES:
        assert np.array_equal(got[k].numpy().view(np.int32),
                              np.asarray(want[k]).view(np.int32)), k
    if C % 2 == 0:  # torch.median would take the lower middle
        lower = torch.tensor(st["c"]).median(dim=0).values
        assert not torch.equal(lower, got["c"])


def test_weak_dp_noise_repeats_per_seed_and_round_and_differs_across_them():
    g, st, w = _stacked(4, seed=3)
    dp = agg.RobustAggregator(_args(defense_type="weak_dp", stddev=0.158))

    def run(seed, rnd):
        return dp.aggregate(_t(st), torch.tensor(w), _t(g), agg.derive_defense_rng(seed, rnd, device="cpu"))

    a, b = run(0, 1), run(0, 1)
    assert all(torch.equal(a[k], b[k]) for k in SHAPES)
    for other in (run(0, 2), run(1, 1)):
        assert not any(torch.equal(a[k], other[k]) for k in SHAPES)
    with pytest.raises(ValueError, match="weak_dp needs a per-round rng"):
        dp.aggregate(_t(st), torch.tensor(w), _t(g))
    big = {"w": torch.zeros(200_000)}
    noise = dp.add_noise(big, agg.derive_defense_rng(5, 7, device="cpu"))["w"]
    assert abs(float(noise.std()) / 0.158 - 1) < 0.02 and abs(float(noise.mean())) < 2e-3


@pytest.mark.parametrize("kw", [dict(defense_type="krum"), dict(norm_bound=0.0),
                                dict(stddev=-0.1)])
def test_the_aggregators_errors_are_the_references(kw):
    with pytest.raises(ValueError) as want:
        jagg.RobustAggregator(_args(**kw))
    with pytest.raises(ValueError) as got:
        agg.RobustAggregator(_args(**kw))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("defense", [None, "norm_diff_clipping", "weak_dp", "median", "krum"])
def test_needs_full_cohort_is_the_references(defense):
    for server in (None, object()):
        args = SimpleNamespace(defense_type=defense)
        try:
            want = jagg.needs_full_cohort(args, server)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                agg.needs_full_cohort(args, server)
            assert str(got.value) == str(e)
            continue
        assert agg.needs_full_cohort(args, server) == want


def _two_rounds(defense: str):
    kw = dict(SLICE, comm_round=2, defense_type=defense, norm_bound=0.05)
    with jax.enable_x64(True):
        jargs = fedml_tpu.init(_set(JaxArguments(), **kw))
        jds = jax_load(jargs)
        for split in ("packed_train", "packed_test", "train_data_global", "test_data_global"):
            setattr(jds, split, _to_f64(getattr(jds, split)))
        japi = JaxFedAvgAPI(jargs, None, jds, jax_models.create(jargs, jds.class_num))
        japi.global_params = jax.tree.map(lambda a: a.astype(jnp.float64), japi.global_params)
        start = params_from_flax(jax.tree.map(np.asarray, japi.global_params))
        japi.train()
        want = params_from_flax(jax.tree.map(np.asarray, japi.global_params))
    targs = fedml_tpu_torch.init(_set(Arguments(), **kw))
    tds = _port_dataset(jds)
    tapi = FedAvgAPI(targs, "cpu", tds, models.create(targs, tds.class_num, device="cpu"))
    assert isinstance(tapi.robust, agg.RobustAggregator)
    tapi.global_params = start
    tapi.train()
    return start, want, tapi, japi


@pytest.mark.parametrize("defense", ["norm_diff_clipping", "median"])
def test_two_defended_rounds_match_jax_in_float64(defense):
    start, want, tapi, japi = _two_rounds(defense)
    moved = max(float((want[k] - start[k]).abs().max()) for k in want)
    assert moved > 1e-3
    for k in want:
        assert tapi.global_params[k].dtype == torch.float64
        np.testing.assert_allclose(tapi.global_params[k].numpy(), want[k].numpy(),
                                   atol=PARAMS_ATOL, err_msg=k)
    for th, jh in zip(tapi.history, japi.history):
        for key in ("train_loss", "test_loss", "train_loss_cohort"):
            np.testing.assert_allclose(th[key], jh[key], rtol=1e-9, err_msg=key)
    if defense == "norm_diff_clipping":  # the clip bit: every delta is held to 0.05
        total = float(sum(((tapi.global_params[k] - start[k]) ** 2).sum() for k in start)) ** 0.5
        assert total <= 2 * 0.05 * (1 + 1e-9)
