"""The fork's defenses: S-FedAvg, HS-FedAvg and the anomaly screen against the JAX package.

- S-FedAvg: the reputation-biased sampling bitwise the JAX package's
  given the same ``phi``; one permutation's Shapley marginals equal the
  JAX package's (float64 on both sides, where both score the same
  prefix models); the whole post-round update (the convergence test,
  the estimate, ``sv`` and ``phi``) equal when both packages are driven
  through the same permutations; a run stopped and resumed is bitwise the
  straight run, ``phi`` and ``sv`` included.
- HS-FedAvg: the FFT amplitude normalizer within 1e-5 of the JAX
  package's (f32 FFTs in both: their last bits differ); two rounds of the
  linear model on images, trained in float64, agree to 1e-6, since both
  packages normalize the images in f32 (the reference casts to f32) and
  the FFTs' last f32 bits differ; non-image data and the sequential mode
  are refused.
- ``AnomalyScreen``: on a scripted sequence of uploads, the same norms
  (to 1e-6) and scores (to 1e-5: the norms reduce in another order and the
  score's ``ratio - 1`` cancels), quarantine decisions, releases and reputations as the JAX
  package's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import models as jax_models
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.core import defense as jdef
from fedml_tpu.core.aggregation import stack_pytrees
from fedml_tpu.core.types import Batches as JaxBatches
from fedml_tpu.data import load as jax_load
from fedml_tpu.simulation import defenses as jsim
from fedml_tpu_torch import models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.core import defense
from fedml_tpu_torch.core.types import Batches
from fedml_tpu_torch.data import load
from fedml_tpu_torch.simulation import HSFedAvgAPI, SFedAvgAPI, SimulatorSingleProcess
from fedml_tpu_torch.simulation.defenses import make_hs_normalizer
from test_torch_fedavg_api import SLICE, _port_dataset, _set, _to_f64
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

S_KW = dict(SLICE, federated_optimizer="SFedAvg", client_num_in_total=8, client_num_per_round=4,
            synthetic_train_size=480, comm_round=2, epochs=1, valid_batches=2)


def _jax_world(**kw):
    """A JAX API and the port's twin on the JAX loader's packed arrays, in
    float64."""
    jargs = fedml_tpu.init(_set(JaxArguments(), **kw))
    jds = jax_load(jargs)
    for split in ("packed_train", "packed_test", "train_data_global", "test_data_global"):
        setattr(jds, split, _to_f64(getattr(jds, split)))
    targs = fedml_tpu_torch.init(_set(Arguments(), **kw))
    tds = _port_dataset(jds)
    return jargs, jds, targs, tds


def _stacked(japi, C, seed):
    """C perturbed copies of the JAX API's params, as the JAX package's
    stacked tree and the port's stacked dict (float64)."""
    rng = np.random.RandomState(seed)
    base = jax.tree.map(lambda a: np.asarray(a, np.float64), japi.global_params)
    trees = [jax.tree.map(lambda a: a + rng.normal(size=a.shape) * 0.3, base) for _ in range(C)]
    ports = [params_from_flax(t) for t in trees]
    return (stack_pytrees([jax.tree.map(jnp.asarray, t) for t in trees]),
            {k: torch.stack([p[k] for p in ports]) for k in ports[0]})


def test_sfedavg_sampling_is_bitwise_the_references_given_phi():
    with jax.enable_x64(True):
        jargs, jds, targs, tds = _jax_world(**S_KW)
        japi = jsim.SFedAvgAPI(jargs, None, jds, jax_models.create(jargs, jds.class_num))
    tapi = SFedAvgAPI(targs, "cpu", tds, models.create(targs, tds.class_num, device="cpu"))
    rng = np.random.RandomState(0)
    for r in range(6):
        phi = rng.normal(size=8) * 2
        japi.phi, tapi.phi = phi.copy(), phi.copy()
        got, want = tapi._client_sampling(r, 8, 4), japi._client_sampling(r, 8, 4)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    np.testing.assert_array_equal(tapi._client_sampling(3, 8, 8), np.arange(8, dtype=np.int32))
    for d, c in (([], 4), ([0.1] * 5, 4), ([0.1, 0.001, 0.001, 0.001, 0.001, 0.001], 4)):
        assert tapi._is_approached(d, c) == japi._is_approached(d, c)


def test_shapley_marginals_and_the_post_round_update_are_the_references(monkeypatch):
    C = 4
    with jax.enable_x64(True):
        jargs, jds, targs, tds = _jax_world(**S_KW, score_method="F1", target_label=3)
        japi = jsim.SFedAvgAPI(jargs, None, jds, jax_models.create(jargs, jds.class_num))
        jst, tst = _stacked(japi, C, seed=1)
        tapi = SFedAvgAPI(targs, "cpu", tds, models.create(targs, tds.class_num, device="cpu"))
        weights = np.asarray([0.1, 0.4, 0.2, 0.3])
        perms = [np.random.RandomState(s).permutation(C) for s in range(40)]
        for perm in perms[:5]:
            want = np.asarray(japi._shapley_perm(jst, jnp.asarray(weights), jnp.asarray(perm),
                                                 japi.val_data))
            got = tapi._shapley_perm(tst, torch.tensor(weights), torch.tensor(perm),
                                     tapi.val_data).numpy()
            np.testing.assert_allclose(got, want, atol=1e-12)
        idx = np.array([5, 0, 2, 7])

        class Given:
            def __init__(self, seed):
                self.it = iter(perms)

            def permutation(self, n):
                return next(self.it)

        monkeypatch.setattr(np.random, "default_rng", Given)
        japi._post_round_stacked(jst, idx, jax.random.PRNGKey(0))
        monkeypatch.undo()
    tapi._post_round_stacked(tst, idx, 0, perms=perms)
    assert tapi.sv_history[-1]["perms"] == japi.sv_history[-1]["perms"] >= C + 2
    np.testing.assert_allclose(tapi.sv, japi.sv, atol=1e-12)
    np.testing.assert_allclose(tapi.phi, japi.phi, atol=1e-12)


def _s_api(ckpt_dir=None, **kw):
    args = _set(Arguments(), **dict(dict(dataset="mnist", synthetic_train_size=320,
                                         synthetic_test_size=64, model="lr",
                                         client_num_in_total=8, client_num_per_round=4,
                                         epochs=1, batch_size=16, learning_rate=0.1,
                                         federated_optimizer="SFedAvg", sv_max_perms=12,
                                         frequency_of_the_test=1, checkpoint_dir=ckpt_dir), **kw))
    args = fedml_tpu_torch.init(args)
    ds = load(args, device="cpu")
    return SimulatorSingleProcess(args, "cpu", ds,
                                  models.create(args, ds.class_num, device="cpu")).fl_trainer


def test_sfedavg_resumes_bitwise_reputation_included(tmp_path):
    d = str(tmp_path / "ck")
    first = _s_api(d, comm_round=2, checkpoint_freq=1)
    assert isinstance(first, SFedAvgAPI)
    first.train()
    resumed = _s_api(d, comm_round=4, checkpoint_freq=1)
    resumed.train()
    straight = _s_api(comm_round=4)
    straight.train()
    for k in straight.global_params:
        assert torch.equal(resumed.global_params[k], straight.global_params[k]), k
    assert np.array_equal(resumed.phi, straight.phi) and np.array_equal(resumed.sv, straight.sv)
    assert not np.allclose(straight.phi, straight.phi[0])  # the reputation moved
    assert [h["round"] for h in resumed.history] == [2, 3]
    # the permutations repeat per (seed, round) and change with the round
    again = _s_api(comm_round=4)
    again.train()
    assert np.array_equal(again.sv, straight.sv)


def _images(seed, lead=(3, 2, 4), hw=(8, 6), ch=2):
    rng = np.random.RandomState(seed)
    x = rng.rand(*lead, *hw, ch).astype(np.float32)
    mask = (rng.rand(*lead) < 0.7).astype(np.float32)
    return x, mask


@pytest.mark.parametrize("L", [0.0, 0.1, 0.25])
def test_the_hs_normalizer_is_the_references(L):
    x, mask = _images(0)
    jnorm, tnorm = jsim.make_hs_normalizer(8, 6, L, 0.1), make_hs_normalizer(8, 6, L, 0.1)
    amp_j = jnp.zeros((8, 6, 2), jnp.float32)
    amp_t = torch.zeros(8, 6, 2)
    for step in range(3):
        x, mask = _images(step)
        xj, amp_j = jnorm(jnp.asarray(x), jnp.asarray(mask), amp_j)
        xt, amp_t = tnorm(torch.tensor(x), torch.tensor(mask), amp_t)
        np.testing.assert_allclose(amp_t.numpy(), np.asarray(amp_j), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5, atol=1e-5)
        pad = mask == 0  # padding is left as it was
        assert np.array_equal(xt.numpy()[pad], x[pad])
        assert torch.isfinite(amp_t).all()


# the linear model: the FFTs' last f32 bits differ between the packages,
# and through a ReLU whose input lies within them of zero (the CNN has
# ~10^6 such inputs a round) that becomes a step of O(lr) (measured:
# 6e-4 on the CNN's weights after two rounds)
HS_KW = dict(SLICE, federated_optimizer="HSFedAvg", comm_round=2, hs_L=0.1, model="lr",
             dataset="mnist")


def test_two_hs_rounds_match_jax_with_the_normalizer_in_f32():
    with jax.enable_x64(True):
        jargs, jds, targs, tds = _jax_world(**HS_KW)
        japi = jsim.HSFedAvgAPI(jargs, None, jds, jax_models.create(jargs, jds.class_num))
        japi.global_params = jax.tree.map(lambda a: a.astype(jnp.float64), japi.global_params)
        start = params_from_flax(jax.tree.map(np.asarray, japi.global_params))
        japi.train()
        want = params_from_flax(jax.tree.map(np.asarray, japi.global_params))
        want_amp = np.asarray(japi.server_state)
    tapi = HSFedAvgAPI(targs, "cpu", tds, models.create(targs, tds.class_num, device="cpu"))
    tapi.global_params = start
    tapi.train()
    np.testing.assert_allclose(tapi.server_state.numpy(), want_amp, rtol=1e-5)
    moved = max(float((want[k] - start[k]).abs().max()) for k in want)
    assert moved > 1e-2
    for k in want:
        np.testing.assert_allclose(tapi.global_params[k].numpy(), want[k].numpy(), atol=1e-6,
                                   err_msg=k)


def test_hs_and_sfedavg_refuse_what_the_reference_refuses():
    args = fedml_tpu_torch.init(_set(Arguments(), **dict(
        SLICE, dataset="synthetic", model="lr", input_dim=10, output_dim=3,
        federated_optimizer="HSFedAvg")))
    ds = load(args, device="cpu")
    with pytest.raises(ValueError, match=r"HS-FedAvg needs image data \[C, nb, bs, H, W, ch\]"):
        HSFedAvgAPI(args, "cpu", ds, models.create(args, ds.class_num, device="cpu"))
    for name in ("SFedAvg", "HSFedAvg"):
        args = fedml_tpu_torch.init(_set(Arguments(), **dict(
            SLICE, federated_optimizer=name, sim_mode="sequential")))
        ds = load(args, device="cpu")
        with pytest.raises(NotImplementedError, match="sim_mode='sequential' is not supported"):
            SimulatorSingleProcess(args, "cpu", ds, models.create(args, ds.class_num, device="cpu"))


def _scripted_uploads(n=24, seed=0):
    """Honest small deltas in a shared direction and a persistent attacker
    (index 2) shipping large opposite ones; each upload with the window's
    running reference direction, None at a window's first."""
    rng = np.random.RandomState(seed)
    direction = rng.normal(size=50).astype(np.float32)
    out = []
    for i in range(n):
        rank = i % 6
        if rank == 2:
            d = -4.0 * direction + rng.normal(size=50).astype(np.float32)
        else:
            d = direction * rng.uniform(0.5, 1.5) + rng.normal(size=50).astype(np.float32) * 0.3
        ref = None if rank == 0 else direction + rng.normal(size=50).astype(np.float32) * 0.1
        out.append((rank, {"w": d.reshape(5, 10)}, None if ref is None else {"w": ref.reshape(5, 10)},
                    int(rng.randint(0, 2))))
    return out


@pytest.mark.parametrize("defense_type", [None, "norm_diff_clipping"])
def test_the_anomaly_screens_decisions_are_the_references(defense_type):
    from types import SimpleNamespace

    args = SimpleNamespace(defense_anomaly_threshold=0.5, defense_quarantine_rounds=2,
                           defense_type=defense_type, norm_bound=5.0)
    port, ref = defense.AnomalyScreen(args), jdef.AnomalyScreen(args)
    decisions = []
    for i, (rank, d, r, stale) in enumerate(_scripted_uploads()):
        got = port.score_upload({k: torch.tensor(v) for k, v in d.items()},
                                None if r is None else {k: torch.tensor(v) for k, v in r.items()},
                                staleness=stale)
        want = ref.score_upload({k: jnp.asarray(v) for k, v in d.items()},
                                None if r is None else {k: jnp.asarray(v) for k, v in r.items()},
                                staleness=stale)
        # the norms reduce in another order; the score's ratio - 1 cancels
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-7)
        assert (got[2] is None) == (want[2] is None)
        if got[2] is not None:
            np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6)
        a, b = port.observe(rank, *got[:2]), ref.observe(rank, *want[:2])
        assert a == b, i
        decisions.append(a)
        if rank == 5:
            assert port.tick() == ref.tick()
        assert port.quarantined_indexes() == ref.quarantined_indexes()
        np.testing.assert_allclose(port.reputation(rank), ref.reputation(rank), rtol=1e-5,
                                   atol=1e-6)
    assert any(decisions) and port.quarantines_total == ref.quarantines_total
    assert 2 in port.quarantined_indexes() or port.quarantines_total >= 1
    assert defense.anomaly_score(3.0, -0.5, 1.0) == jdef.anomaly_score(3.0, -0.5, 1.0)
    assert defense.anomaly_score(0.1, None, None) == 0.0


def test_delta_helpers_are_the_references():
    from fedml_tpu.core import compression as jcomp
    from fedml_tpu_torch.core import compression as comp

    rng = np.random.RandomState(4)
    theta = {"a": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=5).astype(np.float32)}
    g = {k: v * 0.5 for k, v in theta.items()}
    got = defense.delta_from({k: torch.tensor(v) for k, v in theta.items()},
                             {k: torch.tensor(v) for k, v in g.items()})
    want = jdef.delta_from({k: jnp.asarray(v) for k, v in theta.items()},
                           {k: jnp.asarray(v) for k, v in g.items()})
    for k in theta:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    enc = comp.Int8Codec.encode(got)
    dec = defense.decoded_delta(comp.Int8Codec(), enc, got)
    jdec = jdef.decoded_delta(jcomp.Int8Codec(), jcomp.Int8Codec.encode(want), want)
    for k in theta:
        assert np.array_equal(dec[k].numpy(), np.asarray(jdec[k]))


def test_the_batches_containers_line_up():
    # the validation holdout S-FedAvg keeps: the first valid_batches batches
    b = Batches(x=torch.zeros(5, 2, 3), y=torch.zeros(5, 2), mask=torch.ones(5, 2))
    jb = JaxBatches(x=jnp.zeros((5, 2, 3)), y=jnp.zeros((5, 2)), mask=jnp.ones((5, 2)))
    from fedml_tpu_torch.simulation.defenses import _take_batches

    assert _take_batches(b, 2).mask.shape[0] == jsim._take_batches(jb, 2).mask.shape[0] == 2
