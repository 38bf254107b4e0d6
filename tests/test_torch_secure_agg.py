"""Secure aggregation and TurboAggregate through the port against the JAX package.

``core/secure_agg.py`` is host numpy in both packages: every primitive
(field arithmetic, Lagrange and Shamir, additive shares, the pairwise
masks and their dropout correction, quantization) gives the same bits
for the same inputs and seeds, and so does
``TurboAggregateProtocol.secure_weighted_sum``. Two TurboAggregate
rounds of the CNN on the CPU: the port's new global model each round is
bitwise what the JAX package's protocol makes of the same stacked
updates, and within C / (2 * scale) of the plain weighted mean. The
refusal of ``defense_type`` matches the JAX package's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import fedml_tpu
from fedml_tpu import models as jax_models
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.core import secure_agg as jsa
from fedml_tpu.data import load as jax_load
from fedml_tpu.simulation.turboaggregate import TurboAggregateAPI as JaxTurboAggregateAPI
import fedml_tpu_torch
from fedml_tpu_torch import models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.core import secure_agg as sa
from fedml_tpu_torch.data import load
from fedml_tpu_torch.simulation import SimulatorSingleProcess, TurboAggregateAPI
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

P = sa.FIELD_PRIME


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_field_primitives_are_bitwise():
    rng = np.random.default_rng(0)
    a = rng.integers(1, P, size=50, dtype=np.int64)
    for e in (0, 1, 5, P - 2, 123456789):
        _same(sa.modpow(a, e), jsa.modpow(a, e))
    _same(sa.modular_inv(a), jsa.modular_inv(a))
    assert np.all(np.mod(sa.modular_inv(a) * a, P) == 1)
    _same(sa.lagrange_coeffs([0, 7, 9], [1, 2, 3, 4]), jsa.lagrange_coeffs([0, 7, 9], [1, 2, 3, 4]))
    x = rng.integers(0, P, size=(6,), dtype=np.int64)
    shares = sa.shamir_share(x, 5, 2, np.random.default_rng(3))
    _same(shares, jsa.shamir_share(x, 5, 2, np.random.default_rng(3)))
    _same(sa.shamir_reconstruct(shares[[0, 2, 4]], [1, 3, 5]), x)
    _same(sa.shamir_reconstruct(shares[[0, 2, 4]], [1, 3, 5]),
          jsa.shamir_reconstruct(shares[[0, 2, 4]], [1, 3, 5]))
    add = sa.additive_share(x, 4, np.random.default_rng(8))
    _same(add, jsa.additive_share(x, 4, np.random.default_rng(8)))
    _same(np.mod(add.sum(axis=0), P), x)
    with pytest.raises(ValueError, match="at least one recipient"):
        sa.additive_share(x, 0, np.random.default_rng(0))
    f = rng.normal(size=40) * 3
    _same(sa.quantize(f, 2.0**16), jsa.quantize(f, 2.0**16))
    _same(sa.dequantize(sa.quantize(f, 2.0**16), 2.0**16),
          jsa.dequantize(jsa.quantize(f, 2.0**16), 2.0**16))
    assert sa.field_checksum(x) == jsa.field_checksum(x)


def test_pairwise_masks_are_bitwise_and_cancel():
    secrets = {i: sa.derive_mask_secret(100 + i, 3) for i in range(4)}
    assert secrets == {i: jsa.derive_mask_secret(100 + i, 3) for i in range(4)}
    publics = {i: sa.mask_public_key(s) for i, s in secrets.items()}
    assert publics == {i: jsa.mask_public_key(s) for i, s in secrets.items()}
    assert sa.pairwise_seed(secrets[0], publics[1]) == sa.pairwise_seed(secrets[1], publics[0])
    _same(sa.prg_field_vector(77, 9), jsa.prg_field_vector(77, 9))
    masks = [sa.pairwise_mask_vector(i, secrets[i], publics, 16) for i in range(4)]
    for i in range(4):
        _same(masks[i], jsa.pairwise_mask_vector(i, secrets[i], publics, 16))
    assert not np.mod(np.sum(masks, axis=0), P).any()
    # device 2 vanished: the survivors' masks leave its residue, which
    # the correction removes
    survivors = {i: p for i, p in publics.items() if i != 2}
    left = np.mod(sum(masks[i] for i in survivors), P)
    corr = sa.unmask_correction(2, secrets[2], survivors, 16)
    _same(corr, jsa.unmask_correction(2, secrets[2], survivors, 16))
    assert not np.mod(left - corr, P).any()


@pytest.mark.parametrize("clients, groups", [(7, 3), (8, 4), (3, 5)])
def test_turboaggregate_protocol_is_bitwise(clients, groups):
    rng = np.random.default_rng(clients)
    updates = [rng.normal(size=33).astype(np.float32) * 0.1 for _ in range(clients)]
    weights = rng.dirichlet(np.ones(clients))
    got = sa.TurboAggregateProtocol(clients, groups, seed=4).secure_weighted_sum(updates, weights)
    want = jsa.TurboAggregateProtocol(clients, groups, seed=4).secure_weighted_sum(updates,
                                                                                 weights)
    _same(got, want)
    plain = np.sum([w * u for w, u in zip(weights, updates)], axis=0)
    assert np.abs(got - plain).max() <= clients / (2 * 2.0**16)


def test_flat_layout_round_trips():
    params = {"b": torch.arange(3.0), "a": torch.ones(2, 2) * 0.5, "c": torch.tensor(2.0)}
    flat, spec = sa.flatten_params(params)
    assert flat.tolist() == [0.0, 1.0, 2.0, 0.5, 0.5, 0.5, 0.5, 2.0]
    back = sa.unflatten_params(flat.astype(np.float64), spec)
    assert list(back) == ["b", "a", "c"]
    for k in params:
        assert back[k].dtype == torch.float32 and torch.equal(back[k], params[k])


TA = dict(dataset="mnist", model="cnn", synthetic_train_size=96, synthetic_test_size=32,
          partition_method="hetero", partition_alpha=0.5, client_num_in_total=6,
          client_num_per_round=5, comm_round=2, epochs=1, batch_size=8, learning_rate=0.05,
          frequency_of_the_test=1, federated_optimizer="TurboAggregate", ta_groups=2,
          random_seed=1)


def _args(cls, **kw):
    a = cls()
    for k, v in dict(TA, **kw).items():
        setattr(a, k, v)
    a._validate()
    return a


def test_two_rounds_are_the_jax_protocols_result():
    args = fedml_tpu_torch.init(_args(Arguments))
    ds = load(args, device="cpu")
    api = TurboAggregateAPI(args, "cpu", ds, models.create(args, ds.class_num, device="cpu"))
    seen = []
    post = api._post_round_stacked

    def keep(stacked, idx, round_idx):
        seen.append(({k: v.clone() for k, v in stacked.items()}, np.array(idx)))
        post(stacked, idx, round_idx)
        seen[-1] += ({k: v.clone() for k, v in api.global_params.items()},)

    api._post_round_stacked = keep
    api.train()
    assert len(seen) == 2
    protocol = jsa.TurboAggregateProtocol(5, 2, scale=2.0**16, seed=1)
    import jax.numpy as jnp

    from fedml_tpu.core.aggregation import normalize_weights as jax_normalize

    for stacked, idx, got in seen:
        C = len(idx)
        names = list(stacked)
        updates = [np.concatenate([stacked[k][j].numpy().reshape(-1) for k in names])
                   for j in range(C)]
        ns = np.take(np.asarray(ds.packed_num_samples), idx)
        weights = np.asarray(jax_normalize(jnp.asarray(ns))).astype(np.float64)
        want = protocol.secure_weighted_sum(updates, weights).astype(np.float32)
        flat = torch.cat([got[k].reshape(-1) for k in names]).numpy()
        _same(flat, want)
        plain = np.sum([w * u for w, u in zip(weights, updates)], axis=0)
        assert np.abs(flat - plain).max() <= C / (2 * 2.0**16) + 1e-6
        assert np.abs(flat - updates[0]).max() > 1e-4
    assert api.history[-1]["round"] == 1 and np.isfinite(api.history[-1]["train_loss"])


def test_refuses_defense_type_and_operators_as_jax_does():
    msg = "TurboAggregate replaces the aggregation step with the secure-sum protocol"
    args = _args(Arguments, defense_type="median")
    ds = load(args, device="cpu")
    with pytest.raises(ValueError, match=msg):
        TurboAggregateAPI(args, "cpu", ds, models.create(args, ds.class_num, device="cpu"))
    jargs = _args(JaxArguments, defense_type="median")
    jds = jax_load(fedml_tpu.init(jargs))
    with pytest.raises(ValueError, match=msg):
        JaxTurboAggregateAPI(jargs, None, jds, jax_models.create(jargs, jds.class_num))
    args = _args(Arguments)
    from fedml_tpu_torch.core.frame import DefaultClientTrainer

    model = models.create(args, ds.class_num, device="cpu")
    msg = "not supported by TurboAggregateAPI; supported by the FedAvg family"
    with pytest.raises(ValueError, match=msg):
        SimulatorSingleProcess(args, "cpu", ds, model,
                               client_trainer=DefaultClientTrainer(model, args))
