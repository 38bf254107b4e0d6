"""The L3 operator seam of the port: custom ``ClientTrainer`` /
``ServerAggregator`` through ``run_simulation`` and the simulator (port
of ``tests/test_operator_seam.py``'s single-process classes; the
cross-silo class waits for the cross-silo slice).

Held against the JAX package too: the same custom trainer and aggregator
over the same packed federation from the same start, in float64, give
the same params in both packages (1e-9, rounding and nothing else).
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
from fedml_tpu.core import frame as jax_frame
from fedml_tpu.data import load as jax_load
from fedml_tpu.simulation import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu_torch import constants, models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.core.frame import (
    ClientTrainer,
    DefaultClientTrainer,
    DefaultServerAggregator,
    ServerAggregator,
    bind_operator,
)
from fedml_tpu_torch.core.types import Batches
from fedml_tpu_torch.data import load
from fedml_tpu_torch.simulation import FedAvgAPI, SimulatorSingleProcess
from test_torch_fedavg_api import _port_dataset
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SP = constants.FEDML_SIMULATION_TYPE_SP
# the same run in both packages in float64 (see the module docstring)
PARAMS_ATOL = 1e-9
# a per-client trainer vmapped over the cohort against called per client,
# in float64: the same arithmetic, batched or not
VEC_SEQ_ATOL = 1e-12
# the reference's own tolerance for a frozen model (np.allclose's rtol,
# tests/test_operator_seam.py)
FROZEN_RTOL = 1e-5

BASE = dict(dataset="mnist", synthetic_train_size=400, synthetic_test_size=80, model="lr",
            partition_method="hetero", client_num_in_total=4, client_num_per_round=4,
            comm_round=2, epochs=1, batch_size=16, learning_rate=0.1,
            frequency_of_the_test=1, shuffle=False)


def _args(cls=Arguments, **kw):
    a = cls()
    for k, v in dict(BASE, **kw).items():
        setattr(a, k, v)
    a._validate()
    return a


class FrozenTrainer(DefaultClientTrainer):
    """Local training is a no-op, so the global model never moves."""

    def make_train_fn(self, args):
        inner = super().make_train_fn(args)

        def train(params, batches, rng):
            _, metrics = inner(params, batches, rng)
            return params, metrics

        return train


class HalfStepTrainer(DefaultClientTrainer):
    """Halves the local delta (half the effective client lr)."""

    def make_train_fn(self, args):
        inner = super().make_train_fn(args)

        def train(params, batches, rng):
            new, metrics = inner(params, batches, rng)
            return {k: params[k] + 0.5 * (new[k] - params[k]) for k in params}, metrics

        return train


class GlobalKeepAggregator(DefaultServerAggregator):
    """Ignores the clients' updates."""

    def aggregate(self, global_params, stacked_params, weights, rng):
        return global_params


class PlainSGDTrainer(ClientTrainer):
    """A trainer written from scratch against the seam: full-batch SGD
    steps over the client's batches, no shuffle."""

    def make_train_fn(self, args):
        model, lr = self.model, float(args.learning_rate)

        def train(params, batches, rng):
            p = dict(params)
            for i in range(batches.num_batches):
                def loss(q):
                    return model.loss_fn(model.apply(q, batches.x[i]), batches.y[i],
                                         batches.mask[i])

                grads, m = torch.func.grad(loss, has_aux=True)(p)
                p = {k: p[k] - lr * grads[k] for k in p}
            return p, {"loss_sum": m["loss"] * m["count"], "correct": m["correct"],
                       "count": m["count"]}

        return train


def _init_params(api):
    return api.model.init(torch.Generator().manual_seed(int(api.args.random_seed)))


def _sp_run(client_trainer=None, server_aggregator=None, **kw):
    args = fedml_tpu_torch.init(_args(**kw))
    ds = load(args, device="cpu")
    model = models.create(args, ds.class_num, device="cpu")
    if client_trainer is not None:
        client_trainer = client_trainer(model, args)
    if server_aggregator is not None:
        server_aggregator = server_aggregator(model, args)
    sim = SimulatorSingleProcess(args, "cpu", ds, model, client_trainer=client_trainer,
                                 server_aggregator=server_aggregator)
    sim.run()
    return sim.fl_trainer


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def _records(api):
    return [{k: v for k, v in h.items() if k not in ("round_time_s", "train_time_s")}
            for h in api.history]


class TestSimulationSeam:
    def test_default_trainer_is_stock_engine(self):
        """Bitwise, in both modes: the default trainer's function carries
        the stock cohort trainer, and the engine runs it."""
        for mode in ("vectorized", "sequential"):
            stock = _sp_run(sim_mode=mode, shuffle=True)
            via_seam = _sp_run(DefaultClientTrainer, sim_mode=mode, shuffle=True)
            assert _equal(stock.global_params, via_seam.global_params), mode
            assert _records(stock) == _records(via_seam), mode

    def test_frozen_trainer_freezes_global_model(self):
        """To the reference's tolerance, not bitwise: the weighted mean of
        C copies of one tensor rounds (sum_c w_c * p need not be p)."""
        api = _sp_run(FrozenTrainer)
        init = _init_params(api)
        for k in init:
            np.testing.assert_allclose(api.global_params[k].numpy(), init[k].numpy(),
                                       rtol=FROZEN_RTOL, atol=0, err_msg=k)

    def test_halfstep_trainer_changes_training(self):
        stock = _sp_run()
        half = _sp_run(HalfStepTrainer)
        assert not _equal(stock.global_params, half.global_params)
        assert not _equal(_init_params(half), half.global_params)

    def test_custom_aggregator_keeps_global(self):
        api = _sp_run(server_aggregator=GlobalKeepAggregator)
        assert _equal(_init_params(api), api.global_params)

    def test_non_fedavg_family_rejects_operators(self):
        args = _args(federated_optimizer="SplitNN")
        ds = load(args, device="cpu")
        model = models.create(args, ds.class_num, device="cpu")
        with pytest.raises(ValueError, match="not supported"):
            SimulatorSingleProcess(args, "cpu", ds, model,
                                   client_trainer=DefaultClientTrainer(model, args))

    def test_subclass_without_seam_rejects_not_typeerrors(self):
        """An algorithm outside the FedAvg family refuses custom operators
        with the reference's ValueError, whether or not it is ported."""
        args = _args(federated_optimizer="DSGD")
        ds = load(args, device="cpu")
        model = models.create(args, ds.class_num, device="cpu")
        with pytest.raises(ValueError, match="not supported"):
            SimulatorSingleProcess(args, "cpu", ds, model,
                                   client_trainer=DefaultClientTrainer(model, args))

    @pytest.mark.parametrize("algorithm", ["FedOpt", "FedNova"])
    def test_fedopt_rejects_custom_aggregator(self, algorithm):
        """FedOpt's and FedNova's server step is the algorithm: a custom
        aggregator would be dropped, so it is refused."""
        args = _args(federated_optimizer=algorithm)
        ds = load(args, device="cpu")
        model = models.create(args, ds.class_num, device="cpu")
        with pytest.raises(ValueError, match="its own server aggregation"):
            SimulatorSingleProcess(args, "cpu", ds, model,
                                   server_aggregator=GlobalKeepAggregator(model, args))

    def test_imperative_train_advances_rng_per_call(self):
        """Call N and call N + 1 do not replay one shuffle."""
        args = fedml_tpu_torch.init(_args(epochs=2, shuffle=True))
        ds = load(args, device="cpu")
        model = models.create(args, ds.class_num, device="cpu")
        t1, t2 = DefaultClientTrainer(model, args), DefaultClientTrainer(model, args)
        params = model.init(torch.Generator().manual_seed(0))
        batches = ds.train_data_local_dict[0]
        t1.set_model_params(params)
        r1 = t1.train(batches)
        t2.set_model_params(params)
        t2.train(batches)
        t2.set_model_params(params)
        r2 = t2.train(batches)
        assert not _equal(r1, r2)
        t1.set_model_params(params)
        t1._train_calls = 0
        assert _equal(r1, t1.train(batches))  # call 1 again: the same draws


class TestOperatorBinding:
    def test_reused_operator_rebinds_to_new_model(self):
        trainer = HalfStepTrainer(model=None)
        args = fedml_tpu_torch.init(_args())
        model_lr = models.create(args, 10, device="cpu")
        bind_operator(trainer, model_lr, args)
        assert trainer.model is model_lr and trainer.args is args
        args2 = fedml_tpu_torch.init(_args(model="cnn", dataset="femnist"))
        model_cnn = models.create(args2, 62, device="cpu")
        bind_operator(trainer, model_cnn, args2)
        assert trainer.model is model_cnn and trainer.args is args2
        # a model the user set is never overwritten
        t2 = HalfStepTrainer(model_lr)
        bind_operator(t2, model_cnn, args2)
        assert t2.model is model_lr


class TestImperativeSurface:
    def test_imperative_train(self):
        args = fedml_tpu_torch.init(_args())
        ds = load(args, device="cpu")
        model = models.create(args, ds.class_num, device="cpu")
        trainer = DefaultClientTrainer(model, args)
        trainer.set_id(2)
        params = model.init(torch.Generator().manual_seed(0))
        trainer.set_model_params(params)
        new = trainer.train(ds.train_data_local_dict[0])
        assert not _equal(params, new)
        assert trainer.get_model_params() is new
        stats = trainer.test(ds.test_data_local_dict[0])
        assert set(stats) == {"acc", "loss", "count"} and stats["count"] > 0
        aggregator = DefaultServerAggregator(model, args)
        aggregator.set_model_params(new)
        assert aggregator.test(ds.test_data_local_dict[0]) == stats


def test_run_simulation_takes_operators_positionally():
    """The reference's order: ``run_simulation(backend, client_trainer,
    server_aggregator)``; device and args by keyword."""
    args = _args()
    stats = fedml_tpu_torch.run_simulation(SP, FrozenTrainer(None), GlobalKeepAggregator(None),
                                           device="cpu", args=args)
    assert stats["round"] == 1
    with pytest.raises(TypeError):
        fedml_tpu_torch.run_simulation(SP, None, None, "cpu", args)


def test_custom_trainer_vectorized_equals_sequential():
    """A per-client trainer is vmapped over the cohort in the vectorized
    mode and called per client in the sequential one; in float64 the two
    agree to 1e-12. 3 of 4 clients per round, so the pow2 bucket pads
    the cohort by one slot."""
    out = {}
    for mode in ("vectorized", "sequential"):
        args = fedml_tpu_torch.init(_args(sim_mode=mode, client_num_per_round=3, epochs=2,
                                          comm_round=3))
        ds = load(args, device="cpu")
        for split in ("packed_train", "packed_test"):
            b = getattr(ds, split)
            setattr(ds, split, Batches(x=b.x.double(), y=b.y, mask=b.mask.double()))
        model = models.create(args, ds.class_num, device="cpu")
        api = FedAvgAPI(args, "cpu", ds, model, client_trainer=PlainSGDTrainer(model, args))
        api.global_params = {k: v.double() for k, v in api.global_params.items()}
        start = dict(api.global_params)
        api.train()
        out[mode] = (api, start)
    (v, start), (s, _) = out["vectorized"], out["sequential"]
    assert v.pipeline_stats["bucket"] == 4
    assert max(float((v.global_params[k] - start[k]).abs().max()) for k in start) > 1e-2
    for k in start:
        np.testing.assert_allclose(v.global_params[k].numpy(), s.global_params[k].numpy(),
                                   atol=VEC_SEQ_ATOL, rtol=0, err_msg=k)
    for hv, hs in zip(v.history, s.history):
        np.testing.assert_allclose(hv["train_loss_cohort"], hs["train_loss_cohort"], rtol=1e-6)


def test_aggregator_sees_zero_weight_on_padded_slots():
    seen = []

    class Recording(DefaultServerAggregator):
        def aggregate(self, global_params, stacked_params, weights, rng):
            seen.append(weights.clone())
            return super().aggregate(global_params, stacked_params, weights, rng)

    stock = _sp_run(client_num_per_round=3)
    api = _sp_run(server_aggregator=Recording, client_num_per_round=3)
    assert _equal(stock.global_params, api.global_params)
    assert [tuple(w.shape) for w in seen] == [(4,), (4,)]
    for w in seen:
        assert float(w[3]) == 0.0 and abs(float(w.sum()) - 1.0) < 1e-6


def test_lr_schedule_with_custom_trainer_raises():
    args = _args(lr_schedule="cosine", lr_total_rounds=4)
    ds = load(args, device="cpu")
    model = models.create(args, ds.class_num, device="cpu")
    with pytest.raises(ValueError, match="lr_schedule"):
        FedAvgAPI(args, "cpu", ds, model, client_trainer=HalfStepTrainer(model, args))


class _JaxHalfStep(jax_frame.DefaultClientTrainer):
    def make_train_fn(self, args):
        inner = super().make_train_fn(args)

        def train(params, batches, rng):
            new, metrics = inner(params, batches, rng)
            return jax.tree.map(lambda n, p: p + 0.5 * (n - p), new, params), metrics

        return train


class _JaxSquaredWeights(jax_frame.DefaultServerAggregator):
    """The clients' params averaged with their weights squared."""

    def aggregate(self, global_params, stacked_params, weights, rng):
        def avg(s):
            w = weights.astype(s.dtype) ** 2
            return jnp.tensordot(w / jnp.sum(w), s, axes=1)

        return jax.tree.map(avg, stacked_params)


class _SquaredWeights(DefaultServerAggregator):
    def aggregate(self, global_params, stacked_params, weights, rng):
        def avg(s):
            w = weights.to(s.dtype) ** 2
            return torch.tensordot(w / w.sum(), s, dims=1)

        return {k: avg(s) for k, s in stacked_params.items()}


def test_custom_operators_match_jax():
    """The half-step trainer and the squared-weight aggregator, written
    once per package, over the JAX loader's packed federation from the
    same start: 2 rounds of 3 of 4 clients in float64."""
    kw = dict(client_num_per_round=3, epochs=2)
    with jax.enable_x64(True):
        jargs = fedml_tpu.init(_args(JaxArguments, **kw))
        jds = jax_load(jargs)
        for split in ("packed_train", "packed_test", "train_data_global", "test_data_global"):
            b = getattr(jds, split)
            setattr(jds, split, b.replace(x=b.x.astype(jnp.float64)))
        jmodel = jax_models.create(jargs, jds.class_num)
        japi = JaxFedAvgAPI(jargs, None, jds, jmodel,
                            client_trainer=_JaxHalfStep(jmodel, jargs),
                            server_aggregator=_JaxSquaredWeights(jmodel, jargs))
        japi.global_params = jax.tree.map(lambda a: a.astype(jnp.float64), japi.global_params)
        start = params_from_flax(jax.tree.map(np.asarray, japi.global_params))
        japi.train()
        want = params_from_flax(jax.tree.map(np.asarray, japi.global_params))

    targs = fedml_tpu_torch.init(_args(**kw))
    tds = _port_dataset(jds)
    tmodel = models.create(targs, tds.class_num, device="cpu")
    tapi = FedAvgAPI(targs, "cpu", tds, tmodel, client_trainer=HalfStepTrainer(tmodel, targs),
                     server_aggregator=_SquaredWeights(tmodel, targs))
    tapi.global_params = start
    tapi.train()
    assert max(float((want[k] - start[k]).abs().max()) for k in want) > 1e-2
    for k in want:
        assert tapi.global_params[k].dtype == torch.float64
        np.testing.assert_allclose(tapi.global_params[k].numpy(), want[k].numpy(),
                                   atol=PARAMS_ATOL, err_msg=k)
