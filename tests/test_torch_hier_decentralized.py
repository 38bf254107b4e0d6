"""HierFedAvg, DSGD and PushSum through the port against the JAX package.

Both packages train the 2-conv CNN on the same packed MNIST-shaped
arrays (the JAX loader's) from the same initial params, with
``shuffle=False``, in float64, where they agree to rounding (1e-10):
HierFedAvg 2 global x 2 group rounds over 2 groups, DSGD and PushSum 3
gossip rounds. Bitwise: the topologies and neighbor lists for several
(n, k, beta, seed), HierFedAvg's groups. Also: group_num 1 is flat
FedAvg over the same cohort; the refusals (a custom aggregator for
HierFedAvg, a round-indexed ``lr_schedule`` for gossip, one node per
packed client) with the JAX package's types and messages; the local
trainer's stacked-params entry against its default, which is bitwise
as before.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
from fedml_tpu import models as jax_models
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.core import topology as jax_topology
from fedml_tpu.data import load as jax_load
from fedml_tpu.simulation import decentralized as jax_dec
from fedml_tpu.simulation import hierarchical_fl as jax_hier
import fedml_tpu_torch
from fedml_tpu_torch import models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.core import topology
from fedml_tpu_torch.core.frame import DefaultClientTrainer, DefaultServerAggregator
from fedml_tpu_torch.core.local_trainer import make_local_train_fn
from fedml_tpu_torch.core.optimizers import sgd
from fedml_tpu_torch.core.types import Batches
from fedml_tpu_torch.data.loader import FederatedDataset
from fedml_tpu_torch.simulation import (
    DecentralizedDSGDAPI,
    DecentralizedPushSumAPI,
    FedAvgAPI,
    HierarchicalFLAPI,
    SimulatorSingleProcess,
)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

PARAMS_ATOL = 1e-10

SLICE = dict(dataset="mnist", model="cnn", synthetic_train_size=96, synthetic_test_size=32,
             partition_method="hetero", partition_alpha=0.5, client_num_in_total=6,
             client_num_per_round=6, comm_round=2, epochs=1, batch_size=8,
             learning_rate=0.05, frequency_of_the_test=1, shuffle=False, random_seed=3)


def _set(a, **kw):
    for k, v in kw.items():
        setattr(a, k, v)
    a._validate()
    return a


def port_dataset(jds) -> FederatedDataset:
    """The JAX loader's federation as the port's, on the CPU."""
    def cv(b):
        return Batches(x=torch.tensor(np.asarray(b.x)),
                       y=torch.tensor(np.asarray(b.y), dtype=torch.int64),
                       mask=torch.tensor(np.asarray(b.mask)))

    return FederatedDataset(
        train_data_num=jds.train_data_num, test_data_num=jds.test_data_num,
        train_data_global=cv(jds.train_data_global), test_data_global=cv(jds.test_data_global),
        train_data_local_num_dict=dict(jds.train_data_local_num_dict),
        train_data_local_dict={}, test_data_local_dict={}, class_num=jds.class_num,
        packed_train=cv(jds.packed_train), packed_num_samples=np.asarray(jds.packed_num_samples),
        packed_test=cv(jds.packed_test), client_num=jds.client_num, task=jds.task,
    )


def jax_float64_dataset(jargs):
    jds = jax_load(jargs)
    for split in ("packed_train", "packed_test", "train_data_global", "test_data_global"):
        b = getattr(jds, split)
        setattr(jds, split, b.replace(x=b.x.astype(jnp.float64)))
    return jds


def _f64(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float64), tree)


def _torch(tree):
    return params_from_flax(jax.tree.map(np.asarray, tree))


def assert_params_close(got, want, atol=PARAMS_ATOL):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol, rtol=0,
                                   err_msg=k)


def api_pair(jcls, tcls, base, with_model=False, **extra):
    """(JAX API, port API, port dataset): the JAX loader's float64
    federation handed to both, each API built from its own package's
    args (and models.create's model when ``with_model``)."""
    kw = dict(base, **extra)
    jargs = fedml_tpu.init(_set(JaxArguments(), **kw))
    jds = jax_float64_dataset(jargs)
    jm = jax_models.create(jargs, jds.class_num) if with_model else None
    japi = jcls(jargs, None, jds, jm)
    targs = fedml_tpu_torch.init(_set(Arguments(), **kw))
    tds = port_dataset(jds)
    tm = models.create(targs, tds.class_num, device="cpu") if with_model else None
    return japi, tcls(targs, "cpu", tds, tm), tds


def compare_history(th, jh, keys, rtol=1e-9):
    assert [h["round"] for h in th] == [h["round"] for h in jh]
    for t, j in zip(th, jh):
        for key in keys:
            np.testing.assert_allclose(t[key], j[key], rtol=rtol, err_msg=key)


# -- topology -----------------------------------------------------------------


@pytest.mark.parametrize("n, k, beta, seed", [(8, 2, 0.0, 0), (10, 4, 0.3, 1), (7, 2, 0.9, 5),
                                              (16, 6, 0.5, 2)])
def test_topologies_are_bitwise(n, k, beta, seed):
    sym = topology.SymmetricTopologyManager(n, k, beta, seed)
    jsym = jax_topology.SymmetricTopologyManager(n, k, beta, seed)
    asym = topology.AsymmetricTopologyManager(n, k, seed)
    jasym = jax_topology.AsymmetricTopologyManager(n, k, seed)
    for t in (sym, jsym, asym, jasym):
        t.generate_topology()
    for got, want in ((sym, jsym), (asym, jasym)):
        assert np.array_equal(got.topology, want.topology)
        for i in range(n):
            assert got.get_in_neighbor_idx_list(i) == want.get_in_neighbor_idx_list(i)
            assert got.get_out_neighbor_idx_list(i) == want.get_out_neighbor_idx_list(i)
            assert np.array_equal(got.get_in_neighbor_weights(i),
                                  want.get_in_neighbor_weights(i))
        W = got.mixing_matrix(device="cpu")
        assert W.dtype == torch.float32
        assert np.array_equal(W.numpy(), np.asarray(want.mixing_matrix()))
    np.testing.assert_allclose(sym.topology.sum(axis=1), 1.0)
    np.testing.assert_allclose(asym.topology.sum(axis=0), 1.0)


# -- HierFedAvg ------------------------------------------------------------------

_RUNS = {}


def _jax_run(name, jcls, **extra):
    """The JAX package's run in float64: (dataset, start params, final
    params, history, the API)."""
    if name not in _RUNS:
        with jax.enable_x64(True):
            jargs = fedml_tpu.init(_set(JaxArguments(), **dict(SLICE, **extra)))
            jds = jax_float64_dataset(jargs)
            model = jax_models.create(jargs, jds.class_num)
            japi = jcls(jargs, None, jds, model)
            japi.global_params = _f64(japi.global_params)
            start = _torch(japi.global_params)
            if hasattr(japi, "node_params"):
                n = jds.client_num
                japi.node_params = jax.tree.map(
                    lambda l: jnp.broadcast_to(l[None], (n,) + l.shape), japi.global_params)
            japi.train()
            _RUNS[name] = (jds, start, _torch(japi.global_params), japi.history, japi)
    return _RUNS[name]


def _port_api(cls, jds, start, **extra):
    targs = fedml_tpu_torch.init(_set(Arguments(), **dict(SLICE, **extra)))
    tds = port_dataset(jds)
    tapi = cls(targs, "cpu", tds, models.create(targs, tds.class_num, device="cpu"))
    tapi.global_params = dict(start)
    return tapi


HIER = dict(federated_optimizer="HierFedAvg", group_num=2, group_comm_round=2)


def test_hierfedavg_two_rounds_match_jax():
    jds, start, want, jhist, japi = _jax_run("hier", jax_hier.HierarchicalFLAPI, **HIER)
    tapi = _port_api(HierarchicalFLAPI, jds, start, **HIER)
    assert [g.tolist() for g in tapi.groups] == [g.tolist() for g in japi._groups()]
    tapi.train()
    moved = max(float((want[k] - start[k]).abs().max()) for k in want)
    assert moved > 1e-3
    assert_params_close(tapi.global_params, want)
    assert [h["round"] for h in tapi.history] == [h["round"] for h in jhist] == [0, 1]
    for th, jh in zip(tapi.history, jhist):
        for key in ("train_loss", "test_loss", "train_acc", "test_acc"):
            np.testing.assert_allclose(th[key], jh[key], rtol=1e-9, err_msg=key)
        assert th["groups"] == 2


@pytest.mark.parametrize("group_num, seed", [(3, 0), (4, 7)])
def test_hierfedavg_groups_are_bitwise(group_num, seed):
    a, ja = Arguments(), JaxArguments()
    for x in (a, ja):
        x.group_num, x.random_seed = group_num, seed

    class _Fake:
        dataset = type("D", (), {"client_num": 11})

    got = HierarchicalFLAPI._groups(type("A", (_Fake,), {"args": a})())
    want = jax_hier.HierarchicalFLAPI._groups(type("J", (_Fake,), {"args": ja})())
    assert [g.tolist() for g in got] == [g.tolist() for g in want]
    assert all(g.dtype == np.int32 for g in got)


def test_one_group_is_flat_fedavg():
    """group_num 1, group_comm_round 1: the group is the whole cohort
    (in the permutation's order), so a global round is a FedAvg round."""
    args = _set(Arguments(), **dict(SLICE, shuffle=False))
    ds = fedml_tpu_torch.data.load(fedml_tpu_torch.init(args), device="cpu")
    model = models.create(args, ds.class_num, device="cpu")
    flat = FedAvgAPI(args, "cpu", ds, model)
    flat.train()
    hargs = _set(Arguments(), **dict(SLICE, federated_optimizer="HierFedAvg", group_num=1,
                                     group_comm_round=1))
    hier = HierarchicalFLAPI(hargs, "cpu", ds, model)
    hier.train()
    for k, v in flat.global_params.items():
        np.testing.assert_allclose(hier.global_params[k].numpy(), v.numpy(), atol=1e-6, rtol=0)


def test_hierfedavg_refuses_a_custom_aggregator_and_takes_a_trainer():
    args = fedml_tpu_torch.init(_set(Arguments(), **dict(SLICE, **HIER)))
    ds = fedml_tpu_torch.data.load(args, device="cpu")
    model = models.create(args, ds.class_num, device="cpu")
    msg = "HierFedAvg defines its own server aggregation; a custom server_aggregator"
    with pytest.raises(ValueError, match=msg):
        SimulatorSingleProcess(args, "cpu", ds, model,
                               server_aggregator=DefaultServerAggregator(model, args))
    # the JAX package refuses it too, with the same message
    jargs = fedml_tpu.init(_set(JaxArguments(), **dict(SLICE, **HIER)))
    jds = jax_load(jargs)
    from fedml_tpu.core.frame import DefaultServerAggregator as JaxAggregator
    jm = jax_models.create(jargs, jds.class_num)
    with pytest.raises(ValueError, match=msg):
        jax_hier.HierarchicalFLAPI(jargs, None, jds, jm,
                                   server_aggregator=JaxAggregator(jm, jargs))
    sim = SimulatorSingleProcess(args, "cpu", ds, model,
                                 client_trainer=DefaultClientTrainer(model, args))
    assert sim.fl_trainer.client_trainer is not None
    assert sim.run()["round"] == 1


# -- DSGD and PushSum -----------------------------------------------------------


@pytest.mark.parametrize("name, jcls, tcls", [
    ("DSGD", jax_dec.DecentralizedDSGDAPI, DecentralizedDSGDAPI),
    ("PushSum", jax_dec.DecentralizedPushSumAPI, DecentralizedPushSumAPI),
])
def test_gossip_three_rounds_match_jax(name, jcls, tcls):
    extra = dict(federated_optimizer=name, comm_round=3, topology_neighbor_num=2)
    jds, start, want, jhist, japi = _jax_run(name, jcls, **extra)
    tapi = _port_api(tcls, jds, start, **extra)
    n = jds.client_num
    tapi.node_params = {k: v.expand((n,) + tuple(v.shape)).clone() for k, v in start.items()}
    if name == "PushSum":
        tapi.mass = torch.ones(n, dtype=torch.float64)
    assert np.array_equal(tapi.W.numpy(), np.asarray(japi.W))
    tapi.train()
    assert_params_close(tapi.global_params, want)
    with jax.enable_x64(True):
        want_nodes = params_from_flax(jax.tree.map(np.asarray, japi.node_params), stacked=True)
    assert_params_close(tapi.node_params, want_nodes)
    if name == "PushSum":
        np.testing.assert_allclose(tapi.mass.numpy(), np.asarray(japi.mass), atol=1e-12)
        np.testing.assert_allclose(float(tapi.mass.sum()), n, atol=1e-9)
    for th, jh in zip(tapi.history, jhist):
        np.testing.assert_allclose(th["consensus_dist"], jh["consensus_dist"], rtol=1e-9)
        np.testing.assert_allclose(th["test_loss"], jh["test_loss"], rtol=1e-9)
    assert tapi.history[-1]["consensus_dist"] > 0


def test_gossip_refusals_match_jax():
    args = _set(Arguments(), **dict(SLICE, federated_optimizer="DSGD", lr_schedule="cosine",
                                    lr_total_rounds=4))
    ds = fedml_tpu_torch.data.load(args, device="cpu")
    model = models.create(args, ds.class_num, device="cpu")
    msg = "round-indexed lr_schedule is not supported for decentralized gossip"
    with pytest.raises(ValueError, match=msg):
        DecentralizedPushSumAPI(args, "cpu", ds, model)
    jargs = _set(JaxArguments(), **dict(SLICE, federated_optimizer="DSGD",
                                        lr_schedule="cosine", lr_total_rounds=4))
    jds = jax_load(jargs)
    with pytest.raises(ValueError, match=msg):
        jax_dec.DecentralizedDSGDAPI(jargs, None, jds, jax_models.create(jargs, jds.class_num))
    args = _set(Arguments(), **dict(SLICE, federated_optimizer="DSGD"))
    ds.client_num = 7  # the packed federation holds 6 rows
    with pytest.raises(ValueError, match="one node per packed client .got 6 packed rows for 7"):
        DecentralizedDSGDAPI(args, "cpu", ds, model)


# -- the local trainer's stacked-params entry ---------------------------------


def test_stacked_entry_trains_each_row_and_default_is_unchanged():
    """Stacking the global model C times and passing it stacked gives the
    default entry's result bitwise; rows that differ train apart, each
    as it would alone."""
    args = _set(Arguments(), **dict(SLICE, client_num_in_total=4, synthetic_train_size=64))
    ds = fedml_tpu_torch.data.load(args, device="cpu")
    model = models.create(args, ds.class_num, device="cpu")
    p0 = model.init(torch.Generator().manual_seed(0))
    train = make_local_train_fn(model.apply, model.loss_fn, sgd(0.05, momentum=0.9), epochs=2,
                                shuffle=False)
    packed = ds.packed_train
    default, dm = train(p0, packed)
    stacked, sm = train({k: v.expand((4,) + tuple(v.shape)) for k, v in p0.items()}, packed,
                        stacked=True)
    for k in p0:
        assert torch.equal(default[k], stacked[k]), k
    for k in dm:
        assert torch.equal(dm[k], sm[k]), k
    # distinct rows: each as that client alone from its own start (a
    # batched convolution and a single one round differently)
    p1 = model.init(torch.Generator().manual_seed(1))
    rows = {k: torch.stack([p0[k], p1[k], p0[k], p1[k]]) for k in p0}
    got, _ = train(rows, packed, stacked=True)
    one = Batches(x=packed.x[1:2], y=packed.y[1:2], mask=packed.mask[1:2])
    alone, _ = train(p1, one)
    for k in p0:
        torch.testing.assert_close(got[k][1], alone[k][0], atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="lead with the cohort's 4 clients"):
        train({k: v[:2] for k, v in rows.items()}, packed, stacked=True)
