"""The legacy cross-device plane and the centralized baseline of the port
(``fedml_tpu_torch/cross_device/{model_file,server,client_sim}.py``,
``centralized.py``, ``run_edge_server``) against the JAX package's.

- the npz model file: nested and flat trees round-trip bitwise, and a
  file either package writes the other reads with equal arrays;
- the legacy plane: ``ServerEdge`` and 3 ``EdgeClientSim`` over MQTT on
  the port's broker with a ``FilePayloadStore``, 2 rounds of MNIST
  ``lr`` (``tests/test_cross_device.py``'s setup), from the JAX server's
  initial params and with the JAX clients' shuffles, ends within
  ``LEGACY_ATOL`` of the JAX world's global params;
- ``CentralizedTrainer`` on a small CNN, 2 epochs, with a constant LR
  and a step-indexed cosine schedule, equals the JAX trainer's history
  and params in float64 within ``F64_ATOL``;
- the entry points need a card unless told otherwise.
"""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu_torch
from fedml_tpu_torch import models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.centralized import CentralizedTrainer
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.core.comm.payload_store import FilePayloadStore
from fedml_tpu_torch.core.local_trainer import make_local_train_fn
from fedml_tpu_torch.core.optimizers import create_client_optimizer
from fedml_tpu_torch.core.types import Batches
from fedml_tpu_torch.cross_device import (
    EdgeClientSim,
    ServerEdge,
    model_bytes_to_params,
    params_to_model_bytes,
    read_model_file,
    write_model_file,
)
from test_torch_hier_decentralized import port_dataset
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# 2 rounds of 3 clients' local SGD on logistic regression, f32 on both
# sides (measured 2.2e-8)
LEGACY_ATOL = 1e-5
# the centralized trainer in float64 on both sides: the packages agree to
# ~1e-16 there, as the earlier slices' multi-step tests show
F64_ATOL = 1e-10

LEGACY = dict(dataset="mnist", synthetic_train_size=300, synthetic_test_size=60, model="lr",
              client_num_in_total=3, client_num_per_round=3, comm_round=2, epochs=1,
              batch_size=25, learning_rate=0.1, training_type="cross_device")


def _port_args(**kw):
    a = Arguments()
    for k, v in kw.items():
        setattr(a, k, v)
    a._validate()
    return fedml_tpu_torch.init(a)


# -- the model file --------------------------------------------------------

def _nested():
    rng = np.random.default_rng(0)
    return {
        "Dense_0": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                    "bias": np.zeros(3, np.float32)},
        "Block": {"Conv_0": {"kernel": np.ones((3, 3, 1, 8), np.float32)}},
        "step": np.arange(5, dtype=np.int64),
    }


def test_model_file_round_trips_nested_and_flat(tmp_path):
    nested = _nested()
    back = model_bytes_to_params(params_to_model_bytes(nested))
    assert list(back) == list(nested)
    for k in nested:
        for leaf in (nested[k] if isinstance(nested[k], dict) else {"": nested[k]}):
            a = nested[k][leaf] if leaf else nested[k]
            b = back[k][leaf] if leaf else back[k]
            if isinstance(a, dict):
                for kk in a:
                    assert a[kk].tobytes() == b[kk].tobytes() and a[kk].dtype == b[kk].dtype
            else:
                assert a.tobytes() == b.tobytes() and a.dtype == b.dtype
    flat = {"conv/weight": torch.randn(8, 1, 3, 3), "fc/bias": torch.zeros(10)}
    path = str(tmp_path / "m.npz")
    write_model_file(flat, path)
    got = read_model_file(path, flat=True)
    assert list(got) == list(flat)
    for k in flat:
        assert got[k].tobytes() == flat[k].numpy().tobytes()
    assert set(read_model_file(path)) == {"conv", "fc"}


def test_model_files_cross_packages(tmp_path):
    from fedml_tpu.cross_device import model_file as jmf

    nested = _nested()
    jax_leaves = jax.tree_util.tree_leaves_with_path
    for writer, reader in ((params_to_model_bytes, jmf.model_bytes_to_params),
                           (jmf.params_to_model_bytes, model_bytes_to_params)):
        back = reader(writer(nested))
        want = {jax.tree_util.keystr(p): v for p, v in jax_leaves(nested)}
        got = {jax.tree_util.keystr(p): v for p, v in jax_leaves(back)}
        assert set(got) == set(want)
        for k in want:
            assert np.asarray(got[k]).tobytes() == want[k].tobytes()
    # a JAX server's file read by the port, and the port's params by JAX
    jparams = {"Dense_0": {"kernel": jnp.ones((4, 3)), "bias": jnp.zeros(3)}}
    got = model_bytes_to_params(jmf.params_to_model_bytes(jparams), flat=True)
    assert set(got) == {"Dense_0/kernel", "Dense_0/bias"}
    flat = {"fc/weight": torch.arange(6.0).reshape(2, 3)}
    assert np.array_equal(jmf.model_bytes_to_params(params_to_model_bytes(flat))["fc"]["weight"],
                          flat["fc/weight"].numpy())


# -- the legacy plane -------------------------------------------------------

def _jax_legacy_world(tmp_path):
    """``tests/test_cross_device.py``'s loop; returns the initial and
    final params, the history and each client's per-round shuffles."""
    import fedml_tpu
    from fedml_tpu import models as jax_models
    from fedml_tpu.core.comm.payload_store import FilePayloadStore as JaxStore
    from fedml_tpu.core.local_trainer import make_local_train_fn as jax_train_fn
    from fedml_tpu.core.optimizers import create_client_optimizer as jax_opt
    from fedml_tpu.core.types import Batches as JaxBatches
    from fedml_tpu.cross_device import EdgeClientSim as JaxClient, ServerEdge as JaxServer
    from fedml_tpu.data import load as jax_load
    from tests.conftest import make_args

    args = fedml_tpu.init(make_args(run_id="legacy_jax", payload_store_dir=str(tmp_path / "j"),
                                    **LEGACY))
    ds = jax_load(args)
    model = jax_models.create(args, ds.class_num)
    store = JaxStore(str(tmp_path / "j"))
    server = JaxServer(args, None, ds, model, store=store)
    init = jax.tree.map(np.asarray, server.aggregator.global_params)
    trainer = jax.jit(jax_train_fn(model.apply, model.loss_fn, jax_opt(args), epochs=1))
    threads, n = [], 3
    for rank in range(1, n + 1):
        local = JaxBatches(x=ds.packed_train.x[rank - 1], y=ds.packed_train.y[rank - 1],
                           mask=ds.packed_train.mask[rank - 1])
        client = JaxClient(args, trainer, local, store, rank=rank, size=n + 1)
        threads.append(threading.Thread(target=client.run, daemon=True))
    st = threading.Thread(target=server.run, daemon=True)
    st.start()
    for t in threads:
        t.start()
    st.join(120)
    assert not st.is_alive(), "the JAX server did not finish"
    for t in threads:
        t.join(30)
    # each client's shuffle: round r takes the r-th split of its key, the
    # epoch's permutation of its examples as local_train draws it
    nex = int(np.prod(ds.packed_train.mask.shape[1:]))
    perms = {}
    for rank in range(1, n + 1):
        key = jax.random.PRNGKey(int(args.random_seed) + rank)
        for r in range(LEGACY["comm_round"]):
            key, train_key = jax.random.split(key)
            ep = jax.random.split(train_key, LEGACY["epochs"])
            perms[rank, r] = [np.asarray(jax.random.permutation(k, nex)) for k in ep]
    final = jax.tree.map(np.asarray, server.aggregator.global_params)
    return ds, init, final, list(server.aggregator.history), perms


def _uniforms_of(perms):
    """Uniforms whose ``argsort`` is each epoch's permutation."""
    u = np.zeros((1, len(perms), len(perms[0])), np.float32)
    for e, perm in enumerate(perms):
        u[0, e, perm] = np.arange(len(perm), dtype=np.float32) / len(perm)
    return torch.from_numpy(u)


def test_legacy_plane_matches_jax(tmp_path):
    jds, init, final, jhist, perms = _jax_legacy_world(tmp_path)
    args = _port_args(run_id="legacy_port", payload_store_dir=str(tmp_path / "p"), **LEGACY)
    tds = port_dataset(jds)
    store = FilePayloadStore(str(tmp_path / "p"))
    server = ServerEdge(args, "cpu", tds, models.create(args, tds.class_num, device="cpu"),
                        store=store)
    start = params_from_flax(init)
    server.aggregator.global_params = {k: v.clone() for k, v in start.items()}
    clients, n = [], 3
    for rank in range(1, n + 1):
        model = models.create(args, tds.class_num, device="cpu")  # a module a thread
        trainer = make_local_train_fn(model.apply, model.loss_fn, create_client_optimizer(args),
                                      epochs=1)
        local = Batches(x=tds.packed_train.x[rank - 1], y=tds.packed_train.y[rank - 1],
                        mask=tds.packed_train.mask[rank - 1])
        client = EdgeClientSim(args, trainer, local, store, rank=rank, size=n + 1)
        client.uniforms = lambda r, rank=rank: _uniforms_of(perms[rank, r])
        clients.append(client)
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    st = threading.Thread(target=server.run, daemon=True)
    st.start()
    for t in threads:
        t.start()
    st.join(120)
    assert not st.is_alive(), "the port's server did not finish"
    for t in threads:
        t.join(30)
    want = params_from_flax(final)
    got = server.aggregator.global_params
    assert set(got) == set(want)
    moved = max(float((want[k] - start[k]).abs().max()) for k in want)
    assert moved > 1e-3
    err = max(float((got[k] - want[k]).abs().max()) for k in want)
    assert err <= LEGACY_ATOL, err
    hist = server.aggregator.history
    assert len(hist) == len(jhist) == 2 and [h["round"] for h in hist] == [0, 1]
    for h, j in zip(hist, jhist):
        np.testing.assert_allclose(h["loss"], j["loss"], rtol=1e-5)
        assert h["count"] == j["count"]
    assert server.manager.finish_acks == {1: True, 2: True, 3: True}


def test_evaluation_follows_the_configured_frequency(tmp_path):
    args = _port_args(run_id="legacy_freq", **{**LEGACY, "comm_round": 7})
    args.frequency_of_the_test = 3
    model = models.create(args, 10, device="cpu")
    server = ServerEdge(args, "cpu", None, model, store=FilePayloadStore(str(tmp_path)))
    agg = server.aggregator
    agg.test_data = Batches(x=torch.zeros(1, 4, 28, 28, 1), y=torch.zeros(1, 4, dtype=torch.int64),
                            mask=torch.ones(1, 4))
    from fedml_tpu_torch.core.local_trainer import make_eval_fn

    agg._eval = make_eval_fn(model.apply, model.loss_fn)
    for r in range(7):
        agg.test_on_server_for_all_clients(r)
    assert [h["round"] for h in agg.history] == [0, 3, 6]


# -- the centralized baseline ----------------------------------------------

CENTRAL = dict(dataset="femnist", model="cnn", synthetic_train_size=96, synthetic_test_size=40,
               client_num_in_total=2, client_num_per_round=2, epochs=2, batch_size=16,
               learning_rate=0.05, random_seed=3)


@pytest.mark.parametrize("schedule", [{}, {"lr_schedule": "cosine", "lr_total_steps": 5}])
def test_centralized_matches_jax_in_float64(schedule):
    import fedml_tpu
    from fedml_tpu import models as jax_models
    from fedml_tpu.centralized import CentralizedTrainer as JaxTrainer
    from test_torch_hier_decentralized import jax_float64_dataset
    from tests.conftest import make_args

    knobs = {**CENTRAL, **schedule}
    with jax.enable_x64(True):
        ja = fedml_tpu.init(make_args(**knobs))
        jds = jax_float64_dataset(ja)
        jt = JaxTrainer(ja, None, jds, jax_models.create(ja, jds.class_num))
        jt.params = jax.tree.map(lambda a: a.astype(jnp.float64), jt.params)
        start = params_from_flax(jax.tree.map(np.asarray, jt.params))
        # the shuffles the JAX trainer draws: one split of its key an epoch
        key, n = jt.rng, int(np.prod(jds.train_data_global.mask.shape))
        perms = []
        for _ in range(knobs["epochs"]):
            key, ep = jax.random.split(key)
            perms.append(np.asarray(jax.random.permutation(jax.random.split(ep, 1)[0], n)))
        jt.train()
        want = params_from_flax(jax.tree.map(np.asarray, jt.params))

    ta = _port_args(**knobs)
    tds = port_dataset(jds)
    tt = CentralizedTrainer(ta, "cpu", tds, models.create(ta, tds.class_num, device="cpu"))
    tt.params = start
    tt.uniforms = lambda epoch: _uniforms_of([perms[epoch]]).to(torch.float64)
    final = tt.train()
    assert len(tt.history) == len(jt.history) == knobs["epochs"]
    for k in want:
        assert tt.params[k].dtype == torch.float64
        np.testing.assert_allclose(tt.params[k].numpy(), want[k].numpy(), atol=F64_ATOL,
                                   err_msg=k)
    for h, j in zip(tt.history, jt.history):
        assert h["epoch"] == j["epoch"]
        for key in ("train_loss", "test_loss", "train_acc", "test_acc"):
            np.testing.assert_allclose(h[key], float(j[key]), rtol=0, atol=F64_ATOL,
                                       err_msg=key)
    assert tt.history[-1]["train_loss"] < tt.history[0]["train_loss"]
    assert np.isfinite(final["test_acc"]) and final["epoch_time_s"] > 0


# -- devices ------------------------------------------------------------------

def test_entry_points_need_a_card_unless_told(monkeypatch, tmp_path):
    args = _port_args(run_id="legacy_dev", **LEGACY)
    tds_model = models.create(args, 10, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fedml_tpu_torch.run_edge_server(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CentralizedTrainer(args, "cuda", None, tds_model)
    with pytest.raises(ValueError, match="lies on cpu"):
        ServerEdge(args, "cuda", None, tds_model, store=FilePayloadStore(str(tmp_path)))
    server = ServerEdge(args, "cpu", None, tds_model, store=FilePayloadStore(str(tmp_path)))
    assert server.aggregator.device.type == "cpu"


def test_run_edge_server_serves_its_clients(tmp_path):
    """``run_edge_server`` on the CPU: the server of ``init`` ->
    ``data.load`` -> ``models.create``, two port clients over MQTT."""
    args = _port_args(run_id="legacy_entry", payload_store_dir=str(tmp_path), **{
        **LEGACY, "client_num_in_total": 2, "client_num_per_round": 2})
    from fedml_tpu_torch import data

    ds = data.load(args, device="cpu")
    store = FilePayloadStore(str(tmp_path))
    out = {}
    st = threading.Thread(target=lambda: out.update(h=fedml_tpu_torch.run_edge_server(
        args, device="cpu")), daemon=True)
    st.start()
    threads = []
    for rank in (1, 2):
        model = models.create(args, ds.class_num, device="cpu")
        trainer = make_local_train_fn(model.apply, model.loss_fn, create_client_optimizer(args),
                                      epochs=1)
        local = Batches(x=ds.packed_train.x[rank - 1], y=ds.packed_train.y[rank - 1],
                        mask=ds.packed_train.mask[rank - 1])
        c = EdgeClientSim(args, trainer, local, store, rank=rank, size=3)
        threads.append(threading.Thread(target=c.run, daemon=True))
        threads[-1].start()
    st.join(120)
    assert not st.is_alive()
    for t in threads:
        t.join(30)
    assert [h["round"] for h in out["h"]] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in out["h"])
