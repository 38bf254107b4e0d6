"""The port's horizontal cross-silo scenario (``fedml_tpu_torch/cross_silo``)
against the JAX package's, on the CPU.

Worlds are one server and N silos as threads of this process, each rank
with its own model (``FedModel.apply`` loads the params into the module
for the call, so two threads must never share one). Every world joins
its threads with a timeout and fails if one is still alive.

- Parity: a LOCAL world of the port, on the JAX loader's federation and
  started from the JAX server's initial params (``params_from_flax``),
  ends within 1e-5 of the JAX package's world (f32; the JAX package's
  own tolerance, tests/test_cross_silo.py); a port world on its own
  data ends within 1e-5 of the port's ``FedAvgAPI`` on the same config.
- Bitwise: TRPC and gRPC equal LOCAL; stream equals buffered, plain,
  with int8 uplinks, with clipping and with both; the async fold of one
  delta sequence equals the JAX package's.
- The JAX package's scenario tests, on the port, reaching the same
  rounds, drops and counters: ``client_id_list`` indirection (and its
  wrong-length message word for word), the loud median fallback, the
  async world exactly once (also under duplication), the deadline cohort,
  the quorum close past a delayed and a killed client, the failure
  detector, late uploads, elastic join and leave, exactly once under
  duplication, restart + RESYNC (scripted and by a chaos schedule), the
  anomaly screen (the same poisoned rank quarantined in both packages),
  and the frozen custom trainer of ``TestCrossSiloSeam``.
"""

from __future__ import annotations

import threading
import time

import jax
import numpy as np
import pytest
import torch

import fedml_tpu_torch
from fedml_tpu_torch import constants, data, models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.core.chaos import ProcessKilled, reset_chaos
from fedml_tpu_torch.core.frame import DefaultClientTrainer
from fedml_tpu_torch.core.message import Message
from fedml_tpu_torch.core.telemetry import Telemetry
from fedml_tpu_torch.cross_silo import Client, Server
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_world import free_port_block

# the JAX package's tolerance for cross-silo vs simulation, f32
ATOL = 1e-5

BASE = dict(
    training_type="cross_silo", dataset="mnist", synthetic_train_size=400,
    synthetic_test_size=80, model="lr", partition_method="hetero",
    client_num_in_total=4, client_num_per_round=4, comm_round=3, epochs=1,
    batch_size=16, learning_rate=0.1, frequency_of_the_test=1, shuffle=False,
)


@pytest.fixture(autouse=True)
def _reset_planes():
    Telemetry.reset()
    reset_chaos()
    yield
    Telemetry.reset()
    reset_chaos()


class Killed(Exception):
    """A scripted kill -9 of a client thread."""


def port_args(rank, run_id, backend="LOCAL", **kw):
    a = Arguments()
    for k, v in dict(BASE, backend=backend, run_id=run_id, **kw).items():
        setattr(a, k, v)
    a.rank = rank
    a._validate()
    return fedml_tpu_torch.init(a, "cpu")


def build(rank, run_id, backend="LOCAL", dataset=None, **kw):
    """(args, dataset, model) of one rank; the rank's own model."""
    a = port_args(rank, run_id, backend, **kw)
    ds = dataset if dataset is not None else data.load(a, device="cpu")
    return a, ds, models.create(a, ds.class_num, device="cpu")


def _guarded(fn):
    def run():
        try:
            fn()
        except (Killed, ProcessKilled):  # lint: except-ok — the scripted kill IS the test
            pass
    return run


def join_all(threads, timeout=60.0):
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    hung = [t.name for t in threads if t.is_alive()]
    assert not hung, f"threads hung: {hung}"


def backend_knobs(backend, n):
    if backend == "TRPC":
        return {"trpc_port_base": free_port_block(n + 1)}
    if backend == "GRPC":
        return {"grpc_port_base": free_port_block(n + 1)}
    return {}


def make_world(run_id, backend="LOCAL", n_clients=None, dataset=None, init=None,
               client_trainer_cls=None, **kw):
    """(server, clients) of one world, not started."""
    n = n_clients or int(dict(BASE, **kw)["client_num_per_round"])
    kw = dict(backend_knobs(backend, n), **kw)
    a0, ds0, m0 = build(0, run_id, backend, dataset, **kw)
    server = Server(a0, "cpu", ds0, m0)
    if init is not None:
        server.aggregator.set_global_model_params(init)
    clients = []
    for r in range(1, n + 1):
        a, ds, m = build(r, run_id, backend, dataset, **kw)
        ct = client_trainer_cls(m, a) if client_trainer_cls else None
        clients.append(Client(a, "cpu", ds, m, client_trainer=ct))
    return server, clients


def run_world(run_id, backend="LOCAL", hook=None, timeout=60.0, **kw):
    """Build, optionally ``hook(server, clients)``, run to the end; the
    server."""
    server, clients = make_world(run_id, backend, **kw)
    if hook is not None:
        hook(server, clients)
    threads = [threading.Thread(target=_guarded(c.run), daemon=True, name=f"c{i + 1}")
               for i, c in enumerate(clients)]
    for t in threads:
        t.start()
    server.run()
    join_all(threads, timeout)
    return server


def params_of(server):
    return {k: v.detach().clone() for k, v in server.aggregator.get_global_model_params().items()}


def assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def counter(name):
    return sum(Telemetry.get_instance().counters_matching(name).values())


# -- parity with the JAX package and the port's simulation ----------------


def _jax_world(jargs_kw, run_id, n):
    """The JAX package's LOCAL world (tests/test_cross_silo.py's shape)."""
    import fedml_tpu
    from fedml_tpu import models as jax_models
    from fedml_tpu.cross_silo import Client as JClient, Server as JServer
    from fedml_tpu.data import load as jax_load
    from tests.conftest import make_args as jax_args

    def make(rank):
        a = jax_args(**dict(jargs_kw, backend="LOCAL", run_id=run_id))
        a.rank = rank
        a = fedml_tpu.init(a)
        ds = jax_load(a)
        return a, ds, jax_models.create(a, ds.class_num)

    a0, ds0, m0 = make(0)
    server = JServer(a0, None, ds0, m0)
    init = jax.tree.map(np.asarray, server.aggregator.get_global_model_params())
    clients = []
    for r in range(1, n + 1):
        a, ds, m = make(r)
        clients.append(JClient(a, None, ds, m))
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    server.run()
    join_all(threads)
    return server, ds0, init


def _port_dataset(jds):
    from test_torch_hier_decentralized import port_dataset

    return port_dataset(jds)


CLIP = {"defense_type": "norm_diff_clipping", "norm_bound": 0.5}


@pytest.mark.parametrize("knobs", [
    {}, CLIP, {"compression": "int8"}, dict(CLIP, compression="int8"),
], ids=["plain", "clip", "int8", "int8_clip"])
def test_port_world_matches_the_jax_world(knobs):
    """3 rounds, 4 silos, LOCAL: the port world on the JAX loader's
    federation from the JAX server's initial params. Plain and clipped
    worlds agree to 1e-5; int8 worlds to one quantization step (the
    largest per-leaf scale of any upload the port server decoded), and a
    clipped world clips the same uploads as the JAX server."""
    jserver, jds, jinit = _jax_world(dict(BASE, **knobs), "pjw_jax", 4)
    want = params_from_flax(jax.tree.map(np.asarray, jserver.aggregator.get_global_model_params()))
    step = {}

    def record_scales(server, clients):
        agg = server.aggregator
        receive = agg.receive_upload

        def recording(index, sample_num, model_params=None, encoded=None, **kw):
            for k, leaf in (encoded or {}).items():
                step[k] = max(step.get(k, 0.0), float(leaf["scale"]))
            return receive(index, sample_num, model_params=model_params, encoded=encoded, **kw)

        agg.receive_upload = recording

    server = run_world("pjw_port", dataset=_port_dataset(jds), init=params_from_flax(jinit),
                       hook=record_scales, **knobs)
    got = params_of(server)
    assert server.manager.round_idx == 3
    if "compression" in knobs:
        assert step.keys() == want.keys()
    else:
        assert not step
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=max(ATOL, step.get(k, 0.0)), err_msg=k)
    if "defense_type" in knobs:
        assert server.aggregator.defense_clipped == jserver.aggregator.defense_clipped > 0


def test_matches_the_port_simulation():
    from fedml_tpu_torch.simulation import FedAvgAPI

    server = run_world("sim_cs")
    a = port_args(0, "sim_sp", training_type="simulation")
    ds = data.load(a, device="cpu")
    api = FedAvgAPI(a, "cpu", ds, models.create(a, ds.class_num, device="cpu"))
    api.train()
    got = params_of(server)
    for k, v in api.global_params.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=ATOL, err_msg=k)


@pytest.mark.parametrize("backend", ["TRPC", "GRPC"])
def test_networked_fabrics_equal_local_bitwise(backend):
    kw = dict(comm_round=2, client_num_in_total=3, client_num_per_round=3)
    local = params_of(run_world(f"fab_local_{backend}", **kw))
    wire = params_of(run_world(f"fab_{backend}", backend, **kw))
    assert_bitwise(local, wire)


@pytest.mark.parametrize("facade", ["Server", "Client"])
def test_a_facade_refuses_a_device_its_model_does_not_lie_on(facade):
    cls = {"Server": Server, "Client": Client}[facade]
    a, ds, m = build(0 if facade == "Server" else 1, "devchk")
    for device in ("cuda", None):
        with pytest.raises(ValueError, match="the model lies on cpu"):
            cls(a, device, ds, m)


def test_client_id_list_indirection():
    server = run_world("cs_ids", client_id_list="[101, 205, 309, 407]")
    assert server.manager.round_idx == 3
    assert server.manager.client_real_ids == [101, 205, 309, 407]


def test_client_id_list_wrong_length_message_word_for_word():
    from fedml_tpu.cross_silo.horizontal.fedml_server_manager import (
        _resolve_client_real_ids as jax_resolve,
    )
    from tests.conftest import make_args as jax_args

    from fedml_tpu_torch.cross_silo.horizontal.fedml_server_manager import (
        _resolve_client_real_ids,
    )

    msgs = []
    for resolve, a in ((jax_resolve, jax_args(**dict(BASE, client_id_list="[1, 2]"))),
                       (_resolve_client_real_ids, port_args(0, "x", client_id_list="[1, 2]"))):
        with pytest.raises(ValueError, match="client_id_list") as ei:
            resolve(a, size=5)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


# -- stream == buffered, bitwise -------------------------------------------


@pytest.mark.parametrize("knobs", [
    {},
    {"compression": "int8"},
    {"defense_type": "norm_diff_clipping", "norm_bound": 0.5},
    {"compression": "int8", "defense_type": "norm_diff_clipping", "norm_bound": 0.5},
], ids=["plain", "int8", "clip", "int8_clip"])
def test_stream_equals_buffered_bitwise(knobs):
    buffered = run_world("sb_buf", agg_mode="buffered", **knobs)
    assert buffered.aggregator.peak_buffered == 4
    Telemetry.reset()
    streamed = run_world("sb_str", agg_mode="stream", **knobs)
    assert streamed.aggregator.peak_buffered == 0
    assert_bitwise(params_of(buffered), params_of(streamed))
    assert counter("agg_stream_fallback_total") == 0
    if "defense_type" in knobs:
        assert streamed.aggregator.defense_clipped == buffered.aggregator.defense_clipped > 0


def test_median_falls_back_loudly(caplog):
    import logging

    from fedml_tpu_torch.cross_silo import FedMLAggregator

    a, ds, m = build(0, "fb1", agg_mode="stream", defense_type="median")
    with caplog.at_level(logging.WARNING):
        agg = FedMLAggregator(a, m)
    assert not agg.streaming
    assert len([r for r in caplog.records
                if "falling back to the BUFFERED" in r.getMessage()]) == 1
    assert counter("agg_stream_fallback_total") == 1
    agg.begin_round([0, 1, 2])
    for i, s in enumerate((1.0, 3.0, 9.0)):
        agg.receive_upload(i, 10.0, model_params={k: torch.full_like(v, s)
                                                  for k, v in agg.global_params.items()})
    assert agg.peak_buffered == 3
    for v in agg.aggregate().values():
        assert torch.all(v == 3.0)


# -- async (FedBuff-style) --------------------------------------------------


def test_staleness_oracle_and_knobs_match_the_jax_package():
    from fedml_tpu.core.aggregation import staleness_weight as jax_weight
    from tests.conftest import make_args as jax_args

    from fedml_tpu_torch.core.aggregation import staleness_weight

    for n, s, d in [(10.0, 0, 0.5), (32.0, 3, 0.5), (7.0, 5, 0.9), (1.0, 10, 1.0)]:
        assert staleness_weight(n, s, d) == jax_weight(n, s, d)
    with pytest.raises(ValueError):
        staleness_weight(1.0, -1, 0.5)
    for bad in (dict(staleness_decay=0.0), dict(staleness_max=-1),
                dict(async_publish_every=0), dict(round_quorum_frac=1.5),
                dict(agg_mode="async", aggregation_deadline_s=1.0),
                dict(agg_mode="bogus")):
        with pytest.raises(ValueError) as je:
            jax_args(**bad)
        with pytest.raises(ValueError) as te:
            port_args(0, "knobs", **bad)
        assert str(te.value) == str(je.value)


def test_async_delta_sequence_folds_bitwise_like_the_jax_package():
    """Both packages' aggregators, from the same params, fold the same
    staleness-discounted deltas and publish: bitwise equal globals."""
    import fedml_tpu
    from fedml_tpu import models as jax_models
    from fedml_tpu.cross_silo.horizontal.fedml_aggregator import (
        FedMLAggregator as JaxAggregator,
    )
    from fedml_tpu.data import load as jax_load
    from tests.conftest import make_args as jax_args

    from fedml_tpu_torch.cross_silo import FedMLAggregator

    ja = fedml_tpu.init(jax_args(**dict(BASE, agg_mode="async")))
    jds = jax_load(ja)
    jagg = JaxAggregator(ja, jax_models.create(ja, jds.class_num))
    a, ds, m = build(0, "async_bits", agg_mode="async")
    agg = FedMLAggregator(a, m)
    g0 = jax.tree.map(np.asarray, jagg.get_global_model_params())
    agg.set_global_model_params(params_from_flax(g0))
    rng = np.random.default_rng(3)
    for n, scale in [(10.0, 1.0), (20.0, 0.5), (7.0, 0.25), (13.0, 1.0)]:
        d = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32) * 0.1, g0)
        jagg.fold_delta(n, delta=d, weight_scale=scale)
        agg.fold_delta(n, delta=params_from_flax(d), weight_scale=scale)
    assert agg.pending_folds() == 4
    jagg.publish_async()
    agg.publish_async()
    assert agg.pending_folds() == 0
    want = params_from_flax(jax.tree.map(np.asarray, jagg.get_global_model_params()))
    assert_bitwise(params_of(type("S", (), {"aggregator": agg})), want)
    before = params_of(type("S", (), {"aggregator": agg}))
    agg.publish_async()  # nothing folded: a no-op
    assert_bitwise(before, params_of(type("S", (), {"aggregator": agg})))


def _assert_exactly_once(mgr):
    from fedml_tpu_torch.core.aggregation import staleness_weight

    ids = [(e["rank"], e["seq"]) for e in mgr.async_weight_log]
    assert len(ids) == len(set(ids)), "a (rank, seq) pair folded twice"
    for e in mgr.async_weight_log:
        assert e["weight"] == pytest.approx(
            staleness_weight(e["sample_num"], e["staleness"], mgr.staleness_decay))
    assert mgr.async_folds == mgr._async_target_folds()


@pytest.mark.parametrize("faults", [False, True], ids=["clean", "dup_delay"])
def test_async_world_exactly_once(faults):
    kw = dict(agg_mode="async", async_publish_every=3)
    if faults:
        kw.update(async_publish_every=2, reliable_comm=True, comm_retry_max=8,
                  comm_retry_base_s=0.05,
                  fault_injection={"duplicate_prob": 0.5, "delay_s": 0.05, "delay_prob": 0.2})
    server = run_world(f"async_{faults}", **kw)
    mgr = server.manager
    assert mgr._async_target_folds() == 3 * 4
    _assert_exactly_once(mgr)
    assert counter("agg_folds_total") == mgr.async_folds
    assert counter("agg_publish_total") == mgr.version
    if faults:
        assert counter("comm_dup_dropped_total") > 0, "dedup never exercised"
    else:
        assert mgr.version >= 12 // 3
    for v in server.aggregator.get_global_model_params().values():
        assert torch.isfinite(v).all()


# -- deadline, quorum, failure detector, late uploads ----------------------


def _slow(trainer, delay_s):
    orig = trainer.train

    def slow(params, round_idx):
        time.sleep(delay_s)
        return orig(params, round_idx)

    trainer.train = slow


STRAGGLE = dict(synthetic_train_size=300, synthetic_test_size=60,
                client_num_in_total=3, client_num_per_round=3, comm_round=2)


def test_deadline_drops_the_straggler_and_rounds_complete():
    t0 = time.perf_counter()
    server = run_world("dl1", hook=lambda s, cs: _slow(cs[2].trainer, 2.0),
                       aggregation_deadline_s=0.5, **STRAGGLE)
    assert server.manager.round_idx == 2
    assert server.manager.stragglers_dropped == 2
    assert time.perf_counter() - t0 < 4.0 + 2 * 2.0  # the slow thread's tail


def test_no_deadline_waits_for_everyone():
    t0 = time.perf_counter()
    server = run_world("dl2", hook=lambda s, cs: _slow(cs[2].trainer, 0.5),
                       **dict(STRAGGLE, comm_round=1))
    assert server.manager.round_idx == 1
    assert server.manager.stragglers_dropped == 0
    assert time.perf_counter() - t0 >= 0.5


def test_deadline_result_matches_the_two_client_world():
    dl = run_world("dl3", hook=lambda s, cs: _slow(cs[2].trainer, 2.0),
                   aggregation_deadline_s=0.5, **dict(STRAGGLE, comm_round=1))

    def pin(server, clients):
        server.aggregator.data_silo_selection = lambda r, n, k: [0, 1]

    ref = run_world("dl3b", hook=pin, n_clients=2,
                    **dict(STRAGGLE, comm_round=1, client_num_per_round=2))
    assert_bitwise(params_of(dl), params_of(ref))


def _kill(manager, at_round=None):
    orig = manager._train_and_send

    def kill_or_train(msg):
        if at_round is None or int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX, 0)) == at_round:
            manager._stop_heartbeat()
            raise Killed()
        orig(msg)

    manager._train_and_send = kill_or_train


def test_quorum_closes_past_a_delayed_and_a_killed_client():
    def hook(server, clients):
        _slow(clients[2].trainer, 3.0)
        _kill(clients[1].manager)

    t0 = time.monotonic()
    server = run_world("qc1", hook=hook, comm_round=2, round_quorum_frac=0.5,
                       round_grace_s=1.5, heartbeat_interval_s=0.1,
                       heartbeat_timeout_s=0.8)
    mgr = server.manager
    assert mgr.round_idx == 2
    assert mgr.quorum_closes >= 1
    assert mgr.deaths == 1
    assert mgr.stragglers_dropped >= 1
    assert counter("agg_quorum_closes_total") >= 1
    assert time.monotonic() - t0 < 4.0 + 2 * 3.0


def test_killed_client_cannot_stall_the_round():
    server = run_world("fd_kill", hook=lambda s, cs: _kill(cs[1].manager, at_round=1),
                       heartbeat_interval_s=0.1, heartbeat_timeout_s=1.0)
    assert server.manager.round_idx == 3
    assert server.manager.deaths == 1
    assert 2 in server.manager._dead_ranks
    assert counter("cross_silo_clients_declared_dead_total") == 1


def test_late_upload_discarded_and_counted():
    from fedml_tpu_torch.cross_silo import FedMLAggregator, FedMLServerManager

    a, ds, m = build(0, "late1")
    agg = FedMLAggregator(a, m)
    mgr = FedMLServerManager(a, agg, rank=0, size=5, backend="LOCAL")
    mgr.round_idx = 5
    up = Message(constants.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, 2, 0)
    up.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, 3)
    up.add_params(constants.MSG_ARG_KEY_MODEL_PARAMS, agg.global_params)
    up.add_params(constants.MSG_ARG_KEY_NUM_SAMPLES, 10.0)
    mgr.handle_message_receive_model_from_client(up)
    assert agg.num_received() == 0
    assert counter("agg_late_uploads_total") == 1
    mgr.com_manager.stop_receive_message()


def test_quorum_denominator_shrinks_with_client_num():
    from fedml_tpu_torch.cross_silo import FedMLAggregator

    a, ds, m = build(0, "qd1", round_quorum_frac=0.75)
    agg = FedMLAggregator(a, m)
    agg.begin_round([0, 1, 2, 3])
    assert agg.quorum_target(0.75) == 3
    agg.receive_upload(0, 10.0, model_params=agg.global_params)
    agg.receive_upload(1, 10.0, model_params=agg.global_params)
    assert not agg.quorum_met(0.75)
    assert agg.drop_expected(3) and agg.quorum_target(0.75) == 3
    assert agg.drop_expected(2) and agg.quorum_target(0.75) == 2
    assert agg.quorum_met(0.75) and agg.missing_indexes() == []


# -- elastic membership -----------------------------------------------------


ELASTIC = dict(synthetic_train_size=300, synthetic_test_size=60, client_num_in_total=3,
               client_num_per_round=2, frequency_of_the_test=5, elastic_membership=True)


def test_elastic_late_client_joins_and_trains():
    server, clients = make_world("elastic_join", n_clients=3, comm_round=10, **ELASTIC)
    late = clients[2]
    late_calls = []
    orig_train = late.trainer.train
    late.trainer.train = lambda p, r: (late_calls.append(r), orig_train(p, r))[1]
    first_round_done = threading.Event()
    orig_finish = server.manager._finish_round

    def finish_hook():
        first_round_done.set()
        orig_finish()

    server.manager._finish_round = finish_hook
    for c in clients[:2]:
        _slow(c.trainer, 0.2)

    def run_late():
        assert first_round_done.wait(timeout=60)
        late.run()

    threads = [threading.Thread(target=clients[0].run, daemon=True),
               threading.Thread(target=clients[1].run, daemon=True),
               threading.Thread(target=run_late, daemon=True)]
    for t in threads:
        t.start()
    server.run()
    join_all(threads)
    assert server.manager.round_idx == 10
    assert server.manager.joins == 1
    assert len(late_calls) >= 1


def test_nonelastic_ignores_an_unknown_rank():
    from fedml_tpu_torch.cross_silo import FedMLAggregator, FedMLServerManager

    a, ds, m = build(0, "ne1", **dict(ELASTIC, elastic_membership=False))
    mgr = FedMLServerManager(a, FedMLAggregator(a, m), rank=0, size=3, backend="LOCAL")
    msg = Message(constants.MSG_TYPE_C2S_CLIENT_STATUS, 99, 0)
    msg.add_params(constants.MSG_ARG_KEY_CLIENT_STATUS, constants.CLIENT_STATUS_ONLINE)
    mgr.handle_message_client_status_update(msg)
    assert not mgr.is_initialized and 99 not in mgr.client_online_status
    mgr.com_manager.stop_receive_message()


def test_elastic_leaver_does_not_stall_a_round():
    def hook(server, clients):
        leaver = clients[1].manager
        orig = leaver._train_and_send

        def train_or_leave(msg):
            if int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX, 0)) == 0:
                orig(msg)
            else:
                leaver.leave()

        leaver._train_and_send = train_or_leave

    server = run_world("elastic_leave", hook=hook, n_clients=3,
                       **dict(ELASTIC, client_num_per_round=3, comm_round=4))
    assert server.manager.round_idx == 4
    assert server.manager.leaves == 1


# -- exactly once, restart + RESYNC ---------------------------------------


def test_duplicated_and_delayed_uploads_aggregate_exactly_once():
    clean = params_of(run_world("rel_clean"))
    Telemetry.reset()
    lossy = run_world("rel_dup", reliable_comm=True, comm_retry_max=8, comm_retry_base_s=0.05,
                      fault_injection={"duplicate_prob": 0.5, "delay_s": 0.05,
                                       "delay_prob": 0.2})
    assert counter("comm_dup_dropped_total") > 0, "dedup never exercised"
    assert counter("cross_silo_clients_aggregated_total") == 3 * 4
    assert_bitwise(clean, params_of(lossy))


def _restart_world(tmp_path, run_id, crash):
    """A world whose first server incarnation dies (``crash`` arms it),
    restarted from its checkpoint + WAL; the clients re-announce by
    heartbeat and are RESYNCed. Returns (second server, kill-to-close
    seconds)."""
    kw = dict(heartbeat_interval_s=0.1, heartbeat_timeout_s=60.0,
              checkpoint_dir=str(tmp_path / run_id), checkpoint_freq=1)
    server1, clients = make_world(run_id, **kw)
    crashed = threading.Event()
    crash(server1, crashed, kw)
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()

    def server1_thread():
        try:
            server1.run()
        except (Killed, ProcessKilled):
            if server1.manager._failure_detector is not None:
                server1.manager._failure_detector.stop()
            crashed.set()

    st = threading.Thread(target=server1_thread, daemon=True)
    st.start()
    assert crashed.wait(timeout=60)
    t_kill = time.perf_counter()
    join_all([st])
    a0, ds0, m0 = build(0, run_id, **kw)
    server2 = Server(a0, "cpu", ds0, m0)
    assert server2.manager._resumed and server2.manager.round_idx >= 1
    closed = []
    orig = server2.manager._report_round

    def report(*a):
        closed.append(time.perf_counter())
        orig(*a)

    server2.manager._report_round = report
    server2.run()
    join_all(threads, 90)
    return server2, closed[0] - t_kill


def test_restart_resumes_the_round_and_resyncs_clients(tmp_path):
    straight = params_of(run_world("rs_straight"))

    def crash(server1, crashed, kw):
        mgr = server1.manager
        orig_report = mgr._report_round

        def report_then_crash(eval_round, cohort, n_aggregated):
            orig_report(eval_round, cohort, n_aggregated)
            if eval_round == 0:
                raise Killed()

        mgr._report_round = report_then_crash

    server2, _ = _restart_world(tmp_path, "rs_world", crash)
    assert server2.manager.round_idx == 3
    recs = server2.manager._wal.records()
    assert [r["round_idx"] for r in recs] == [0, 1, 2]
    assert all(r["folded"] == [1, 2, 3, 4] for r in recs)
    assert counter("cross_silo_client_resyncs_total") == 4
    assert_bitwise(straight, params_of(server2))


def test_chaos_kill_at_round_close_recovers_bitwise(tmp_path):
    """The chaos plane's own choreography: a schedule kills the server
    at ``server.round_close`` of round 1."""
    straight = params_of(run_world("ck_straight"))

    def crash(server1, crashed, kw):
        server1.args.chaos_schedule = [
            {"at": {"event": "barrier", "name": "server.round_close", "round": 1},
             "fault": "kill_server"}]
        from fedml_tpu_torch.core.chaos import maybe_install_chaos

        maybe_install_chaos(server1.args)

    server2, seconds = _restart_world(tmp_path, "ck_world", crash)
    assert server2.manager.round_idx == 3 and seconds > 0
    assert [r["round_idx"] for r in server2.manager._wal.records()] == [0, 1, 2]
    assert counter("chaos_faults_injected_total") == 1
    assert_bitwise(straight, params_of(server2))


def test_client_resync_trains_like_a_sync():
    from fedml_tpu_torch.cross_silo import FedMLClientManager, FedMLTrainer

    a, ds, m = build(1, "resync_unit")
    mgr = FedMLClientManager(a, FedMLTrainer(a, ds, m), rank=1, size=5, backend="LOCAL")
    sent = []
    mgr.send_message = sent.append
    msg = Message(constants.MSG_TYPE_S2C_RESYNC, 0, 1)
    msg.add_params(constants.MSG_ARG_KEY_MODEL_PARAMS, m.init(torch.Generator().manual_seed(0)))
    msg.add_params(constants.MSG_ARG_KEY_CLIENT_INDEX, 0)
    msg.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, 2)
    mgr.handle_message_resync(msg)
    assert len(sent) == 1
    assert sent[0].get_type() == constants.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER
    assert sent[0].get(constants.MSG_ARG_KEY_ROUND_INDEX) == 2


# -- the anomaly screen -----------------------------------------------------


def test_the_screen_quarantines_the_same_rank_in_both_packages():
    """The JAX package's ``test_screen_quarantines_and_rejects_before_fold``
    on both aggregators from the same params: the same statuses,
    reputations, quarantined ranks and releases."""
    import fedml_tpu
    from fedml_tpu import models as jax_models
    from fedml_tpu.cross_silo.horizontal.fedml_aggregator import (
        FedMLAggregator as JaxAggregator,
    )
    from fedml_tpu.data import load as jax_load
    from tests.conftest import make_args as jax_args

    from fedml_tpu_torch.cross_silo import FedMLAggregator

    knobs = dict(agg_mode="stream", defense_type="norm_diff_clipping", norm_bound=5.0,
                 defense_anomaly_threshold=0.4, defense_quarantine_rounds=1)
    ja = fedml_tpu.init(jax_args(**dict(BASE, **knobs)))
    jagg = JaxAggregator(ja, jax_models.create(ja, jax_load(ja).class_num))
    a, ds, m = build(0, "screen", **knobs)
    agg = FedMLAggregator(a, m)
    g = jax.tree.map(np.asarray, jagg.global_params)
    agg.set_global_model_params(params_from_flax(g))
    near = jax.tree.map(lambda x: x + 0.01, g)
    attack = jax.tree.map(lambda x: x - 50.0, g)
    trace = []
    for name, ag, conv in (("jax", jagg, lambda t: t), ("port", agg, params_from_flax)):
        ag.begin_round([0, 1, 2])
        got = [ag.receive_upload(0, 10.0, model_params=conv(near)),
               ag.receive_upload(1, 10.0, model_params=conv(near)),
               ag.receive_upload(2, 10.0, model_params=conv(attack))]
        got += [sorted(ag.quarantined_ranks()), ag.defense_rejected, ag.num_received(),
                round(ag.screen.reputation(2), 6),
                ag.receive_upload(2, 10.0, model_params=conv(near)),
                ag.tick_defense(), ag.tick_defense(), sorted(ag.quarantined_ranks())]
        trace.append(got)
    assert trace[0] == trace[1]
    assert trace[1][:4] == ["folded", "folded", "quarantined", [3]]


def test_a_quarantined_rank_cannot_stall_the_quorum_round():
    def hook(server, clients):
        attacker = clients[1].trainer
        orig = attacker.train

        def byzantine(params, round_idx):
            new, n = orig(params, round_idx)
            return {k: v - 100.0 for k, v in new.items()}, n

        attacker.train = byzantine

    server = run_world("qworld", hook=hook, defense_type="norm_diff_clipping", norm_bound=1.0,
                       defense_anomaly_threshold=0.3, defense_quarantine_rounds=5)
    assert server.manager.round_idx == 3
    q = Telemetry.get_instance().counters_matching("defense_quarantined_total")
    assert "defense_quarantined_total{rank=2}" in q
    assert server.aggregator.quarantined_ranks() == {2}
    assert counter("defense_quarantined_rejected_total") >= 1


# -- the operator seam ------------------------------------------------------


class FrozenTrainer(DefaultClientTrainer):
    """Local training is a no-op: the global model can never move."""

    def make_train_fn(self, args):
        inner = super().make_train_fn(args)

        def train(params, batches, rng):
            _, metrics = inner(params, batches, rng)
            return params, metrics

        return train


def test_frozen_trainer_freezes_cross_silo():
    server = run_world("seam_frozen", client_trainer_cls=FrozenTrainer)
    a, ds, m = build(0, "seam_init")
    assert_bitwise(m.init(torch.Generator().manual_seed(0)), params_of(server))


def test_entry_points_default_to_cuda():
    for fn in (fedml_tpu_torch.run_cross_silo_server, fedml_tpu_torch.run_cross_silo_client,
               fedml_tpu_torch.run_hierarchical_cross_silo_server,
               fedml_tpu_torch.run_hierarchical_cross_silo_client):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(port_args(0, "nocuda"))


def test_entry_points_run_a_world_on_the_cpu():
    """``run_cross_silo_server`` / ``_client`` with ``device="cpu"``: the
    server returns its last evaluated round's stats."""
    out = {}
    kw = dict(client_num_in_total=2, client_num_per_round=2, comm_round=2)
    threads = [threading.Thread(
        target=fedml_tpu_torch.run_cross_silo_client,
        args=(port_args(r, "entry", **kw),), kwargs={"device": "cpu"}, daemon=True)
        for r in (1, 2)]
    for t in threads:
        t.start()
    out["stats"] = fedml_tpu_torch.run_cross_silo_server(port_args(0, "entry", **kw), device="cpu")
    join_all(threads)
    assert out["stats"]["count"] == 80 and 0.0 <= out["stats"]["acc"] <= 1.0
