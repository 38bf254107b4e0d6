"""The port's edge plane over ranks (``fedml_tpu_torch/cross_silo/
hierarchical``: ``edge_plane: ranks``) against the JAX package's, on the
CPU.

- Planning bitwise the JAX package's (``plan_edge_partition``,
  ``edge_clients``, ``edge_fabric_run_id``, ``edge_port_base``,
  ``hier_partition``, ``prepare_client_args``) and the knob messages word
  for word.
- The tree over ranks == the in-process tree == flat, bitwise, for raw
  and int8 uplinks, also under drop + duplicate faults on both hops
  with the reliable channel (exactly one fold per (client, round), one
  merge per (edge, round)).
- The JAX package's unit and world scenarios (tests/test_hierarchical.py)
  on the port: duplicate and stale reports dropped, quarantine evidence
  up and the decision down and released, the edge enforcing it, an
  abandoned edge window, held rounds, a dead edge dropping out while the
  survivor closes the round, all edges dead finishing loudly, the
  detector declaring a silent edge, and an edge killed at its
  ``edge.merge_upload`` barrier recovering bitwise. Where the JAX test
  asserts through ``core/invariants.py`` (not ported yet) the WAL
  sub-ledgers and counters are asserted directly.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest

from fedml_tpu_torch import constants, data
from fedml_tpu_torch.core.aggregation import StreamingAccumulator
from fedml_tpu_torch.core.chaos import ProcessKilled
from fedml_tpu_torch.core.checkpoint import RoundWAL
from fedml_tpu_torch.core.comm.local import _Fabric
from fedml_tpu_torch.core.message import Message
from fedml_tpu_torch.core.telemetry import Telemetry
from fedml_tpu_torch.cross_silo import FedMLAggregator
from fedml_tpu_torch.cross_silo.hierarchical import (
    HierEdge,
    RootServerManager,
    edge_clients,
    edge_port_base,
    hier_partition,
    plan_edge_partition,
    prepare_client_args,
    run_local_hier_world,
)
from test_torch_cross_silo import (  # noqa: F401 (autouse fixture)
    _reset_planes,
    assert_bitwise,
    build,
    counter,
    params_of,
    port_args,
    run_world,
)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(synthetic_train_size=200, synthetic_test_size=40, comm_round=2,
             frequency_of_the_test=2)
RANKS = dict(edge_plane="ranks", edge_num=2)


def run_hier(run_id, n=4, edge_wrapper=None, **kw):
    def mk(role, rank):
        return build(rank, run_id, **dict(SMALL, client_num_in_total=n,
                                          client_num_per_round=n, **RANKS, **kw))

    return run_local_hier_world(mk, n, 2, join_timeout_s=60.0, edge_wrapper=edge_wrapper)


def root_params(world):
    return params_of(world["root"])


# -- planning, bitwise the JAX package's -----------------------------------


@pytest.mark.parametrize("n, e, sizes", [
    (8, 4, None), (4, 2, [100, 1, 1, 1]), (7, 3, [5, 9, 2, 2, 40, 1, 3]),
    (16, 5, None), (3, 3, [1.5, 2.5, 0.5]), (1, 1, None),
])
def test_planning_bitwise_the_jax_package(n, e, sizes):
    from fedml_tpu.cross_silo.hierarchical import plane as jplane

    from fedml_tpu_torch.cross_silo.hierarchical import plane

    p, jp = plane.plan_edge_partition(n, e, sizes), jplane.plan_edge_partition(n, e, sizes)
    assert p == jp
    assert plane.edge_clients(p) == jplane.edge_clients(jp)
    assert plane.edge_fabric_run_id("run7", e) == jplane.edge_fabric_run_id("run7", e)


def test_port_blocks_partition_and_client_args_match():
    from fedml_tpu.cross_silo.hierarchical import (
        edge_port_base as jax_port_base,
        hier_partition as jax_partition,
        prepare_client_args as jax_prepare,
    )
    from fedml_tpu.data import load as jax_load
    from tests.conftest import make_args as jax_args

    kw = dict(training_type="cross_silo", client_num_in_total=4, client_num_per_round=4,
              dataset="mnist", synthetic_train_size=200, synthetic_test_size=40,
              model="lr", run_id="hp", backend="GRPC", grpc_port_base=9000, **RANKS)
    ja = jax_args(**kw)
    ta = port_args(0, kw.pop("run_id"), kw.pop("backend"), **kw)
    for e in (1, 2):
        assert edge_port_base(ta, e) == jax_port_base(ja, e)
    # the per-client load comes from the silo sample counts
    assert hier_partition(ta, data.load(ta, device="cpu")) == jax_partition(ja, jax_load(ja))
    part = plan_edge_partition(4, 2)
    ja.rank = ta.rank = 3
    jax_prepare(ja, part)
    prepare_client_args(ta, part)
    assert (ta.run_id, ta.grpc_port_base) == (ja.run_id, ja.grpc_port_base)
    assert ta.run_id == f"hp_edge{part[3]}"
    ta.rank = 99
    with pytest.raises(ValueError, match="not in the edge partition"):
        prepare_client_args(ta, part)
    with pytest.raises(ValueError, match="edge_num") as te:
        plan_edge_partition(4, 0)
    from fedml_tpu.cross_silo.hierarchical import plan_edge_partition as jax_plan

    with pytest.raises(ValueError) as je:
        jax_plan(4, 0)
    assert str(te.value) == str(je.value)


OK = dict(training_type="cross_silo", client_num_per_round=4, client_num_in_total=4, **RANKS)


@pytest.mark.parametrize("bad", [
    dict(agg_mode="async"), dict(agg_mode="buffered"),
    dict(defense_type="median", norm_bound=1.0), dict(elastic_membership=True),
    dict(aggregation_deadline_s=5.0), dict(edge_num=9), dict(edge_plane="bogus"),
    dict(hier_port_stride=0), dict(training_type="simulation", backend="sp"),
])
def test_knob_messages_word_for_word(bad):
    from fedml_tpu_torch.arguments import Arguments
    from tests.conftest import make_args as jax_args

    def port(**kw):
        a = Arguments()
        for k, v in kw.items():
            setattr(a, k, v)
        a._validate()

    jax_args(**OK)
    port(**OK)
    msgs = []
    for make in (jax_args, port):
        with pytest.raises(ValueError) as ei:
            make(**dict(OK, **bad))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_inproc_tree_suppressed_under_the_ranks_plane():
    a, ds, m = build(0, "sup", **dict(SMALL, **RANKS))
    assert FedMLAggregator(a, m)._tree is None
    a, ds, m = build(0, "sup2", **dict(SMALL, edge_num=2))
    assert FedMLAggregator(a, m)._tree is not None


# -- bit identity -----------------------------------------------------------


@pytest.mark.parametrize("knobs", [{}, {"compression": "int8"}], ids=["raw", "int8"])
def test_tree_over_ranks_equals_inproc_tree_equals_flat(knobs):
    flat = params_of(run_world("hier_flat", **dict(SMALL, **knobs)))
    Telemetry.reset()
    inproc = params_of(run_world("hier_inproc", edge_num=2, **dict(SMALL, **knobs)))
    Telemetry.reset()
    world = run_hier("hier_ranks", **knobs)
    assert_bitwise(flat, inproc)
    assert_bitwise(flat, root_params(world))
    assert counter("hier_uploads_folded_total") == 4 * 2
    assert counter("hier_edge_merges_total") == 2 * 2


def test_drop_and_duplicate_faults_heal_to_exactly_once():
    clean = root_params(run_hier("hier_clean_x1"))
    Telemetry.reset()
    world = run_hier("hier_fault_x1", reliable_comm=True, comm_retry_max=8,
                     comm_retry_base_s=0.05,
                     fault_injection={"drop_prob": 0.25, "duplicate_prob": 0.25})
    assert counter("hier_uploads_folded_total") == 4 * 2
    assert counter("hier_edge_merges_total") == 2 * 2
    assert_bitwise(clean, root_params(world))


# -- the root decides, the edges enforce ----------------------------------


def _edge_report(edge, round_idx, template, folded, cohort):
    acc = StreamingAccumulator(template)
    for r in folded:
        acc.fold({k: v + np.float32(0.01 * r) for k, v in template.items()}, 50.0)
    msg = Message(constants.MSG_TYPE_E2R_EDGE_REPORT, edge, 0)
    msg.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, round_idx)
    msg.add_params(constants.MSG_ARG_KEY_EDGE_STATE, acc.export_state())
    msg.add_params(constants.MSG_ARG_KEY_FOLDED, list(folded))
    msg.add_params(constants.MSG_ARG_KEY_COHORT, list(cohort))
    return msg


def _online(sender):
    m = Message(constants.MSG_TYPE_C2S_CLIENT_STATUS, sender, 0)
    m.add_params(constants.MSG_ARG_KEY_CLIENT_STATUS, constants.CLIENT_STATUS_ONLINE)
    return m


def _drain(run_id, rank):
    q = _Fabric.get(f"run_{run_id}").inbox(rank)
    out = []
    while not q.empty():
        out.append(q.get_nowait())
    return [m for m in out if isinstance(m, Message)]


@pytest.fixture
def root_world(tmp_path):
    a, ds, m = build(0, f"rootunit_{tmp_path.name}",
                     **dict(SMALL, synthetic_train_size=80, synthetic_test_size=20, **RANKS))
    agg = FedMLAggregator(a, m, test_data=None)
    mgr = RootServerManager(a, agg, hier_partition(a, ds))
    mgr.register_message_receive_handlers()
    for e in (1, 2):
        mgr.handle_message_edge_status(_online(e))
    assert mgr.is_initialized
    yield mgr, agg.get_global_model_params()
    if mgr._failure_detector is not None:
        mgr._failure_detector.stop()


def test_duplicate_and_stale_edge_reports_dropped(root_world):
    root, template = root_world
    rep = _edge_report(1, 0, template, folded=[1, 2], cohort=[1, 2])
    root.handle_message_edge_report(rep)
    count = root._root_acc.count
    root.handle_message_edge_report(rep)
    assert root._root_acc.count == count
    tel = Telemetry.get_instance()
    assert tel.get_counter("hier_edge_merge_dups_total", reason="dup") == 1
    root.handle_message_edge_report(_edge_report(2, 0, template, [3, 4], [3, 4]))
    root.handle_message_edge_report(_edge_report(1, 0, template, [1, 2], [1, 2]))
    assert tel.get_counter("hier_edge_merge_dups_total", reason="stale") == 1


def test_quarantine_evidence_propagates_and_releases(root_world):
    root, template = root_world
    run_id = root.args.run_id
    _drain(run_id, 1), _drain(run_id, 2)
    ev = Message(constants.MSG_TYPE_E2R_CLIENT_EVENT, 2, 0)
    ev.add_params(constants.MSG_ARG_KEY_EVENT_KIND, constants.HIER_EVENT_QUARANTINE)
    ev.add_params(constants.MSG_ARG_KEY_RANK, 3)
    root.handle_message_client_event(ev)
    assert 3 in root._quarantine
    e_of = edge_clients(root.partition)
    for e in (1, 2):
        root.handle_message_edge_report(
            _edge_report(e, 0, template, [r for r in e_of[e] if r != 3], e_of[e]))
    for e in (1, 2):
        (msg,) = [m for m in _drain(run_id, e)
                  if m.get_type() == constants.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT]
        assert msg.get(constants.MSG_ARG_KEY_QUARANTINED) == [3]
        assert 3 not in {int(k) for k in msg.get(constants.MSG_ARG_KEY_HIER_ASSIGNMENT)}
    assert root._quarantine[3] == root.quarantine_rounds - 1
    root._quarantine[3] = 1
    for e in (1, 2):
        root.handle_message_edge_report(
            _edge_report(e, 1, template, [r for r in e_of[e] if r != 3], e_of[e]))
    assert 3 not in root._quarantine


def _edge_unit(tmp_path, tag, **kw):
    a, ds, m = build(1, f"{tag}_{tmp_path.name}",
                     **dict(SMALL, synthetic_train_size=80, synthetic_test_size=20,
                            comm_round=3, **RANKS, **kw))
    mgr = HierEdge(a, "cpu", ds, m).manager
    mgr.register_message_receive_handlers()
    for r in mgr.client_ranks:
        mgr.client_online[r] = True
    return mgr


def _round_msg(mgr, idx, assignment, quarantined=()):
    m = Message(constants.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, 0, 0)
    m.add_params(constants.MSG_ARG_KEY_MODEL_PARAMS, mgr.aggregator.get_global_model_params())
    m.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, idx)
    m.add_params(constants.MSG_ARG_KEY_HIER_ASSIGNMENT, {str(r): s for r, s in assignment.items()})
    m.add_params(constants.MSG_ARG_KEY_QUARANTINED, list(quarantined))
    return m


def _upload(mgr, sender, round_idx):
    up = Message(constants.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, sender, 0)
    up.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, round_idx)
    up.add_params(constants.MSG_ARG_KEY_MODEL_PARAMS, mgr.aggregator.get_global_model_params())
    up.add_params(constants.MSG_ARG_KEY_NUM_SAMPLES, 10.0)
    return up


def test_edge_enforces_the_quarantine_list(tmp_path):
    mgr = _edge_unit(tmp_path, "edgeq")
    quarantined, ok = mgr.client_ranks[:2]
    mgr.handle_message_round(_round_msg(mgr, 0, {ok: 0}, [quarantined]))
    before = mgr.aggregator.folds_total
    mgr.handle_message_upload(_upload(mgr, quarantined, 0))
    assert mgr.aggregator.folds_total == before
    assert Telemetry.get_instance().get_counter("defense_quarantined_rejected_total") >= 1


def test_root_advancing_abandons_the_open_edge_round(tmp_path):
    mgr = _edge_unit(tmp_path, "edgeab")
    r1, r2 = mgr.client_ranks[:2]
    mgr.handle_message_round(_round_msg(mgr, 0, {r1: 0, r2: 1}))
    mgr.handle_message_upload(_upload(mgr, r1, 0))
    assert mgr.aggregator.num_received() == 1
    mgr.handle_message_round(_round_msg(mgr, 1, {r1: 0, r2: 1}))
    assert mgr.round_idx == 1 and mgr.aggregator.num_received() == 0
    assert Telemetry.get_instance().get_counter("hier_edge_rounds_abandoned_total") == 1


def test_held_rounds_never_wedge(tmp_path):
    mgr = _edge_unit(tmp_path, "edgeleft")
    r1, r2 = mgr.client_ranks[:2]
    off = Message(constants.MSG_TYPE_C2S_CLIENT_STATUS, r2, 0)
    off.add_params(constants.MSG_ARG_KEY_CLIENT_STATUS, constants.CLIENT_STATUS_OFFLINE)
    mgr.handle_message_client_status(off)
    mgr.handle_message_round(_round_msg(mgr, 0, {r1: 0, r2: 1}))
    assert mgr._round_open and mgr.round_idx == 0 and mgr.aggregator.client_num == 1
    mgr2 = _edge_unit(tmp_path, "edgehold")
    r1, r2 = mgr2.client_ranks[:2]
    mgr2.handle_message_round(_round_msg(mgr2, 0, {r1: 0, r2: 1}))
    mgr2.client_online[r2] = False
    mgr2.handle_message_round(_round_msg(mgr2, 1, {r1: 0, r2: 1}))
    assert mgr2._pending_round is not None and mgr2.round_idx == 0
    mgr2.handle_message_client_status(_online(r2))
    assert mgr2._pending_round is None and mgr2.round_idx == 1 and mgr2._round_open


# -- edge death and restart -------------------------------------------------


def test_a_dead_edge_drops_out_and_the_survivor_closes(root_world):
    root, template = root_world
    part = edge_clients(root.partition)
    root.handle_message_edge_report(_edge_report(1, 0, template, part[1], part[1]))
    assert root.round_idx == 0
    dead = Message(constants.MSG_TYPE_S2S_CLIENT_DEAD, 0, 0)
    dead.add_params(constants.MSG_ARG_KEY_RANK, 2)
    root.handle_message_edge_dead(dead)
    assert root.round_idx == 1 and root.edge_deaths == 1
    assert Telemetry.get_instance().get_counter("hier_edges_declared_dead_total") == 1
    assert _drain(root.args.run_id, 1)
    assert [m for m in _drain(root.args.run_id, 2)
            if m.get(constants.MSG_ARG_KEY_ROUND_INDEX) == 1] == []


def test_all_edges_dead_finishes_loudly(root_world):
    root, _ = root_world
    for e in (1, 2):
        dead = Message(constants.MSG_TYPE_S2S_CLIENT_DEAD, 0, 0)
        dead.add_params(constants.MSG_ARG_KEY_RANK, e)
        root.handle_message_edge_dead(dead)
    assert Telemetry.get_instance().get_counter("cross_silo_finish_total") == 1
    assert [m for m in _drain(root.args.run_id, 1)
            if m.get_type() == constants.MSG_TYPE_S2C_FINISH]


def test_the_detector_declares_a_silent_edge(tmp_path):
    a, ds, m = build(0, f"edet_{tmp_path.name}",
                     **dict(SMALL, client_num_in_total=2, client_num_per_round=2,
                            synthetic_train_size=80, synthetic_test_size=20,
                            heartbeat_timeout_s=0.3, **RANKS))
    mgr = RootServerManager(a, FedMLAggregator(a, m, test_data=None), {1: 1, 2: 2})
    try:
        mgr.register_message_receive_handlers()
        for e in (1, 2):
            mgr.handle_message_edge_status(_online(e))
        deadline, declared = time.monotonic() + 5.0, []
        while time.monotonic() < deadline and not declared:
            declared = [x for x in _drain(a.run_id, 0)
                        if x.get_type() == constants.MSG_TYPE_S2S_CLIENT_DEAD]
            time.sleep(0.05)
        assert declared, "silent edge never declared dead"
    finally:
        mgr._failure_detector.stop()


def test_an_edge_killed_at_its_barrier_recovers_bitwise(tmp_path):
    clean = root_params(run_hier("hier_ck_clean"))
    Telemetry.reset()
    ck = str(tmp_path / "ck")
    kw = dict(checkpoint_dir=ck, heartbeat_interval_s=0.1, heartbeat_timeout_s=60.0,
              chaos_schedule=[{"at": {"event": "barrier", "name": "edge.merge_upload",
                                      "rank": 1, "occurrence": 1},
                               "fault": {"kind": "kill_client"}}])
    restarted = threading.Event()

    def edge_wrapper(rank, edge):
        if rank != 1:
            return edge.run

        def run_and_die():
            try:
                edge.run()
            except ProcessKilled:
                time.sleep(0.3)  # the corpse's threads drain
                a2, ds2, m2 = build(1, "hier_ck", **dict(SMALL, client_num_in_total=4,
                                                         client_num_per_round=4, **RANKS, **kw))
                edge2 = HierEdge(a2, "cpu", ds2, m2, partition=edge.partition)
                restarted.set()
                edge2.run()

        return run_and_die

    world = run_hier("hier_ck", edge_wrapper=edge_wrapper, **kw)
    assert restarted.is_set(), "the kill never fired"
    assert_bitwise(clean, root_params(world))
    # the killed incarnation died before its write-ahead; the restarted
    # edge logged the re-run round once, and the root merged each
    # (edge, round) once
    assert [r["round_idx"] for r in RoundWAL(os.path.join(ck, "edge_1")).records()] == [0, 1]
    root_recs = RoundWAL(ck).records()
    assert [r["round_idx"] for r in root_recs] == [0, 1]
    for rec in root_recs:
        parts = [set(v) for v in rec["edge_folds"].values()]
        assert set().union(*parts) == set(rec["folded"]) == {1, 2, 3, 4}
        assert sum(len(p) for p in parts) == 4
    assert counter("hier_edge_merges_total") == 2 * 2
