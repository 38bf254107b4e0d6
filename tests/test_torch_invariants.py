"""The port's post-hoc invariant checker (``fedml_tpu_torch/core/
invariants.py``; ``cli check``) against the JAX package's.

Every planted ledger of ``tests/test_invariants.py`` and of
``tests/test_elastic_mesh.py::TestPreemptInvariants`` (a multi-step test
there is one case a step here), plus the edge tier's and the cross-device
plane's ledgers, is one case of one parametrised test. Each case is
written once by each package's ``RoundWAL`` (the artifacts are the JAX
package's in meaning, so either writer serves either checker), and the
two checkers' ``to_dict()`` must be equal, and flag what the JAX test
expects. Then each checker reads the other package's run artifacts: a
port FedAvg run preempted and resumed with ``telemetry_dir`` set, and a
JAX one. ``cli check``'s exit codes and JSON line are the JAX cli's.

Tolerance: none; reports compare exactly.
"""

from __future__ import annotations

import json
import os

import pytest

from fedml_tpu.core.checkpoint import RoundWAL as JaxWAL
from fedml_tpu.core.invariants import InvariantChecker as JaxChecker
from fedml_tpu_torch.core.checkpoint import RoundWAL as PortWAL
from fedml_tpu_torch.core.invariants import InvariantChecker as PortChecker

WALS = {"jax": JaxWAL, "port": PortWAL}
KILL = "chaos_faults_injected_total{event=wal_append,fault=kill_server}"
LATENCY = "chaos_faults_injected_total{event=wal_append,fault=latency}"


def snapshot(d, counters, rank=0):
    with open(os.path.join(d, "telemetry.jsonl"), "a") as f:
        f.write(json.dumps({"ts": 0.0, "kind": "telemetry_snapshot", "rank": rank,
                            "role": "server", "counters": counters}) + "\n")


def trace(d, events):
    with open(os.path.join(d, "trace.json"), "w") as f:
        json.dump({"traceEvents": events}, f)


def fault(f, event="wal_append", ts=0):
    return {"name": "chaos.fault", "ph": "i", "ts": ts, "pid": 1, "tid": 1,
            "args": {"fault": f, "event": event}}


def publish(wal, version, pairs, max_seq, folds_total):
    wal.append(version, version, [], folded=pairs, kind="publish",
               extra={"version": version, "max_seq": max_seq, "folds_total": folds_total})


def rounds(wal, n, cohort=(1, 2), ckpt=True):
    for r in range(n):
        wal.append(r, r + 1 if ckpt else None, list(cohort), folded=list(cohort))


# -- the planted ledgers: name -> (build(d, wal), invariants it must violate)
def _clean(d, wal):
    for r in range(3):
        wal.append(r, r + 1, [1, 2, 3], folded=[1, 2, 3])


def _fold_outside_cohort(d, wal):
    wal.append(0, 1, [1, 2], folded=[1, 3])


def _partial_no_evidence(d, wal):
    wal.append(0, 1, [1, 2, 3], folded=[1, 2])
    snapshot(d, {"cross_silo_rounds_total": 1.0})


def _partial_quorum(d, wal):
    wal.append(0, 1, [1, 2, 3], folded=[1, 2])
    snapshot(d, {"agg_quorum_closes_total": 1.0})


def _partial_no_telemetry(d, wal):
    wal.append(0, 1, [1, 2, 3], folded=[1, 2])


def _backward_onto_durable(d, wal):
    wal.append(0, 1, [1], folded=[1])
    wal.append(1, 2, [1], folded=[1])
    wal.append(3, None, [1], folded=[1])
    wal.append(1, None, [1], folded=[1])


def _backward_onto_nothing(d, wal):
    wal.append(0, None, [1], folded=[1])
    wal.append(1, None, [1], folded=[1])
    wal.append(0, None, [1], folded=[1])


def _ckpt_regression(d, wal):
    wal.append(0, 5, [1], folded=[1])
    wal.append(1, 3, [1], folded=[1])


def _dup_rank(d, wal):
    wal.append(0, 1, [1, 2], folded=[1, 1, 2])


def _async_clean(d, wal):
    publish(wal, 1, [[1, 1], [2, 2]], 4, 2)
    publish(wal, 2, [[1, 5], [3, 3]], 6, 4)


def _async_refold(d, wal):
    publish(wal, 1, [[1, 1]], 2, 1)
    publish(wal, 2, [[1, 1]], 3, 2)
    snapshot(d, {"agg_publish_total": 2.0})


def _async_version_regression(d, wal):
    publish(wal, 2, [[1, 1]], 2, 1)
    publish(wal, 2, [[1, 2]], 3, 2)


def _async_seq_above_mark(d, wal):
    publish(wal, 1, [[1, 9]], 4, 1)


def _async_max_seq_regression(d, wal):
    publish(wal, 1, [[1, 1]], 8, 1)
    publish(wal, 2, [[1, 2]], 4, 2)


def _async_fold_total_under(d, wal):
    publish(wal, 1, [[1, 1], [2, 2]], 4, 1)


def _carry_with_failure(d, wal):
    publish(wal, 1, [[1, 1], [2, 2]], 4, 2)
    publish(wal, 2, [[1, 1], [2, 2], [3, 3]], 6, 3)
    snapshot(d, {"wal_append_failures_total": 1.0})


def _carry_without_failure(d, wal):
    publish(wal, 1, [[1, 1], [2, 2]], 4, 2)
    publish(wal, 2, [[1, 1], [2, 2], [3, 3]], 6, 3)
    snapshot(d, {"agg_publish_total": 2.0})


def _carry_without_telemetry(d, wal):
    publish(wal, 1, [[1, 1], [2, 2]], 4, 2)
    publish(wal, 2, [[1, 1], [2, 2], [3, 3]], 6, 3)


def _partial_repeat(d, wal):
    publish(wal, 1, [[1, 1], [2, 2]], 4, 2)
    publish(wal, 2, [[1, 1], [3, 3]], 6, 3)
    snapshot(d, {"wal_append_failures_total": 5.0})


def _lost_unreported(d, wal):
    publish(wal, 1, [[1, 1], [2, 2]], 3, 2)
    snapshot(d, {"agg_folds_total{mode=async}": 3.0, "agg_folds_published_total": 2.0,
                 "cross_silo_finish_total": 1.0})


def _lost_reported(d, wal):
    publish(wal, 1, [[1, 1], [2, 2]], 3, 2)
    snapshot(d, {"agg_folds_total{mode=async}": 3.0, "agg_folds_published_total": 2.0,
                 "agg_folds_lost_total": 1.0, "cross_silo_finish_total": 1.0})


def _lost_excused_by_failure(d, wal):
    publish(wal, 1, [[1, 1], [2, 2]], 3, 2)
    snapshot(d, {"agg_folds_total{mode=async}": 3.0, "agg_folds_published_total": 2.0,
                 "wal_append_failures_total": 1.0, "cross_silo_finish_total": 1.0})


def _unclean_finish(d, wal):
    publish(wal, 1, [[1, 1]], 2, 1)
    snapshot(d, {"agg_folds_total{mode=async}": 5.0})


def _ledger_gap(d, wal):
    rounds(wal, 3)
    snapshot(d, {"wal_rounds_logged_total": 1.0, "wal_folds_logged_total": 2.0,
                 "agg_folds_total{mode=stream}": 6.0})


def _fold_gap_strict(d, wal):
    rounds(wal, 2)
    snapshot(d, {"wal_rounds_logged_total": 2.0, "wal_folds_logged_total": 2.0,
                 "agg_folds_total{mode=stream}": 4.0})


def _fold_gap_failure(d, wal):
    rounds(wal, 2)
    snapshot(d, {"wal_rounds_logged_total": 2.0, "wal_folds_logged_total": 2.0,
                 "wal_append_failures_total": 1.0, "agg_folds_total{mode=stream}": 4.0})


def _latency_explains_nothing(d, wal):
    rounds(wal, 2)
    snapshot(d, {"wal_rounds_logged_total": 1.0, "wal_folds_logged_total": 2.0,
                 LATENCY: 5.0, "agg_folds_total{mode=stream}": 4.0})


def _kill_explains(d, wal):
    rounds(wal, 2)
    snapshot(d, {"wal_rounds_logged_total": 1.0, "wal_folds_logged_total": 2.0,
                 KILL: 1.0, LATENCY: 5.0, "agg_folds_total{mode=stream}": 4.0})
    trace(d, [fault(f, ts=t) for t, f in enumerate(["kill_server"] + ["latency"] * 5)])


def _publish_kill_tolerance(d, wal):
    wal.append(1, 1, [], folded=[[1, 1], [2, 2], [3, 3]], kind="publish",
               extra={"version": 1, "max_seq": 5, "folds_total": 3})
    wal.append(2, 2, [], folded=[[1, 7], [2, 8], [3, 9]], kind="publish",
               extra={"version": 2, "max_seq": 12, "folds_total": 6})
    snapshot(d, {"agg_folds_published_total": 3.0, KILL: 1.0})
    trace(d, [fault("kill_server", ts=1)])


def _publish_gap_no_kill(d, wal):
    wal.append(1, 1, [], folded=[[1, 1], [2, 2], [3, 3]], kind="publish",
               extra={"version": 1, "max_seq": 5, "folds_total": 3})
    wal.append(2, 2, [], folded=[[1, 7], [2, 8], [3, 9]], kind="publish",
               extra={"version": 2, "max_seq": 12, "folds_total": 6})
    snapshot(d, {"agg_folds_published_total": 3.0})


def _counters_reset(d, wal):
    rounds(wal, 3)
    snapshot(d, {"wal_rounds_logged_total": 2.0, "wal_folds_logged_total": 4.0,
                 "agg_folds_total{mode=stream}": 4.0})
    snapshot(d, {"wal_rounds_logged_total": 1.0, "wal_folds_logged_total": 2.0,
                 "agg_folds_total{mode=stream}": 2.0})


def _counters_under_ledger(d, wal):
    wal.append(0, 1, [1, 2], folded=[1, 2])
    snapshot(d, {"agg_folds_total{mode=stream}": 1.0, "wal_rounds_logged_total": 1.0,
                 "wal_folds_logged_total": 2.0})


def _chaos_trace_mismatch(d, wal):
    snapshot(d, {"chaos_faults_injected_total{event=send,fault=drop}": 2.0})
    trace(d, [fault("drop", event="send", ts=1)])


def _chaos_trace_match(d, wal):
    snapshot(d, {"chaos_faults_injected_total{event=send,fault=drop}": 1.0})
    trace(d, [fault("drop", event="send", ts=1)])


def _no_artifacts(d, wal):
    pass


def _preempt_paired(d, wal):
    wal.append(1, 1, [], kind="preempt", extra={"reason": "x"})
    wal.append(2, 1, [], kind="resume")


def _preempt_trailing(d, wal):
    wal.append(1, 1, [], kind="preempt")


def _preempt_ordinary(d, wal):
    wal.append(0, None, [1], folded=[1])


def _preempt_answered_by_round(d, wal):
    wal.append(1, 1, [], kind="preempt")
    wal.append(2, 2, [7], folded=[7])


def _resume_wrong_round(d, wal):
    wal.append(1, 1, [], kind="preempt")
    wal.append(3, 1, [], kind="resume")


def _resume_wrong_step(d, wal):
    wal.append(1, 1, [], kind="preempt")
    wal.append(2, 0, [], kind="resume")


def _orphan_resume(d, wal):
    wal.append(2, 1, [], kind="resume")


def _preempt_without_step(d, wal):
    wal.append(1, None, [], kind="preempt")
    wal.append(2, 1, [], kind="resume")


def _edge_clean(d, wal):
    for r in range(2):
        wal.append(r, r + 1, [1, 2, 3, 4], folded=[1, 2, 3, 4],
                   extra={"edge_folds": {"1": [1, 2], "2": [3, 4]}})
    snapshot(d, {"hier_edge_merges_total{edge=1}": 2.0, "hier_edge_merges_total{edge=2}": 2.0})
    for e, ranks in ((1, [1, 2]), (2, [3, 4])):
        sub = wal.__class__(os.path.join(d, f"edge_{e}"))
        for r in range(2):
            sub.append(r, None, ranks, folded=ranks)


def _edge_double_merge(d, wal):
    wal.append(0, 1, [1, 2, 3], folded=[1, 2, 3],
               extra={"edge_folds": {"1": [1, 2], "2": [2, 3]}})
    snapshot(d, {"hier_edge_merges_total{edge=1}": 1.0, "hier_edge_merges_total{edge=2}": 1.0})


def _edge_merge_counter_gap(d, wal):
    wal.append(0, 1, [1, 2], folded=[1, 2], extra={"edge_folds": {"1": [1], "2": [2]}})
    snapshot(d, {"hier_edge_merges_total{edge=1}": 3.0, "hier_edge_merges_total{edge=2}": 2.0})


def _edge_missing_twin(d, wal):
    wal.append(0, 1, [1, 2], folded=[1, 2], extra={"edge_folds": {"1": [1, 2]}})
    snapshot(d, {"hier_edge_merges_total{edge=1}": 1.0})
    wal.__class__(os.path.join(d, "edge_1")).append(0, None, [1], folded=[1])


def _xdev(wal, folded, checkins, reason="target", target=2, masked=True, field=None):
    ups = {str(i): 10 + i for i in folded}
    corr = {"9": 3}
    want = (sum(ups.values()) - 3) % (2**31 - 1)
    wal.append(0, 1, [1, 2, 3, 4], folded=folded, kind="crossdevice",
               extra={"checkins": checkins, "close_reason": reason, "fold_target": target,
                      "masked": masked, "upload_checksums": ups, "correction_checksums": corr,
                      "field_checksum": want if field is None else field})


def _xdev_clean(d, wal):
    _xdev(wal, [1, 2], [1, 2, 3])
    snapshot(d, {"device_uploads_folded_total": 2.0})


def _xdev_unledgered(d, wal):
    _xdev(wal, [1, 4], [1, 2])
    snapshot(d, {"device_uploads_folded_total": 2.0})


def _xdev_bad_balance(d, wal):
    _xdev(wal, [1, 2], [1, 2], field=5)


def _xdev_bad_close(d, wal):
    _xdev(wal, [1], [1, 2], target=3)
    snapshot(d, {"device_uploads_folded_total": 1.0,
                 "device_mask_recovery_failures_total": 1.0})


CASES = {
    "clean_sync": (_clean, set()),
    "fold_outside_cohort": (_fold_outside_cohort, {"cohort_accounting"}),
    "partial_close_without_evidence": (_partial_no_evidence, {"partial_closes_accounted"}),
    "partial_close_by_quorum": (_partial_quorum, set()),
    "partial_close_without_telemetry": (_partial_no_telemetry, set()),
    "backward_onto_a_durable_step": (_backward_onto_durable, set()),
    "backward_onto_nothing_durable": (_backward_onto_nothing, {"round_monotone"}),
    "ckpt_step_regression": (_ckpt_regression, {"ckpt_step_monotone"}),
    "a_rank_folded_twice": (_dup_rank, {"cohort_accounting"}),
    "clean_async": (_async_clean, set()),
    "refolded_pair": (_async_refold, {"exactly_once_folds"}),
    "version_regression": (_async_version_regression, {"version_monotone"}),
    "seq_above_high_water_mark": (_async_seq_above_mark, {"no_reissued_seqs"}),
    "max_seq_regression": (_async_max_seq_regression, {"no_reissued_seqs"}),
    "fold_total_under_ledger": (_async_fold_total_under, {"fold_ledger_consistent"}),
    "whole_carry_after_a_failed_append": (_carry_with_failure, set()),
    "whole_carry_without_a_failure": (_carry_without_failure, {"exactly_once_folds"}),
    "whole_carry_without_telemetry": (_carry_without_telemetry, set()),
    "partial_repeat_is_never_a_carry": (_partial_repeat, {"exactly_once_folds"}),
    "lost_unreported_folds": (_lost_unreported, {"no_lost_unreported_folds"}),
    "lost_folds_reported": (_lost_reported, set()),
    "unledgered_folds_excused_by_a_failure": (_lost_excused_by_failure, set()),
    "unclean_finish_skips_loss_accounting": (_unclean_finish, set()),
    "ledger_counter_gap": (_ledger_gap, {"ledger_counter_match"}),
    "fold_gap_strict_without_faults": (_fold_gap_strict, {"ledger_counter_match"}),
    "fold_gap_explained_by_a_failure": (_fold_gap_failure, set()),
    "latency_explains_no_gap": (_latency_explains_nothing, {"ledger_counter_match"}),
    "a_kill_explains_the_gap": (_kill_explains, set()),
    "publish_kill_tolerance": (_publish_kill_tolerance, set()),
    "publish_gap_without_a_kill": (_publish_gap_no_kill, {"published_counter_match"}),
    "counters_reset_skip_balances": (_counters_reset, set()),
    "counters_under_the_ledger": (_counters_under_ledger, {"counters_cover_ledger"}),
    "chaos_trace_mismatch": (_chaos_trace_mismatch, {"chaos_trace_consistent"}),
    "chaos_trace_match": (_chaos_trace_match, set()),
    "no_artifacts": (_no_artifacts, set()),
    "preempt_paired": (_preempt_paired, set()),
    "preempt_trailing": (_preempt_trailing, set()),
    "preempt_ordinary_ledger": (_preempt_ordinary, set()),
    "preempt_answered_by_a_round": (_preempt_answered_by_round,
                                    {"preempt_paired_with_checkpoint"}),
    "resume_at_the_wrong_round": (_resume_wrong_round, {"preempt_resume_continuity"}),
    "resume_of_the_wrong_step": (_resume_wrong_step, {"preempt_paired_with_checkpoint",
                                                      "ckpt_step_monotone"}),
    "orphan_resume": (_orphan_resume, {"preempt_resume_continuity"}),
    "preempt_without_a_step": (_preempt_without_step, {"preempt_paired_with_checkpoint"}),
    "edge_tier_clean": (_edge_clean, set()),
    "edge_double_merge": (_edge_double_merge, {"edge_partition"}),
    "edge_merge_counter_gap": (_edge_merge_counter_gap, {"edge_merge_exactly_once"}),
    "edge_missing_write_ahead_twin": (_edge_missing_twin, {"edge_subledger_consistent"}),
    "crossdevice_clean": (_xdev_clean, set()),
    "crossdevice_fold_without_checkin": (_xdev_unledgered, {"device_fold_requires_checkin"}),
    "crossdevice_mask_survived": (_xdev_bad_balance, {"device_masked_folds_balance"}),
    "crossdevice_close_and_recovery": (_xdev_bad_close, {"device_round_close_accounted",
                                                         "device_mask_recovery_verified"}),
}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_planted_ledger_reports_equal_the_reference(case, writer, tmp_path):
    build, violated = CASES[case]
    build(str(tmp_path), WALS[writer](str(tmp_path)))
    port = PortChecker(telemetry_dir=str(tmp_path)).check().to_dict()
    ref = JaxChecker(telemetry_dir=str(tmp_path)).check().to_dict()
    assert port == ref
    assert {v["invariant"] for v in port["violations"]} == violated
    assert port["ok"] is (not violated)


def test_the_wal_is_read_from_its_own_checkpoint_dir(tmp_path):
    ck, td = tmp_path / "ck", tmp_path / "td"
    ck.mkdir()
    td.mkdir()
    PortWAL(str(ck)).append(0, 1, [1], folded=[1])
    rep = PortChecker(telemetry_dir=str(td), checkpoint_dir=str(ck)).check()
    assert "wal_well_formed" in rep.checked
    assert rep.to_dict() == JaxChecker(telemetry_dir=str(td), checkpoint_dir=str(ck)).check(
    ).to_dict()


def test_fault_signature_is_the_references():
    evs = [fault("drop", event="send"), fault("latency"), {"name": "other", "args": {}}]
    assert PortChecker.fault_signature(evs) == JaxChecker.fault_signature(evs)
    assert PortChecker.fault_signature(list(reversed(evs))) == PortChecker.fault_signature(evs)


def test_cli_check_exit_codes_and_json_line(tmp_path, capsys):
    from fedml_tpu.cli import main as jax_main
    from fedml_tpu_torch.cli import main as port_main

    wal = PortWAL(str(tmp_path))
    wal.append(0, 1, [1, 2], folded=[1, 2])
    for expect in (0, 1):
        lines = {}
        for pkg, main in (("jax", jax_main), ("port", port_main)):
            assert main(["check", "--telemetry-dir", str(tmp_path)]) == expect
            captured = capsys.readouterr()
            lines[pkg] = json.loads(captured.out.strip())
            if expect:
                assert "check: VIOLATED cohort_accounting" in captured.err
        assert lines["port"] == lines["jax"]
        assert lines["port"]["ok"] is (expect == 0)
        wal.append(1, 2, [1], folded=[1, 2])  # rank 2 outside the cohort
    assert port_main(["check", "--telemetry-dir", str(tmp_path / "nope")]) == 2
    assert port_main(["check", "--telemetry-dir", str(tmp_path),
                      "--checkpoint-dir", str(tmp_path)]) == 1


def _port_run(tmp_path):
    """A port FedAvg run preempted at round 1 and resumed, exporting its
    artifacts; returns the directory."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core.telemetry import Telemetry
    from fedml_tpu_torch.parallel.elastic import Preempted

    d = str(tmp_path / "port_run")

    def args(**kw):
        a = Arguments()
        for k, v in dict(dataset="mnist", model="lr", client_num_in_total=8,
                         client_num_per_round=4, synthetic_train_size=320,
                         synthetic_test_size=80, comm_round=3, epochs=1, batch_size=16,
                         checkpoint_dir=d, telemetry_dir=d, **kw).items():
            setattr(a, k, v)
        a._validate()
        return a

    Telemetry.reset()
    with pytest.raises(Preempted):
        fedml_tpu_torch.run_simulation(device="cpu", args=args(preempt_signal="round:1"))
    Telemetry.reset()
    fedml_tpu_torch.run_simulation(device="cpu", args=args())
    Telemetry.reset()
    return d


def _jax_run(tmp_path):
    """The same drill through the JAX package."""
    import fedml_tpu
    from fedml_tpu.core.telemetry import Telemetry
    from fedml_tpu.parallel.elastic import Preempted

    from tests.conftest import make_args

    d = str(tmp_path / "jax_run")

    from fedml_tpu import data, models
    from fedml_tpu.simulation import SimulatorSingleProcess

    def run(**kw):
        a = fedml_tpu.init(make_args(
            dataset="mnist", model="lr", client_num_in_total=8, client_num_per_round=4,
            synthetic_train_size=320, synthetic_test_size=80, comm_round=3, epochs=1,
            batch_size=16, checkpoint_dir=d, telemetry_dir=d, **kw))
        ds = data.load(a)
        SimulatorSingleProcess(a, None, ds, models.create(a, ds.class_num)).run()

    Telemetry.reset()
    with pytest.raises(Preempted):
        run(preempt_signal="round:1")
    Telemetry.reset()
    run()
    Telemetry.reset()
    return d


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_checker_reads_the_other_packages_run(writer, tmp_path):
    d = _port_run(tmp_path) if writer == "port" else _jax_run(tmp_path)
    kinds = [r.get("kind") for r in PortWAL(d).records()]
    assert kinds[:1] == ["preempt"] and "resume" in kinds
    port = PortChecker(telemetry_dir=d).check().to_dict()
    assert port == JaxChecker(telemetry_dir=d).check().to_dict()
    assert port["ok"], port
    assert {"preempt_paired_with_checkpoint", "preempt_resume_continuity"} <= set(
        port["checked"])
    assert {"trace.json", "metrics.prom", "telemetry.jsonl"} <= set(os.listdir(d))
