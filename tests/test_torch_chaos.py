"""The chaos plane (``fedml_tpu_torch/core/chaos.py``) against the JAX
package's ``core/chaos.py``, on the CPU.

The JAX package's tests/test_chaos.py unit classes run on both packages
(the ``pkg`` parameter): schedule validation with its messages word for
word, occurrence-counted firing, ``FaultInjector`` with a plan, the
``FaultyIO`` faults on each package's own ``RoundWAL`` and checkpoints
(torn write, failed fsync, ENOSPC, kills before and after, a torn
publish the serving watcher falls back from), the named barriers and the
clock skew, the install from args, and the crash-point enumeration.
Across packages: the same ``(schedule, seed)`` fed the same events fires
the same fault trace, every validation error reads the same, and
``enumerate_crash_points`` / ``crash_point_schedule`` agree on one
recorded event list (each package's own ``RecordingIO`` over its own
WAL and checkpoints).
"""

from __future__ import annotations

import importlib
import os
import stat
import time
import types

import numpy as np
import pytest
import torch

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

PACKAGES = ("fedml_tpu", "fedml_tpu_torch")


def _load(base: str) -> types.SimpleNamespace:
    def m(path):
        return importlib.import_module(f"{base}.{path}")

    def make_args(**kw):
        a = m("arguments").Arguments()
        for k, v in kw.items():
            setattr(a, k, v)
        a._validate()
        return a

    return types.SimpleNamespace(
        name=base, constants=m("constants"), chaos=m("core.chaos"),
        checkpoint=m("core.checkpoint"), faults=m("core.comm.faults"),
        base=m("core.comm.base"), Message=m("core.message").Message,
        Telemetry=m("core.telemetry").Telemetry, make_args=make_args,
    )


@pytest.fixture(params=PACKAGES)
def pkg(request):
    p = _load(request.param)
    p.chaos.reset_chaos()
    p.Telemetry.reset()
    yield p
    p.chaos.reset_chaos()
    p.Telemetry.reset()


def _transport(pkg):
    class Recording(pkg.base.BaseCommunicationManager):
        def __init__(self):
            self.sent = []

        def send_message(self, msg):
            self.sent.append(msg)

        def add_observer(self, o):
            pass

        def remove_observer(self, o):
            pass

        def handle_receive_message(self):
            pass

        def stop_receive_message(self):
            pass

    return Recording()


def _msg(pkg, t=3, sender=1, receiver=0, round_idx=None):
    m = pkg.Message(t, sender, receiver)
    if round_idx is not None:
        m.add_params(pkg.constants.MSG_ARG_KEY_ROUND_INDEX, round_idx)
    return m


BAD_SCHEDULES = [
    [{"at": {"event": "nope"}, "fault": "drop"}],
    [{"at": {"event": "send"}, "fault": "frobnicate"}],
    [{"at": {"event": "send"}, "fault": "kill_server"}],
    [{"at": {"event": "wal_append"}, "fault": "drop"}],
    [{"at": {"event": "ckpt_publish"}, "fault": "torn_write"}],
    [{"at": {"event": "wal_append"}, "fault": "torn_publish"}],
    [{"at": {"event": "wal_create"}, "fault": "fsync_fail"}],
    [{"at": {"event": "wal_create"}, "fault": "torn_write"}],
    [{"at": {"event": "ckpt_publish", "rank": 0}, "fault": "torn_publish"}],
    [{"at": {"event": "send", "name": "server.broadcast"}, "fault": "drop"}],
    [{"at": {"event": "wal_create", "round": 1}, "fault": "kill_server"}],
    [{"at": {"event": "wal_append", "msg_type": 3}, "fault": "fsync_fail"}],
    [{"at": {"event": "send", "occurrence": 0}, "fault": "drop"}],
    [{"at": {"event": "send", "bogus": 1}, "fault": "drop"}],
    [{"fault": "drop"}],
    [{"at": {"event": "wal_append"}, "fault": {"kind": "kill_server", "when": "during"}}],
    [{"at": {"event": "barrier"}, "fault": "preempt"}],
    [{"at": {"event": "elastic.check"}, "fault": "drop"}],
    [{"at": {"event": "elastic.check", "rank": 0}, "fault": "preempt"}],
    [{"at": {"event": "wal_append"}, "fault": {"kind": "torn_write", "at_byte": -1}}],
    [["at", "fault"]],
    "not a list",
]


def _error(fn, *a, **kw):
    try:
        fn(*a, **kw)
    except ValueError as e:
        return str(e)
    return None


# -- across packages ------------------------------------------------------


class TestAcrossPackages:
    @pytest.mark.parametrize("bad", BAD_SCHEDULES)
    def test_validation_messages_word_for_word(self, bad):
        from fedml_tpu.core.chaos import validate_schedule as jax_validate
        from fedml_tpu_torch.core.chaos import validate_schedule

        want = _error(jax_validate, bad, "chaos_schedule")
        assert want is not None
        assert _error(validate_schedule, bad, "chaos_schedule") == want

    @pytest.mark.parametrize("knobs", [
        dict(chaos_schedule=[{"at": {"event": "x"}, "fault": "drop"}]),
        dict(io_faults=[{"at": {"event": "send"}, "fault": "drop"}]),
        dict(chaos_seed="not-a-number"),
    ])
    def test_knob_messages_word_for_word(self, knobs):
        from tests.conftest import make_args as jax_args

        from fedml_tpu_torch.arguments import Arguments

        def port_args(**kw):
            a = Arguments()
            for k, v in kw.items():
                setattr(a, k, v)
            a._validate()

        want = _error(jax_args, **knobs)
        assert want is not None
        assert _error(port_args, **knobs) == want

    def test_same_schedule_and_seed_fire_the_same_trace(self):
        """One schedule with every layer's steps and a latency jitter,
        fed one event sequence: the fired records, the jitter draws and
        the counters agree across packages."""
        spec = [
            {"at": {"event": "send", "msg_type": 3, "occurrence": 2}, "fault": "drop"},
            {"at": {"event": "send", "occurrence": 1}, "fault": {"kind": "delay", "delay_s": 0.5}},
            {"at": {"event": "wal_append", "round": 1}, "fault": "fsync_fail"},
            {"at": {"event": "barrier", "name": "client.train", "rank": 2},
             "fault": "kill_client"},
            {"at": {"event": "ckpt_publish", "occurrence": 2}, "fault": "torn_publish"},
            {"at": {"event": "barrier", "name": "b"},
             "fault": {"kind": "latency", "delay_s": 0.0, "jitter_s": 1.0}},
        ]
        events = [
            ("send", {"msg_type": 3}), ("wal_append", {"round": 0}),
            ("send", {"msg_type": 3}), ("send", {"msg_type": 4}),
            ("barrier", {"name": "client.train", "rank": 1}),
            ("ckpt_publish", {"round": 1}), ("wal_append", {"round": 1}),
            ("barrier", {"name": "client.train", "rank": 2}),
            ("send", {"msg_type": 3}), ("ckpt_publish", {"round": 2}),
            ("barrier", {"name": "b"}),
        ]
        traces = []
        for base in PACKAGES:
            p = _load(base)
            p.Telemetry.reset()
            s = p.chaos.ChaosSchedule(spec, seed=11)
            for ev, ctx in events:
                s.on_event(ev, **ctx)
            tel = p.Telemetry.get_instance()
            traces.append((
                s.fired, s.pending(), [s.jitter(1.0) for _ in range(3)],
                tel.counters_matching("chaos_faults_injected_total"),
            ))
            p.Telemetry.reset()
        assert traces[0] == traces[1]
        assert len(traces[0][0]) == 6

    def test_crash_points_agree_on_one_recorded_run(self, tmp_path):
        """Each package's ``RecordingIO`` over its own WAL and
        checkpoints, the same sequence of durable writes: the recorded
        event kinds, the crash points and their schedules agree."""
        out = []
        for base in PACKAGES:
            p = _load(base)
            rec = p.chaos.RecordingIO()
            p.checkpoint.install_io_seam(rec)
            d = str(tmp_path / base)
            try:
                wal = p.checkpoint.RoundWAL(d)
                ckpt = p.checkpoint.RoundCheckpointer(d)
                for r in range(3):
                    wal.append(r, r + 1, [1, 2], folded=[1, 2])
                    state = {"round_idx": r + 1}
                    ckpt.save(r + 1, state)
                ckpt.close()
            finally:
                p.checkpoint.reset_io_seam()
            points = p.chaos.enumerate_crash_points(rec.events)
            out.append((
                [(e, {k: v for k, v in c.items() if k != "nbytes"}) for e, c in rec.events],
                [{k: v for k, v in q.items() if k != "nbytes"} for q in points],
                [p.chaos.crash_point_schedule(q) for q in points if q["mode"] != "torn"],
            ))
        assert out[0] == out[1]
        assert len(out[0][1]) == 1 + 3 * 3 + 2 * 3

    def test_crash_point_functions_agree_on_one_event_list(self):
        from fedml_tpu.core import chaos as jchaos
        from fedml_tpu_torch.core import chaos as tchaos

        events = [
            ("wal_create", {}), ("wal_append", {"round": 0, "nbytes": 60}),
            ("ckpt_publish", {"step": 1}), ("wal_append", {"round": 1, "nbytes": 62}),
            ("ckpt_publish", {"step": 2}), ("wal_append", {"round": 2, "nbytes": 1}),
        ]
        jp, tp = jchaos.enumerate_crash_points(events), tchaos.enumerate_crash_points(events)
        assert jp == tp and len(tp) == 14
        assert ([jchaos.crash_point_schedule(q) for q in jp]
                == [tchaos.crash_point_schedule(q) for q in tp])


# -- the JAX package's unit classes, on both packages ---------------------


class TestScheduleValidation:
    def test_normalizes_and_defaults(self, pkg):
        steps = pkg.chaos.validate_schedule(
            [{"at": {"event": "wal_append"}, "fault": "kill_server"}])
        assert steps[0]["at"]["occurrence"] == 1
        assert steps[0]["fault"]["kind"] == "kill_server"

    def test_rejects_malformed_steps(self, pkg):
        for bad in BAD_SCHEDULES:
            with pytest.raises(ValueError):
                pkg.chaos.validate_schedule(bad)

    def test_knob_validation_names_the_knob(self, pkg):
        with pytest.raises(ValueError, match="chaos_schedule"):
            pkg.make_args(chaos_schedule=[{"at": {"event": "x"}, "fault": "drop"}])
        with pytest.raises(ValueError, match="io_faults"):
            pkg.make_args(io_faults=[{"at": {"event": "send"}, "fault": "drop"}])
        with pytest.raises(ValueError, match="chaos_seed"):
            pkg.make_args(chaos_seed="not-a-number")

    def test_valid_knobs_accepted(self, pkg):
        a = pkg.make_args(
            chaos_schedule=[{"at": {"event": "send", "msg_type": 3, "rank": 1,
                                    "occurrence": 2}, "fault": "drop"}],
            io_faults=[{"at": {"event": "ckpt_publish"}, "fault": "torn_publish"}],
            chaos_seed=7,
        )
        assert a.chaos_seed == 7

    def test_validation_does_not_mutate_the_caller_spec(self, pkg):
        fault = {"kind": "delay", "delay_s": "0.5"}
        steps = pkg.chaos.validate_schedule([{"at": {"event": "send"}, "fault": fault}])
        assert steps[0]["fault"]["delay_s"] == 0.5
        assert fault["delay_s"] == "0.5"

    def test_elastic_event_adapter_fires_on_round_match(self, pkg):
        pkg.chaos.install_chaos(pkg.chaos.ChaosSchedule([
            {"at": {"event": "elastic.check", "round": 2}, "fault": "device.loss"}]))
        assert pkg.chaos.elastic_event(0) is None
        assert pkg.chaos.elastic_event(2)["kind"] == "device.loss"
        assert pkg.chaos.elastic_event(2) is None


class TestScheduleFiring:
    def test_occurrence_counting_and_one_shot(self, pkg):
        s = pkg.chaos.ChaosSchedule([
            {"at": {"event": "send", "msg_type": 3, "occurrence": 2}, "fault": "drop"}])
        assert s.on_event("send", msg_type=4) == []
        assert s.on_event("send", msg_type=3) == []
        assert s.on_event("send", msg_type=3)[0]["kind"] == "drop"
        assert s.on_event("send", msg_type=3) == []
        assert s.pending() == 0 and len(s.fired) == 1

    def test_matchers_must_all_agree(self, pkg):
        s = pkg.chaos.ChaosSchedule([
            {"at": {"event": "barrier", "name": "client.train", "rank": 2},
             "fault": "kill_client"}])
        assert s.on_event("barrier", name="client.train", rank=1) == []
        assert s.on_event("barrier", name="server.publish", rank=2) == []
        assert s.on_event("barrier", name="client.train") == []
        assert s.on_event("barrier", name="client.train", rank=2) != []

    def test_one_firing_per_event_no_phantom_burn(self, pkg):
        s = pkg.chaos.ChaosSchedule([
            {"at": {"event": "send", "msg_type": 3, "occurrence": 1}, "fault": "drop"},
            {"at": {"event": "send", "occurrence": 1}, "fault": {"kind": "delay", "delay_s": 0.5}},
        ])
        hits = s.on_event("send", msg_type=3)
        assert len(hits) == 1 and hits[0]["kind"] == "drop" and s.pending() == 1
        hits = s.on_event("send", msg_type=4)
        assert len(hits) == 1 and hits[0]["kind"] == "delay" and s.pending() == 0

    def test_firing_is_counted_and_traced(self, pkg):
        s = pkg.chaos.ChaosSchedule([{"at": {"event": "send"}, "fault": "drop"}])
        s.on_event("send", msg_type=3)
        tel = pkg.Telemetry.get_instance()
        assert tel.get_counter("chaos_faults_injected_total", fault="drop", event="send") == 1
        faults = [e for e in tel.recorder.tail(50) if e["name"] == "chaos.fault"]
        assert len(faults) == 1 and faults[0]["args"]["fault"] == "drop"


class TestFaultInjectorPlan:
    def _injector(self, pkg, spec, **knobs):
        pkg.chaos.install_chaos(pkg.chaos.ChaosSchedule(spec))
        transport = _transport(pkg)
        return pkg.faults.FaultInjector(transport, plan=pkg.chaos.comm_plan(rank=1),
                                        **knobs), transport

    def test_exact_message_drop(self, pkg):
        inj, transport = self._injector(pkg, [
            {"at": {"event": "send", "msg_type": 3, "rank": 1, "occurrence": 2},
             "fault": "drop"}])
        for _ in range(3):
            inj.send_message(_msg(pkg))
        assert len(transport.sent) == 2
        assert inj.injected["drop"] == 0
        assert pkg.Telemetry.get_instance().get_counter(
            "chaos_faults_injected_total", fault="drop", event="send") == 1

    def test_scheduled_faults_spare_the_probabilistic_budget(self, pkg):
        inj, transport = self._injector(pkg, [
            {"at": {"event": "send", "occurrence": 1}, "fault": "drop"},
            {"at": {"event": "send", "occurrence": 2}, "fault": "drop"},
        ], drop_prob=1.0, max_faults=1)
        for _ in range(3):
            inj.send_message(_msg(pkg))
        assert len(transport.sent) == 0 and inj.injected["drop"] == 1

    def test_exact_message_duplicate_and_delay(self, pkg):
        inj, transport = self._injector(pkg, [
            {"at": {"event": "send", "msg_type": 3, "occurrence": 1}, "fault": "duplicate"},
            {"at": {"event": "send", "msg_type": 3, "occurrence": 2},
             "fault": {"kind": "delay", "delay_s": 0.05}},
        ])
        inj.send_message(_msg(pkg))
        assert len(transport.sent) == 2
        inj.send_message(_msg(pkg))
        assert len(transport.sent) == 2
        deadline = time.monotonic() + 5.0
        while len(transport.sent) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(transport.sent) == 3

    def test_loopback_and_round_matcher(self, pkg):
        inj, transport = self._injector(pkg, [
            {"at": {"event": "send", "round": 2, "occurrence": 1}, "fault": "drop"}])
        inj.send_message(_msg(pkg, sender=0, receiver=0, round_idx=2))  # loopback
        inj.send_message(_msg(pkg, round_idx=1))
        inj.send_message(_msg(pkg, round_idx=2))
        inj.send_message(_msg(pkg, round_idx=2))
        assert len(transport.sent) == 3

    def test_retransmits_do_not_advance_occurrence(self, pkg):
        inj, transport = self._injector(pkg, [
            {"at": {"event": "send", "msg_type": 3, "occurrence": 2}, "fault": "drop"}])

        def wire(seq):
            m = _msg(pkg)
            m.add_params(pkg.constants.MSG_ARG_KEY_COMM_SEQ, seq)
            m.add_params(pkg.constants.MSG_ARG_KEY_COMM_CHAN, 0)
            return m

        for _ in range(3):
            inj.send_message(wire(0))
        assert len(transport.sent) == 3
        inj.send_message(wire(1))
        assert len(transport.sent) == 3

    def test_maybe_wrap_faulty_takes_the_plan(self, pkg):
        """The comm stack's wrap: an installed schedule with send steps
        wraps the injector with no ``fault_injection`` knobs at all."""
        a = pkg.make_args(rank=1, chaos_schedule=[
            {"at": {"event": "send", "occurrence": 1}, "fault": "drop"}])
        pkg.chaos.maybe_install_chaos(a)
        transport = _transport(pkg)
        com = pkg.faults.maybe_wrap_faulty(transport, a)
        assert isinstance(com, pkg.faults.FaultInjector)
        com.send_message(_msg(pkg))
        com.send_message(_msg(pkg))
        assert len(transport.sent) == 1
        pkg.chaos.reset_chaos()
        assert pkg.faults.maybe_wrap_faulty(transport, pkg.make_args()) is transport

    def test_no_send_steps_means_no_plan(self, pkg):
        pkg.chaos.install_chaos(pkg.chaos.ChaosSchedule([
            {"at": {"event": "wal_append"}, "fault": "kill_server"}]))
        assert pkg.chaos.comm_plan(rank=0) is None


class TestFaultyIOWal:
    def _wal(self, pkg, tmp_path, spec):
        pkg.chaos.install_chaos(pkg.chaos.ChaosSchedule(spec))
        return pkg.checkpoint.RoundWAL(str(tmp_path))

    def test_torn_write_kills_midway_and_next_incarnation_recovers(self, pkg, tmp_path):
        wal = self._wal(pkg, tmp_path, [
            {"at": {"event": "wal_append", "occurrence": 2},
             "fault": {"kind": "torn_write", "at_byte": 7}}])
        wal.append(0, 1, [1, 2], folded=[1, 2])
        with pytest.raises(pkg.chaos.ProcessKilled):
            wal.append(1, 2, [1, 2], folded=[1, 2])
        pkg.chaos.reset_chaos()
        wal2 = pkg.checkpoint.RoundWAL(str(tmp_path))
        assert [r["round_idx"] for r in wal2.records()] == [0]
        wal2.append(1, 2, [1, 2], folded=[1])
        assert [r["round_idx"] for r in wal2.records()] == [0, 1]

    def test_enospc_is_an_oserror_and_writes_nothing(self, pkg, tmp_path):
        wal = self._wal(pkg, tmp_path, [
            {"at": {"event": "wal_append", "occurrence": 1}, "fault": "enospc"}])
        with pytest.raises(OSError) as ei:
            wal.append(0, None, [1])
        assert isinstance(ei.value, pkg.chaos.ChaosError)
        assert wal.records() == []
        wal.append(0, None, [1])
        assert len(wal.records()) == 1

    def test_fsync_fail_leaves_the_record_but_raises(self, pkg, tmp_path):
        wal = self._wal(pkg, tmp_path, [
            {"at": {"event": "wal_append", "occurrence": 1}, "fault": "fsync_fail"}])
        with pytest.raises(OSError):
            wal.append(0, None, [1], folded=[1])
        assert [r["round_idx"] for r in wal.records()] == [0]

    def test_kill_before_wal_create_leaves_no_file(self, pkg, tmp_path):
        wal = self._wal(pkg, tmp_path, [{"at": {"event": "wal_create"}, "fault": "kill_server"}])
        with pytest.raises(pkg.chaos.ProcessKilled):
            wal.append(0, None, [1])
        assert not os.path.exists(wal.path)

    def test_kill_after_append_leaves_the_record(self, pkg, tmp_path):
        wal = self._wal(pkg, tmp_path, [
            {"at": {"event": "wal_append", "occurrence": 1},
             "fault": {"kind": "kill_server", "when": "after"}}])
        with pytest.raises(pkg.chaos.ProcessKilled):
            wal.append(0, None, [1], folded=[1])
        assert len(pkg.checkpoint.RoundWAL(str(tmp_path)).records()) == 1

    def test_first_append_fsyncs_the_parent_directory(self, pkg, tmp_path, monkeypatch):
        synced = []
        real_fsync = os.fsync

        def spy(fd):
            synced.append(stat.S_ISDIR(os.fstat(fd).st_mode))
            return real_fsync(fd)

        monkeypatch.setattr(os, "fsync", spy)
        wal = pkg.checkpoint.RoundWAL(str(tmp_path))
        wal.append(0, None, [1])
        assert True in synced and False in synced
        synced.clear()
        wal.append(1, None, [1])
        assert synced == [False]


def _state(pkg, scale, step):
    w = np.full(4, scale, np.float32)
    return {"params": {"w": w if pkg.name == "fedml_tpu" else torch.from_numpy(w)},
            "round_idx": step}


class TestCheckpointFaults:
    def test_torn_publish_falls_back_and_never_retries(self, pkg, tmp_path):
        pkg.chaos.install_chaos(pkg.chaos.ChaosSchedule([
            {"at": {"event": "ckpt_publish", "occurrence": 2}, "fault": "torn_publish"}]))
        ckpt = pkg.checkpoint.RoundCheckpointer(str(tmp_path))
        ckpt.save(0, _state(pkg, 1.0, 0))
        ckpt.save(1, _state(pkg, 2.0, 1))  # torn: listed on disk, content garbage
        watcher = pkg.checkpoint.CheckpointWatcher(str(tmp_path))
        step, state = watcher.poll()
        assert step == 0 and float(np.asarray(state["params"]["w"])[0]) == 1.0
        assert watcher.poll() is None
        ckpt.save(2, _state(pkg, 3.0, 2))
        step, state = watcher.poll()
        assert step == 2 and float(np.asarray(state["params"]["w"])[0]) == 3.0
        ckpt.close()
        watcher.close()

    @pytest.mark.parametrize("fault,raises", [
        ({"kind": "kill_server", "when": "before"}, "killed"),
        ({"kind": "kill_server", "when": "after"}, "killed"),
        ("enospc", "oserror"),
    ])
    def test_publish_kill_and_enospc(self, pkg, tmp_path, fault, raises):
        pkg.chaos.install_chaos(pkg.chaos.ChaosSchedule([
            {"at": {"event": "ckpt_publish", "round": 1}, "fault": fault}]))
        ckpt = pkg.checkpoint.RoundCheckpointer(str(tmp_path))
        ckpt.save(0, _state(pkg, 1.0, 0))
        exc = pkg.chaos.ProcessKilled if raises == "killed" else OSError
        with pytest.raises(exc):
            ckpt.save(1, _state(pkg, 2.0, 1))
        after = isinstance(fault, dict) and fault.get("when") == "after"
        assert ckpt.latest_step() == (1 if after else 0)
        ckpt.close()


class TestBarriersAndClock:
    def test_kill_at_named_barrier(self, pkg):
        pkg.chaos.chaos_barrier("server.round_close", round=0, rank=0)  # no schedule
        pkg.chaos.install_chaos(pkg.chaos.ChaosSchedule([
            {"at": {"event": "barrier", "name": "server.round_close", "round": 1},
             "fault": "kill_server"}]))
        pkg.chaos.chaos_barrier("server.round_close", round=0, rank=0)
        pkg.chaos.chaos_barrier("server.broadcast", round=1, rank=0)
        with pytest.raises(pkg.chaos.ProcessKilled):
            pkg.chaos.chaos_barrier("server.round_close", round=1, rank=0)

    def test_clock_skew_steps_the_wall_anchor_only(self, pkg):
        pkg.chaos.install_chaos(pkg.chaos.ChaosSchedule([
            {"at": {"event": "barrier", "name": "b"},
             "fault": {"kind": "clock_skew", "skew_s": 2.5}}]))
        rec = pkg.Telemetry.get_instance().recorder
        before = rec.wall_t0
        t0 = time.monotonic()
        pkg.chaos.chaos_barrier("b")
        assert rec.wall_t0 == pytest.approx(before + 2.5)
        assert time.monotonic() - t0 < 1.0


class TestInstallFromArgs:
    def test_maybe_install_and_reuse(self, pkg):
        spec = [{"at": {"event": "wal_append"}, "fault": "kill_server"}]
        a = pkg.make_args(chaos_schedule=spec)
        s1 = pkg.chaos.maybe_install_chaos(a)
        assert pkg.chaos.maybe_install_chaos(a) is s1
        b = pkg.make_args(io_faults=[{"at": {"event": "ckpt_publish"}, "fault": "torn_publish"}])
        assert pkg.chaos.maybe_install_chaos(b) is not s1
        pkg.chaos.reset_chaos()
        assert pkg.chaos.active_chaos() is None
        assert pkg.chaos.maybe_install_chaos(pkg.make_args()) is None

    def test_comm_stack_installs_the_schedule(self):
        """The port's managers install the chaos plane before they wrap
        the comm stack (``core/managers.py``)."""
        from fedml_tpu_torch.arguments import Arguments
        from fedml_tpu_torch.core import chaos
        from fedml_tpu_torch.core.comm.faults import FaultInjector
        from fedml_tpu_torch.core.managers import build_comm_stack

        a = Arguments()
        a.chaos_schedule = [{"at": {"event": "send", "rank": 1}, "fault": "drop"}]
        a.run_id = "chaos_stack"
        a._validate()
        com = build_comm_stack(a, rank=1, size=2, backend="LOCAL")
        try:
            assert chaos.active_chaos() is not None
            assert isinstance(com, FaultInjector)
        finally:
            chaos.reset_chaos()
