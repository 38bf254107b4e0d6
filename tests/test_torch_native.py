"""The port's native plane (``fedml_tpu_torch/core/native.py``,
``core/comm/native_broker.py``, ``core/scheduler.py``'s ``dp_schedule``
and ``best_makespan``) against the JAX package's, on the CPU.

- the scheduler: the native LPT's makespan equals the port's and the
  JAX package's ``greedy_makespan`` (bitwise the same as each other) on
  seeded workloads; the branch-and-bound equals brute force on small
  instances (tests/test_native.py's cases); ``dp_schedule`` in both modes
  (memory overflow included) and ``best_makespan`` equal the JAX
  package's;
- the broker: the port's native binary and the JAX package's Python
  broker carry each other's clients' frames byte for byte; one MQTT world
  of the port sees the same messages over the native broker as over the
  Python one; ``FEDML_TPU_NATIVE_BROKER=1`` makes ``ensure_broker`` start
  the port's own binary, built under ``fedml_tpu_torch/native/build/``;
- the fallback: without a build, the Python broker and LPT, with the
  JAX package's ``native build failed`` warning.
"""

from __future__ import annotations

import itertools
import logging
import os
import shutil
import socket
import threading
import types

import numpy as np
import pytest

from fedml_tpu.core import scheduler as jax_scheduler
from fedml_tpu.core.comm import broker as jax_broker
from fedml_tpu_torch import constants
from fedml_tpu_torch.core import native, scheduler
from fedml_tpu_torch.core.comm import broker as port_broker
from fedml_tpu_torch.core.comm import native_broker
from fedml_tpu_torch.core.message import Message

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "fedml_tpu_torch")

needs_gxx = pytest.mark.skipif(
    shutil.which("g++") is None or native.native_disabled(),
    reason="the native plane needs g++ (the callers fall back to Python without it)",
)


def _brute_force_makespan(w, m):
    best = float("inf")
    for assign in itertools.product(range(m), repeat=len(w)):
        loads = [0.0] * m
        for j, r in enumerate(assign):
            loads[r] += w[j]
        best = min(best, max(loads))
    return best


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- the scheduler -----------------------------------------------------------

@needs_gxx
@pytest.mark.parametrize("seed, jobs, resources", [(0, 40, 5), (3, 17, 4), (7, 64, 8)])
def test_native_lpt_equals_greedy_in_both_packages(seed, jobs, resources):
    w = np.random.default_rng(seed).uniform(1, 10, size=jobs).tolist()
    port_assign, port_ms = scheduler.greedy_makespan(w, resources)
    jax_assign, jax_ms = jax_scheduler.greedy_makespan(w, resources)
    assert (port_assign, port_ms) == (jax_assign, jax_ms)
    assign, ms = native.lpt_makespan_native(w, resources)
    assert ms == pytest.approx(port_ms)
    assert sorted(j for bunch in assign for j in bunch) == list(range(jobs))
    assert max(sum(w[j] for j in b) for b in assign) == pytest.approx(ms)


@needs_gxx
def test_branch_and_bound_is_exact_on_small_instances():
    rng = np.random.default_rng(1)
    for _ in range(5):
        w = rng.uniform(1, 10, size=9).tolist()
        assign, ms = native.exact_makespan(w, 3)
        assert ms == pytest.approx(_brute_force_makespan(w, 3), rel=1e-9)
        assert max(sum(w[j] for j in b) for b in assign) == pytest.approx(ms)
    # the classic LPT-suboptimal instance: a perfect 3-way split of 48
    w = [7.0, 7.0, 6.0, 6.0, 5.0, 5.0, 4.0, 4.0, 4.0]
    _, ms = native.exact_makespan(w, 3)
    assert ms == pytest.approx(16.0)
    assert ms <= scheduler.greedy_makespan(w, 3)[1] + 1e-9


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("seed, jobs, cap", [(0, 12, 40.0), (5, 20, 25.0), (9, 15, 3.0)])
def test_dp_schedule_equals_jax(mode, seed, jobs, cap):
    """cap 3.0 overflows every resource: the least loaded takes the job
    anyway, in both packages."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(1, 20, size=jobs).tolist()
    memory = rng.uniform(1, 8, size=jobs).tolist()
    constraints = [cap, cap * 1.5, cap * 0.5]
    assert scheduler.dp_schedule(w, constraints, memory, mode) == jax_scheduler.dp_schedule(
        w, constraints, memory, mode)


@pytest.mark.parametrize("seed, jobs, resources", [(2, 14, 4), (4, 9, 3), (6, 11, 2)])
def test_best_makespan_equals_jax(seed, jobs, resources):
    w = np.random.default_rng(seed).uniform(1, 20, size=jobs).tolist()
    port_assign, port_ms = scheduler.best_makespan(w, resources)
    jax_assign, jax_ms = jax_scheduler.best_makespan(w, resources)
    assert port_ms == pytest.approx(jax_ms, rel=1e-12)
    assert port_ms <= scheduler.greedy_makespan(w, resources)[1] + 1e-9
    if shutil.which("g++") is not None and not native.native_disabled():
        # both packages' branch-and-bound: the same source, the same schedule
        assert port_assign == jax_assign


def test_best_makespan_falls_back_to_greedy_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "_scheduler_lib", lambda: None)
    w = np.random.default_rng(8).uniform(1, 20, size=10).tolist()
    assert scheduler.best_makespan(w, 3) == scheduler.greedy_makespan(w, 3)
    assert native.lpt_makespan_native(w, 3) is None and native.exact_makespan(w, 3) is None


def test_failed_build_logs_as_jax_and_returns_none(tmp_path, monkeypatch, caplog):
    (tmp_path / "bad.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with caplog.at_level(logging.WARNING):
        assert native.build_native("bad.cpp", "bad") is None
    assert any("native build failed (bad.cpp)" in r.getMessage() for r in caplog.records)
    assert os.listdir(tmp_path / "build") == []  # no temp file left behind


def test_disabled_native_takes_the_python_broker(monkeypatch):
    monkeypatch.setenv("FEDML_TPU_NO_NATIVE", "1")
    monkeypatch.setenv("FEDML_TPU_NATIVE_BROKER", "1")
    assert native_broker.spawn_native_broker() is None
    host, port = port_broker.ensure_broker("127.0.0.1", 0)
    assert (host, port) in port_broker._shared_brokers


# -- the broker --------------------------------------------------------------

@pytest.fixture(scope="module")
def port_native_broker():
    spawned = native_broker.spawn_native_broker()
    if spawned is None:
        pytest.skip("native toolchain unavailable")
    host, port, proc = spawned
    yield host, port, proc
    proc.terminate()
    proc.wait(10)


@pytest.fixture
def spawned(monkeypatch):
    """Every native broker ``ensure_broker`` starts, terminated after."""
    procs = []
    real = native_broker.spawn_native_broker

    def recording(port=0, timeout_s=10.0):
        out = real(port, timeout_s)
        if out is not None:
            procs.append(out[2])
        return out

    monkeypatch.setattr(native_broker, "spawn_native_broker", recording)
    yield procs
    for proc in procs:
        proc.terminate()
        proc.wait(10)


def _exchange(host, port, publisher_cls, subscriber_cls, payloads):
    """``publisher_cls`` clients publish ``payloads`` on one topic; a
    ``subscriber_cls`` client collects them in order."""
    got, done = [], threading.Event()
    sub = subscriber_cls(host, port)

    def on_msg(_topic, payload):
        got.append(payload)
        if len(got) == len(payloads):
            done.set()

    sub.subscribe("t/x", on_msg)
    pub = publisher_cls(host, port)
    # the subscription is in place once a probe published after it arrives
    probe = threading.Event()
    sub.subscribe("t/probe", lambda _t, _p: probe.set())
    while not probe.wait(0.05):
        pub.publish("t/probe", b"")
    for p in payloads:
        pub.publish("t/x", p)
    assert done.wait(30)
    pub.close()
    sub.close()
    return got


def _payloads():
    rng = np.random.default_rng(11)
    return [b"native-hello", b"", rng.bytes(3 * 1024 * 1024), bytes(range(256)) * 7]


@needs_gxx
def test_clients_cross_brokers_byte_for_byte(port_native_broker):
    payloads = _payloads()
    host, port, _ = port_native_broker
    # a JAX client publishes to a port client through the port's native broker
    assert _exchange(host, port, jax_broker.BrokerClient, port_broker.BrokerClient,
                     payloads) == payloads
    # and a port client publishes to a JAX client through the JAX package's broker
    broker = jax_broker.Broker()
    try:
        assert _exchange(broker.host, broker.port, port_broker.BrokerClient,
                         jax_broker.BrokerClient, payloads) == payloads
    finally:
        broker.stop()


@needs_gxx
def test_native_broker_is_the_ports_own_binary(port_native_broker):
    _, _, proc = port_native_broker
    build = os.path.realpath(os.path.join(PORT, "native", "build"))
    assert os.path.realpath(native.NATIVE_DIR) == os.path.join(os.path.realpath(PORT), "native")
    assert os.path.realpath(native.BUILD_DIR) == build
    for name in ("broker.cpp", "scheduler.cpp"):
        assert os.path.isfile(os.path.join(native.NATIVE_DIR, name))
    assert os.path.dirname(os.path.realpath(proc.args[0])) == build
    exe = f"/proc/{proc.pid}/exe"
    if os.path.exists(exe):
        assert os.path.dirname(os.readlink(exe)) == build


@needs_gxx
@pytest.mark.parametrize("fixed_port", [False, True])
def test_ensure_broker_starts_the_native_binary_when_asked(monkeypatch, spawned, fixed_port):
    monkeypatch.setenv("FEDML_TPU_NATIVE_BROKER", "1")
    want = _free_port() if fixed_port else 0
    host, port = port_broker.ensure_broker("127.0.0.1", want)
    assert len(spawned) == 1 and (host, port) not in port_broker._shared_brokers
    assert os.path.dirname(os.path.realpath(spawned[0].args[0])) == os.path.realpath(
        native.BUILD_DIR)
    if fixed_port:
        assert port == want
        # a second rank of the world reaches the running broker
        assert port_broker.ensure_broker("127.0.0.1", want) == (host, port)
        assert len(spawned) == 1
    payloads = [b"a", b"bc"]
    assert _exchange(host, port, port_broker.BrokerClient, port_broker.BrokerClient,
                     payloads) == payloads


PROBE = -7  # a message type no world sends: the subscription probes


class _Capture:
    def __init__(self, n):
        self.n, self.got, self.done = n, [], threading.Event()
        self.probed = threading.Event()

    def receive_message(self, msg_type, msg):
        if msg_type == PROBE:
            self.probed.set()
            return
        self.got.append(msg.to_bytes())
        if len(self.got) == self.n:
            self.done.set()


def _mqtt_world(run_id: str, port: int):
    """Rank 0 sends rank 1 four model messages and rank 1 answers with
    two; returns the bytes each rank received, in order."""
    from fedml_tpu_torch.core.managers import _build_com_manager

    args = types.SimpleNamespace(run_id=run_id, broker_port=port, broker_host="127.0.0.1")
    # each rank reaches the broker through ensure_broker, as a world does
    coms = [_build_com_manager(args, r, 2, constants.COMM_BACKEND_MQTT) for r in (0, 1)]
    caps = [_Capture(2), _Capture(4)]
    threads = []
    for com, cap in zip(coms, caps):
        com.add_observer(cap)
        t = threading.Thread(target=com.handle_receive_message, daemon=True)
        t.start()
        threads.append(t)
    # pub/sub keeps nothing for a topic nobody has subscribed to yet: probe
    # each rank until its subscription is live at the broker
    for r, cap in enumerate(caps):
        while not cap.probed.wait(0.05):
            coms[1 - r].send_message(Message(PROBE, 1 - r, r))
    rng = np.random.default_rng(5)
    for i in range(4):
        msg = Message(constants.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, 0, 1)
        msg.add_params("w", rng.normal(size=(64, 33)).astype(np.float32))
        msg.add_params("round", i)
        coms[0].send_message(msg)
    for i in range(2):
        msg = Message(constants.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, 1, 0)
        msg.add_params("n", np.arange(i + 3, dtype=np.int64))
        coms[1].send_message(msg)
    for cap in caps:
        assert cap.done.wait(30)
    for com, t in zip(coms, threads):
        com.stop_receive_message()
        t.join(10)
    return [cap.got for cap in caps]


@needs_gxx
def test_mqtt_world_is_the_same_over_either_broker(monkeypatch, spawned):
    python_world = _mqtt_world("native_parity_py", _free_port())
    assert spawned == []
    monkeypatch.setenv("FEDML_TPU_NATIVE_BROKER", "1")
    native_world = _mqtt_world("native_parity_cc", _free_port())
    assert len(spawned) == 1
    assert native_world == python_world
    assert [len(g) for g in native_world] == [2, 4]
