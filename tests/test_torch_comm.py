"""The port's comm layer (``fedml_tpu_torch.core.comm``, ``core/message.py``,
``core/wire.py``) against the JAX package's, on the CPU.

- The wire codec: the port's bytes equal ``flax.serialization
  .msgpack_serialize``'s on the same trees (nested dicts in insertion
  order, lists, None, bools, ints, numpy scalars, f32/int64/uint8
  arrays, 0-d arrays, a bf16 leaf, chunked leaves) and each package
  decodes the other's; tuples raise as in flax.
- The comm classes: the unit tests of the JAX package's
  ``TestFrame``/``TestPipes`` (tests/test_tensor_rpc.py),
  ``TestFaultInjectorUnit`` (tests/test_faults.py),
  ``TestReliableChannelUnit``/``TestFailureDetectorUnit``/``TestRoundWAL``/
  ``TestGrpcSendRetry`` (tests/test_robustness.py), ``TestTraceContext``
  (tests/test_tracing.py) and ``TestBroker``/``TestPayloadStore``/
  ``TestMqttBackend`` (tests/test_cross_device.py), each run on both
  packages (the ``pkg`` parameter), plus frames, pipes and broker
  topics crossing from one package to the other.
"""

from __future__ import annotations

import importlib
import socket
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as flax_ser

from fedml_tpu.core.message import Message as JaxMessage
from fedml_tpu_torch.core import wire
from fedml_tpu_torch.core.message import Message as PortMessage
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_world import free_port_block

PACKAGES = ("fedml_tpu", "fedml_tpu_torch")


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    from fedml_tpu_torch.core.telemetry import Telemetry

    Telemetry.reset()
    yield
    Telemetry.reset()


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
        name=base, constants=m("constants"), Message=m("core.message").Message,
        base=m("core.comm.base"), faults=m("core.comm.faults"),
        reliable=m("core.comm.reliable"), heartbeat=m("core.comm.heartbeat"),
        trpc=m("core.comm.tensor_rpc"), grpc=m("core.comm.grpc_backend"),
        broker=m("core.comm.broker"), mqtt=m("core.comm.mqtt_backend"),
        store=m("core.comm.payload_store"), instrument=m("core.comm.instrument"),
        tracing=m("core.tracing"), checkpoint=m("core.checkpoint"),
        Telemetry=m("core.telemetry").Telemetry, make_args=make_args,
    )


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _load(request.param)


def _array(pkg, a):
    """``a`` as the package's own array type: a jax array or a tensor."""
    return jnp.asarray(a) if pkg.name == "fedml_tpu" else torch.tensor(a)


# -- the wire codec ----------------------------------------------------

RNG = np.random.default_rng(0)
TREES = {
    "scalars": {"z": 1, "a": -5, "m": None, "t": True, "f": False, "x": 1.5, "s": "hé",
                "big": 2**40, "neg": -2**40, "i8": -100, "u16": 60000, "i32": -70000,
                "b": b"\x00\x01" * 200},
    "nested_unsorted": {"c": {"y": [1, 2, {"q": 3, "p": None}], "x": {}},
                        "a": [[], [True, 0.25]], "b": {str(i): i for i in range(20)}},
    "numpy_scalars": {"i64": np.int64(7), "f64": np.float64(2.5), "f32": np.float32(-1.25),
                      "bool": np.bool_(True), "u8": np.uint8(200)},
    "arrays": {"f32": RNG.normal(size=(3, 4)).astype(np.float32),
               "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
               "u8": np.arange(300, dtype=np.uint8).reshape(3, 100) % 251,
               "zero_d": np.array(3.0, np.float32), "zero_d_int": np.array(-2, np.int32),
               "empty": np.zeros((0, 5), np.float32),
               "in_list": [np.ones(3, np.float16), {"k": np.arange(4, dtype=np.int8)}]},
    "complex": {"c": 1 + 2j, "l": list(range(40))},
    "message": {"msg_type": 40, "sender": 3, "receiver": 0, "request_id": "3-17",
                "x": np.arange(64, dtype=np.int64), "deadline_ts": 12345.678},
}


def _same(a, b):
    """Trees equal leaf for leaf, arrays by dtype, shape and value."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (a, b)


@pytest.mark.parametrize("name", sorted(TREES))
def test_port_bytes_are_flax_bytes_and_decode_both_ways(name):
    tree = TREES[name]
    want = flax_ser.msgpack_serialize(tree)
    got = wire.msgpack_serialize(tree)
    assert got == want
    _same(wire.msgpack_restore(want), flax_ser.msgpack_restore(want))
    _same(flax_ser.msgpack_restore(got), wire.msgpack_restore(got))


def test_keys_go_out_sorted_as_flax_writes_them():
    tree = {"b": 1, "a": 2, "c": {"z": 0, "y": 1}}
    back = flax_ser.msgpack_restore(wire.msgpack_serialize(tree))
    assert list(back) == ["a", "b", "c"] and list(back["c"]) == ["y", "z"]


def test_tensor_leaves_are_jax_array_bytes():
    a = RNG.normal(size=(5, 7)).astype(np.float32)
    i = np.arange(12, dtype=np.int32).reshape(3, 4)  # jax's default int width
    want = flax_ser.msgpack_serialize({"w": jnp.asarray(a), "n": [jnp.asarray(i)],
                                       "s": jnp.asarray(np.float32(2.0))})
    got = wire.msgpack_serialize({"w": torch.tensor(a), "n": [torch.tensor(i)],
                                  "s": torch.tensor(np.float32(2.0))})
    assert got == want


def test_bf16_leaf_is_flax_bytes_and_reads_back_as_a_bf16_tensor():
    vals = np.array([0.0, 1.0, -2.5, 3.140625, 1e-3, 65280.0], np.float32)
    want = flax_ser.msgpack_serialize({"h": jnp.asarray(vals, jnp.bfloat16)})
    got = wire.msgpack_serialize({"h": torch.tensor(vals).to(torch.bfloat16)})
    assert got == want
    back = wire.msgpack_restore(want)["h"]
    assert isinstance(back, torch.Tensor) and back.dtype == torch.bfloat16
    assert back.device.type == "cpu"
    np.testing.assert_array_equal(back.float().numpy(),
                                  np.asarray(jnp.asarray(vals, jnp.bfloat16), np.float32))
    jax_back = flax_ser.msgpack_restore(got)["h"]
    np.testing.assert_array_equal(np.asarray(jax_back, np.float32), back.float().numpy())


def test_tuples_raise_as_in_flax():
    for tree in ({"t": (1, 2)}, {"a": [1, (2,)]}):
        with pytest.raises(TypeError) as jax_err:
            flax_ser.msgpack_serialize(tree)
        with pytest.raises(TypeError) as port_err:
            wire.msgpack_serialize(tree)
        assert str(port_err.value) == str(jax_err.value)


def test_chunking_matches_flax_at_a_small_chunk_size(monkeypatch):
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 24)
    monkeypatch.setattr(wire, "MAX_CHUNK_SIZE", 24)
    tree = {"w": RNG.normal(size=(5, 7)).astype(np.float32),
            "n": {"q": np.arange(3, dtype=np.int64), "big": np.arange(40, dtype=np.int64)},
            "l": [np.arange(20, dtype=np.float32)], "small": np.arange(2, dtype=np.int32)}
    want = flax_ser.msgpack_serialize(tree)
    assert wire.msgpack_serialize(tree) == want
    _same(wire.msgpack_restore(want), flax_ser.msgpack_restore(want))
    whole = flax_ser.msgpack_serialize(np.arange(30, dtype=np.float32))
    assert wire.msgpack_serialize(np.arange(30, dtype=np.float32)) == whole
    np.testing.assert_array_equal(wire.msgpack_restore(whole), np.arange(30, dtype=np.float32))


def test_message_bytes_equal_and_each_package_reads_the_other():
    params = {"w": {"kernel": RNG.normal(size=(4, 3)).astype(np.float32),
                    "bias": np.zeros(3, np.float32)},
              "count": np.asarray(7, np.int32)}

    def fill(m):
        m.add_params("model_params", params)
        m.add_params("client_idx", 5)
        m.add_params("num_samples", 123.5)
        m.add_params("round_idx", np.int64(2))
        return m

    jm, pm = fill(JaxMessage(3, 1, 0)), fill(PortMessage(3, 1, 0))
    assert pm.to_bytes() == jm.to_bytes()
    from_port = JaxMessage.from_bytes(pm.to_bytes())
    from_jax = PortMessage.from_bytes(jm.to_bytes())
    assert from_port.get_type() == from_jax.get_type() == 3
    _same(from_jax.get_params(), from_port.get_params())


@pytest.mark.parametrize("name", sorted(TREES))
def test_payload_nbytes_is_the_references(name):
    from fedml_tpu.core.comm.instrument import payload_nbytes as jax_nbytes
    from fedml_tpu_torch.core.comm.instrument import payload_nbytes

    jm, pm = JaxMessage(3, 1, 0), PortMessage(3, 1, 0)
    jm.add_params("p", TREES[name])
    pm.add_params("p", TREES[name])
    jm.add_params("trace_flow", 99)
    pm.add_params("trace_flow", 99)
    assert payload_nbytes(pm) == jax_nbytes(jm)
    # a tensor counts its numel x element size, as the jax array does
    jm.add_params("t", {"a": jnp.ones((3, 5), jnp.float32), "b": jnp.ones(4, jnp.bfloat16)})
    pm.add_params("t", {"a": torch.ones(3, 5), "b": torch.ones(4, dtype=torch.bfloat16)})
    assert payload_nbytes(pm) == jax_nbytes(jm)


# -- TestFrame / TestPipes (tests/test_tensor_rpc.py) ---------------------


def _roundtrip(pkg, msg):
    parts = pkg.trpc.encode_frame(msg)
    header = bytes(parts[0][8:])
    body = b"".join(bytes(p) for p in parts[1:])
    return pkg.trpc.decode_frame(header, memoryview(body))


class TestFrame:
    def test_pytree_roundtrip(self, pkg):
        c = pkg.constants
        m = pkg.Message(c.MSG_TYPE_S2C_INIT_CONFIG, 0, 3)
        params = {
            "dense": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
                      "bias": np.zeros(3, np.float32)},
            "emb": np.arange(8, dtype=np.int32),
        }
        m.add_params(c.MSG_ARG_KEY_MODEL_PARAMS, params)
        m.add_params(c.MSG_ARG_KEY_CLIENT_INDEX, 7)
        m.add_params(c.MSG_ARG_KEY_NUM_SAMPLES, 123.5)
        m2 = _roundtrip(pkg, m)
        assert m2.get_type() == c.MSG_TYPE_S2C_INIT_CONFIG
        assert m2.get_receiver_id() == 3
        assert m2.get(c.MSG_ARG_KEY_CLIENT_INDEX) == 7
        assert m2.get(c.MSG_ARG_KEY_NUM_SAMPLES) == 123.5
        got = m2.get(c.MSG_ARG_KEY_MODEL_PARAMS)
        np.testing.assert_array_equal(got["dense"]["kernel"], params["dense"]["kernel"])
        np.testing.assert_array_equal(got["emb"], params["emb"])

    def test_array_leaves(self, pkg):
        m = pkg.Message(1, 2, 0)
        m.add_params("w", {"a": _array(pkg, np.ones((4, 2), np.float32)),
                           "lst": [_array(pkg, np.zeros(3, np.float32)), 5]})
        m2 = _roundtrip(pkg, m)
        np.testing.assert_array_equal(m2.get("w")["a"], np.ones((4, 2)))
        np.testing.assert_array_equal(m2.get("w")["lst"][0], np.zeros(3))
        assert m2.get("w")["lst"][1] == 5

    def test_zero_d_arrays_stay_arrays(self, pkg):
        m = pkg.Message(1, 0, 1)
        m.add_params("state", {"count": np.asarray(7, np.int32)})
        got = _roundtrip(pkg, m).get("state")["count"]
        assert isinstance(got, np.ndarray)
        assert got.shape == () and got.dtype == np.int32 and got == 7

    def test_marker_keys_in_user_dicts_escape(self, pkg):
        m = pkg.Message(1, 0, 1)
        m.add_params("meta", {"__fedml_tensor__": 0, "x": [1, 2]})
        m.add_params("t", (1, {"__fedml_tuple__": "y"}))
        got = _roundtrip(pkg, m)
        assert got.get("meta") == {"__fedml_tensor__": 0, "x": [1, 2]}
        assert got.get("t") == (1, {"__fedml_tuple__": "y"})

    def test_array_payload_not_reencoded(self, pkg):
        a = np.arange(1024, dtype=np.float32)
        m = pkg.Message(1, 0, 1)
        m.add_params("x", {"a": a})
        parts = pkg.trpc.encode_frame(m)
        assert len(parts) == 2  # header + exactly one raw buffer
        assert len(parts[1]) == a.nbytes
        assert np.shares_memory(np.frombuffer(parts[1], np.float32), a)


def _frame_msg(cls):
    m = cls(3, 1, 0)
    m.add_params("model_params", {"k": np.arange(6, dtype=np.float32).reshape(2, 3),
                                  "count": np.asarray(4, np.int64)})
    m.add_params("t", (1, {"__fedml_tuple__": "y"}))
    m.add_params("round_idx", np.int64(3))
    return m


def test_trpc_frames_are_the_jax_frames_and_cross_decode():
    from fedml_tpu.core.comm import tensor_rpc as jtrpc
    from fedml_tpu_torch.core.comm import tensor_rpc as ptrpc

    jparts = [bytes(p) for p in jtrpc.encode_frame(_frame_msg(JaxMessage))]
    pparts = [bytes(p) for p in ptrpc.encode_frame(_frame_msg(PortMessage))]
    assert pparts == jparts
    header, body = jparts[0][8:], memoryview(b"".join(jparts[1:]))
    a = jtrpc.decode_frame(header, body).get_params()
    b = ptrpc.decode_frame(header, body).get_params()
    assert a["t"] == b["t"] == (1, {"__fedml_tuple__": "y"})
    for k in ("k", "count"):
        np.testing.assert_array_equal(a["model_params"][k], b["model_params"][k])
        assert a["model_params"][k].dtype == b["model_params"][k].dtype


def test_trpc_bf16_tensor_roundtrips_as_bf16():
    from fedml_tpu_torch.core.comm import tensor_rpc as ptrpc

    t = torch.tensor([1.0, -2.5, 0.125]).to(torch.bfloat16)
    m = PortMessage(1, 0, 1)
    m.add_params("h", {"t": t})
    back = _roundtrip(types.SimpleNamespace(trpc=ptrpc), m).get("h")["t"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


class _Obs:
    def __init__(self, com, got, stop_after=1, done=None):
        self.com, self.got, self.stop_after, self.done = com, got, stop_after, done

    def receive_message(self, t, msg):
        self.got.append((t, msg))
        if len(self.got) == self.stop_after:
            if self.done is not None:
                self.done.set()
            self.com.stop_receive_message()


class TestPipes:
    def test_two_rank_ping_pong(self, pkg):
        base = free_port_block(2)
        m0 = pkg.trpc.TensorRpcCommunicationManager(rank=0, size=2, port_base=base)
        m1 = pkg.trpc.TensorRpcCommunicationManager(rank=1, size=2, port_base=base)
        got = []
        m1.add_observer(_Obs(m1, got))
        t = threading.Thread(target=m1.handle_receive_message, daemon=True)
        t.start()
        msg = pkg.Message(42, 0, 1)
        msg.add_params("payload", {"w": np.full((256, 4), 3.0, np.float32)})
        m0.send_message(msg)
        t.join(timeout=30)
        assert not t.is_alive()
        assert got and got[0][0] == 42
        np.testing.assert_array_equal(got[0][1].get("payload")["w"],
                                      np.full((256, 4), 3.0, np.float32))
        m0.stop_receive_message()

    def test_pipe_reuse(self, pkg):
        base = free_port_block(2)
        m0 = pkg.trpc.TensorRpcCommunicationManager(rank=0, size=2, port_base=base)
        m1 = pkg.trpc.TensorRpcCommunicationManager(rank=1, size=2, port_base=base)
        n = 5
        done = threading.Event()
        seen = []
        m1.add_observer(_Obs(m1, seen, stop_after=n, done=done))
        t = threading.Thread(target=m1.handle_receive_message, daemon=True)
        t.start()
        for i in range(n):
            m0.send_message(pkg.Message(i, 0, 1))
        assert done.wait(timeout=30)
        assert [s[0] for s in seen] == list(range(n))
        assert len(m0._pipes) == 1  # one persistent pipe for rank 1
        m0.stop_receive_message()


@pytest.mark.parametrize("sender", PACKAGES)
def test_trpc_pipe_across_packages(sender):
    """A frame written by one package's TRPC rank is read by the other's."""
    send_pkg, recv_pkg = _load(sender), _load(PACKAGES[1 - PACKAGES.index(sender)])
    base = free_port_block(2)
    m0 = send_pkg.trpc.TensorRpcCommunicationManager(rank=0, size=2, port_base=base)
    m1 = recv_pkg.trpc.TensorRpcCommunicationManager(rank=1, size=2, port_base=base)
    got = []
    m1.add_observer(_Obs(m1, got))
    t = threading.Thread(target=m1.handle_receive_message, daemon=True)
    t.start()
    msg = send_pkg.Message(7, 0, 1)
    w = RNG.normal(size=(64, 8)).astype(np.float32)
    msg.add_params("payload", {"w": w, "n": [1, 2.5, "s", None]})
    m0.send_message(msg)
    t.join(timeout=30)
    assert got and got[0][0] == 7
    np.testing.assert_array_equal(got[0][1].get("payload")["w"], w)
    assert got[0][1].get("payload")["n"] == [1, 2.5, "s", None]
    m0.stop_receive_message()


# -- TestFaultInjectorUnit (tests/test_faults.py) -------------------------


def _recording(pkg):
    class Recording(pkg.base.BaseCommunicationManager):
        def __init__(self):
            self.sent = []
            self.observer = None

        def send_message(self, msg):
            self.sent.append(msg)

        def add_observer(self, o):
            self.observer = o

        def remove_observer(self, o):
            pass

        def handle_receive_message(self):
            pass

        def stop_receive_message(self):
            pass

    return Recording()


class TestFaultInjectorUnit:
    def test_drop_is_deterministic_and_counted(self, pkg):
        rec = _recording(pkg)
        fi = pkg.faults.FaultInjector(rec, drop_prob=0.5, seed=7)
        for _ in range(100):
            fi.send_message(pkg.Message(3, 1, 0))
        assert fi.injected["drop"] > 20
        assert len(rec.sent) + fi.injected["drop"] == 100
        rec2 = _recording(pkg)
        fi2 = pkg.faults.FaultInjector(rec2, drop_prob=0.5, seed=7)
        for _ in range(100):
            fi2.send_message(pkg.Message(3, 1, 0))
        assert fi2.injected == fi.injected
        assert pkg.Telemetry.get_instance().get_counter(
            "comm_faults_injected_total", fault="drop", msg_type=3) == 2 * fi.injected["drop"]

    def test_same_seed_same_pattern_in_both_packages(self, pkg):
        other = _load(PACKAGES[1 - PACKAGES.index(pkg.name)])
        pattern = []
        for p in (pkg, other):
            rec = _recording(p)
            fi = p.faults.FaultInjector(rec, drop_prob=0.3, duplicate_prob=0.2, seed=11)
            for i in range(50):
                m = p.Message(3, 1, 0)
                m.add_params("i", i)
                fi.send_message(m)
            pattern.append([m.get("i") for m in rec.sent])
        assert pattern[0] == pattern[1]

    def test_duplicate_sends_twice(self, pkg):
        rec = _recording(pkg)
        fi = pkg.faults.FaultInjector(rec, duplicate_prob=1.0, max_faults=1)
        fi.send_message(pkg.Message(3, 1, 0))
        fi.send_message(pkg.Message(3, 1, 0))  # max_faults reached -> clean send
        assert fi.injected["duplicate"] == 1
        assert len(rec.sent) == 3

    def test_msg_type_filter(self, pkg):
        rec = _recording(pkg)
        fi = pkg.faults.FaultInjector(rec, drop_prob=1.0, msg_types=[3])
        fi.send_message(pkg.Message(5, 1, 0))  # not armed
        fi.send_message(pkg.Message(3, 1, 0))  # dropped
        assert len(rec.sent) == 1 and fi.injected["drop"] == 1

    def test_control_signals_exempt_by_default(self, pkg):
        c = pkg.constants
        rec = _recording(pkg)
        fi = pkg.faults.FaultInjector(rec, drop_prob=1.0)
        fi.send_message(pkg.Message(c.MSG_TYPE_S2S_AGG_DEADLINE, 0, 0))
        fi.send_message(pkg.Message(c.MSG_TYPE_S2C_FINISH, 0, 1))
        assert len(rec.sent) == 2 and fi.injected["drop"] == 0
        fi2 = pkg.faults.FaultInjector(rec, drop_prob=1.0, msg_types=[c.MSG_TYPE_S2C_FINISH])
        fi2.send_message(pkg.Message(c.MSG_TYPE_S2C_FINISH, 0, 1))
        assert fi2.injected["drop"] == 1
        fi3 = pkg.faults.FaultInjector(rec, drop_prob=1.0,
                                       msg_types=[c.MSG_TYPE_S2S_AGG_DEADLINE])
        fi3.send_message(pkg.Message(c.MSG_TYPE_S2S_AGG_DEADLINE, 0, 0))
        assert fi3.injected["drop"] == 0

    def test_fired_delay_timers_are_released(self, pkg):
        rec = _recording(pkg)
        fi = pkg.faults.FaultInjector(rec, delay_prob=1.0, delay_s=0.01)
        for _ in range(20):
            fi.send_message(pkg.Message(3, 1, 0))
        deadline = time.monotonic() + 5.0
        while (len(rec.sent) < 20 or fi._timers) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(rec.sent) == 20
        assert fi._timers == []

    def test_delay_reorders(self, pkg):
        rec = _recording(pkg)
        fi = pkg.faults.FaultInjector(rec, delay_prob=1.0, delay_s=0.2, max_faults=1)
        fi.send_message(pkg.Message(3, 1, 0))  # delayed
        fi.send_message(pkg.Message(5, 1, 0))  # immediate
        assert [m.get_type() for m in rec.sent] == [5]
        deadline = time.monotonic() + 5.0
        while len(rec.sent) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert [m.get_type() for m in rec.sent] == [5, 3]

    def test_closed_injector_swallows_fired_delay_timer(self, pkg):
        rec = _recording(pkg)
        fi = pkg.faults.FaultInjector(rec, delay_prob=1.0, delay_s=0.05)
        fi.send_message(pkg.Message(3, 1, 0))
        fi.stop_receive_message()  # before the timer fires
        assert fi.closed
        time.sleep(0.2)
        assert rec.sent == []

    def test_wrap_validation_and_rank_mixed_seed(self, pkg):
        a = pkg.make_args()
        assert pkg.faults.maybe_wrap_faulty("com", a) == "com"  # no spec -> untouched
        a.fault_injection = {"drop_prob": 0.1, "bogus": 1}
        with pytest.raises(ValueError, match="bogus"):
            pkg.faults.maybe_wrap_faulty(_recording(pkg), a)
        a.fault_injection = {"drop_prob": 0.1, "seed": 3}
        a.rank = 2
        fi = pkg.faults.maybe_wrap_faulty(_recording(pkg), a)
        want = np.random.RandomState((3 + 0x9E3779B1 * 3) % 2**32).random_sample(4)
        np.testing.assert_array_equal(fi._rng.random_sample(4), want)
        a.fault_injection = [0.1]
        with pytest.raises(ValueError, match="must be a mapping of knobs, got list"):
            pkg.faults.maybe_wrap_faulty(_recording(pkg), a)

    def test_extras_pass_through(self, pkg):
        rec = _recording(pkg)
        rec.destroy_fabric = lambda: "destroyed"
        fi = pkg.faults.FaultInjector(rec)
        assert fi.destroy_fabric() == "destroyed"


# -- TestReliableChannelUnit / TestFailureDetectorUnit / TestRoundWAL /
# TestGrpcSendRetry (tests/test_robustness.py) ----------------------------


class _Sink:
    def __init__(self):
        self.got = []

    def receive_message(self, t, m):
        self.got.append((int(t), m))


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


class TestReliableChannelUnit:
    def test_tracked_send_attaches_seq_and_chan(self, pkg):
        rec = _recording(pkg)
        ch = pkg.reliable.ReliableChannel(rec, rank=1, retry_max=0, retry_base_s=60.0)
        ch.send_message(pkg.Message(3, 1, 0))
        m = rec.sent[0]
        assert m.get(pkg.constants.MSG_ARG_KEY_COMM_SEQ) == 1
        assert m.get(pkg.constants.MSG_ARG_KEY_COMM_CHAN) == ch.channel_id
        ch.stop_receive_message()

    def test_retransmits_then_gives_up(self, pkg):
        rec = _recording(pkg)
        ch = pkg.reliable.ReliableChannel(rec, rank=1, retry_max=2, retry_base_s=0.02)
        ch.send_message(pkg.Message(3, 1, 0))
        assert _wait(lambda: ch.stats["giveups"] == 1)
        assert len(rec.sent) == 3  # original + 2 retransmits
        assert ch.stats["retries"] == 2
        assert ch.pending_unacked() == 0
        tel = pkg.Telemetry.get_instance()
        assert tel.get_counter("comm_retries_total", msg_type=3) == 2
        assert tel.get_counter("comm_giveups_total", msg_type=3) == 1

    def test_ack_stops_retransmission(self, pkg):
        c = pkg.constants
        rec = _recording(pkg)
        ch = pkg.reliable.ReliableChannel(rec, rank=1, retry_max=5, retry_base_s=0.05)
        ch.add_observer(_Sink())
        out = pkg.Message(3, 1, 0)
        ch.send_message(out)
        ack = pkg.Message(c.MSG_TYPE_COMM_ACK, 0, 1)
        ack.add_params(c.MSG_ARG_KEY_COMM_ACK_SEQ, out.get(c.MSG_ARG_KEY_COMM_SEQ))
        ack.add_params(c.MSG_ARG_KEY_COMM_ACK_CHAN, out.get(c.MSG_ARG_KEY_COMM_CHAN))
        rec.observer.receive_message(ack.get_type(), ack)
        assert ch.pending_unacked() == 0
        time.sleep(0.3)
        assert len(rec.sent) == 1 and ch.stats["retries"] == 0

    def test_stale_incarnation_ack_ignored(self, pkg):
        c = pkg.constants
        rec = _recording(pkg)
        ch = pkg.reliable.ReliableChannel(rec, rank=1, retry_max=5, retry_base_s=60.0)
        ch.add_observer(_Sink())
        ch.send_message(pkg.Message(3, 1, 0))
        ack = pkg.Message(c.MSG_TYPE_COMM_ACK, 0, 1)
        ack.add_params(c.MSG_ARG_KEY_COMM_ACK_SEQ, 1)
        ack.add_params(c.MSG_ARG_KEY_COMM_ACK_CHAN, ch.channel_id ^ 1)
        rec.observer.receive_message(ack.get_type(), ack)
        assert ch.pending_unacked() == 1
        ch.stop_receive_message()

    def test_receive_dedup_and_ack(self, pkg):
        c = pkg.constants
        rec = _recording(pkg)
        ch = pkg.reliable.ReliableChannel(rec, rank=0, retry_max=5, retry_base_s=60.0)
        sink = _Sink()
        ch.add_observer(sink)
        inbound = pkg.Message(3, 1, 0)
        inbound.add_params(c.MSG_ARG_KEY_COMM_SEQ, 7)
        inbound.add_params(c.MSG_ARG_KEY_COMM_CHAN, 1234)
        ch._observer_wrappers[sink].receive_message(3, inbound)
        ch._observer_wrappers[sink].receive_message(3, inbound)  # duplicate
        assert len(sink.got) == 1 and ch.stats["dup_dropped"] == 1

        def acks():
            return [m for m in rec.sent if m.get_type() == c.MSG_TYPE_COMM_ACK]

        assert _wait(lambda: len(acks()) == 2)
        assert acks()[0].get(c.MSG_ARG_KEY_COMM_ACK_SEQ) == 7
        assert acks()[0].get(c.MSG_ARG_KEY_COMM_ACK_CHAN) == 1234
        ch.stop_receive_message()

    def test_dedup_memory_bounded_per_sender_incarnation(self, pkg):
        ch = pkg.reliable.ReliableChannel(_recording(pkg), rank=0)
        for chan in range(10):
            assert not ch._is_duplicate(1, chan, seq=1)
        assert len(ch._seen[1]) == pkg.reliable._MAX_INCARNATIONS
        assert ch._is_duplicate(1, 9, seq=1)
        assert not ch._is_duplicate(1, 0, seq=1)  # evicted: re-learned

    def test_untracked_types_bypass_the_protocol(self, pkg):
        c = pkg.constants
        rec = _recording(pkg)
        ch = pkg.reliable.ReliableChannel(rec, rank=1, retry_max=5, retry_base_s=60.0)
        sink = _Sink()
        ch.add_observer(sink)
        ch.send_message(pkg.Message(c.MSG_TYPE_C2S_HEARTBEAT, 1, 0))
        ch.send_message(pkg.Message(c.MSG_TYPE_S2S_AGG_DEADLINE, 1, 1))
        assert ch.pending_unacked() == 0
        for m in rec.sent:
            assert m.get(c.MSG_ARG_KEY_COMM_SEQ) is None
        ch._observer_wrappers[sink].receive_message(
            c.MSG_TYPE_C2S_HEARTBEAT, pkg.Message(c.MSG_TYPE_C2S_HEARTBEAT, 2, 1))
        assert len(sink.got) == 1
        time.sleep(0.1)
        assert all(m.get_type() != c.MSG_TYPE_COMM_ACK for m in rec.sent)

    def test_composes_with_fault_injector(self, pkg):
        rec = _recording(pkg)
        fi = pkg.faults.FaultInjector(rec, drop_prob=1.0, max_faults=1, msg_types=[3])
        ch = pkg.reliable.ReliableChannel(fi, rank=1, retry_max=4, retry_base_s=0.02)
        ch.send_message(pkg.Message(3, 1, 0))
        assert _wait(lambda: bool(rec.sent)), "retransmit never recovered the injected drop"
        assert fi.injected["drop"] == 1
        ch.stop_receive_message()

    def test_wrap_disabled_by_default_and_knobs(self, pkg):
        a = pkg.make_args()
        assert pkg.reliable.maybe_wrap_reliable("com", a) == "com"
        a.reliable_comm, a.comm_retry_max, a.comm_retry_base_s, a.rank = True, 3, 0.5, 2
        ch = pkg.reliable.maybe_wrap_reliable(_recording(pkg), a)
        assert isinstance(ch, pkg.reliable.ReliableChannel)
        assert ch.retry_max == 3 and ch.retry_base_s == 0.5
        assert "reliable_rank2" in pkg.Telemetry.get_instance().probes()

    def test_stop_cancels_pending_retransmits(self, pkg):
        rec = _recording(pkg)
        ch = pkg.reliable.ReliableChannel(rec, rank=1, retry_max=50, retry_base_s=0.02)
        ch.send_message(pkg.Message(3, 1, 0))
        ch.stop_receive_message()
        n = len(rec.sent)
        time.sleep(0.2)
        assert len(rec.sent) == n
        assert ch.closed and ch.pending_unacked() == 0


class TestFailureDetectorUnit:
    def test_silent_rank_declared_dead_once(self, pkg):
        dead = []
        fd = pkg.heartbeat.FailureDetector(0.15, dead.append).start()
        fd.watch(1)
        assert _wait(lambda: dead == [1], timeout=3.0)
        time.sleep(0.3)
        fd.stop()
        assert dead == [1]  # exactly once, then unwatched

    def test_traffic_defers_declaration(self, pkg):
        dead = []
        fd = pkg.heartbeat.FailureDetector(0.3, dead.append).start()
        fd.watch(1)
        for _ in range(4):
            time.sleep(0.1)
            fd.note_alive(1)
        assert dead == []
        assert fd.seen_recently(1)
        fd.stop()

    def test_seen_recently_is_per_rank(self, pkg):
        fd = pkg.heartbeat.FailureDetector(0.2, lambda r: None)
        fd.note_alive(1)
        assert fd.seen_recently(1)
        assert not fd.seen_recently(2)

    def test_emitter_beats_until_stopped(self, pkg):
        beats = []
        em = pkg.heartbeat.HeartbeatEmitter(lambda: beats.append(1), 0.02).start()
        assert _wait(lambda: len(beats) >= 3)
        em.stop()
        n = len(beats)
        time.sleep(0.1)
        assert len(beats) == n


class TestRoundWAL:
    def test_append_records_last(self, pkg, tmp_path):
        wal = pkg.checkpoint.RoundWAL(str(tmp_path))
        wal.append(0, 1, [1, 3, 2])
        wal.append(1, None, [1, 2])
        recs = wal.records()
        assert [r["round_idx"] for r in recs] == [0, 1]
        assert recs[0]["cohort"] == [1, 2, 3]
        assert recs[0]["ckpt_step"] == 1 and recs[1]["ckpt_step"] is None
        assert wal.last()["round_idx"] == 1

    def test_torn_final_line_tolerated(self, pkg, tmp_path):
        wal = pkg.checkpoint.RoundWAL(str(tmp_path))
        wal.append(0, 1, [1])
        with open(wal.path, "a") as f:
            f.write('{"round_idx": 1, "ckpt_')  # killed mid-append
        assert wal.last()["round_idx"] == 0
        wal2 = pkg.checkpoint.RoundWAL(str(tmp_path))
        wal2.append(1, 2, [1])
        assert wal2.last()["round_idx"] == 1
        assert [r["round_idx"] for r in wal2.records()] == [0, 1]

    def test_empty_wal(self, pkg, tmp_path):
        wal = pkg.checkpoint.RoundWAL(str(tmp_path))
        assert wal.records() == [] and wal.last() is None

    def test_folded_set_and_publish_records(self, pkg, tmp_path):
        wal = pkg.checkpoint.RoundWAL(str(tmp_path))
        wal.append(0, 1, [1, 2, 3], folded=[2, 1])
        wal.append(1, None, [1, 2], folded=[(1, 5), (2, 7)], kind="publish",
                   extra={"version": 1, "max_seq": 7, "folds_total": 2})
        recs = pkg.checkpoint.RoundWAL(str(tmp_path)).records()
        assert recs[0]["folded"] == [1, 2] and "kind" not in recs[0]
        assert recs[1]["kind"] == "publish"
        assert recs[1]["folded"] == [[1, 5], [2, 7]]
        assert recs[1]["max_seq"] == 7 and recs[1]["folds_total"] == 2

    def test_same_file_bytes_in_both_packages(self, tmp_path):
        from fedml_tpu.core.checkpoint import RoundWAL as JaxWAL
        from fedml_tpu_torch.core.checkpoint import RoundWAL

        paths = []
        for cls, sub in ((JaxWAL, "jax"), (RoundWAL, "port")):
            wal = cls(str(tmp_path / sub))
            wal.append(0, 1, [3, 1], folded=[1])
            wal.append(1, None, [1, 2], folded=[(2, 7)], kind="publish", extra={"v": 1})
            paths.append(wal.path)
        assert open(paths[0], "rb").read() == open(paths[1], "rb").read()

    def test_appends_go_through_the_io_seam(self, tmp_path):
        from fedml_tpu_torch.core import checkpoint as ckpt

        calls = []

        class Recording(ckpt.DurableIO):
            def wal_create(self, dir_path, path):
                calls.append("create")
                super().wal_create(dir_path, path)

            def wal_append(self, path, data, **ctx):
                calls.append(("append", ctx["round_idx"], ctx["kind"]))
                super().wal_append(path, data, **ctx)

        ckpt.install_io_seam(Recording())
        try:
            wal = ckpt.RoundWAL(str(tmp_path))
            wal.append(0, 1, [1])
            wal.append(1, 2, [1], kind="publish")
        finally:
            ckpt.reset_io_seam()
        assert calls == ["create", ("append", 0, None), ("append", 1, "publish")]


class TestGrpcSendRetry:
    def test_exhausted_retries_raise_typed_error_and_count(self, pkg):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        pkg.Telemetry.reset()
        com = pkg.grpc.GrpcCommunicationManager(rank=0, size=2, port_base=base,
                                                send_timeout_s=0.2, send_retries=1,
                                                retry_base_s=0.01)
        try:
            t0 = time.monotonic()
            with pytest.raises(pkg.base.CommSendError) as ei:
                com.send_message(pkg.Message(3, 0, 1))
            assert ei.value.receiver == 1 and ei.value.attempts == 2
            assert time.monotonic() - t0 < 5.0
            tel = pkg.Telemetry.get_instance()
            assert sum(tel.counters_matching("comm_send_errors_total").values()) == 1
            assert sum(tel.counters_matching("comm_transport_retries_total").values()) == 1
        finally:
            com.stop_receive_message()


def test_grpc_absent_raises_naming_the_package(monkeypatch):
    import builtins

    from fedml_tpu_torch.core.comm import grpc_backend

    real = builtins.__import__

    def no_grpc(name, *a, **kw):
        if name == "grpc":
            raise ImportError("No module named 'grpc'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_grpc)
    with pytest.raises(ImportError, match="grpcio"):
        grpc_backend.GrpcCommunicationManager(rank=0, size=1, port_base=free_port_block(1))


# -- TestTraceContext (tests/test_tracing.py) ----------------------------


def _msg(pkg, t=3, payload=None, sender=1, receiver=0):
    m = pkg.Message(t, sender, receiver)
    if payload is not None:
        m.add_params(pkg.constants.MSG_ARG_KEY_MODEL_PARAMS, payload)
    return m


class TestTraceContext:
    def test_stamp_assigns_unique_flow_and_trace_id(self, pkg):
        c, tr = pkg.constants, pkg.tracing
        tel = pkg.Telemetry.get_instance(pkg.make_args(run_id="ctx"))
        m1, m2 = _msg(pkg), _msg(pkg)
        f1, r1 = tr.stamp_context(m1, tel, rank=1)
        f2, r2 = tr.stamp_context(m2, tel, rank=1)
        assert f1 != f2 and not r1 and not r2
        assert m1.get(c.MSG_ARG_KEY_TRACE_ID) == "fedrun-ctx"
        assert m1.get(c.MSG_ARG_KEY_TRACE_FLOW) == f1
        assert f1 >> 40 == 2  # (rank + 1) in the high bits

    def test_restamp_is_resend_and_keeps_flow(self, pkg):
        tel = pkg.Telemetry.get_instance()
        m = _msg(pkg)
        f1, _ = pkg.tracing.stamp_context(m, tel, rank=1)
        f2, resend = pkg.tracing.stamp_context(m, tel, rank=1)
        assert f2 == f1 and resend is True

    def test_loopback_never_stamped(self, pkg):
        tel = pkg.Telemetry.get_instance()
        m = _msg(pkg, sender=0, receiver=0)
        flow, resend = pkg.tracing.stamp_context(m, tel, rank=0)
        assert flow is None and resend is False
        assert m.get(pkg.constants.MSG_ARG_KEY_TRACE_FLOW) is None

    def test_flow_ids_unique_across_ranks(self, pkg):
        tel = pkg.Telemetry.get_instance()
        f1, _ = pkg.tracing.stamp_context(_msg(pkg), tel, rank=1)
        f2, _ = pkg.tracing.stamp_context(_msg(pkg), tel, rank=2)
        assert f1 != f2

    def test_continue_context_links_parent(self, pkg):
        c = pkg.constants
        tel = pkg.Telemetry.get_instance()
        inbound = _msg(pkg, t=2, sender=0, receiver=1)
        flow, _ = pkg.tracing.stamp_context(inbound, tel, rank=0)
        out = _msg(pkg, t=3, sender=1, receiver=0)
        pkg.tracing.continue_context(inbound, out)
        assert out.get(c.MSG_ARG_KEY_TRACE_SPAN) == flow
        assert out.get(c.MSG_ARG_KEY_TRACE_ID) == inbound.get(c.MSG_ARG_KEY_TRACE_ID)

    def test_context_survives_wire_format(self, pkg):
        c = pkg.constants
        m = _msg(pkg, payload={"w": np.ones((4,), np.float32)})
        flow, _ = pkg.tracing.stamp_context(m, pkg.Telemetry.get_instance(), rank=3)
        back = pkg.Message.from_bytes(m.to_bytes())
        assert int(back.get(c.MSG_ARG_KEY_TRACE_FLOW)) == flow
        assert back.get(c.MSG_ARG_KEY_TRACE_ID) == m.get(c.MSG_ARG_KEY_TRACE_ID)

    def test_payload_nbytes_excludes_ctx(self, pkg):
        m = _msg(pkg, payload={"w": np.ones((8,), np.float32)})
        before = pkg.instrument.payload_nbytes(m)
        pkg.tracing.stamp_context(m, pkg.Telemetry.get_instance(), rank=0)
        assert pkg.instrument.payload_nbytes(m) == before

    def test_instrumented_send_and_receive_count_and_flow(self, pkg):
        tel = pkg.Telemetry.get_instance()
        rec = _recording(pkg)
        inst = pkg.instrument.InstrumentedCommunicationManager(rec, tel, rank=1)
        sink = _Sink()
        inst.add_observer(sink)
        m = _msg(pkg, payload={"w": np.ones((8,), np.float32)})
        inst.send_message(m)
        assert tel.get_counter("comm_messages_sent_total", msg_type=3) == 1
        assert tel.get_counter("comm_bytes_sent_total", msg_type=3) == \
            pkg.instrument.payload_nbytes(m)
        rec.observer.receive_message(3, rec.sent[0])
        assert tel.get_counter("comm_messages_received_total", msg_type=3) == 1
        phases = [(e["name"], e["ph"]) for e in tel.recorder.tail()]
        assert phases == [("comm.send", "B"), ("comm.msg", "s"), ("comm.send", "E"),
                          ("comm.recv", "B"), ("comm.msg", "f"), ("comm.recv", "E")]


# -- TestBroker / TestPayloadStore / TestMqttBackend (test_cross_device) ---


class TestBroker:
    def test_pub_sub_roundtrip(self, pkg):
        broker = pkg.broker.Broker()
        got = []
        done = threading.Event()
        a = pkg.broker.BrokerClient(broker.host, broker.port)
        b = pkg.broker.BrokerClient(broker.host, broker.port)
        a.subscribe("topic/x", lambda t, p: (got.append((t, p)), done.set()))
        time.sleep(0.05)
        b.publish("topic/x", b"hello")
        assert done.wait(5)
        assert got == [("topic/x", b"hello")]
        a.close(), b.close(), broker.stop()

    def test_no_cross_topic_leak(self, pkg):
        broker = pkg.broker.Broker()
        got = []
        done = threading.Event()
        a = pkg.broker.BrokerClient(broker.host, broker.port)
        a.subscribe("t1", lambda t, p: got.append(p))
        a.subscribe("t2", lambda t, p: (got.append(p), done.set()))
        time.sleep(0.05)
        b = pkg.broker.BrokerClient(broker.host, broker.port)
        b.publish("t3", b"nope")
        b.publish("t2", b"yes")
        assert done.wait(5)
        assert got == [b"yes"]
        a.close(), b.close(), broker.stop()

    def test_ensure_broker_binds_then_reuses(self, pkg):
        port = free_port_block(1)
        assert pkg.broker.ensure_broker("127.0.0.1", port) == ("127.0.0.1", port)
        assert pkg.broker.ensure_broker("127.0.0.1", port) == ("127.0.0.1", port)
        host, eph = pkg.broker.ensure_broker("127.0.0.1", 0)
        assert eph != 0


class TestPayloadStore:
    def test_roundtrip(self, pkg, tmp_path):
        store = pkg.store.FilePayloadStore(str(tmp_path))
        url = store.put(b"payload-bytes")
        assert url.startswith("file://")
        assert store.get(url) == b"payload-bytes"

    def test_params_bytes_roundtrip(self, pkg):
        tree = {"a": {"w": np.ones((3, 2), np.float32)}, "b": np.arange(4)}
        back = pkg.store.params_from_bytes(pkg.store.params_to_bytes(tree))
        np.testing.assert_array_equal(back["a"]["w"], tree["a"]["w"])
        np.testing.assert_array_equal(back["b"], tree["b"])

    def test_params_bytes_are_the_jax_packages(self):
        from fedml_tpu.core.comm.payload_store import params_to_bytes as jax_bytes
        from fedml_tpu_torch.core.comm.payload_store import params_to_bytes

        w = RNG.normal(size=(6, 5)).astype(np.float32)
        assert params_to_bytes({"w": torch.tensor(w), "n": 3}) == \
            jax_bytes({"w": jnp.asarray(w), "n": 3})


def _mqtt_pair(pkg, run_id, wrap=None, other=None):
    host, port = pkg.broker.broker_for_run(run_id)
    cls0 = pkg.mqtt.MqttCommunicationManager
    cls1 = (other or pkg).mqtt.MqttCommunicationManager
    m0 = cls0(rank=0, size=2, broker_host=host, broker_port=port, run_id=run_id)
    m1 = cls1(rank=1, size=2, broker_host=host, broker_port=port, run_id=run_id)
    if wrap:
        m0, m1 = wrap(m0), wrap(m1)
    return m0, m1


class _Capture:
    def __init__(self):
        self.messages = []
        self.event = threading.Event()

    def receive_message(self, msg_type, msg):
        self.messages.append((msg_type, msg))
        self.event.set()


class TestMqttBackend:
    def test_message_delivery(self, pkg):
        m0, m1 = _mqtt_pair(pkg, f"t_mqtt_1_{pkg.name}")
        cap = _Capture()
        m1.add_observer(cap)
        t = threading.Thread(target=m1.handle_receive_message, daemon=True)
        t.start()
        time.sleep(0.05)
        msg = pkg.Message(pkg.constants.MSG_TYPE_S2C_INIT_CONFIG, 0, 1)
        msg.add_params("k", np.arange(3))
        m0.send_message(msg)
        assert cap.event.wait(5)
        mt, got = cap.messages[0]
        assert mt == pkg.constants.MSG_TYPE_S2C_INIT_CONFIG
        np.testing.assert_array_equal(got.get("k"), np.arange(3))
        m1.stop_receive_message()
        t.join(5)

    def test_hybrid_swaps_payload_through_store(self, pkg, tmp_path):
        store = pkg.store.FilePayloadStore(str(tmp_path))
        m0, m1 = _mqtt_pair(pkg, f"t_mqtt_2_{pkg.name}",
                            wrap=lambda m: pkg.store.HybridCommunicationManager(m, store))
        cap = _Capture()
        m1.add_observer(cap)
        t = threading.Thread(target=m1.handle_receive_message, daemon=True)
        t.start()
        time.sleep(0.05)
        params = {"w": RNG.normal(size=(64, 8)).astype(np.float32)}
        c = pkg.constants
        msg = pkg.Message(c.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, 0, 1)
        msg.add_params(c.MSG_ARG_KEY_MODEL_PARAMS, params)
        m0.send_message(msg)
        assert cap.event.wait(5)
        _, got = cap.messages[0]
        np.testing.assert_array_equal(got.get(c.MSG_ARG_KEY_MODEL_PARAMS)["w"], params["w"])
        assert got.get(c.MSG_ARG_KEY_MODEL_PARAMS + "_url") is None
        m1.stop_receive_message()
        t.join(5)

    def test_topics_cross_packages(self, pkg):
        """A port rank and a JAX rank on one broker read each other."""
        other = _load(PACKAGES[1 - PACKAGES.index(pkg.name)])
        m0, m1 = _mqtt_pair(pkg, f"t_mqtt_x_{pkg.name}", other=other)
        cap = _Capture()
        m1.add_observer(cap)
        t = threading.Thread(target=m1.handle_receive_message, daemon=True)
        t.start()
        time.sleep(0.05)
        msg = pkg.Message(3, 0, 1)
        msg.add_params("w", {"a": np.arange(5, dtype=np.float32), "i": np.int64(4)})
        m0.send_message(msg)
        assert cap.event.wait(5)
        _, got = cap.messages[0]
        np.testing.assert_array_equal(got.get("w")["a"], np.arange(5, dtype=np.float32))
        assert got.get("w")["i"] == 4
        m1.stop_receive_message()
        t.join(5)


# -- the managers ---------------------------------------------------------


def test_manager_stack_wrap_order_and_local_roundtrip():
    from fedml_tpu_torch.core import managers
    from fedml_tpu_torch.core.comm.faults import FaultInjector
    from fedml_tpu_torch.core.comm.instrument import InstrumentedCommunicationManager
    from fedml_tpu_torch.core.comm.local import LocalCommunicationManager
    from fedml_tpu_torch.core.comm.reliable import ReliableChannel

    a = _load("fedml_tpu_torch").make_args(
        run_id="stack", reliable_comm=True, fault_injection={"drop_prob": 0.0})
    com = managers.build_comm_stack(a, rank=1, size=2, backend="LOCAL")
    assert isinstance(com, ReliableChannel)
    assert isinstance(com.inner, FaultInjector)
    assert isinstance(com.inner.inner, InstrumentedCommunicationManager)
    assert isinstance(com.inner.inner.inner, LocalCommunicationManager)
    for bad in ("BOGUS",):
        with pytest.raises(ValueError, match="unsupported comm backend"):
            managers._build_com_manager(a, 0, 1, bad)

    # a server and a client manager over LOCAL: a tensor crosses by reference
    got = []

    class Server(managers.ServerManager):
        def register_message_receive_handlers(self):
            self.register_message_receive_handler(3, lambda m: (got.append(m), self.finish()))

    b = _load("fedml_tpu_torch").make_args(run_id="mgr")
    server = Server(b, rank=0, size=2, backend="LOCAL")
    client = managers.ClientManager(b, rank=1, size=2, backend="LOCAL")
    t = threading.Thread(target=server.run, daemon=True)
    t.start()
    w = torch.arange(6.0)
    m = PortMessage(3, 1, 0)
    m.add_params("w", w)
    client.send_message(m)
    t.join(10)
    assert not t.is_alive() and got[0].get("w") is w


def test_load_ip_config(tmp_path):
    from fedml_tpu.core.managers import _load_ip_config as jax_load
    from fedml_tpu_torch.core.managers import _load_ip_config

    p = tmp_path / "ips.csv"
    p.write_text("receiver_id,ip\n0,10.0.0.1\n1, 10.0.0.2\n\n")
    assert _load_ip_config(str(p)) == jax_load(str(p)) == {0: "10.0.0.1", 1: "10.0.0.2"}
