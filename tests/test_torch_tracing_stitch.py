"""The port's trace stitcher and round analyzer (``fedml_tpu_torch/core/
tracing.py``: ``stitch_shards``, ``flow_match_stats``, ``analyze_rounds``,
``trace_run``; ``cli trace``) against the JAX package's.

Shards are written by each package's own flight recorder and comm
instrumentation: a server and two clients, each a ``Telemetry`` of its
own (one "process" each) joined by a synchronous in-process wire, two
rounds of broadcast -> train -> upload -> aggregate, the clients' clocks
skewed. Each package's stitcher and analyzer then read both packages'
shards: the port's results equal the JAX package's on the JAX-written
shards and the other way round, and ``cli trace``'s JSON line is the
same from both CLIs.

Tolerance: none; merged traces, reports and summaries compare exactly
(the stitcher's arithmetic is the same float operations in the same
order).
"""

from __future__ import annotations

import json
import os

import pytest

import fedml_tpu.core.tracing as jax_tracing
import fedml_tpu_torch.core.tracing as port_tracing
from fedml_tpu import constants as jax_constants
from fedml_tpu.core.comm import base as jax_base
from fedml_tpu.core.comm import instrument as jax_instrument
from fedml_tpu.core.message import Message as JaxMessage
from fedml_tpu.core.telemetry import Telemetry as JaxTelemetry
from fedml_tpu_torch import constants as port_constants
from fedml_tpu_torch.core.comm import base as port_base
from fedml_tpu_torch.core.comm import instrument as port_instrument
from fedml_tpu_torch.core.message import Message as PortMessage
from fedml_tpu_torch.core.telemetry import Telemetry as PortTelemetry

PKGS = {
    "jax": (JaxTelemetry, JaxMessage, jax_base, jax_instrument, jax_constants),
    "port": (PortTelemetry, PortMessage, port_base, port_instrument, port_constants),
}
TRACING = {"jax": jax_tracing, "port": port_tracing}
SKEWS_S = {1: 0.25, 2: -0.4}


def _bridge_classes(base):
    class Bridge(base.BaseCommunicationManager):
        """Synchronous wire: a send delivers straight into the addressed
        peer's observers."""

        def __init__(self, peers):
            self.peers, self.observers = peers, []

        def send_message(self, msg):
            for o in list(self.peers[int(msg.get_receiver_id())].observers):
                o.receive_message(msg.get_type(), msg)

        def add_observer(self, o):
            self.observers.append(o)

        def remove_observer(self, o):
            self.observers.remove(o)

        def handle_receive_message(self):
            pass

        def stop_receive_message(self):
            pass

    class Null(base.Observer):
        def receive_message(self, t, m):
            pass

    return Bridge, Null


def write_shards(pkg: str, out_dir: str, rounds: int = 2) -> str:
    """Three 'processes' of ``pkg`` (server 0, clients 1 and 2) over a
    synchronous wire, ``rounds`` rounds; each exports its shard."""
    Telemetry, Message, base, instrument, constants = PKGS[pkg]
    Bridge, Null = _bridge_classes(base)
    peers = {}
    tels, comms = {}, {}
    for r in range(3):
        tel = Telemetry()
        tel.rank = r
        tels[r] = tel
        peers[r] = Bridge(peers)
        comms[r] = instrument.InstrumentedCommunicationManager(peers[r], tel, rank=r)
        comms[r].add_observer(Null())

    def msg(t, s, d, rnd):
        m = Message(t, s, d)
        m.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, rnd)
        return m

    for rnd in range(rounds):
        for c in (1, 2):
            kind = (constants.MSG_TYPE_S2C_INIT_CONFIG if rnd == 0
                    else constants.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT)
            comms[0].send_message(msg(kind, 0, c, rnd))
        for c in (2, 1):  # client 1 reports last: the straggler
            rec = tels[c].recorder
            rec.begin("train", round=rnd, rank=c)
            rec.end("train", round=rnd, rank=c)
            comms[c].send_message(msg(constants.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, c, 0, rnd))
        tels[0].recorder.begin("aggregate", round=rnd)
        tels[0].recorder.end("aggregate", round=rnd)
    for r, tel in tels.items():
        tel.recorder.wall_t0 += SKEWS_S.get(r, 0.0)
        name = "trace.json" if r == 0 else f"trace_rank{r}.json"
        tel.recorder.export(os.path.join(out_dir, name), meta={"rank": r})
    return out_dir


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    return {pkg: write_shards(pkg, str(tmp_path_factory.mktemp(pkg))) for pkg in PKGS}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stitch_equals_the_reference_on_both_packages_shards(shards, writer):
    got = {pkg: TRACING[pkg].stitch_shards(shards[writer]) for pkg in TRACING}
    assert got["port"] == got["jax"]
    merged = got["port"]
    assert merged["otherData"]["ranks"] == [0, 1, 2]
    # the skew estimate recovers each client's step (the wire is synchronous)
    for r, skew in SKEWS_S.items():
        assert abs(merged["otherData"]["skew_us"][str(r)] - skew * 1e6) < 0.05e6
    names = {e["args"]["name"] for e in merged["traceEvents"] if e.get("ph") == "M"}
    assert names == {"rank0 (server)", "rank1", "rank2"}
    assert (port_tracing.flow_match_stats(merged["traceEvents"])
            == jax_tracing.flow_match_stats(merged["traceEvents"]))
    assert port_tracing.flow_match_stats(merged["traceEvents"])["matched"] == 8


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_analyze_rounds_equals_the_reference(shards, writer):
    events = jax_tracing.stitch_shards(shards[writer])["traceEvents"]
    got = {pkg: TRACING[pkg].analyze_rounds(events) for pkg in TRACING}
    assert got["port"] == got["jax"]
    assert [r["round"] for r in got["port"]] == [0, 1]
    for r in got["port"]:
        assert r["straggler_rank"] == 1 and r["cohort"] == [1, 2]
        assert set(r["segments_s"]) >= {"broadcast_send", "client_compute", "aggregate"}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trace_run_equals_the_reference(shards, writer, tmp_path):
    outs, reports = {}, {}
    for pkg, mod in TRACING.items():
        out = mod.trace_run(shards[writer], out_dir=str(tmp_path / pkg))
        reports[pkg] = json.load(open(out["round_report"]))
        merged = json.load(open(out["merged_trace"]))
        reports[pkg + "_merged"] = merged
        out = {k: v for k, v in out.items() if k not in ("merged_trace", "round_report")}
        outs[pkg] = out
    assert outs["port"] == outs["jax"]
    assert outs["port"]["rounds_analyzed"] == 2 and outs["port"]["shards"] == [
        "trace.json", "trace_rank1.json", "trace_rank2.json"]
    assert reports["port"] == reports["jax"]
    assert reports["port_merged"] == reports["jax_merged"]


def test_the_stitcher_skips_its_own_output_and_refuses_an_empty_dir(shards, tmp_path):
    port_tracing.trace_run(shards["port"], out_dir=shards["port"])
    again = port_tracing.stitch_shards(shards["port"])
    assert port_tracing.MERGED_TRACE_BASENAME not in again["otherData"]["shards"]
    with pytest.raises(FileNotFoundError, match="no trace shards"):
        port_tracing.stitch_shards(str(tmp_path))


def _span(name, ts, dur, pid=1, tid=1, **args):
    return [
        {"name": name, "ph": "B", "ts": ts, "pid": pid, "tid": tid, "cat": "x", "args": args},
        {"name": name, "ph": "E", "ts": ts + dur, "pid": pid, "tid": tid, "cat": "x"},
    ]


def _hier_round():
    """One hand-built edge-tier round: uploads land at an edge, the edge
    exports its limb set (edge_merge) and the root merges it (root_fold)."""
    evs = []
    evs += _span("comm.send", 0, 50, pid=1, msg_type=2, round=0, sender=0, receiver=1, flow=11)
    evs += _span("comm.recv", 300, 50, pid=2, msg_type=2, round=0, sender=0, flow=11)
    evs += _span("train", 400, 4000, pid=2, round=0, rank=1)
    evs += _span("comm.send", 4500, 100, pid=2, msg_type=3, round=0, sender=1, receiver=0,
                 flow=21)
    evs += _span("comm.recv", 4700, 100, pid=1, msg_type=3, round=0, sender=1, flow=21)
    evs += _span("edge_merge", 4800, 300, pid=3, round=0)
    evs += _span("root_fold", 5200, 200, pid=1, round=0)
    evs += _span("root_fold", 5450, 100, pid=1, round=0)
    evs += _span("aggregate", 5600, 400, pid=1, round=0)
    return evs


@pytest.mark.parametrize("case", ["hierarchical", "incomplete", "retry_duplicate"])
def test_analyzer_units_equal_the_reference(case):
    if case == "hierarchical":
        evs = _hier_round()
    elif case == "incomplete":
        evs = _span("comm.send", 0, 10, pid=1, msg_type=2, round=0, sender=0, receiver=1,
                    flow=1)
    else:
        evs = _hier_round()
        evs += _span("comm.send", 7000, 10, pid=2, msg_type=3, round=0, sender=1,
                     receiver=0, flow=21, retry=True)
        evs += _span("comm.recv", 8000, 10, pid=1, msg_type=3, round=0, sender=1, flow=21)
    got = {pkg: TRACING[pkg].analyze_rounds(evs) for pkg in TRACING}
    assert got["port"] == got["jax"]
    if case == "incomplete":
        assert got["port"] == []
    else:
        seg = got["port"][0]["segments_s"]
        assert seg["edge_merge"] == pytest.approx(300e-6)
        assert seg["root_fold"] == pytest.approx(300e-6)
        assert got["port"][0]["coverage"] == pytest.approx(1.0)


def test_cli_trace_json_line_equals_the_reference(shards, tmp_path, capsys):
    from fedml_tpu.cli import main as jax_main
    from fedml_tpu_torch.cli import main as port_main

    lines = {}
    for pkg, main in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / pkg
        assert main(["trace", "--telemetry-dir", shards["jax"], "--out", str(out),
                     "--summary"]) == 0
        captured = capsys.readouterr()
        line = json.loads(captured.out.strip().splitlines()[-1])
        line["merged_trace"] = os.path.basename(line["merged_trace"])
        line["round_report"] = os.path.basename(line["round_report"])
        lines[pkg] = line
        assert "straggler=rank1" in captured.err
    assert lines["port"] == lines["jax"]
    assert port_main(["trace", "--telemetry-dir", str(tmp_path / "missing")]) == 2
