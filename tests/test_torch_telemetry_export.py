"""The port's run-artifact exporters (``fedml_tpu_torch/core/telemetry.py``,
``core/sys_stats.py``, ``core/tracking.py``) against the JAX package's.

- the same sequence of ``inc`` / ``set_gauge`` / ``observe`` / spans on
  both registries gives the same Prometheus text, byte for byte, and the
  same snapshot record (heartbeat ages aside, which are clock readings);
- ``trace.json`` keeps matched B/E pairs after the ring overflows, with
  the same events and meta as the JAX package's export of the same
  sequence;
- ``export_run_artifacts`` writes the same files, rank-suffixed above
  rank 0, with one snapshot appended to ``telemetry.jsonl``, and never
  raises on an IO error;
- the stall watchdog's bundle on an induced stall carries the JAX
  bundle's keys, and a run that keeps beating writes none;
- a ``/metrics`` scrape on loopback returns the registry's text;
- the ``sys_*`` keys are the JAX package's (host stats, and the device
  keys with the card's memory, read through a stand-in of the CUDA
  allocator here, where there is no card);
- ``MetricsReporter``'s sinks, ``RunLogger`` and ``device_trace``.

Tolerance: none; every comparison is exact (strings and dicts).
"""

from __future__ import annotations

import json
import os
import time
import types
import urllib.error
import urllib.request

import pytest

from fedml_tpu.core import sys_stats as jax_sys
from fedml_tpu.core import telemetry as jax_tel
from fedml_tpu_torch.core import sys_stats as port_sys
from fedml_tpu_torch.core import telemetry as port_tel

PKGS = {"jax": jax_tel, "port": port_tel}


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    port_tel.Telemetry.reset()
    yield
    port_tel.Telemetry.reset()


def _args(**kw):
    base = dict(run_id='run "7"', rank=2, role="client", telemetry=True,
                trace_ring_size=64)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _drive(tel):
    """One fixed sequence of every instrument kind."""
    tel.inc("comm_messages_sent_total", msg_type=3)
    tel.inc("comm_messages_sent_total", 2, msg_type=3)
    tel.inc("agg_folds_total", 4, mode="async")
    tel.inc("plain_total")
    tel.set_gauge("pipeline_depth", 2)
    tel.set_gauge("defense_quarantined_now", 1, rank=5)
    for v in (0.002, 0.04, 0.7, 3.0):
        tel.observe("serving_latency_seconds", v, buckets=(0.01, 0.1, 1.0))
    for v in (1.5, 0.25):
        tel.observe("round_wall_seconds", v, phase="train")
    tel.recorder.begin("round", cat="span", round=0)
    tel.recorder.instant("pipeline.dispatch", cat="pipeline", round=0)
    tel.recorder.counter("inflight", 3)
    tel.recorder.end("round", cat="span", round=0)
    tel.heartbeat("pipeline.round", 0)


def _snap(tel):
    snap = tel.snapshot()
    snap["heartbeats"] = {k: v["value"] for k, v in snap["heartbeats"].items()}
    return snap


def test_same_sequence_same_prometheus_text_and_snapshot():
    tels = {name: m.Telemetry(_args()) for name, m in PKGS.items()}
    for tel in tels.values():
        _drive(tel)
    assert tels["port"].prometheus_text() == tels["jax"].prometheus_text()
    assert _snap(tels["port"]) == _snap(tels["jax"])
    text = tels["port"].prometheus_text()
    # the quote in run_id is escaped, the histogram carries its buckets
    assert 'run_id="run \\"7\\""' in text
    assert "# TYPE serving_latency_seconds histogram" in text
    assert "# TYPE round_wall_seconds summary" in text


def test_ring_overflow_keeps_matched_pairs_like_the_reference(tmp_path):
    """A ring of 8 events fed 9 nested spans: the export drops the E
    events whose B fell off, force-closes what is still open, and counts
    the drops; the port writes what the JAX package writes."""
    out = {}
    for name, m in PKGS.items():
        rec = m.FlightRecorder(capacity=8)
        for i in range(9):
            rec.begin(f"span{i % 3}", round=i)
            if i % 2:
                rec.end(f"span{i % 3}", round=i)
        rec.instant("tail")
        path = rec.export(str(tmp_path / name / "trace.json"), meta={"rank": 0})
        payload = json.load(open(path))
        out[name] = payload
        depth = {}
        for ev in payload["traceEvents"]:
            key = (ev["tid"], ev["name"])
            if ev["ph"] == "B":
                depth[key] = depth.get(key, 0) + 1
            elif ev["ph"] == "E":
                assert depth.get(key, 0) > 0, ev  # never an orphan E
                depth[key] -= 1
        assert all(d == 0 for d in depth.values())
        ts = [ev["ts"] for ev in payload["traceEvents"]]
        assert ts == sorted(ts)
        assert not os.path.exists(path + ".tmp")

    def shape(payload):
        return [(e["ph"], e["name"], e.get("args")) for e in payload["traceEvents"]]

    assert shape(out["port"]) == shape(out["jax"])
    for key in ("events_dropped", "ring_capacity", "rank"):
        assert out["port"]["otherData"][key] == out["jax"]["otherData"][key]
    assert out["port"]["otherData"]["events_dropped"] == 6
    assert set(out["port"]["otherData"]) == set(out["jax"]["otherData"])


def test_resize_counts_a_shrink_as_drops():
    for m in PKGS.values():
        rec = m.FlightRecorder(capacity=10)
        for i in range(6):
            rec.instant(f"e{i}")
        rec.resize(4)
        assert len(rec) == 4 and rec.dropped == 2 and rec.capacity == 4


@pytest.mark.parametrize("rank", [0, 3])
def test_export_run_artifacts_matches_the_reference(tmp_path, rank):
    files = {}
    for name, m in PKGS.items():
        tel = m.Telemetry(_args(rank=rank, run_id="r1"))
        _drive(tel)
        d = tmp_path / name
        assert tel.export_run_artifacts(str(d)) == str(d)
        tel.export_run_artifacts(str(d))  # a second export appends one more snapshot
        files[name] = sorted(os.listdir(d))
        suffix = "" if rank == 0 else f"_rank{rank}"
        assert files[name] == sorted([f"trace{suffix}.json", f"metrics{suffix}.prom",
                                      "telemetry.jsonl"])
        prom = (d / f"metrics{suffix}.prom").read_text()
        # the sys_* gauges are clock and load readings; the rest is exact
        files[name + "_prom"] = "\n".join(
            line for line in prom.splitlines() if "sys_" not in line)
        lines = (d / "telemetry.jsonl").read_text().splitlines()
        assert len(lines) == 2
        rec = json.loads(lines[-1])
        assert rec["kind"] == "telemetry_snapshot" and rec["rank"] == rank
        files[name + "_keys"] = sorted(rec)
        files[name + "_counters"] = rec["counters"]
    assert files["port"] == files["jax"]
    assert files["port_prom"] == files["jax_prom"]
    assert files["port_keys"] == files["jax_keys"]
    assert files["port_counters"] == files["jax_counters"]


def test_export_never_raises_and_is_off_without_a_dir(tmp_path):
    tel = port_tel.Telemetry(_args())
    assert tel.export_run_artifacts(None) is None
    blocker = tmp_path / "file"
    blocker.write_text("x")  # a file where the directory should be
    assert tel.export_run_artifacts(str(blocker / "sub")) is None
    tel.enabled = False
    assert tel.export_run_artifacts(str(tmp_path / "off")) is None
    assert not (tmp_path / "off").exists()


def test_trace_drops_reach_the_counter_in_every_exposition():
    for m in PKGS.values():
        tel = m.Telemetry(_args(trace_ring_size=4))
        for i in range(7):
            tel.recorder.instant(f"e{i}")
        assert tel.snapshot()["counters"]["telemetry_trace_dropped_total"] == 3.0
        assert "telemetry_trace_dropped_total{" in tel.prometheus_text()


def _bundle(m, tmp_path, beat: bool):
    tel = m.Telemetry(_args(rank=0))
    tel.add_probe("queue_depth", lambda: 7)
    tel.add_probe("broken", lambda: 1 / 0)
    tel.heartbeat("pipeline.round", 0)
    dog = m.StallWatchdog(tel, 0.3, str(tmp_path), poll_s=0.05).start()
    try:
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not dog.bundles:
            if beat:
                tel.heartbeat("pipeline.round", 1)
                if time.monotonic() > deadline - 4.0:
                    break
            time.sleep(0.02)
    finally:
        dog.stop()
    return tel, dog


def test_watchdog_bundle_on_an_induced_stall(tmp_path):
    bundles = {}
    for name, m in PKGS.items():
        tel, dog = _bundle(m, tmp_path / name, beat=False)
        assert len(dog.bundles) == 1, name
        assert os.path.basename(dog.bundles[0]) == "stall_bundle_001.json"
        b = json.load(open(dog.bundles[0]))
        assert b["kind"] == "stall_bundle" and b["reason"].startswith("no heartbeat for")
        assert b["probes"]["queue_depth"] == 7
        assert b["probes"]["broken"].startswith("probe failed: ZeroDivisionError")
        assert tel.get_counter("telemetry_stall_bundles_total") == 1.0
        bundles[name] = b
    assert sorted(bundles["port"]) == sorted(bundles["jax"])
    assert sorted(bundles["port"]["heartbeats"]) == sorted(bundles["jax"]["heartbeats"])


def test_a_run_that_keeps_beating_writes_no_bundle(tmp_path):
    _tel, dog = _bundle(port_tel, tmp_path, beat=True)
    assert dog.bundles == [] and not list(tmp_path.glob("stall_bundle_*"))


def test_watchdog_and_server_follow_the_knobs():
    tel = port_tel.Telemetry(_args())
    assert tel.maybe_start_watchdog(_args(stall_timeout_s=0)) is None
    assert tel.maybe_start_metrics_server(_args(metrics_port=0)) is None
    dog = tel.maybe_start_watchdog(_args(stall_timeout_s=30, telemetry_dir=None))
    try:
        assert dog.alive() and tel.maybe_start_watchdog(_args(stall_timeout_s=30)) is dog
    finally:
        tel.stop_watchdog()
    assert tel._watchdog is None


def test_metrics_scrape_on_loopback():
    tel = port_tel.Telemetry(_args())
    _drive(tel)
    srv = port_tel.MetricsServer(tel, 0).start()
    try:
        assert srv._httpd.server_address[0] == "127.0.0.1"
        url = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(url + "/metrics", timeout=5) as resp:
            body = resp.read().decode()
            assert resp.headers["Content-Type"].startswith("text/plain; version=0.0.4")
        assert body == tel.prometheus_text()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "/nope", timeout=5)
        assert e.value.code == 404
    finally:
        srv.stop()
    assert not srv.alive()


def test_a_busy_port_is_logged_and_the_run_goes_on():
    tel = port_tel.Telemetry(_args())
    first = port_tel.MetricsServer(tel, 0).start()
    try:
        other = port_tel.Telemetry(_args())
        assert other.maybe_start_metrics_server(_args(metrics_port=first.port)) is None
    finally:
        first.stop()


def test_host_stats_keys_are_the_references():
    assert set(port_sys.sample_host_stats()) == set(jax_sys.sample_host_stats())


def test_device_stats_keys_are_the_references(monkeypatch):
    """On the CPU the port samples no device; on a card (stood in for
    here by the allocator's readings) it reports the JAX package's keys
    for that card, which the export turns into the same ``sys_*``
    gauges."""
    import jax
    import torch

    assert port_sys.sample_device_stats() == {}
    assert port_sys.sample_device_stats("cpu") == {}
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (30, 80))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: 11)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda i: 13)
    port = port_sys.sample_device_stats("cuda:1")
    assert port == {"device1_bytes_in_use": 11, "device1_peak_bytes": 13,
                    "device1_bytes_limit": 80}

    class _Dev:
        def memory_stats(self):
            return {"bytes_in_use": 11, "peak_bytes_in_use": 13, "bytes_limit": 80}

    monkeypatch.setattr(jax, "local_devices", lambda: [_Dev(), _Dev()])
    ref = jax_sys.sample_device_stats()
    assert {k for k in ref if k.startswith("device1_")} == set(port)
    gauges = {}
    for name, m in PKGS.items():
        tel = m.Telemetry(_args())
        tel.set_system_gauges({**port, "note": "text is skipped"})
        gauges[name] = tel.snapshot()["gauges"]
    assert gauges["port"] == gauges["jax"] == {f"sys_{k}": float(v) for k, v in port.items()}


def test_sys_stats_sampler_streams_into_gauges():
    from fedml_tpu_torch.core.tracking import MetricsReporter

    rep = MetricsReporter(types.SimpleNamespace(log_metrics=False))
    tel = port_tel.Telemetry(_args())
    s = port_sys.SysStats(rep, interval_s=0.05, telemetry=tel, device="cpu").start()
    try:
        deadline = time.monotonic() + 5
        while not rep.history and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        s.stop()
    assert rep.history[0]["kind"] == "sys_stats"
    assert "sys_cpu_util_pct" in tel.snapshot()["gauges"]


def test_reporter_sinks_history_and_the_failing_sink(tmp_path):
    from fedml_tpu.core.tracking import MetricsReporter as JaxReporter
    from fedml_tpu_torch.core.tracking import MetricsReporter

    got = {}
    for name, cls in (("jax", JaxReporter), ("port", MetricsReporter)):
        path = tmp_path / name / "m.jsonl"
        rep = cls(types.SimpleNamespace(log_metrics=False, metrics_jsonl_path=None))
        rep.add_jsonl_sink(str(path))
        seen = []
        rep.add_sink(seen.append)
        rep.add_sink(lambda rec: 1 / 0)  # logged, never raised
        rep.report_server_training_metric({"round": 1})
        rep.report_client_training_metric({"round": 1, "rank": 2})
        recs = [json.loads(line) for line in path.read_text().splitlines()]
        got[name] = [{k: v for k, v in r.items() if k != "ts"} for r in recs]
        assert [r["kind"] for r in seen] == ["server_train", "client_train"]
        assert len(rep.history) == 2
    assert got["port"] == got["jax"]
    quiet = MetricsReporter(None, keep_history=False)
    quiet.report({"kind": "x"})
    assert quiet.history == []


def test_telemetry_sinks_publish_snapshots(tmp_path):
    tel = port_tel.Telemetry(_args())
    seen = []
    tel.add_sink(seen.append)
    tel.add_jsonl_sink(str(tmp_path / "snap.jsonl"))
    _drive(tel)
    snap = tel.publish_snapshot()
    assert seen[0]["counters"] == snap["counters"]
    rec = json.loads((tmp_path / "snap.jsonl").read_text())
    assert rec["kind"] == "telemetry_snapshot"


def test_open_spans_and_pending_deferred_reach_the_bundle():
    import torch

    from fedml_tpu_torch.core.tracking import DeferredMetrics, ProfilerEvent

    tel = port_tel.Telemetry(_args())
    prof = ProfilerEvent()
    tel.attach_profiler(prof)
    prof.log_event_started("aggregate")
    ring = DeferredMetrics()
    ring.push(0, {"loss": torch.ones(())})
    tel.attach_deferred(ring)
    assert [s["name"] for s in tel.open_spans()] == ["aggregate"]
    assert tel.pending_deferred() == 1
    prof.log_event_ended("aggregate")
    assert tel.open_spans() == []


def test_run_logger_chunks_and_files(tmp_path):
    from fedml_tpu_torch.core.tracking import RunLogger

    RunLogger.reset()
    log = RunLogger.get_instance(types.SimpleNamespace(run_id="r9", rank=1))
    chunks = []
    log.set_uploader(chunks.append)
    for i in range(RunLogger.CHUNK_LINES + 5):
        log.upload_line(f"line {i}")
    log.flush()
    assert [len(c) for c in chunks] == [RunLogger.CHUNK_LINES, 5]
    log.init_logs(str(tmp_path))
    import logging

    logging.info("hello")
    for h in logging.getLogger().handlers:
        h.flush()
    assert "hello" in (tmp_path / "run_r9_rank_1.log").read_text()
    logging.basicConfig(force=True)
    RunLogger.reset()


def test_device_trace_captures_a_run_when_asked(tmp_path):
    import torch

    from fedml_tpu_torch.core.tracking import device_trace

    with device_trace(types.SimpleNamespace(profile_dir=None), "cpu") as t:
        assert t._prof is None
    with device_trace(types.SimpleNamespace(profile_dir=str(tmp_path)), "cpu"):
        torch.ones(4).sum()
    trace = json.load(open(tmp_path / "trace.json"))
    assert trace["traceEvents"]
