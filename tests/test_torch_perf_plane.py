"""The performance-attribution plane of the port (``analysis/perf.py``),
its device peak tables (``constants.py``) and the round series it joins
(``simulation/fedavg_api.py``, ``core/round_pipeline.py``), each held
against the JAX package on the same inputs.

- ``parse_series_key``, ``attribute_idle``, ``summarize_ledger``,
  ``join_roofline`` and ``run_ratchet`` on the planted inputs of
  ``tests/test_perf_plane.py``: equal results, but for the port's
  ``seconds_clock`` (its seconds are host wall time) and its tool name;
- either package's ``perf`` on the artifacts either package's
  cross-silo world exported: the same roofline rows and ledger;
- the CLI's exit codes 0, 1 and 2;
- the peak tables on a list of device kinds: the same answers, but for
  the card's row, which the JAX table lacks;
- the round series (C1, C2): a mesh run tags its rounds
  ``simulation.round_fn_mesh`` and a sequential run tags none, as the
  JAX runs do.

No test here reads ``<root>/audit_report.json``: every audit report is
planted under ``tmp_path``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import pytest

import fedml_tpu
import torch_world
from fedml_tpu import constants as jax_constants
from fedml_tpu.analysis import perf as jax_perf
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu_torch import cli as port_cli
from fedml_tpu_torch import constants
from fedml_tpu_torch.analysis import perf
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": perf, "jax": jax_perf}


# -- parse_series_key, attribute_idle, summarize_ledger ---------------------

@pytest.mark.parametrize("key", [
    "exec_device_seconds{bucket=b8,executable=simulation.round_fn}",
    "exec_device_seconds{executable=agg.fold_tree}",
    "round_wall_seconds",
    "round_idle_seconds{gap=arrival_to_aggregate}",
])
def test_parse_series_key_is_the_references(key):
    assert perf.parse_series_key(key) == jax_perf.parse_series_key(key)


@pytest.mark.parametrize("timeline", [
    dict(now=104.0, bcast_t0=100.0, last_arrival=103.0, aggregate_s=0.5, prev_close=99.0),
    dict(now=10.0, bcast_t0=9.0, last_arrival=9.5, aggregate_s=0.1),
    dict(now=10.0, bcast_t0=9.0, last_arrival=9.99, aggregate_s=5.0, prev_close=9.5),
])
def test_attribute_idle_is_the_references(timeline):
    got = perf.attribute_idle(**timeline)
    assert got == jax_perf.attribute_idle(**timeline)
    assert all(v >= 0.0 for v in got.values())


LEDGERS = [
    [{"round": 0, "wall_s": 2.0,
      "segments": {"broadcast_send": 0.2, "wait": 1.0, "aggregate": 0.3},
      "idle": {"arrival_to_aggregate": 0.5}, "wire_utilization_frac": 0.6},
     {"round": 1, "wall_s": 1.0,
      "segments": {"broadcast_send": 0.1, "wait": 0.5, "aggregate": 0.2},
      "idle": {"arrival_to_aggregate": 0.2, "close_to_broadcast": 10.0},
      "wire_utilization_frac": 0.4}],
    [{"round": 0, "wall_s": 2.0, "segments": {"aggregate": 0.5},
      "idle": {"arrival_to_aggregate": 0.5}}],
]


@pytest.mark.parametrize("ledgers", LEDGERS)
def test_summarize_ledger_is_the_references(ledgers):
    assert perf.summarize_ledger(ledgers) == jax_perf.summarize_ledger(ledgers)


# -- the roofline join ---------------------------------------------------------

# tests/test_perf_plane.py's planted report: 1000 calls x 2e9 FLOPs in
# 2.0 s is 1e12 FLOP/s
_AUDIT = {
    "version": 1,
    "platform": "tpu",
    "executables": [
        {"executable": "simulation.round_fn", "case": "b8", "round_shaped": True,
         "hot": True, "flops": 2.0e9, "bytes_accessed": 1.0e9},
        {"executable": "simulation.round_fn", "case": "b32", "round_shaped": True,
         "hot": True, "flops": 8.0e9, "bytes_accessed": 2.0e9},
        {"executable": "agg.weighted_term", "case": None, "round_shaped": False,
         "hot": False, "flops": 36.0, "bytes_accessed": 72.0},
    ],
}

MEASURED = {
    "exact": {("simulation.round_fn", "b8"): {"count": 1000.0, "sum": 2.0, "min": 0.001,
                                              "max": 0.01}},
    "bucket": {("simulation.round_fn", "b32"): {"count": 10.0, "sum": 1.0, "min": 0.1,
                                                "max": 0.1}},
    "unknown": {("simulation.round_fn", "b8"): {"count": 1.0, "sum": 3.0, "min": 3.0,
                                                "max": 3.0},
                ("not.in.audit", ""): {"count": 1.0, "sum": 1.0, "min": 1.0, "max": 1.0}},
    "fallback": {("simulation.round_fn", "b64"): {"count": 2.0, "sum": 0.5, "min": 0.2,
                                                  "max": 0.3},
                 ("agg.weighted_term", ""): {"count": 4.0, "sum": 0.01, "min": 0.001,
                                             "max": 0.005}},
}


@pytest.mark.parametrize("kind", ["TPU v5 lite", "cpu"])
@pytest.mark.parametrize("case", sorted(MEASURED))
def test_join_roofline_is_the_references(case, kind):
    """The rows equal the JAX rows key by key; the roofline's one extra
    key is ``seconds_clock``."""
    got = perf.join_roofline(_AUDIT, MEASURED[case], kind)
    want = jax_perf.join_roofline(_AUDIT, MEASURED[case], kind)
    assert got.pop("seconds_clock") == "host wall clock around the call"
    assert got == want
    assert [sorted(r) for r in got["rows"]] == [sorted(r) for r in want["rows"]]


def test_join_roofline_on_the_card_has_an_mfu():
    """The card's row: 1e12 FLOP/s against its 989 TFLOP/s bf16 peak,
    memory-bound at an intensity of 2 against a ridge of 989 / 3.35."""
    roof = perf.join_roofline(_AUDIT, MEASURED["exact"], "NVIDIA H100 80GB HBM3")
    row = roof["rows"][0]
    assert roof["peak_bf16_flops"] == 989e12 and roof["hbm_bytes_per_sec"] == 3.35e12
    assert row["mfu_vs_bf16_peak"] == round(1e12 / 989e12, 6)
    assert row["bound"] == "memory"
    assert roof["ridge_flops_per_byte"] == round(989 / 3.35, 2)


# -- the ratchet ---------------------------------------------------------------


def _bench_file(tmp_path, name, phase, kind, smoke, value, unit="rounds/s",
                omit_meta=False, crashed=False):
    """tests/test_perf_plane.py's planted BENCH record."""
    rec = {"n": 1, "cmd": "bench", "rc": 0}
    if crashed:
        rec["parsed"] = None
    elif omit_meta:
        rec["parsed"] = {"metric": phase, "value": value, "unit": unit, "detail": {}}
    else:
        rec["parsed"] = {
            "metric": phase, "value": value, "unit": unit, "detail": {},
            "meta": {"schema": 1, "phase": phase, "device_kind": kind,
                     "backend": "cpu" if kind == "cpu" else "tpu", "smoke": smoke,
                     "value": value, "metric": phase, "unit": unit},
        }
    path = tmp_path / name
    path.write_text(json.dumps(rec))
    return str(path)


RATCHETS = {
    "regression": [("BENCH_r01.json", "headline", "TPU v5 lite", False, 1.14, {}),
                   ("BENCH_r02.json", "headline", "TPU v5 lite", False, 0.50, {})],
    "jitter_and_gain": [("BENCH_r01.json", "headline", "TPU v5 lite", False, 1.00, {}),
                        ("BENCH_r02.json", "headline", "TPU v5 lite", False, 0.95, {}),
                        ("BENCH_r03.json", "headline", "TPU v5 lite", False, 1.30, {})],
    "smoke_apart": [("BENCH_r01.json", "headline", "TPU v5 lite", False, 1.14, {}),
                    ("BENCH_r02.json", "headline", "cpu", True, 0.05, {})],
    "missing_meta": [("BENCH_r01.json", "headline", "cpu", False, 1.0, {}),
                     ("BENCH_r02.json", "headline", "cpu", False, 1.0, {"omit_meta": True})],
    "crashed": [("BENCH_r01.json", "headline", "cpu", False, 1.0, {"crashed": True}),
                ("BENCH_r02.json", "headline", "cpu", False, 1.0, {})],
    "latency": [("BENCH_r01.json", "serving", "cpu", False, 10.0, {"unit": "p99_ms"}),
                ("BENCH_r02.json", "serving", "cpu", False, 20.0, {"unit": "p99_ms"})],
}


def _without_tool(report: dict) -> dict:
    return {k: v for k, v in report.items() if k != "tool"}


@pytest.mark.parametrize("case", sorted(RATCHETS))
def test_run_ratchet_is_the_references(case, tmp_path):
    paths = [_bench_file(tmp_path, name, phase, kind, smoke, value, **kw)
             for name, phase, kind, smoke, value, kw in RATCHETS[case]]
    got, want = perf.run_ratchet(paths), jax_perf.run_ratchet(paths)
    assert got["tool"] == "fedml-tpu-torch perf --ratchet"
    assert _without_tool(got) == _without_tool(want)
    expect_ok = case not in ("regression", "missing_meta", "latency")
    assert got["ok"] is expect_ok


def test_the_repo_bench_records_ratchet_as_in_jax():
    """The repo's BENCH_*.json: 3 groups, no regression, BENCH_r01.json
    skipped as a crashed record; the same report as the JAX package's."""
    paths = sorted(glob.glob(os.path.join(REPO, "BENCH_*.json")))
    got, want = perf.run_ratchet(paths), jax_perf.run_ratchet(paths)
    assert _without_tool(got) == _without_tool(want)
    assert got["ok"] is True and got["regressions"] == 0 and got["violations"] == []
    assert len(got["groups"]) == 3
    assert {g["device_kind"] for g in got["groups"]} == {"TPU v5 lite", "cpu"}
    assert [s.split(":")[0] for s in got["skipped"]] == [os.path.join(REPO, "BENCH_r01.json")]


# -- the CLI ---------------------------------------------------------------------


def _synth_run_dir(path, extra_series=None):
    """tests/test_perf_plane.py's minimal run directory: one snapshot of a
    round series and two ledgered rounds."""
    os.makedirs(path, exist_ok=True)
    hists = {"exec_device_seconds{bucket=b8,executable=simulation.round_fn}":
             {"count": 4, "sum": 2.0, "min": 0.4, "max": 0.6}}
    hists.update(extra_series or {})
    with open(os.path.join(path, "telemetry.jsonl"), "w") as fh:
        fh.write(json.dumps({"kind": "telemetry_snapshot", "run_id": "t", "rank": 0,
                             "histograms": hists}) + "\n")
    events = [{"name": "round.ledger", "ph": "i", "ts": 1.0, "pid": 1,
               "args": {"round": r, "wall_s": 1.0,
                        "segments": {"broadcast_send": 0.2, "wait": 0.5, "aggregate": 0.2},
                        "idle": {"arrival_to_aggregate": 0.1},
                        "wire_utilization_frac": 0.5}} for r in range(2)]
    with open(os.path.join(path, "trace.json"), "w") as fh:
        json.dump({"traceEvents": events, "otherData": {}}, fh)
    return str(path)


def _planted_audit(tmp_path) -> str:
    path = tmp_path / "planted_audit.json"
    path.write_text(json.dumps(_AUDIT))
    return str(path)


def _ns(**kw):
    ns = argparse.Namespace(
        telemetry_dir=None, audit_report=None, device_kind=None, n_chips=1,
        min_coverage=perf.DEFAULT_MIN_COVERAGE, ratchet=None,
        tolerance=perf.DEFAULT_TOLERANCE, out=None, root=REPO, quiet=True)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def _cli_cases(tmp_path):
    """(name, namespace kwargs, expected exit code) of the JAX CLI's
    contract, every audit report planted under tmp_path."""
    audit = _planted_audit(tmp_path)
    good = _synth_run_dir(str(tmp_path / "good"))
    rogue = _synth_run_dir(str(tmp_path / "rogue"), {
        "exec_device_seconds{executable=rogue.exec}":
        {"count": 1, "sum": 98.0, "min": 98.0, "max": 98.0}})
    reg = [_bench_file(tmp_path, n, "headline", "TPU v5 lite", False, v)
           for n, v in (("BENCH_r01.json", 1.14), ("BENCH_r02.json", 0.5))]
    green = [_bench_file(tmp_path, "BENCH_r03.json", "x", "cpu", False, 1.0)]
    bad = [_bench_file(tmp_path, "BENCH_r04.json", "x", "cpu", False, 1.0, omit_meta=True)]
    return [
        ("report", dict(telemetry_dir=good, audit_report=audit, device_kind="TPU v5 lite",
                        out=str(tmp_path / "good.json")), 0),
        ("low_coverage", dict(telemetry_dir=rogue, audit_report=audit,
                              device_kind="TPU v5 lite", out=str(tmp_path / "rogue.json")), 1),
        ("no_mode", {}, 2),
        ("missing_dir", dict(telemetry_dir=str(tmp_path / "nope")), 2),
        ("missing_audit", dict(telemetry_dir=good,
                               audit_report=str(tmp_path / "no_audit.json")), 2),
        ("ratchet_green", dict(ratchet=green), 0),
        ("ratchet_regression", dict(ratchet=reg), 1),
        ("ratchet_violation", dict(ratchet=bad), 2),
    ]


def test_cli_exit_codes_are_the_references(tmp_path, capsys):
    for name, kw, code in _cli_cases(tmp_path):
        for reader, mod in PACKAGES.items():
            mine = dict(kw, out=kw["out"].replace(".json", f"_{reader}.json")) if kw.get(
                "out") else kw
            assert mod.run_cli(_ns(**mine)) == code, (name, reader)
    capsys.readouterr()
    # the report mode's files: the same roofline (but seconds_clock) and ledger
    port = json.load(open(tmp_path / "good_port.json"))
    want = json.load(open(tmp_path / "good_jax.json"))
    assert port["roofline"].pop("seconds_clock") == perf.SECONDS_CLOCK
    assert port["roofline"] == want["roofline"] and port["ledger"] == want["ledger"]
    assert all(r["recon_frac"] >= 0.95 for r in port["ledger"]["rounds"])


def test_cli_subcommands_parse_and_refuse_as_the_jax_cli(tmp_path, capsys):
    """`perf` without a mode exits 2; `audit --ci --update-baseline`
    exits 2; an unknown flag is a SystemExit (argparse)."""
    assert port_cli.main(["perf"]) == 2
    assert port_cli.main(["audit", "--ci", "--update-baseline"]) == 2
    for argv in (["perf", "--bogus"], ["audit", "--bogus"]):
        with pytest.raises(SystemExit):
            port_cli.main(argv)
    ns = port_cli.build_parser().parse_args(["perf", "--ratchet", "x.json"])
    assert ns.ratchet == ["x.json"] and callable(ns.fn)
    capsys.readouterr()


# -- either package's perf on either package's cross-silo artifacts -----------

CS_KNOBS = dict(training_type="cross_silo", dataset="mnist", synthetic_train_size=400,
                synthetic_test_size=80, model="lr", partition_method="hetero",
                client_num_in_total=4, client_num_per_round=4, comm_round=3, epochs=1,
                batch_size=16, learning_rate=0.1, frequency_of_the_test=1, shuffle=False)


def _port_cross_silo(telemetry_dir: str) -> None:
    from fedml_tpu_torch.core.chaos import reset_chaos
    from fedml_tpu_torch.core.telemetry import Telemetry
    from test_torch_cross_silo import run_world

    Telemetry.reset()
    reset_chaos()
    try:
        run_world("perf_port", telemetry_dir=telemetry_dir)
    finally:
        Telemetry.reset()
        reset_chaos()


def _jax_cross_silo(telemetry_dir: str) -> None:
    from fedml_tpu.core.chaos import reset_chaos
    from fedml_tpu.core.telemetry import Telemetry
    from test_torch_cross_silo import _jax_world

    Telemetry.reset()
    reset_chaos()
    try:
        _jax_world(dict(CS_KNOBS, telemetry_dir=telemetry_dir), "perf_jax", 4)
    finally:
        Telemetry.reset()
        reset_chaos()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_perf_reads_the_other_packages_cross_silo_run(writer, tmp_path, capsys):
    d = str(tmp_path / writer)
    (_port_cross_silo if writer == "port" else _jax_cross_silo)(d)
    audit = _planted_audit(tmp_path)
    reports = {}
    for reader, mod in PACKAGES.items():
        out = str(tmp_path / f"{reader}.json")
        rc = mod.run_cli(_ns(telemetry_dir=d, audit_report=audit, device_kind="TPU v5 lite",
                             out=out, min_coverage=0.0))
        assert rc == 0, reader
        reports[reader] = json.load(open(out))
    capsys.readouterr()
    port, jax_ = reports["port"], reports["jax"]
    assert port["roofline"].pop("seconds_clock") == perf.SECONDS_CLOCK
    assert port["roofline"] == jax_["roofline"]
    assert port["ledger"] == jax_["ledger"]
    rounds = port["ledger"]["rounds"]
    assert len(rounds) == CS_KNOBS["comm_round"]
    # the JAX tests' bar: each round's ledger accounts for its wall within 5%
    assert all(abs(r["recon_frac"] - 1.0) <= 0.05 for r in rounds), rounds


# -- the device peak tables ----------------------------------------------------

KINDS = [*jax_constants.PEAK_BF16_TFLOPS, "TPU v5 lite0", "TPU v4i", "TFRT_CPU_0", "cpu",
         "Cpu0", "", "Some GPU 7", "NVIDIA H100 80GB HBM3", "NVIDIA H100 80GB HBM30"]


@pytest.mark.parametrize("kind", KINDS)
def test_peak_tables_answer_as_the_references(kind):
    got = (constants.normalize_device_kind(kind), constants.peak_bf16_flops(kind),
           constants.hbm_bandwidth_bytes(kind))
    want = (jax_constants.normalize_device_kind(kind), jax_constants.peak_bf16_flops(kind),
            jax_constants.hbm_bandwidth_bytes(kind))
    if kind.startswith("NVIDIA H100 80GB HBM3"):
        # the card's row, which the JAX table lacks (it answers 0 there)
        assert got == ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12)
        assert want[0] == kind and want[1:] == (0.0, 0.0)
    else:
        assert got == want


def test_the_tpu_rows_are_the_references_and_the_card_adds_one():
    for ours, theirs in ((constants.PEAK_BF16_TFLOPS, jax_constants.PEAK_BF16_TFLOPS),
                         (constants.HBM_BANDWIDTH_TBPS, jax_constants.HBM_BANDWIDTH_TBPS)):
        assert {k: v for k, v in ours.items() if k in theirs} == theirs
        assert set(ours) - set(theirs) == {"NVIDIA H100 80GB HBM3"}


def test_chip_smoke_reads_its_denominators_from_the_table():
    import torch

    import chip_smoke

    assert chip_smoke.HBM_BYTES_PER_S == constants.hbm_bandwidth_bytes(chip_smoke.H100_KIND)
    assert chip_smoke.PEAK_FLOPS[torch.bfloat16] == constants.peak_bf16_flops(
        chip_smoke.H100_KIND) == 989e12


# -- the round series (C1, C2) --------------------------------------------------

SERIES_KNOBS = dict(dataset="femnist", model="lr", synthetic_train_size=320,
                    synthetic_test_size=80, client_num_in_total=8, client_num_per_round=4,
                    comm_round=2, epochs=1, batch_size=10, learning_rate=0.05,
                    frequency_of_the_test=1, log_metrics=False)


@pytest.fixture
def threefry_restored():
    """The JAX package's init flips ``jax_threefry_partitionable`` for a
    fed mesh; put it back for the rest of the worker's tests."""
    import jax

    before = jax.config.jax_threefry_partitionable
    yield
    jax.config.update("jax_threefry_partitionable", before)


def _jax_series(knobs: dict, mesh: bool) -> dict:
    """The JAX package's run of ``knobs`` (on its fed mesh, or in one
    process); the exec_device_seconds series of its snapshot."""
    from fedml_tpu import data as jax_data
    from fedml_tpu import models as jax_models
    from fedml_tpu.core.telemetry import Telemetry
    from fedml_tpu.simulation import SimulatorMesh, SimulatorSingleProcess

    a = JaxArguments()
    for k, v in knobs.items():
        setattr(a, k, v)
    a._validate()
    args = fedml_tpu.init(a)
    Telemetry.reset()
    try:
        ds = jax_data.load(args)
        model = jax_models.create(args, ds.class_num)
        sim = (SimulatorMesh(args, None, ds, model) if mesh
               else SimulatorSingleProcess(args, None, ds, model))
        sim.run()
        return torch_world.exec_series(Telemetry.get_instance().snapshot()["histograms"])
    finally:
        Telemetry.reset()


def _port_series(knobs: dict) -> dict:
    """The port's one-process run of ``knobs``, in this process."""
    from fedml_tpu_torch.core.telemetry import Telemetry

    Telemetry.reset()
    try:
        torch_world._mesh_one({"args": knobs, "single": True})
        return torch_world.exec_series(Telemetry.get_instance().snapshot()["histograms"])
    finally:
        Telemetry.reset()


def _round_series(series: dict) -> dict:
    return {k: v for k, v in series.items() if k.startswith("simulation.round_fn")}


@pytest.mark.parametrize("depth", [1, 2])
def test_mesh_rounds_are_tagged_round_fn_mesh_as_in_jax(depth, threefry_restored, tmp_path):
    """C1: a FEMNIST-shaped LR run on the fed mesh at world size 1 (the
    port's SimMesh {data: 1, fsdp: 1} in a gloo world of one, the JAX
    package's 1x1 fed mesh), synchronous and with 2 rounds in flight:
    the same exec_device_seconds series, buckets and counts."""
    knobs = dict(SERIES_KNOBS, mesh_shape={"data": 1, "fsdp": 1}, pipeline_depth=depth)
    want = _jax_series(knobs, mesh=True)
    (got,) = torch_world.run_world(torch_world.devtime_series, 1,
                                   {"runs": [{"args": knobs}]}, tmp_path, 90)[0]
    assert _round_series(want) == {"simulation.round_fn_mesh|b4": 2}
    assert got == want


@pytest.mark.parametrize("mode", ["sequential", "vectorized"])
def test_only_the_vectorized_round_is_measured_as_in_jax(mode):
    """C2: a sequential run leaves no round series (a sequential round is
    a loop of executables); a vectorized run leaves the same ones as the
    JAX run."""
    knobs = dict(SERIES_KNOBS, sim_mode=mode)
    want, got = _jax_series(knobs, mesh=False), _port_series(knobs)
    assert got == want
    assert _round_series(got) == ({} if mode == "sequential"
                                  else {"simulation.round_fn|b4": 2})


def test_the_round_series_are_tagged_by_one_function():
    """Both dispatch sites (the synchronous loop and the round pipeline)
    read the API's own name for its round, as the JAX package's do."""
    import inspect

    from fedml_tpu_torch.core import round_pipeline
    from fedml_tpu_torch.simulation import fedavg_api

    assert '"simulation.round_fn"' not in inspect.getsource(round_pipeline)
    src = inspect.getsource(fedavg_api.FedAvgAPI._sync_round)
    assert "self._round_exec_name()" in src and '"simulation.round_fn"' not in src


def test_server_attribute_idle_is_the_perf_planes():
    """The cross-silo server keeps no copy of the idle arithmetic."""
    from fedml_tpu_torch.cross_silo.horizontal import fedml_server_manager

    assert not hasattr(fedml_server_manager, "attribute_idle")
    src = open(fedml_server_manager.__file__).read()
    assert "from ...analysis.perf import attribute_idle" in src


def test_perf_imports_no_torch():
    """perf.py stays stdlib: a fresh interpreter importing it alone (with
    the package's __init__ stubbed out) loads no torch."""
    import subprocess
    import sys

    code = (
        "import importlib.util, sys, types\n"
        f"root = {REPO!r}\n"
        "pkg = types.ModuleType('fedml_tpu_torch'); pkg.__path__ = [root + '/fedml_tpu_torch']\n"
        "sys.modules['fedml_tpu_torch'] = pkg\n"
        "an = types.ModuleType('fedml_tpu_torch.analysis')\n"
        "an.__path__ = [root + '/fedml_tpu_torch/analysis']\n"
        "sys.modules['fedml_tpu_torch.analysis'] = an\n"
        "import fedml_tpu_torch.analysis.perf, fedml_tpu_torch.analysis.audit\n"
        "print(sorted(m for m in ('torch', 'numpy', 'jax') if m in sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=60)
    assert out.stdout.strip() == "[]"

