"""Elastic preemption in the port (``fedml_tpu_torch/parallel/elastic.py``,
the round loops' preemption seam, ``MeshModelEndpoint.remesh(devices=)``)
against the JAX package's.

- ``make_signal`` and the four signals, errors word for word (the
  metadata server stood in for by a monkeypatched ``urlopen``: no
  network);
- ``surviving_mesh``'s floor, and a mesh over a subset of a world's ranks;
- limb travel across a reshape, raw and int8-encoded, bitwise the
  unsplit fold;
- a gloo world of 8 ranks preempted at round 1 and resumed on a world of
  4 (the linear model): bitwise the uninterrupted port run, within 1e-5
  (``tests/test_mesh_simulator.py``'s tolerance) of the JAX
  ``SimulatorMesh`` preempted and resumed 8 -> 4 on forced CPU devices,
  the WAL reading ``preempt``, ``resume`` and the checker ``ok``;
- the pipeline's drain at ``pipeline_depth`` 2, the cadence-saved round
  that skips the second save, a notice with no checkpointer, a notice
  only one rank can see, the registry loop's preempt and resume;
- the serving endpoint and fleet re-meshed onto surviving ranks answer
  bitwise as before.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
import torch_world
from fedml_tpu.parallel import elastic as jax_elastic
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.core.checkpoint import RoundWAL
from fedml_tpu_torch.core.invariants import InvariantChecker
from fedml_tpu_torch.parallel import elastic
from fedml_tpu_torch.parallel.elastic import (
    ChaosPreemption,
    FilePreemption,
    MetadataPreemption,
    Preempted,
    PreemptionNotice,
    SimulatedPreemption,
    make_signal,
)
from test_torch_mesh_simulator import BASE, jax_mesh_world
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5  # tests/test_mesh_simulator.py's


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    from fedml_tpu_torch.core.chaos import reset_chaos
    from fedml_tpu_torch.core.telemetry import Telemetry

    Telemetry.reset()
    reset_chaos()
    yield
    Telemetry.reset()
    reset_chaos()


# -- the signals --------------------------------------------------------------

@pytest.mark.parametrize("spec, cls", [
    (None, None), ("", None), ("none", None), ("  NONE ", None),
    ("round:2", SimulatedPreemption), ("file:/tmp/drain-me", FilePreemption),
    ("metadata", MetadataPreemption), ("chaos", ChaosPreemption),
])
def test_make_signal_parses_as_the_reference(spec, cls):
    sig, ref = make_signal(spec), jax_elastic.make_signal(spec)
    if cls is None:
        assert sig is None and ref is None
        return
    assert isinstance(sig, cls) and type(ref).__name__ == cls.__name__
    assert sig.describe() == ref.describe()
    passthrough = SimulatedPreemption(3)
    assert make_signal(passthrough) is passthrough


@pytest.mark.parametrize("bad", ["round:", "round:x", "round:-1", "file:", "frobnicate"])
def test_bad_specs_are_loud_in_the_references_words(bad):
    with pytest.raises(ValueError) as want:
        jax_elastic.make_signal(bad)
    with pytest.raises(ValueError) as got:
        make_signal(bad)
    assert str(got.value) == str(want.value)


def test_simulated_and_file_signals(tmp_path):
    sig = SimulatedPreemption(2, reason="drill")
    assert sig.poll(0) is None and sig.poll(1) is None
    n = sig.poll(2)
    assert n.reason == "drill" and n.detail == {"at_round": 2, "round": 2}
    assert sig.poll(3) is not None
    flag = tmp_path / "drain"
    fs = FilePreemption(str(flag))
    assert fs.poll(0) is None
    flag.write_text("")
    n = fs.poll(1)
    assert n.reason == "preempt-file" and n.detail == {"path": str(flag), "round": 1}


def test_metadata_signal_reads_the_event_and_no_server_as_none(monkeypatch):
    import io
    import urllib.error
    import urllib.request

    seen = []

    def answer(body):
        def urlopen(req, timeout):
            seen.append((req.full_url, req.get_header("Metadata-flavor"), timeout))
            return io.BytesIO(body)
        return urlopen

    monkeypatch.setattr(urllib.request, "urlopen", answer(b"NONE\n"))
    assert MetadataPreemption(timeout_s=0.2).poll(0) is None
    monkeypatch.setattr(urllib.request, "urlopen", answer(b"TERMINATE_ON_HOST_MAINTENANCE"))
    n = MetadataPreemption().poll(4)
    assert n.reason == "maintenance-event"
    assert n.detail == {"event": "TERMINATE_ON_HOST_MAINTENANCE", "round": 4}
    assert seen[0] == (MetadataPreemption.URL, "Google", 0.2)
    assert MetadataPreemption.URL == jax_elastic.MetadataPreemption.URL

    def unreachable(req, timeout):
        raise urllib.error.URLError("no route")

    monkeypatch.setattr(urllib.request, "urlopen", unreachable)
    assert MetadataPreemption().poll(0) is None


def test_chaos_signal_bridges_the_schedule():
    from fedml_tpu_torch.core.chaos import ChaosSchedule, install_chaos

    assert ChaosPreemption().poll(0) is None  # no schedule: no notice
    install_chaos(ChaosSchedule([
        {"at": {"event": "elastic.check", "round": 1}, "fault": "device.loss"}]))
    sig = ChaosPreemption()
    assert sig.poll(0) is None
    n = sig.poll(1)
    assert n.reason == "device.loss" and n.detail["chaos_fault"]["kind"] == "device.loss"


def test_the_knobs_validate_in_the_references_words(tmp_path):
    from tests.conftest import make_args

    def both(**kw):
        out = []
        for build in (make_args, _port_args):
            try:
                a = build(**kw)
                out.append(("ok", a.preempt_signal, a.elastic_min_devices))
            except ValueError as e:
                out.append(("err", str(e)))
        return out

    for kw in (dict(preempt_signal="round:2"),
               dict(preempt_signal="round:2", checkpoint_dir=str(tmp_path)),
               dict(preempt_signal="frobnicate", checkpoint_dir=str(tmp_path)),
               dict(elastic_min_devices="4"), dict(elastic_min_devices=None),
               dict(elastic_min_devices=0), dict(elastic_min_devices="four"),
               dict(stall_timeout_s=-1), dict(metrics_port=70000), dict(trace_ring_size=0)):
        port, ref = both(**kw)
        assert port == ref, kw


def _port_args(**kw):
    a = Arguments()
    for k, v in kw.items():
        setattr(a, k, v)
    a._validate()
    return a


# -- the mesh over survivors and the limbs ------------------------------------

def test_surviving_mesh_refuses_below_the_floor():
    with pytest.raises(RuntimeError) as got:
        elastic.surviving_mesh(devices=[0, 1], mesh_shape={"data": 2}, min_devices=4)
    assert "2 surviving devices < elastic_min_devices=4" in str(got.value)


def _trees(n, seed=0):
    rs = np.random.RandomState(seed)
    return [{"Dense_0/weight": rs.standard_normal((6, 16)).astype(np.float32),
             "Dense_0/bias": rs.standard_normal(6).astype(np.float32)} for _ in range(n)]


@pytest.mark.parametrize("int8, shape", [(False, {"data": 1, "fsdp": 2}),
                                         (True, {"data": 2, "fsdp": 1})])
def test_limbs_travel_bitwise_across_the_reshape(int8, shape, tmp_path):
    """Uploads 0-1 folded on a world of 4, the limbs exported, reshaped
    onto survivors ranks 0 and 2 and folded on with uploads 2-3 there:
    bitwise the unsplit fold (raw: the survivors at fsdp 2, each holding
    half the kernel; int8: every upload an encoded delta, one term launch
    and one fold each)."""
    trees = _trees(5, seed=3)
    payload = {"trees": trees[:4], "base": trees[4], "ws": [3.0, 1.0, 5.0, 2.0],
               "ranks": [0, 2], "shape": shape, "int8": int8}
    out = torch_world.run_world(torch_world.limb_travel, 4, payload, tmp_path, 90)
    assert [o["member"] for o in out] == [True, False, True, False]
    assert out[1]["ranks"] == [0, 2] and out[1]["full_ranks"] == [0, 1, 2, 3]
    for o in (out[0], out[2]):
        assert o["count"] == 4 and o["total_w"] == o["ref_total_w"] == 11.0
        for k in o["ref"]:
            np.testing.assert_array_equal(o["got"][k], o["ref"][k], err_msg=k)
    want = (6, 8) if shape["fsdp"] == 2 else (6, 16)
    assert out[0]["local_shapes"]["Dense_0/weight"] == want


def test_reshape_limb_state_passes_through_without_a_fed_mesh():
    state = {"limbs": _trees(3), "total_w": 1.0, "count": 1}
    assert elastic.reshape_limb_state(state, None) is state


# -- preempt on 8, resume on 4 ------------------------------------------------

KNOBS = dict(BASE, synthetic_train_size=320, synthetic_test_size=80, comm_round=3,
             frequency_of_the_test=10**9)


def _jax_drill(tmp_path):
    """The JAX package's drill (``tests/test_elastic_mesh.py``): preempted
    at round 1 on 8 forced CPU devices, resumed on 4; its packed
    federation, start params and end params."""
    from fedml_tpu import models as jax_models
    from fedml_tpu.data import load as jax_load
    from fedml_tpu.parallel.layout import build_fed_mesh
    from fedml_tpu.simulation import SimulatorMesh
    from test_torch_mesh_simulator import _set
    from fedml_tpu.arguments import Arguments as JaxArguments

    ck = str(tmp_path / "jax_ck")

    def world(shape, devices=None, **kw):
        args = fedml_tpu.init(_set(JaxArguments(), **dict(KNOBS, mesh_shape=shape, **kw)))
        ds = jax_load(args)
        mesh = build_fed_mesh(devices=devices, mesh_shape=shape) if devices else None
        return SimulatorMesh(args, None, ds, jax_models.create(args, ds.class_num), mesh=mesh)

    sim = world({"data": 8, "fsdp": 1}, checkpoint_dir=ck)
    sim.fl_trainer._preempt_signal = jax_elastic.SimulatedPreemption(at_round=1)
    with pytest.raises(jax_elastic.Preempted):
        sim.run()
    sim = world({"data": 4, "fsdp": 1}, devices=jax.devices()[:4], checkpoint_dir=ck)
    sim.run()
    from fedml_tpu_torch.convert import params_from_flax

    end = params_from_flax(jax.tree.map(np.asarray, sim.fl_trainer.global_params))
    return {k: v.numpy() for k, v in end.items()}, RoundWAL(ck).records()


@pytest.fixture
def threefry_restored():
    before = jax.config.jax_threefry_partitionable
    yield
    jax.config.update("jax_threefry_partitionable", before)


def test_preempted_on_8_resumed_on_4(tmp_path, threefry_restored):
    ref = jax_mesh_world(KNOBS, {"data": 8, "fsdp": 1})
    jax_end, jax_wal = _jax_drill(tmp_path)
    np.testing.assert_allclose(jax_end["Dense_0/weight"], ref["end"]["Dense_0/weight"],
                               atol=0)  # the JAX drill is bitwise its straight run
    ck, td = str(tmp_path / "ck"), str(tmp_path / "td")
    carried = {"dataset": ref["dataset"], "params": ref["start"]}
    runs8 = [
        dict(carried, args=dict(KNOBS, mesh_shape={"data": 8, "fsdp": 1})),
        dict(carried, args=dict(KNOBS, mesh_shape={"data": 8, "fsdp": 1}, checkpoint_dir=ck,
                                telemetry_dir=td), preempt_at=1),
    ]
    out8 = torch_world.run_world(torch_world.mesh_sim, 8, {"runs": runs8}, tmp_path, 180)
    straight = out8[0][0]["params"]
    assert all(r[1]["preempted"] == [1, 1] for r in out8)
    wal = RoundWAL(ck).records()
    assert [r.get("kind") for r in wal] == ["preempt"]
    assert wal[0]["round_idx"] == wal[0]["ckpt_step"] == 1
    assert wal[0]["mesh_shape"] == jax_wal[0]["mesh_shape"] == {"data": 8, "fsdp": 1}
    assert len(wal[0]["devices"]) == len(jax_wal[0]["devices"]) == 8
    steps = sorted(d for d in os.listdir(ck) if d.isdigit())
    assert steps == ["1"]  # rank 0 alone wrote the forced save
    out4 = torch_world.run_world(torch_world.mesh_sim, 4, {"runs": [
        dict(carried, args=dict(KNOBS, mesh_shape={"data": 4, "fsdp": 1}, checkpoint_dir=ck,
                                telemetry_dir=td))]}, tmp_path, 180)
    for (r,) in out4:
        for k, v in straight.items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)  # bitwise
            np.testing.assert_allclose(r["params"][k], jax_end[k], atol=ATOL, err_msg=k)
    wal = RoundWAL(ck).records()
    assert [r.get("kind") for r in wal] == [r.get("kind") for r in jax_wal] == [
        "preempt", "resume"]
    assert wal[1]["round_idx"] == 2 and wal[1]["mesh_shape"] == {"data": 4, "fsdp": 1}
    assert len(wal[1]["devices"]) == len(jax_wal[1]["devices"]) == 4
    rep = InvariantChecker(td, ck).check()
    assert rep.ok, rep.to_dict()
    assert {"preempt_paired_with_checkpoint", "preempt_resume_continuity"} <= set(rep.checked)
    assert {"trace.json", "metrics.prom", "telemetry.jsonl"} <= set(os.listdir(td))


def test_a_notice_only_one_rank_sees(tmp_path):
    """Rank 0 polls and the world follows its answer: a file only rank 1
    can see preempts nobody (and nothing hangs); one only rank 0 sees
    preempts every rank at the same round."""
    flag = tmp_path / "drain"
    flag.write_text("")
    knobs = dict(KNOBS, mesh_shape={"data": 2, "fsdp": 1})
    runs = [dict(args=dict(knobs, checkpoint_dir=str(tmp_path / f"ck{r}")),
                 preempt_file={"path": str(flag), "visible_to": r}) for r in (1, 0)]
    out = torch_world.run_world(torch_world.mesh_sim, 2, {"runs": runs}, tmp_path, 120)
    for ranks in out:
        assert ranks[0]["preempted"] is None and ranks[0]["stats"] is not None
        assert ranks[1]["preempted"] == [0, 0]
    assert [r.get("kind") for r in RoundWAL(str(tmp_path / "ck1")).records()] == []
    assert [r.get("kind") for r in RoundWAL(str(tmp_path / "ck0")).records()] == ["preempt"]


# -- one process: the pipeline, the cadence save, the refusals, the registry --

def _api(**kw):
    from fedml_tpu_torch import data, models
    from fedml_tpu_torch.simulation.fedavg_api import FedAvgAPI

    args = fedml_tpu_torch.init(_port_args(**dict(KNOBS, shuffle=True, **kw)))
    ds = data.load(args, device="cpu")
    return FedAvgAPI(args, "cpu", ds, models.create(args, ds.class_num, device="cpu"))


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("depth", [1, 2])
def test_the_pipeline_drains_before_the_exit_and_resumes_bitwise(depth, tmp_path):
    straight = _api(pipeline_depth=depth)
    straight.train()
    api = _api(pipeline_depth=depth, checkpoint_dir=str(tmp_path))
    api._preempt_signal = SimulatedPreemption(at_round=1)
    with pytest.raises(Preempted) as e:
        api.train()
    assert e.value.round_idx == 1 and e.value.ckpt_step == 1
    recs = RoundWAL(str(tmp_path)).records()
    assert [r.get("kind") for r in recs] == ["preempt"] and recs[0]["ckpt_step"] == 1
    assert recs[0]["devices"] == [] and recs[0]["mesh_shape"] == {}
    resumed = _api(pipeline_depth=depth, checkpoint_dir=str(tmp_path))
    resumed.train()
    _equal(resumed.global_params, straight.global_params)
    assert resumed.telemetry.get_counter("elastic_resumes_total") == 1.0
    assert [r.get("kind") for r in RoundWAL(str(tmp_path)).records()] == ["preempt", "resume"]


def test_a_cadence_saved_round_skips_the_second_save(tmp_path):
    api = _api(checkpoint_dir=str(tmp_path), checkpoint_freq=1, sim_mode="sequential")
    api._preempt_signal = SimulatedPreemption(at_round=0)
    saves = []
    real = api._save_checkpoint
    api._save_checkpoint = lambda ck, r: (saves.append(r), real(ck, r))
    with pytest.raises(Preempted):
        api.train()
    assert saves == [0]
    recs = RoundWAL(str(tmp_path)).records()
    assert [r.get("kind") for r in recs] == ["preempt"] and recs[0]["ckpt_step"] == 0
    assert sorted(d for d in os.listdir(tmp_path) if d.isdigit()) == ["0"]


def test_a_notice_without_a_checkpointer_is_loud():
    api = _api()
    with pytest.raises(RuntimeError, match="checkpoint_dir"):
        elastic.preempt_now(api, None, 0, PreemptionNotice("maintenance"))


def test_the_knob_drives_the_sync_loop_and_a_plain_restart_adds_no_record(tmp_path):
    api = _api(checkpoint_dir=str(tmp_path), preempt_signal="round:0", sim_mode="sequential")
    with pytest.raises(Preempted):
        api.train()
    assert api.telemetry.get_counter("elastic_preemptions_total") == 1.0
    _api(checkpoint_dir=str(tmp_path), sim_mode="sequential").train()
    plain = tmp_path / "plain"
    _api(checkpoint_dir=str(plain), comm_round=2, checkpoint_freq=1).train()
    _api(checkpoint_dir=str(plain)).train()  # resumes after step 1: no preempt to answer
    assert RoundWAL(str(plain)).records() == []
    assert [r.get("kind") for r in RoundWAL(str(tmp_path)).records()] == ["preempt", "resume"]


def test_the_registry_loop_preempts_and_resumes_bitwise(tmp_path):
    from test_torch_planet_scale import SIM

    planet = dict(SIM, shuffle=True)

    def api(**kw):
        from fedml_tpu_torch import data, models
        from fedml_tpu_torch.simulation.fedavg_api import FedAvgAPI

        args = fedml_tpu_torch.init(_port_args(**dict(planet, **kw)))
        ds = data.load(args, device="cpu")
        return FedAvgAPI(args, "cpu", ds, models.create(args, ds.class_num, device="cpu"))

    straight = api()
    straight.train()
    stopped = api(checkpoint_dir=str(tmp_path), preempt_signal="round:1")
    with pytest.raises(Preempted) as e:
        stopped.train()
    assert e.value.round_idx == 1
    resumed = api(checkpoint_dir=str(tmp_path))
    resumed.train()
    _equal(resumed.global_params, straight.global_params)
    assert [h["round"] for h in resumed.history] == [2]
    rep = InvariantChecker(None, str(tmp_path)).check()
    assert rep.ok and "preempt_resume_continuity" in rep.checked


# -- serving onto survivors ---------------------------------------------------

def test_endpoint_and_fleet_remesh_onto_survivors_answer_bitwise(tmp_path):
    from test_torch_serving_fleet import LR, _mesh_payload

    shrink = {"devices": [0, 1], "mesh_shape": {"data": 1, "fsdp": 2}}
    runs = [_mesh_payload(LR, (2, 2), shrink=shrink),
            _mesh_payload(LR, (2, 2), fleet=True, shrink=shrink)]
    out = torch_world.run_world(torch_world.mesh_serve, 4, {"runs": runs}, tmp_path, 120)
    ep, fleet = out[0]
    assert ep["shrunk_mesh"] == {"data": 1, "fsdp": 2}
    assert ep["version"] == 2 and len(ep["rows"]) == 4
    np.testing.assert_array_equal(ep["rows"][3], ep["rows"][2])  # same version, same bits
    assert fleet["remeshed"] == 2
    assert fleet["shrunk_mesh"] == [{"data": 1, "fsdp": 2}] * 2
    np.testing.assert_array_equal(fleet["rows"][3], fleet["rows"][2])
    # the ranks left out follow the channel to its end and serve nothing
    assert [len(r) for r in out] == [2, 2, 2, 2]
