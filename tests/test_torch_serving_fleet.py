"""The port's serving over the comm layer (``fedml_tpu_torch.serving``
frontends, fleet, mesh endpoint, ``core.checkpoint.CheckpointWatcher``,
``cli serve``) against the JAX package's, on the CPU.

- Across packages on the wire: a JAX ``ServingClient`` asks a port
  ``ServingFrontend`` over TRPC and over gRPC, and a port client asks a
  JAX frontend; answers are within 1e-5 of the other package's on
  ``_build``'s ``lr`` model and on a 2-layer flash transformer.
- The JAX package's ``TestFrontends``, ``TestCheckpointPublishWatch`` and
  ``TestCliServe`` (tests/test_serving.py) and ``TestMeshEndpoint``,
  ``TestSwapShardingIdentity``, ``TestWatcherShardedTarget``,
  ``TestFleetRouting`` and ``TestFleetFrontend``
  (tests/test_serving_fleet.py), on the port. The mesh endpoint runs in
  spawned gloo worlds (``tests/torch_world.py``) of 1, 4 and 8 ranks
  ({data: 1, fsdp: 1}, {2, 2}, {4, 2}): the answers are bitwise equal
  across the three through two hot swaps (measured: distance 0 for both
  models: on the CPU the lanes' batches of 8, 4 and 2 rows give the
  same bits a row).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from fedml_tpu_torch import models as torch_models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.core import devtime
from fedml_tpu_torch.core.telemetry import Telemetry
from tests.conftest import make_args as jax_args
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_world import free_port_block, run_world
import torch_world

# both packages compute the lr model and the flash transformer in f32
# from the same weights; answers differ by summation order only
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    Telemetry.reset()
    devtime.reset()
    yield
    Telemetry.reset()
    devtime.reset()


def port_args(**kw):
    a = Arguments()
    for k, v in kw.items():
        setattr(a, k, v)
    a._validate()
    return a


LR = dict(dataset="synthetic", input_dim=8, model="lr")
TRANSFORMER = dict(model="transformer", vocab_size=40, embed_dim=32, num_heads=2,
                   num_layers=2, seq_len=32, max_len=32, attention_impl="flash",
                   serve_max_batch=8)


def _build(**kw):
    """The port's ``_build`` of tests/test_serving_fleet.py: the lr model
    over 8 features, 4 classes, no default deadline."""
    args = port_args(**LR, serve_deadline_ms=0.0, **kw)
    model = torch_models.create(args, 4, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return args, model, params


def _answer(model, params, x):
    with torch.inference_mode():
        return model.apply(params, torch.as_tensor(np.asarray(x)[None]))[0].numpy()


def _burst(engine, xs, timeout=30):
    engine.pause()
    futs = [engine.submit(x) for x in xs]
    engine.resume()
    return [f.result(timeout=timeout) for f in futs]


def _rows(model_kw, n, seed):
    rng = np.random.default_rng(seed)
    if model_kw is TRANSFORMER:
        return [rng.integers(0, 40, size=32) for _ in range(n)]
    return [rng.normal(size=8).astype(np.float32) for _ in range(n)]


# -- across packages on the wire -----------------------------------------


def _pair(model_kw, **knobs):
    """One model in both packages on the same weights (the JAX init,
    converted)."""
    from fedml_tpu import models as jax_models

    out_dim = 4 if model_kw is LR else 10
    ja = jax_args(**model_kw, serve_deadline_ms=0.0, **knobs)
    jm = jax_models.create(ja, out_dim)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    ta = port_args(**model_kw, serve_deadline_ms=0.0, **knobs)
    tm = torch_models.create(ta, out_dim, device="cpu")
    tp = params_from_flax(jax.tree.map(np.asarray, jp))
    return (ja, jm, jp), (ta, tm, tp)


@pytest.mark.parametrize("backend", ["TRPC", "GRPC"])
@pytest.mark.parametrize("model_kw", [LR, TRANSFORMER], ids=["lr", "transformer"])
@pytest.mark.parametrize("server", ["port", "jax"])
def test_a_client_of_one_package_asks_a_frontend_of_the_other(backend, model_kw, server):
    from fedml_tpu.core.telemetry import Telemetry as JaxTelemetry
    from fedml_tpu.serving import ModelEndpoint as JaxEndpoint
    from fedml_tpu.serving import ServingClient as JaxClient
    from fedml_tpu.serving import ServingEngine as JaxEngine
    from fedml_tpu.serving import ServingFrontend as JaxFrontend
    from fedml_tpu.serving.frontends import build_serving_com as jax_com
    from fedml_tpu_torch.serving import (
        ModelEndpoint,
        ServingClient,
        ServingEngine,
        ServingFrontend,
        build_serving_com,
    )

    base = free_port_block(2)
    knobs = dict(run_id=f"x_{server}_{backend}", grpc_port_base=base)
    (ja, jm, jp), (ta, tm, tp) = _pair(model_kw, **knobs)
    rows = _rows(model_kw, 2, seed=3)
    if server == "port":
        eng = ServingEngine(ModelEndpoint(tm, tp), ta).start()
        fe = ServingFrontend(eng, build_serving_com(ta, 0, 2, backend), ta)
        threading.Thread(target=fe.serve_forever, daemon=True).start()
        cl = JaxClient(jax_com(ja, 1, 2, backend), rank=1, args=ja)
        want = [np.asarray(jm.apply(jp, np.asarray(x)[None]))[0] for x in rows]
    else:
        eng = JaxEngine(JaxEndpoint(jm, jp), ja).start()
        fe = JaxFrontend(eng, jax_com(ja, 0, 2, backend), ja)
        threading.Thread(target=fe.serve_forever, daemon=True).start()
        cl = ServingClient(build_serving_com(ta, 1, 2, backend), rank=1, args=ta)
        want = [_answer(tm, tp, x) for x in rows]
    try:
        got = [cl.request(x, timeout_s=60.0, retries=1) for x in rows]
    finally:
        cl.close()
        fe.stop()
        eng.stop()
        JaxTelemetry.reset()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=ATOL)


# -- TestFrontends (tests/test_serving.py) -------------------------------


def _start_frontend(engine, com, args):
    from fedml_tpu_torch.serving import ServingFrontend

    fe = ServingFrontend(engine, com, args)
    threading.Thread(target=fe.serve_forever, daemon=True).start()
    return fe


class TestFrontends:
    @pytest.mark.parametrize("backend", ["LOCAL", "TRPC", "GRPC", "MQTT"])
    def test_roundtrip(self, backend):
        from fedml_tpu_torch.serving import ServingClient, ServingEngine
        from fedml_tpu_torch.serving.endpoint import ModelEndpoint
        from fedml_tpu_torch.serving.frontends import build_serving_com

        args, model, params = _build(run_id=f"srv_{backend}",
                                     grpc_port_base=free_port_block(2))
        eng = ServingEngine(ModelEndpoint(model, params), args).start()
        fe = _start_frontend(eng, build_serving_com(args, 0, 2, backend), args)
        cl = ServingClient(build_serving_com(args, 1, 2, backend), rank=1, args=args)
        try:
            x = np.random.RandomState(1).randn(8).astype(np.float32)
            y = cl.request(x, timeout_s=10.0)
            assert np.allclose(y, _answer(model, params, x), atol=1e-5)
        finally:
            cl.close()
            fe.stop()
            eng.stop()

    def test_simulation_backend_names_serve_in_process(self):
        from fedml_tpu_torch.core.comm.local import LocalCommunicationManager
        from fedml_tpu_torch.serving.frontends import build_serving_com

        for name in ("sp", "single_process", "MESH"):
            com = build_serving_com(port_args(run_id="sim"), 0, 2, name)
            inner = com
            while hasattr(inner, "inner"):
                inner = inner.inner
            assert isinstance(inner, LocalCommunicationManager)

    @pytest.mark.parametrize("faults_outermost", [True, False])
    def test_dropped_request_counted_and_retried(self, faults_outermost):
        from fedml_tpu_torch import constants
        from fedml_tpu_torch.core.comm.faults import FaultInjector
        from fedml_tpu_torch.core.comm.instrument import wrap_instrumented
        from fedml_tpu_torch.core.managers import _build_com_manager
        from fedml_tpu_torch.serving import ModelEndpoint, ServingClient, ServingEngine
        from fedml_tpu_torch.serving.frontends import build_serving_com

        args, model, params = _build(run_id=f"srv_drop_{int(faults_outermost)}")
        eng = ServingEngine(ModelEndpoint(model, params), args).start()
        fe = _start_frontend(eng, build_serving_com(args, 0, 2), args)
        raw = _build_com_manager(args, 1, 2, "LOCAL")
        fault_kw = dict(drop_prob=1.0, max_faults=1,
                        msg_types=[constants.MSG_TYPE_C2S_INFER_REQUEST])
        if faults_outermost:
            com_c = FaultInjector(wrap_instrumented(raw, args), **fault_kw)
        else:
            com_c = wrap_instrumented(FaultInjector(raw, **fault_kw), args)
        cl = ServingClient(com_c, rank=1, args=args)
        try:
            x = np.random.RandomState(2).randn(8).astype(np.float32)
            y = cl.request(x, timeout_s=0.5, retries=2)
            assert np.allclose(y, _answer(model, params, x), atol=1e-5)
            tel = Telemetry.get_instance()
            assert tel.get_counter("comm_faults_injected_total", fault="drop",
                                   msg_type=constants.MSG_TYPE_C2S_INFER_REQUEST) == 1
            assert tel.get_counter("serving_client_retries_total") >= 1
        finally:
            cl.close()
            fe.stop()
            eng.stop()

    def test_delayed_request_sheds_stale_and_retries(self):
        from fedml_tpu_torch import constants
        from fedml_tpu_torch.core.comm.faults import FaultInjector
        from fedml_tpu_torch.core.comm.instrument import wrap_instrumented
        from fedml_tpu_torch.core.managers import _build_com_manager
        from fedml_tpu_torch.serving import ModelEndpoint, ServingClient, ServingEngine
        from fedml_tpu_torch.serving.frontends import build_serving_com

        args, model, params = _build(run_id="srv_delay")
        eng = ServingEngine(ModelEndpoint(model, params), args).start()
        fe = _start_frontend(eng, build_serving_com(args, 0, 2), args)
        raw = _build_com_manager(args, 1, 2, "LOCAL")
        com_c = FaultInjector(wrap_instrumented(raw, args), delay_s=0.4, delay_prob=1.0,
                              max_faults=1,
                              msg_types=[constants.MSG_TYPE_C2S_INFER_REQUEST])
        cl = ServingClient(com_c, rank=1, args=args)
        try:
            x = np.random.RandomState(3).randn(8).astype(np.float32)
            y = cl.request(x, timeout_s=1.5, retries=2, deadline_s=0.1)
            assert np.allclose(y, _answer(model, params, x), atol=1e-5)
            tel = Telemetry.get_instance()
            assert tel.get_counter("comm_faults_injected_total", fault="delay",
                                   msg_type=constants.MSG_TYPE_C2S_INFER_REQUEST) == 1
            assert tel.get_counter("serving_shed_total", reason="deadline") >= 1
            assert tel.get_counter("serving_client_retries_total") >= 1
        finally:
            cl.close()
            fe.stop()
            eng.stop()

    def test_shed_and_error_statuses_are_the_references(self):
        from fedml_tpu.serving import frontends as jax_fe
        from fedml_tpu.serving.admission import (
            DeadlineExceededError as JDeadline,
            QueueFullError as JFull,
            ServingShedError as JShed,
        )
        from fedml_tpu_torch.serving import frontends
        from fedml_tpu_torch.serving.admission import (
            DeadlineExceededError,
            QueueFullError,
            ServingShedError,
        )

        for port_exc, jax_exc in ((QueueFullError("q"), JFull("q")),
                                  (DeadlineExceededError("d"), JDeadline("d")),
                                  (ServingShedError("s"), JShed("s")),
                                  (ValueError("v"), ValueError("v"))):
            assert frontends._status_for(port_exc) == jax_fe._status_for(jax_exc)

    def test_unavailable_after_the_retry_budget(self):
        from fedml_tpu_torch.serving import ServingClient, ServingUnavailableError
        from fedml_tpu_torch.serving.frontends import build_serving_com

        args = port_args(run_id="srv_nobody")
        cl = ServingClient(build_serving_com(args, 1, 2), rank=1, args=args)
        try:
            with pytest.raises(ServingUnavailableError, match="2 attempt"):
                cl.request(np.zeros(8, np.float32), timeout_s=0.05, retries=1)
            assert Telemetry.get_instance().get_counter("serving_client_retries_total") == 1
        finally:
            cl.close()


# -- TestCheckpointPublishWatch (tests/test_serving.py) ------------------


def _save(ckpt, step, params, scale):
    ckpt.save(step, {"params": {k: v * scale for k, v in params.items()},
                     "round_idx": step})


def _garble(step_dir):
    for root, _, names in os.walk(step_dir):
        for n in names:
            with open(os.path.join(root, n), "wb") as fh:
                fh.write(b"GARBAGE")


class TestCheckpointPublishWatch:
    def test_watcher_publishes_each_new_step_once(self, tmp_path):
        from fedml_tpu_torch.core.checkpoint import CheckpointWatcher, RoundCheckpointer

        _args, _model, params = _build()
        ckpt = RoundCheckpointer(str(tmp_path))
        watcher = CheckpointWatcher(str(tmp_path))
        assert watcher.poll() is None
        _save(ckpt, 0, params, 1.0)
        step, _state = watcher.poll()
        assert step == 0
        assert watcher.poll() is None
        _save(ckpt, 1, params, 2.0)
        _save(ckpt, 2, params, 3.0)
        step, state = watcher.poll()
        assert step == 2  # latest-wins: step 1 was superseded, never delivered
        assert torch.equal(state["params"]["Dense_0/weight"], params["Dense_0/weight"] * 3.0)
        assert watcher.poll() is None
        watcher.close()

    def test_corrupt_latest_falls_back_to_previous(self, tmp_path):
        from fedml_tpu_torch.core.checkpoint import CheckpointWatcher, RoundCheckpointer
        from fedml_tpu_torch.serving import ModelEndpoint

        _args, model, params = _build()
        ep = ModelEndpoint(model, params)
        ckpt = RoundCheckpointer(str(tmp_path))
        _save(ckpt, 0, params, 2.0)
        _save(ckpt, 1, params, 3.0)
        _garble(tmp_path / "1")
        watcher = CheckpointWatcher(str(tmp_path))
        step, state = watcher.poll()
        assert step == 0
        ep.swap_from_checkpoint_state(state, version=step)
        assert ep.version == 0 and ep.swaps == 1
        x = np.zeros(8, np.float32)
        ref = _answer(model, {k: v * 2.0 for k, v in params.items()}, x)
        assert np.allclose(_answer(model, ep.params(), x), ref, atol=1e-5)
        assert watcher.poll() is None  # bad step 1 is never retried
        assert 1 in watcher._bad
        watcher.close()

    def test_close_stops_watch_threads(self, tmp_path):
        from fedml_tpu_torch.core.checkpoint import CheckpointWatcher

        watcher = CheckpointWatcher(str(tmp_path), poll_interval_s=0.05)
        thread = watcher.watch(lambda step, state: None)
        assert thread.is_alive()
        watcher.close()
        thread.join(timeout=2.0)
        assert not thread.is_alive()

    def test_watch_delivers_to_a_serving_engine(self, tmp_path):
        from fedml_tpu_torch.core.checkpoint import CheckpointWatcher, RoundCheckpointer
        from fedml_tpu_torch.serving import ModelEndpoint, ServingEngine

        args, model, params = _build()
        ep = ModelEndpoint(model, params)
        ckpt = RoundCheckpointer(str(tmp_path))
        watcher = CheckpointWatcher(str(tmp_path), poll_interval_s=0.02)
        x = np.random.RandomState(4).randn(8).astype(np.float32)
        with ServingEngine(ep, args) as eng:
            (before,) = _burst(eng, [x])
            watcher.watch(lambda step, state: ep.swap_from_checkpoint_state(state, step))
            _save(ckpt, 4, params, -1.0)
            deadline = time.monotonic() + 10
            while ep.version != 4 and time.monotonic() < deadline:
                time.sleep(0.02)
            (after,) = _burst(eng, [x])
        watcher.close()
        assert ep.version == 4
        ref = _answer(model, {k: -v for k, v in params.items()}, x)
        assert np.allclose(after, ref, atol=1e-5) and not np.allclose(after, before)


# -- TestCliServe (tests/test_serving.py) ------------------------------------


class TestCliServe:
    def test_dry_run_builds_the_plane_and_reports(self, capsys):
        from fedml_tpu_torch import cli

        assert cli.main(["serve", "--dry-run", "--device", "cpu"]) == 0
        status = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert status["model"] == "lr" and status["backend"] == "LOCAL"
        assert status["queue_size"] >= 1 and status["max_batch"] >= 1

    def test_status_fields_are_the_references(self, capsys):
        from fedml_tpu import cli as jax_cli
        from fedml_tpu_torch import cli

        assert jax_cli.main(["serve", "--dry-run", "--fleet-size", "2"]) == 0
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert cli.main(["serve", "--dry-run", "--fleet-size", "2", "--device", "cpu"]) == 0
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert got == want

    def test_dry_run_restores_latest_checkpoint(self, tmp_path, capsys):
        from fedml_tpu_torch import cli
        from fedml_tpu_torch.core.checkpoint import RoundCheckpointer

        model = torch_models.create(port_args(dataset="synthetic", model="lr"), 10,
                                    device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        RoundCheckpointer(str(tmp_path)).save(5, {"params": params, "round_idx": 5})
        rc = cli.main(["serve", "--dry-run", "--device", "cpu",
                       "--checkpoint-dir", str(tmp_path)])
        assert rc == 0
        status = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert status["version"] == 5

    def test_the_card_is_the_default_device(self, monkeypatch):
        from fedml_tpu_torch import cli

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["serve", "--dry-run"])

    @pytest.mark.parametrize("command", ["trace", "lint", "check", "audit", "perf"])
    def test_other_subcommands_name_their_slice(self, command, tmp_path):
        """``trace``, ``check``, ``lint``, ``audit`` and ``perf`` are ported
        and take the JAX package's flags: an unknown one is a usage error
        (``SystemExit``), and each answers a usage mistake with exit code
        2 (``perf`` without a mode, ``audit --ci --update-baseline``), as
        the JAX cli does."""
        from fedml_tpu_torch import cli

        with pytest.raises(SystemExit):
            cli.main([command, "--anything"])
        if command in ("lint", "audit"):
            assert cli.main([command, "--ci", "--update-baseline"]) == 2
            if command == "lint":
                assert cli.main([command, "--ci", "--no-baseline"]) == 2
            return
        if command == "perf":
            assert cli.main([command]) == 2
        assert cli.main([command, "--telemetry-dir", str(tmp_path / "none")]) == 2

    def test_telemetry_dir_export_names_its_slice(self, tmp_path):
        """A ``telemetry_dir`` no longer refuses ``serve``: a dry run builds
        and prints its status, as the JAX cli's does."""
        from fedml_tpu_torch import cli

        cfg = tmp_path / "c.yaml"
        cfg.write_text(f"tracking_args: {{telemetry_dir: {tmp_path}}}\n")
        assert cli.main(["serve", "--dry-run", "--device", "cpu", "--cf", str(cfg)]) == 0

    @pytest.mark.parametrize("knob,value", [
        ("serve_queue_size", 0), ("serve_bucket", "fib"), ("serve_watch_interval_s", -1),
        ("serve_fleet_size", 0), ("serve_route_policy", "round_robin"),
        ("serve_mesh", {"data": 2, "model": 2}), ("serve_mesh", [2, 2]),
        ("serve_route_slo_ms", -1), ("serve_route_failover", -1),
        ("comm_retry_max", -1), ("comm_retry_base_s", -0.5),
        ("heartbeat_interval_s", -1), ("heartbeat_timeout_s", -1),
        ("grpc_send_timeout_s", 0),
    ])
    def test_serve_and_comm_knobs_validate_with_the_references_words(self, knob, value):
        with pytest.raises(ValueError) as want:
            jax_args(**{knob: value})
        with pytest.raises(ValueError) as got:
            port_args(**{knob: value})
        assert str(got.value) == str(want.value)

    def test_knobs_coerce_as_the_reference(self):
        kw = dict(serve_deadline_ms="250", serve_max_batch="32", serve_fleet_size="3",
                  serve_mesh={"data": "2", "fsdp": 1}, comm_retry_max="4",
                  grpc_send_timeout_s="7")
        a, b = port_args(**kw), jax_args(**kw)
        for k in kw:
            assert getattr(a, k) == getattr(b, k) and type(getattr(a, k)) is type(getattr(b, k))


# -- TestMeshEndpoint / TestFleetFrontend's mesh half (gloo worlds) --------

MESH_WORLDS = {(1, 1): 1, (2, 2): 4, (4, 2): 8}


def _mesh_payload(model_kw, shape, **extra):
    out_dim = 4 if model_kw is LR else 10
    knobs = dict(model_kw, serve_deadline_ms=0.0, run_id="mesh")
    model = torch_models.create(port_args(**knobs), out_dim, device="cpu")

    def init(seed):
        return {k: v.numpy() for k, v in model.init(torch.Generator().manual_seed(seed)).items()}

    return dict(args=knobs, output_dim=out_dim, params=init(0), pubs=[init(11), init(12)],
                xs=_rows(model_kw, 6, seed=5),
                mesh_shape={"data": shape[0], "fsdp": shape[1]}, **extra)


# each world re-meshes onto another shape of its ranks after the swaps
REMESH = {(1, 1): (1, 1), (2, 2): (1, 4), (4, 2): (2, 4)}


@pytest.fixture(scope="module")
def mesh_worlds(tmp_path_factory):
    """Rank 0's results of the lr and the transformer runs in each world
    of ``MESH_WORLDS`` (one spawned world a shape, both models in it)."""
    out = {}
    for shape, world in MESH_WORLDS.items():
        d, f = REMESH[shape]
        runs = [_mesh_payload(kw, shape, remesh={"data": d, "fsdp": f})
                for kw in (LR, TRANSFORMER)]
        results = run_world(torch_world.mesh_serve, world, {"runs": runs},
                            tmp_path_factory.mktemp("mesh"), timeout=120)
        out[shape] = {"lr": results[0][0], "transformer": results[0][1],
                      "shapes": [r[0]["local_shapes"] for r in results]}
    return out


@pytest.mark.parametrize("model", ["lr", "transformer"])
def test_mesh_answers_bitwise_equal_across_mesh_shapes_through_two_swaps(model, mesh_worlds):
    got = {}
    for shape in MESH_WORLDS:
        r = mesh_worlds[shape][model]
        assert r["version"] == 2 and r["swaps"] == 2
        got[shape] = np.concatenate(r["rows"][:3])
    assert got[(1, 1)].shape[0] == 3 * 6
    for shape in ((2, 2), (4, 2)):
        assert np.array_equal(got[shape], got[(1, 1)]), (
            shape, float(np.abs(got[shape] - got[(1, 1)]).max()))
    # and the one-rank mesh answers as the plain endpoint does
    p = _mesh_payload(LR if model == "lr" else TRANSFORMER, (1, 1))
    args = port_args(**p["args"])
    model_ = torch_models.create(args, p["output_dim"], device="cpu")
    from fedml_tpu_torch.serving import ModelEndpoint, ServingEngine

    ep = ModelEndpoint(model_, {k: torch.tensor(v) for k, v in p["params"].items()})
    with ServingEngine(ep, args) as eng:
        plain = np.stack(_burst(eng, p["xs"]))
    assert np.array_equal(plain, got[(1, 1)][:6])


class TestMeshEndpoint:
    def test_params_rest_sharded_refusals_and_stale_swaps(self, mesh_worlds):
        r = mesh_worlds[(2, 2)]["lr"]
        # the lr weight [4, 8] shards its input rows over fsdp 2; the bias stays whole
        assert mesh_worlds[(2, 2)]["shapes"] == [
            {"Dense_0/weight": (4, 4), "Dense_0/bias": (4,)}] * 4
        assert r["stale_version"] == 2 and r["rejected"] == 1
        assert r["errors"][0] == (
            "mesh serving batch of 3 does not tile the data axis (2 lanes) — bucket "
            "micro-batches with shard_multiple=2 (the engine does this automatically)")
        assert r["errors"][1] == (
            "remesh(devices=[1]): the surviving ranks must be a subset of the mesh's "
            "[0, 1, 2, 3] and keep rank 0, which serves")

    def test_remesh_over_the_same_world_answers_the_same(self, mesh_worlds):
        for shape in MESH_WORLDS:
            for model in ("lr", "transformer"):
                rows = mesh_worlds[shape][model]["rows"]
                assert len(rows) == 4
                # re-sharded, same version, same bits
                assert np.array_equal(rows[3], rows[2]), (shape, model)

    def test_the_non_fed_mesh_is_refused(self):
        from fedml_tpu_torch.serving import MeshModelEndpoint

        _args, model, params = _build()

        class Legacy:
            axis_names = ("clients",)
            shape = {"clients": 2}

        with pytest.raises(ValueError) as err:
            MeshModelEndpoint(model, params, Legacy())
        assert str(err.value) == (
            "MeshModelEndpoint needs a named (data, fsdp) mesh, got axes ('clients',) "
            "— build one with parallel.layout.build_fed_mesh")

    def test_the_batcher_lifts_buckets_to_the_lane_multiple(self):
        import queue as queue_mod

        from fedml_tpu_torch.serving.batcher import MicroBatcher

        mb = MicroBatcher(queue_mod.Queue(), 64, 0.0, "exact", shard_multiple=2)

        class _R:
            def __init__(self, x):
                self.x = x

        _padded, valid, bucket, n = mb.pad([_R(np.zeros(8, np.float32))] * 3)
        assert bucket == 4 and n == 3
        assert valid.tolist() == [1, 1, 1, 0]
        from fedml_tpu.serving.batcher import MicroBatcher as JaxBatcher

        for policy in ("pow2", "exact"):
            for m in (1, 2, 3, 4):
                for n in (1, 3, 5, 8):
                    rows = [_R(np.zeros(8, np.float32))] * n
                    want = JaxBatcher(queue_mod.Queue(), 64, 0.0, policy,
                                      shard_multiple=m).pad(rows)
                    got = MicroBatcher(queue_mod.Queue(), 64, 0.0, policy,
                                       shard_multiple=m).pad(rows)
                    assert got[2:] == want[2:] and got[1].tolist() == want[1].tolist()


class TestSwapShardingIdentity:
    def test_plain_swap_rejects_a_changed_dtype_and_places_any_device(self):
        from fedml_tpu_torch.serving import ModelEndpoint

        _args, model, params = _build()
        ep = ModelEndpoint(model, params)
        with pytest.raises(ValueError, match="hot swap rejected"):
            ep.swap({k: v.double() for k, v in params.items()})
        assert ep.swaps == 0
        # host numpy (the watcher's raw path) and tensors both place on the
        # endpoint's device
        assert ep.swap({k: v.numpy() * 2 for k, v in params.items()}) == 1
        assert all(v.device == ep.device for v in ep.params().values())

    def test_mesh_swaps_place_host_arrays_on_every_rank(self, mesh_worlds):
        """The publishes arrive as host numpy arrays; every world's
        endpoint placed them (its own shard on each rank) and swapped."""
        for shape in MESH_WORLDS:
            for model in ("lr", "transformer"):
                r = mesh_worlds[shape][model]
                assert (r["swaps"], r["version"]) == (2, 2), (shape, model)


class TestWatcherShardedTarget:
    def _publish(self, ckpt, model, seed, step):
        state = {"params": model.init(torch.Generator().manual_seed(seed)), "round_idx": step}
        ckpt.save(step, state)
        return state

    def _mesh_fleet(self, args, model, params):
        """A fleet of mesh endpoints in this process's own world of one."""
        import torch.distributed as dist

        from fedml_tpu_torch.parallel.layout import build_fed_mesh
        from fedml_tpu_torch.serving import ServingFleet

        assert not dist.is_initialized()
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        mesh = build_fed_mesh({"data": 1, "fsdp": 1}, 1, "cpu")
        return ServingFleet.build(model, params, args, mesh=mesh)

    def test_restore_lands_on_the_endpoint_device_through_the_target(self, tmp_path):
        import torch.distributed as dist

        from fedml_tpu_torch.core.checkpoint import CheckpointWatcher, RoundCheckpointer

        args, model, params = _build(serve_fleet_size=2)
        ckpt = RoundCheckpointer(str(tmp_path))
        self._publish(ckpt, model, seed=1, step=3)
        try:
            fleet = self._mesh_fleet(args, model, params)
            watcher = CheckpointWatcher(str(tmp_path), restore_target=fleet.restore_target)
            step, state = watcher.poll()
            fleet.publish_state(state, step)
            target = fleet.restore_target()
            assert target is not None
            assert all(t.device == fleet.engines[0].endpoint.device
                       and t.untyped_storage().nbytes() == t.element_size()
                       for t in target["params"].values())
            want = self._publish(ckpt, model, seed=2, step=7)
            step, state = watcher.poll()
            fleet.publish_state(state, step)
            for eng in fleet.engines:
                ep = eng.endpoint
                assert ep.version == 7 and ep.swaps == 2
                for k, v in ep.params().items():
                    assert torch.equal(v, want["params"][k])
            # a target that no longer matches the step (the state tree
            # changed) is relearned by a target-free restore, counted
            bad = dict(target, params={k: v[..., :1] for k, v in target["params"].items()})
            watcher.restore_target = bad
            self._publish(ckpt, model, seed=3, step=9)
            step, state = watcher.poll()
            assert step == 9 and 9 not in watcher._bad
            assert Telemetry.get_instance().get_counter(
                "serving_restore_target_relearned_total") == 1
            watcher.close()
            fleet.release()
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()

    def test_corrupt_latest_falls_back_with_target_set(self, tmp_path):
        import torch.distributed as dist

        from fedml_tpu_torch.core.checkpoint import CheckpointWatcher, RoundCheckpointer

        args, model, params = _build()
        ckpt = RoundCheckpointer(str(tmp_path))
        self._publish(ckpt, model, seed=1, step=1)
        try:
            fleet = self._mesh_fleet(args, model, params)
            watcher = CheckpointWatcher(str(tmp_path), restore_target=fleet.restore_target)
            step, state = watcher.poll()
            fleet.publish_state(state, step)
            self._publish(ckpt, model, seed=2, step=4)
            _garble(tmp_path / "4")
            assert watcher.poll() is None  # fell back, no crash
            assert 4 in watcher._bad
            self._publish(ckpt, model, seed=3, step=5)
            step, state = watcher.poll()
            assert step == 5
            fleet.publish_state(state, step)
            assert fleet.engines[0].endpoint.version == 5
            watcher.close()
            fleet.release()
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()

    def test_no_target_keeps_raw_restore(self, tmp_path):
        from fedml_tpu_torch.core.checkpoint import CheckpointWatcher, RoundCheckpointer

        _args, model, _params = _build()
        self._publish(RoundCheckpointer(str(tmp_path)), model, seed=1, step=2)
        watcher = CheckpointWatcher(str(tmp_path))
        step, state = watcher.poll()
        assert step == 2
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                   for v in state["params"].values())
        watcher.close()

    def test_restore_checks_the_target(self, tmp_path):
        from fedml_tpu_torch.core.checkpoint import RoundCheckpointer

        _args, model, params = _build()
        ckpt = RoundCheckpointer(str(tmp_path))
        ckpt.save(1, {"params": params, "round_idx": 1})
        target = {"params": {k: torch.empty(v.shape, dtype=torch.float64)
                             for k, v in params.items()}}
        with pytest.raises(ValueError, match="restore target mismatch"):
            ckpt.restore(1, target=target)
        with pytest.raises(ValueError, match="does not hold"):
            ckpt.restore(1, target={"params": {"nope": torch.empty(1)}})
        ok = ckpt.restore(1, target={"params": dict(params)})
        assert ok["round_idx"] == 1
        assert all(torch.equal(ok["params"][k], v) for k, v in params.items())


# -- TestFleetRouting / TestFleetFrontend (tests/test_serving_fleet.py) -----


class TestFleetRouting:
    def test_least_loaded_spreads_evenly(self):
        from fedml_tpu_torch.serving import ServingFleet

        args, model, params = _build(serve_fleet_size=2)
        with ServingFleet.build(model, params, args) as fleet:
            futs = [fleet.submit(np.zeros(8, np.float32)) for _ in range(12)]
            for f in futs:
                f.result(timeout=30)
            assert sum(fleet.routed) == 12
            assert fleet.load_skew() <= 2.0
        assert Telemetry.get_instance().snapshot()["gauges"]["serving_fleet_size"] == 2

    def test_concurrent_engines_answer_their_own_rows(self):
        """``FedModel.apply`` loads the params into its module for the
        call, so the fleet gives each endpoint a module of its own: the
        engines' threads run forwards at once and every answer is its
        row's."""
        from fedml_tpu_torch.serving import ServingFleet

        args = port_args(**TRANSFORMER, serve_deadline_ms=0.0, serve_fleet_size=2,
                         serve_batch_wait_ms=0.0)
        model = torch_models.create(args, 10, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        rows = _rows(TRANSFORMER, 16, seed=9)
        want = np.stack([_answer(model, params, x) for x in rows])
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)  # interleave the threads' bytecode finely
        try:
            with ServingFleet.build(model, params, args) as fleet:
                assert len({id(e.endpoint.model.module) for e in fleet.engines}) == 2
                results = {}

                def ask(i):
                    results[i] = [fleet.submit(rows[i]).result(timeout=60) for _ in range(4)]

                threads = [threading.Thread(target=ask, args=(i,)) for i in range(16)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
                assert not any(t.is_alive() for t in threads)
                assert min(fleet.routed) > 0
        finally:
            sys.setswitchinterval(switch)
        for i in range(16):
            for y in results[i]:
                np.testing.assert_allclose(y, want[i], atol=ATOL)

    def test_static_deal_uses_assign_by_load(self):
        from fedml_tpu.core.scheduler import assign_by_load as jax_assign
        from fedml_tpu_torch.core.scheduler import assign_by_load
        from fedml_tpu_torch.serving import ServingFleet

        loads = [3, 1, 2, 2, 1, 3, 2, 2]
        assert assign_by_load(loads, 2) == jax_assign(loads, 2)
        args, model, params = _build(serve_fleet_size=2, serve_route_policy="static")
        with ServingFleet.build(model, params, args) as fleet:
            futs = fleet.submit_burst([np.zeros(8, np.float32)] * 8, loads=loads)
            for f in futs:
                f.result(timeout=30)
            assert fleet.load_skew() <= 2.0
            plan = assign_by_load(loads, 2)
            assert fleet.routed == [sum(1 for j in plan if plan[j] == i) for i in (0, 1)]

    def test_a_deep_endpoint_routes_last(self):
        """The least-loaded order (no timing): a paused endpoint holding
        queued requests is the last candidate while its peer is idle."""
        from fedml_tpu_torch.serving import ServingFleet

        args, model, params = _build(serve_fleet_size=2)
        with ServingFleet.build(model, params, args) as fleet:
            fleet.engines[0].pause()
            stuck = [fleet.engines[0].submit(np.zeros(8, np.float32)) for _ in range(4)]
            assert fleet.depths()[0] == 4
            for _ in range(4):
                assert fleet._route_order() == [1, 0]
            fleet.engines[0].resume()
            for f in stuck:
                f.result(timeout=30)

    def test_killed_endpoint_drains_to_live_and_sheds_counted(self):
        from fedml_tpu_torch.serving import ServingFleet
        from fedml_tpu_torch.serving.admission import ServingShedError

        args, model, params = _build(serve_fleet_size=2, run_id="fleet_kill")
        fleet = ServingFleet.build(model, params, args).start()
        try:
            fleet.engines[0].stop()
            futs = [fleet.submit(np.zeros(8, np.float32)) for _ in range(6)]
            for f in futs:
                f.result(timeout=30)
            assert fleet.routed[0] == 0 and fleet.routed[1] == 6
            fleet.engines[1].stop()
            dead = fleet.submit(np.zeros(8, np.float32))
            with pytest.raises(ServingShedError):
                dead.result(timeout=5)
            assert Telemetry.get_instance().get_counter(
                "serving_fleet_shed_total", reason="no_endpoint") == 1
        finally:
            fleet.stop()

    def test_queue_full_fails_over_and_counts(self):
        from fedml_tpu_torch.serving import ServingFleet

        args, model, params = _build(serve_fleet_size=2, serve_queue_size=1,
                                     serve_route_failover=1)
        fleet = ServingFleet.build(model, params, args).start()
        try:
            for e in fleet.engines:
                e.pause()
            futs = [fleet.submit(np.zeros(8, np.float32)) for _ in range(3)]
            assert Telemetry.get_instance().get_counter("serving_fleet_failover_total") >= 1
            for e in fleet.engines:
                e.resume()
            assert sum(1 for f in futs if f.exception(timeout=30) is None) == 2
        finally:
            fleet.stop()

    def test_slo_controller_sheds_at_the_door(self):
        from fedml_tpu_torch.serving import FleetSloError, ServingFleet
        from fedml_tpu_torch.serving.engine import LATENCY_BUCKETS_S

        args, model, params = _build(serve_fleet_size=2, serve_route_slo_ms=50.0)
        tel = Telemetry.get_instance(args)
        fleet = ServingFleet.build(model, params, args).start()
        try:
            assert fleet.slo.p99_ms() is None  # below min_count it abstains
            for _ in range(30):
                tel.observe("serving_request_latency_s", 0.4,
                            buckets=LATENCY_BUCKETS_S, bucket=4)
            assert fleet.slo.p99_ms() == 500.0
            fut = fleet.submit(np.zeros(8, np.float32))
            with pytest.raises(FleetSloError):
                fut.result(timeout=5)
            assert tel.get_counter("serving_fleet_shed_total", reason="slo") == 1
        finally:
            fleet.stop()

    def test_a_fleet_needs_an_engine_and_a_known_policy(self):
        from fedml_tpu_torch.serving import ServingEngine, ServingFleet
        from fedml_tpu_torch.serving.endpoint import ModelEndpoint

        with pytest.raises(ValueError, match="at least one engine"):
            ServingFleet([])
        args, model, params = _build()
        args.serve_route_policy = "random"
        with pytest.raises(ValueError, match="pick 'least_loaded' or 'static'"):
            ServingFleet([ServingEngine(ModelEndpoint(model, params), args)], args)


class TestFleetFrontend:
    @pytest.mark.parametrize("faults_outermost", [True, False])
    def test_roundtrip_with_faults_in_both_wrap_orders(self, faults_outermost):
        from fedml_tpu_torch import constants
        from fedml_tpu_torch.core.comm.faults import FaultInjector
        from fedml_tpu_torch.core.comm.instrument import wrap_instrumented
        from fedml_tpu_torch.core.managers import _build_com_manager
        from fedml_tpu_torch.serving import FleetFrontend, ServingClient, ServingFleet
        from fedml_tpu_torch.serving.frontends import build_serving_com

        args, model, params = _build(serve_fleet_size=2,
                                     run_id=f"fleet_fe_{int(faults_outermost)}")
        fleet = ServingFleet.build(model, params, args).start()
        fe = FleetFrontend(fleet, build_serving_com(args, 0, 2), args)
        threading.Thread(target=fe.serve_forever, daemon=True).start()
        raw = _build_com_manager(args, 1, 2, "LOCAL")
        fault_kw = dict(drop_prob=1.0, max_faults=1,
                        msg_types=[constants.MSG_TYPE_C2S_INFER_REQUEST])
        if faults_outermost:
            com_c = FaultInjector(wrap_instrumented(raw, args), **fault_kw)
        else:
            com_c = wrap_instrumented(FaultInjector(raw, **fault_kw), args)
        cl = ServingClient(com_c, rank=1, args=args)
        try:
            x = np.random.RandomState(2).randn(8).astype(np.float32)
            y = cl.request(x, timeout_s=0.5, retries=2)
            assert np.allclose(y, _answer(model, params, x), atol=1e-5)
            assert Telemetry.get_instance().get_counter("serving_client_retries_total") >= 1
            assert sum(fleet.routed) >= 1
        finally:
            cl.close()
            fe.stop()
            fleet.stop()

    def test_mesh_fleet_frontend_in_a_world_of_four(self, tmp_path):
        out = run_world(torch_world.mesh_serve, 4,
                        {"runs": [_mesh_payload(LR, (2, 2), fleet=True)]}, tmp_path)
        r = out[0][0]
        assert sum(r["routed"]) == 3 * 6 and min(r["routed"]) > 0
        p = _mesh_payload(LR, (1, 1))
        args = port_args(**p["args"])
        model = torch_models.create(args, 4, device="cpu")
        for rows, pub in zip(r["rows"], [p["params"]] + p["pubs"]):
            want = [_answer(model, {k: torch.tensor(v) for k, v in pub.items()}, x)
                    for x in p["xs"]]
            np.testing.assert_allclose(rows, np.stack(want), atol=ATOL)

    def test_cli_serve_dry_run_fleet_mesh_in_a_world_of_four(self, tmp_path):
        out = run_world(torch_world.cli_serve, 4, {"argv": [
            "serve", "--dry-run", "--device", "cpu", "--fleet-size", "2", "--mesh", "2x2"]},
            tmp_path)
        status = json.loads(out[0].strip().splitlines()[-1])
        assert status["fleet_size"] == 2
        assert status["mesh"] == {"data": 2, "fsdp": 2}
        assert status["route_policy"] == "least_loaded"
        assert out[1:] == ["", "", ""]  # the followers print nothing
