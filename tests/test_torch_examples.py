"""The port's examples (``fedml_tpu_torch/examples/``), run as a user runs
them: a subprocess with ``--cf`` on a copied YAML that adds
``device_args: {device_type: cpu}`` (the config is how a script asks for
the CPU) and free ports. The port's counterpart of
``tests/test_examples.py``.

Two runs hold an example against the JAX package's example on the same
YAML:

- the user's run: the script as shipped. The two packages draw the
  stand-in's features, the initial weights and the shuffle from
  different generators, so its ``FINAL:`` is held to the JAX run's
  accuracies within ``ACC_TOL``, and its losses must be finite;
- the carried run (``torch_example_harness.py``): the same script on the
  JAX run's federation and initial params, with ``shuffle: false`` in
  both YAMLs, so that only rounding separates the two. Its final stats
  are held to the JAX run's within ``RTOL``/``ATOL`` in f32. The custom
  tiers' JAX operators are imported from the JAX example scripts.

The 8-rank examples (``distributed``, ``longcontext``) run under
torchrun in a gloo world of 8 and carry ``slow`` as their JAX
counterparts do; their numerics are held by
``tests/test_torch_distributed.py`` and ``tests/test_torch_longcontext.py``.
"""

from __future__ import annotations

import argparse
import ast
import importlib.util
import math
import os
import pickle
import shutil
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

import fedml_tpu
from fedml_tpu import models as jax_models
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.arguments import load_arguments as jax_load_arguments
from fedml_tpu.data import load as jax_load
from fedml_tpu.simulation import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu_torch.convert import params_from_flax
from torch_world import free_port_block

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_EXAMPLES = os.path.join(REPO, "fedml_tpu_torch", "examples")
JAX_EXAMPLES = os.path.join(REPO, "examples")
HARNESS = os.path.join(REPO, "tests", "torch_example_harness.py")

# the user's run against the JAX example's: accuracies within two points
# (5 rounds of the linear model on the MNIST stand-in reach 0.99-1.0 in
# both packages from their own generators' data and weights)
ACC_TOL = 0.02
# the carried run against the JAX example's: the same f32 arithmetic up
# to rounding (the linear model has no ReLU to amplify it)
RTOL, ATOL = 1e-5, 1e-6
STAT_KEYS = ("train_acc", "train_loss", "test_acc", "test_loss", "train_loss_cohort")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _copy(example: str, tmp_path, port_base=None, **knobs) -> str:
    """The port's example directory copied under ``tmp_path``, its YAML
    asking for the CPU (and ``knobs``, in a section of their own) and
    the gRPC ports from ``port_base``."""
    dst = tmp_path / example.replace("/", "_")
    shutil.copytree(os.path.join(PORT_EXAMPLES, example), dst)
    cfg = dst / "fedml_config.yaml"
    text = cfg.read_text()
    if port_base is not None:
        assert "grpc_port_base: 8890" in text
        text = text.replace("grpc_port_base: 8890", f"grpc_port_base: {port_base}")
    text += "\ndevice_args:\n  device_type: cpu\n"
    if knobs:
        text += "test_args:\n" + "".join(f"  {k}: {v!r}\n".replace("'", "") for k, v in knobs.items())
    cfg.write_text(text)
    return str(dst)


def _run(cmd, cwd, timeout=240):
    r = subprocess.run(cmd, cwd=cwd, env=_env(), capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, f"{cmd} failed:\n{r.stdout[-2000:]}\n{r.stderr[-3000:]}"
    return r.stdout


def _line(stdout: str, tag: str) -> list:
    """Every ``<tag> <dict>`` line of a run's output, parsed."""
    return [ast.literal_eval(line[len(tag):].strip()) for line in stdout.splitlines()
            if line.startswith(tag)]


def _finite(stats: dict) -> None:
    for k, v in stats.items():
        if isinstance(v, float):
            assert math.isfinite(v), (k, v)


def _close(got: dict, want: dict, keys=STAT_KEYS) -> None:
    for k in keys:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=RTOL, atol=ATOL, err_msg=k)


def _jax_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(b):
    return (np.asarray(b.x), np.asarray(b.y), np.asarray(b.mask))


def _carried(ds, params) -> dict:
    """A JAX federation and params in the harness's numpy form."""
    return {
        "dataset": {
            "train_data_num": ds.train_data_num, "test_data_num": ds.test_data_num,
            "train_data_global": _np(ds.train_data_global),
            "test_data_global": _np(ds.test_data_global),
            "train_data_local_num_dict": dict(ds.train_data_local_num_dict),
            "class_num": ds.class_num, "packed_train": _np(ds.packed_train),
            "packed_num_samples": np.asarray(ds.packed_num_samples),
            "packed_test": _np(ds.packed_test), "client_num": ds.client_num, "task": ds.task,
        },
        "params": {k: v.numpy() for k, v in
                   params_from_flax(jax.tree.map(np.asarray, params)).items()},
    }


def _write(carried: dict, tmp_path) -> str:
    path = str(tmp_path / "carried.pkl")
    with open(path, "wb") as fh:
        pickle.dump(carried, fh)
    return path


@pytest.fixture
def argv(monkeypatch):
    """The JAX package's entry points read ``--cf`` from ``sys.argv``."""
    def set_argv(*a):
        monkeypatch.setattr(sys, "argv", ["main.py", *a])
    return set_argv


# -- simulation --------------------------------------------------------------


def _jax_sp(cfg: str, argv, custom: bool):
    """The JAX example's run on ``cfg`` in this process: its final stats,
    and the federation and initial params it trained from."""
    argv("--cf", cfg)
    trainer = None
    if custom:
        mod = _jax_module(os.path.join(JAX_EXAMPLES, "simulation_sp", "custom", "main.py"),
                          "jax_example_sp_custom")
        trainer = mod.ClippedDeltaTrainer(model=None)
    stats = fedml_tpu.run_simulation(client_trainer=trainer)
    args = fedml_tpu.init(jax_load_arguments("simulation", "single_process"))
    ds = jax_load(args)
    init = JaxFedAvgAPI(args, None, ds, jax_models.create(args, ds.class_num)).global_params
    return stats, ds, init


@pytest.mark.parametrize("tier", ["one_line", "custom"])
def test_simulation_sp(tier, tmp_path, argv):
    """``python main.py --cf fedml_config.yaml``: the user's run within
    ``ACC_TOL`` of the JAX example's; the carried run (shuffle off in
    both) within ``RTOL``/``ATOL`` of it."""
    user = _copy(f"simulation_sp/{tier}", tmp_path)
    (final,) = _line(_run([sys.executable, "main.py", "--cf", "fedml_config.yaml"], user),
                     "FINAL:")
    _finite(final)
    want, _, _ = _jax_sp(os.path.join(user, "fedml_config.yaml"), argv, tier == "custom")
    assert final["round"] == want["round"] == 4
    for k in ("train_acc", "test_acc"):
        assert abs(final[k] - float(want[k])) <= ACC_TOL, (k, final[k], want[k])

    carried = _copy(f"simulation_sp/{tier}", tmp_path / "carried", shuffle=False)
    cfg = os.path.join(carried, "fedml_config.yaml")
    want, ds, init = _jax_sp(cfg, argv, tier == "custom")
    out = _run([sys.executable, HARNESS, _write(_carried(ds, init), tmp_path), "main.py",
                "--cf", "fedml_config.yaml"], carried)
    (final,) = _line(out, "FINAL:")
    assert final["round"] == want["round"]
    _close(final, want)


def _torchrun(d: str, n: int, timeout=240) -> list:
    """``torchrun --nproc_per_node n main.py --cf fedml_config.yaml`` in
    ``d`` (gloo on the CPU, as the YAML says); each rank's ``FINAL:``
    lines, read from its own stdout file (the ranks' prints interleave on
    one pipe)."""
    import glob

    logs = os.path.join(d, "torchrun_logs")
    _run([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(n),
          "--master_addr", "127.0.0.1", "--master_port", str(free_port_block(1)),
          "--redirects", "1", "--log-dir", logs, "main.py", "--cf", "fedml_config.yaml"],
         d, timeout=timeout)
    outs = sorted(glob.glob(os.path.join(logs, "*", "attempt_0", "*", "stdout.log")),
                  key=lambda p: int(p.split(os.sep)[-2]))
    assert len(outs) == n, outs
    return [_line(open(p).read(), "FINAL:") for p in outs]


def test_simulation_mesh_under_torchrun(tmp_path):
    """``torchrun --nproc_per_node 8 main.py``: the legacy mesh with every
    rank on ``clients`` (8, the cohort), gloo on the CPU; each rank prints
    the same final stats."""
    finals = [f for (f,) in _torchrun(_copy("simulation_mesh/one_line", tmp_path), 8)]
    untimed = [{k: v for k, v in f.items() if not k.endswith("_time_s")} for f in finals]
    assert all(u == untimed[0] for u in untimed)
    _finite(finals[0])
    assert finals[0]["round"] == 4 and finals[0]["test_acc"] >= 0.9


# -- cross silo ----------------------------------------------------------------


def _jax_cross_silo(cfg: str, tier: str, hierarchical: bool):
    """The JAX example's federation on ``cfg`` as a LOCAL world of threads
    in this process (the gRPC processes' protocol on the in-process
    fabric): the server's final evaluation, the federation and the
    initial params."""
    from fedml_tpu.cross_silo import Client, HierarchicalClient, Server

    trainer_cls = aggregator_cls = None
    if tier == "custom":
        base = os.path.join(JAX_EXAMPLES, "cross_silo", "custom")
        trainer_cls = _jax_module(os.path.join(base, "client.py"),
                                  "jax_example_cs_client").ClippedDeltaTrainer
        aggregator_cls = _jax_module(os.path.join(base, "server.py"),
                                     "jax_example_cs_server").CoordClipAggregator

    def make(rank):
        a = JaxArguments(argparse.Namespace(yaml_config_file=cfg, rank=rank),
                         "cross_silo", "LOCAL")
        a = fedml_tpu.init(a)
        ds = jax_load(a)
        return a, ds, jax_models.create(a, ds.class_num)

    a0, ds0, m0 = make(0)
    server = Server(a0, None, ds0, m0,
                    server_aggregator=aggregator_cls(model=None) if aggregator_cls else None)
    init = jax.tree.map(np.asarray, server.aggregator.get_global_model_params())
    client_cls = HierarchicalClient if hierarchical else Client
    clients = []
    for r in (1, 2):
        a, ds, m = make(r)
        clients.append(client_cls(a, None, ds, m, client_trainer=trainer_cls(model=None)
                                  if trainer_cls else None))
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    server.run()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    stats = server.aggregator.test_on_server_for_all_clients(int(a0.comm_round) - 1)
    return stats, ds0, init


def _grpc_world(d: str, cmd_prefix: list) -> str:
    """``bash run.sh``'s three processes: 2 silos, then the server; the
    server's output."""
    clients = [subprocess.Popen(cmd_prefix + ["client.py", "--cf", "fedml_config.yaml",
                                              "--rank", str(r)],
                                cwd=d, env=_env(), stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True)
               for r in (1, 2)]
    try:
        out = _run(cmd_prefix + ["server.py", "--cf", "fedml_config.yaml", "--rank", "0"], d)
        for c in clients:
            _, err = c.communicate(timeout=60)
            assert c.returncode == 0, err[-3000:]
    finally:
        for c in clients:
            if c.poll() is None:
                c.kill()
    return out


@pytest.mark.parametrize("example", ["cross_silo/one_line", "cross_silo/step_by_step",
                                     "cross_silo/custom", "cross_silo_hierarchical/one_line"])
def test_cross_silo_over_grpc(example, tmp_path):
    """A server and 2 silo processes over gRPC, as ``run.sh`` starts them,
    on the JAX example's federation and initial params (shuffle off in
    both): the server's last evaluation within ``RTOL``/``ATOL`` of the
    JAX example's world on the same YAML."""
    tier = example.split("/")[1]
    d = _copy(example, tmp_path, port_base=free_port_block(3), shuffle=False)
    want, ds, init = _jax_cross_silo(os.path.join(d, "fedml_config.yaml"), tier,
                                     example.startswith("cross_silo_hierarchical"))
    out = _grpc_world(d, [sys.executable, HARNESS, _write(_carried(ds, init), tmp_path)])
    (got,) = _line(out, "RESULT:")
    assert got["count"] == want["count"]
    _close(got, want, keys=("acc", "loss"))


# -- cross device ----------------------------------------------------------------


def test_cross_device_beehive_example(tmp_path):
    """The server and 3 simulated edge clients over the repo's own MQTT
    broker and a file payload store: the last round's evaluation."""
    d = _copy("cross_device/one_line", tmp_path)
    (final,) = _line(_run([sys.executable, "main.py", "--cf", "fedml_config.yaml"], d),
                     "FINAL:")
    _finite(final)
    assert final["round"] == 1 and final["count"] == 120 and 0.0 <= final["acc"] <= 1.0


# -- the 8-rank examples -------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("example", ["distributed/one_line", "distributed/step_by_step",
                                     "longcontext/one_line"])
def test_eight_rank_examples_under_torchrun(example, tmp_path):
    """The shipped YAML on 8 gloo ranks: every rank's last epoch's stats,
    finite. (The Shakespeare stand-in is 2,048 batches of 8 sequences in
    both packages, whatever ``synthetic_train_size`` says.)"""
    for (final,) in _torchrun(_copy(example, tmp_path), 8, timeout=2400):
        _finite(final)
        assert math.isfinite(final["train_loss"]) and final["epoch"] == 0
