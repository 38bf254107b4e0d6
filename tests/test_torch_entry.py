"""The port's front door against the JAX package's, on the CPU:

- C1: with no ``--cf``, ``load_arguments(training_type)`` (and so
  ``init()``) resolves the JAX package's shipped default config for each
  training type, the port's ``config/`` copies of it; the one stated
  exception is ``device_type`` (``"cuda"`` where the JAX table says
  ``"tpu"``);
- C2: each entry point pins ``training_type`` (and ``run_simulation``
  its ``backend``) over a YAML that names others, as the JAX one does;
  with ``args`` given, neither package overrides them; ``load_arguments
  ("cross_device")`` reads the command line in both; ``init`` sets the
  log level from ``verbose``; the device comes from ``device_type``
  unless ``device=`` is passed, and ``"tpu"`` raises naming the knob;
- C3: the JAX public names the port lacked, with the JAX behaviour.
"""

from __future__ import annotations

import logging
import sys
import time

import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import arguments as jax_arguments
from fedml_tpu import constants as jax_constants
from fedml_tpu.core import tracing as jax_tracing
from fedml_tpu.core import tracking as jax_tracking
from fedml_tpu.core import types as jax_types
from fedml_tpu.simulation import fedavg_api as jax_fedavg_api
from fedml_tpu_torch import arguments as port_arguments
from fedml_tpu_torch import constants as port_constants
from fedml_tpu_torch import device as port_device
from fedml_tpu_torch.core import frame as port_frame
from fedml_tpu_torch.core import tracing as port_tracing
from fedml_tpu_torch.core import tracking as port_tracking
from fedml_tpu_torch.core import types as port_types
from fedml_tpu_torch.simulation import fedavg_api as port_fedavg_api

TRAINING_TYPES = ("simulation", "cross_silo", "cross_device")
# keys the port declares for its silo process groups (test_torch_arguments.py)
PORT_ONLY_KEYS = {"distributed_coordinator", "n_proc_in_silo", "proc_rank_in_silo"}
DEFAULT_EXCEPTIONS = {"device_type": ("tpu", "cuda")}


@pytest.fixture
def argv(monkeypatch):
    def set_argv(*a):
        monkeypatch.setattr(sys, "argv", ["main.py", *a])
    set_argv()
    return set_argv


@pytest.fixture(autouse=True)
def _restore_globals_and_logging():
    """The entry points' pins and ``init``'s log level are process-wide.
    Each test starts both packages unpinned: an entry point that pins no
    backend keeps the one an earlier ``run_simulation`` left, and tests run
    before this file in the same process may have called either package's."""
    saved = [(m, getattr(m, "_global_training_type", None),
              getattr(m, "_global_comm_backend", None)) for m in (fedml_tpu, fedml_tpu_torch)]
    level = logging.getLogger().level
    for m in (fedml_tpu, fedml_tpu_torch):
        m._global_training_type, m._global_comm_backend = None, None
    yield
    for m, t, b in saved:
        m._global_training_type, m._global_comm_backend = t, b
    logging.getLogger().setLevel(level)
    jax_tracking.ProfilerEvent.reset()


def _differing(jax_table: dict, port_table: dict) -> dict:
    jax_table = {k: v for k, v in jax_table.items() if k != "yaml_config_file"}
    port_table = {k: v for k, v in port_table.items()
                  if k != "yaml_config_file" and k not in PORT_ONLY_KEYS}
    assert set(jax_table) == set(port_table)
    return {k: (jax_table[k], port_table[k]) for k in jax_table
            if jax_table[k] != port_table[k] or type(jax_table[k]) is not type(port_table[k])}


# -- C1 -------------------------------------------------------------------------


@pytest.mark.parametrize("training_type", TRAINING_TYPES)
def test_default_config_resolves_the_jax_table(training_type, argv):
    jax_a = jax_arguments.load_arguments(training_type)
    port_a = port_arguments.load_arguments(training_type)
    assert port_a.yaml_config_file.endswith(f"fedml_tpu_torch/config/{training_type}.yaml"
                                            if training_type != "simulation" else
                                            "fedml_tpu_torch/config/simulation_sp.yaml")
    assert _differing(jax_a.to_dict(), port_a.to_dict()) == DEFAULT_EXCEPTIONS
    assert port_a.training_type == training_type


def test_init_without_cf_trains_the_jax_default_federation(argv, monkeypatch):
    """``python main.py`` with nothing else: the table the JAX run resolves
    (mnist, 1000 clients, 200 rounds, batch 10, weight decay 0.001), on
    ``cuda``."""
    for m in (fedml_tpu, fedml_tpu_torch):
        monkeypatch.setattr(m, "_global_training_type", None, raising=False)
        monkeypatch.setattr(m, "_global_comm_backend", None, raising=False)
    keys = ("dataset", "client_num_in_total", "comm_round", "batch_size", "weight_decay",
            "training_type", "backend", "learning_rate", "frequency_of_the_test")
    jax_a, port_a = fedml_tpu.init(), fedml_tpu_torch.init()
    assert [getattr(port_a, k) for k in keys] == [getattr(jax_a, k) for k in keys]
    assert [getattr(port_a, k) for k in keys[:5]] == ["mnist", 1000, 200, 10, 0.001]
    assert (jax_a.device_type, port_a.device_type) == ("tpu", "cuda")


def test_shipped_configs_are_the_jax_files_but_for_the_device():
    import os

    for name in ("simulation_sp.yaml", "cross_silo.yaml", "cross_device.yaml"):
        with open(os.path.join(os.path.dirname(jax_arguments.__file__), "config", name)) as f:
            jax_lines = f.read().splitlines()
        with open(os.path.join(os.path.dirname(port_arguments.__file__), "config", name)) as f:
            port_lines = f.read().splitlines()
        changed = [(a, b) for a, b in zip(jax_lines, port_lines) if a != b]
        assert len(jax_lines) == len(port_lines), name
        if name == "simulation_sp.yaml":
            assert changed == [("  device_type: tpu", '  device_type: cuda  # the one change '
                                'from fedml_tpu/config: "tpu" there')]
        else:
            assert changed == [], name


# -- C2 -------------------------------------------------------------------------


class _Pinned(Exception):
    pass


def _captured(module, monkeypatch):
    """Patch ``module.init`` to stop the entry point with the args it
    resolved."""
    real = module.init

    def init(args=None, *rest):
        raise _Pinned(real(args, *rest))

    monkeypatch.setattr(module, "init", init)


def _pinned(module, entry: str, kwargs: dict):
    with pytest.raises(_Pinned) as got:
        getattr(module, entry)(**kwargs)
    a = got.value.args[0]
    return a.training_type, a.backend


ENTRIES = [
    ("run_simulation", {}),
    ("run_simulation", {"backend": "MESH"}),
    ("run_distributed", {}),
    ("run_cross_silo_server", {}),
    ("run_cross_silo_client", {}),
    ("run_hierarchical_cross_silo_server", {}),
    ("run_hierarchical_cross_silo_client", {}),
    ("run_edge_server", {}),
]


@pytest.mark.parametrize("entry, kwargs", ENTRIES,
                         ids=[f"{e}{'_' + k['backend'] if k else ''}" for e, k in ENTRIES])
def test_entry_points_pin_what_the_jax_ones_pin(entry, kwargs, argv, monkeypatch, tmp_path):
    cfg = tmp_path / "other.yaml"
    cfg.write_text("common_args: {training_type: cross_device, random_seed: 0}\n"
                   "comm_args: {backend: TRPC}\n")
    argv("--cf", str(cfg), "--rank", "1")
    for m in (fedml_tpu, fedml_tpu_torch):
        _captured(m, monkeypatch)
    assert _pinned(fedml_tpu_torch, entry, kwargs) == _pinned(fedml_tpu, entry, kwargs)


@pytest.mark.parametrize("entry", ["run_cross_silo_server", "run_cross_silo_client",
                                   "run_distributed", "run_edge_server"])
def test_given_args_are_not_pinned(entry, monkeypatch):
    """With ``args`` given, the JAX entry points take them as they are, a
    simulation's training type included, and so does the port (whose
    cross-silo entries refused it)."""
    got = []
    for m, arguments in ((fedml_tpu, jax_arguments), (fedml_tpu_torch, port_arguments)):
        _captured(m, monkeypatch)
        a = arguments.Arguments()
        a.backend = "LOCAL"
        with pytest.raises(_Pinned) as out:
            getattr(m, entry)(a)
        got.append((out.value.args[0].training_type, out.value.args[0].backend))
    assert got[0] == got[1] == ("simulation", "LOCAL")


def test_load_arguments_cross_device_in_both_packages(argv, tmp_path):
    """The JAX example's ``load_arguments("cross_device")``: the shipped
    default without ``--cf``, the YAML and ``--rank`` with them, and
    ``training_type`` pinned over the YAML's."""
    jax_a = jax_arguments.load_arguments("cross_device")
    port_a = port_arguments.load_arguments("cross_device")
    assert _differing(jax_a.to_dict(), port_a.to_dict()) == DEFAULT_EXCEPTIONS
    cfg = tmp_path / "c.yaml"
    cfg.write_text("common_args: {training_type: simulation, run_id: beehive}\n"
                   "train_args: {comm_round: 3, client_num_per_round: 2}\n")
    argv("--cf", str(cfg), "--rank", "2", "--role", "server")
    jax_a = jax_arguments.load_arguments("cross_device")
    port_a = port_arguments.load_arguments("cross_device")
    assert _differing(jax_a.to_dict(), port_a.to_dict()) == DEFAULT_EXCEPTIONS
    assert (port_a.training_type, port_a.rank, port_a.role, port_a.run_id, port_a.comm_round) \
        == ("cross_device", 2, "server", "beehive", 3)


@pytest.mark.parametrize("verbose", [True, False])
def test_init_sets_the_log_level_from_verbose(verbose):
    levels = []
    for m, arguments in ((fedml_tpu, jax_arguments), (fedml_tpu_torch, port_arguments)):
        logging.getLogger().setLevel(logging.WARNING)
        a = arguments.Arguments()
        a.verbose = verbose
        m.init(a)
        levels.append(logging.getLogger().level)
    assert levels[0] == levels[1] == (logging.DEBUG if verbose else logging.INFO)


SMALL = dict(dataset="mnist", synthetic_train_size=200, synthetic_test_size=40, model="lr",
             client_num_in_total=4, client_num_per_round=2, comm_round=1, batch_size=20,
             frequency_of_the_test=1)


def _small(**kw):
    a = port_arguments.Arguments()
    for k, v in dict(SMALL, **kw).items():
        setattr(a, k, v)
    a._validate()
    return a


def test_the_device_comes_from_device_type_unless_passed(monkeypatch):
    stats = fedml_tpu_torch.run_simulation(args=_small(device_type="cpu"))
    assert stats["round"] == 0 and np.isfinite(stats["test_loss"])
    with pytest.raises(ValueError, match="device_type 'tpu'.*device_args.device_type"):
        fedml_tpu_torch.run_simulation(args=_small(device_type="tpu"))
    assert fedml_tpu_torch.run_simulation(args=_small(device_type="tpu"),
                                          device="cpu")["round"] == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type: cpu"):
        fedml_tpu_torch.run_simulation(args=_small())


# -- C3 -------------------------------------------------------------------------


def test_top_level_names():
    for name in ("ClientTrainer", "DefaultClientTrainer", "ServerAggregator",
                 "DefaultServerAggregator"):
        assert getattr(fedml_tpu_torch, name) is getattr(port_frame, name)
        assert name in dir(fedml_tpu_torch) and name in dir(fedml_tpu)
    assert fedml_tpu_torch.load_arguments is port_arguments.load_arguments
    with pytest.raises(AttributeError):
        fedml_tpu_torch.NotAName  # noqa: B018


def test_device_names():
    a = _small(device_type="cpu")
    assert port_device.get_device(a) == torch.device("cpu")
    assert port_device.get_device("cpu") == torch.device("cpu")
    assert port_device.device_count("cpu") == 1 and port_device.topology("cpu") == ["cpu"]
    assert port_device.device_count() == torch.cuda.device_count()
    assert port_device.topology() == [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    with pytest.raises(ValueError, match="device_args.device_type"):
        port_device.get_device(_small(device_type="tpu"))


def test_constants():
    for name in ("FED_OPTIMIZER_FEDAVG", "FED_OPTIMIZER_FEDOPT", "FED_OPTIMIZER_FEDPROX",
                 "FED_OPTIMIZER_FEDNOVA", "PARTITION_HOMO", "PARTITION_HETERO",
                 "PARTITION_HETERO_FIX"):
        assert getattr(port_constants, name) == getattr(jax_constants, name), name


def test_get_algorithms():
    port = port_fedavg_api.get_algorithms()
    assert sorted(port) == sorted(jax_fedavg_api.get_algorithms())
    assert port is port_fedavg_api.get_algorithms()
    assert port["FedAvg"] is port_fedavg_api.FedAvgAPI


def test_profiler_event_singleton_and_summary(monkeypatch):
    """The same spans on a fake clock: the same ``summary()``; the
    singleton adopts a later caller's args and ``reset`` drops it."""
    clock = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    summaries = []
    for tracking in (jax_tracking, port_tracking):
        tracking.ProfilerEvent.reset()
        ev = tracking.ProfilerEvent.get_instance()
        assert ev.args is None and tracking.ProfilerEvent.get_instance() is ev

        class A:
            run_id = "r7"

        assert tracking.ProfilerEvent.get_instance(A()).run_id == "r7"
        for name in ("train", "comm", "train", "aggregate"):
            ev.log_event_started(name)
            ev.log_event_ended(name)
        ev.log_event_ended("never_started")
        summaries.append(ev.summary())
        tracking.ProfilerEvent.reset()
        assert tracking.ProfilerEvent.get_instance() is not ev
    assert summaries[0] == summaries[1]
    assert summaries[1]["train"] == {"total_s": 0.5, "count": 2}


@pytest.mark.parametrize("rounds, telemetry", [([1, 2], True), ([1], False), (None, True)])
def test_round_profiler_enabled(rounds, telemetry, tmp_path):
    class A:
        profile_rounds = rounds
        telemetry_dir = str(tmp_path) if telemetry else None

    jax_p = jax_tracing.RoundProfiler(A())
    port_p = port_tracing.RoundProfiler(A(), "cpu")
    assert port_p.enabled == jax_p.enabled == bool(rounds and telemetry)


def test_client_dataset():
    x = np.zeros((2, 3, 4), np.float32)
    y = np.zeros((2, 3), np.int64)
    m = np.ones((2, 3), np.float32)
    jb = jax_types.Batches(x=x, y=y, mask=m)
    pb = port_types.Batches(x=torch.tensor(x), y=torch.tensor(y), mask=torch.tensor(m))
    jd, pd = jax_types.ClientDataset(train=jb), port_types.ClientDataset(train=pb)
    assert jd.test is None and pd.test is None and pd.train is pb
    assert [f.name for f in __import__("dataclasses").fields(pd)] == ["train", "test"]
    assert port_types.ClientDataset(train=pb, test=pb).test is pb
