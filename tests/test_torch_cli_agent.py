"""The port's CLI subcommands and edge agent (``fedml_tpu_torch/cli.py``,
``edge_agent.py``) against the JAX package's.

- ``device --dry-run`` and ``edge --dry-run`` print the JAX commands'
  status JSON on the same config;
- ``version``, ``build``, ``login --no-daemon`` and ``logout`` behave as
  ``tests/test_cli_observability.py`` holds the JAX CLI to, with the
  home directory in a tmp dir;
- ``EdgeAgent`` starts a built package on a start publish (its config
  rewritten), publishes STARTING -> RUNNING, is stopped by a stop
  publish, and reaps a stale recorded run on restart;
- ``trace``, ``check``, ``lint``, ``audit`` and ``perf`` raise and name
  what they wait for;
- ``cli device`` runs a small Beehive world on the CPU.
"""

from __future__ import annotations

import json
import os
import time
import zipfile

import pytest
import torch
import yaml

from fedml_tpu_torch.cli import main as cli_main
from fedml_tpu_torch.core.comm.broker import Broker, BrokerClient
from fedml_tpu_torch.edge_agent import EdgeAgent, run_edge
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

HIER = "\n".join([
    "train_args:",
    "  training_type: cross_silo",
    "  client_num_in_total: 4",
    "  client_num_per_round: 4",
    "  comm_round: 1",
    "hier_args:",
    "  edge_plane: ranks",
    "  edge_num: 2",
    "data_args:",
    "  dataset: mnist",
    "  synthetic_train_size: 80",
    "  synthetic_test_size: 20",
    "model_args:",
    "  model: lr",
])
BEEHIVE = "\n".join([
    "common_args: {training_type: simulation, random_seed: 0}",
    "train_args: {client_registry_size: 3000, crossdevice_cohort: 24, comm_round: 2}",
    "comm_args: {crossdevice_fold_target_frac: 0.5, crossdevice_secure_agg: false}",
])


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("config", [None, "beehive"])
def test_device_dry_run_equals_jax(config, tmp_path, capsys):
    from fedml_tpu.cli import main as jax_cli

    argv = ["device", "--dry-run"]
    if config:
        cf = tmp_path / "b.yaml"
        cf.write_text(BEEHIVE)
        argv += ["--cf", str(cf), "--feature-dim", "6", "--output-dim", "3"]
    assert jax_cli(argv) == 0
    want = _last_json(capsys.readouterr().out)
    assert cli_main(argv + ["--device", "cpu"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert got == want
    assert got["plane"] == "crossdevice" and got["update_dim"] == (
        6 * 3 + 3 if config else 8 * 4 + 4)


@pytest.mark.parametrize("rank", [1, 2])
def test_edge_dry_run_equals_jax(rank, tmp_path, capsys):
    from fedml_tpu.cli import main as jax_cli

    cf = tmp_path / "hier.yaml"
    cf.write_text(HIER)
    argv = ["edge", "--rank", str(rank), "--cf", str(cf), "--dry-run"]
    assert jax_cli(argv) == 0
    want = _last_json(capsys.readouterr().out)
    assert cli_main(argv + ["--device", "cpu"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert got == want
    assert got["edge_rank"] == rank and len(got["clients"]) == 2
    assert got["fabric"].endswith(f"_edge{rank}")


def test_edge_refuses_a_root_rank_and_inproc(tmp_path):
    from fedml_tpu_torch.arguments import load_yaml_arguments

    cf = tmp_path / "hier.yaml"
    cf.write_text(HIER)
    a = load_yaml_arguments(str(cf))
    a.rank = 0
    with pytest.raises(ValueError, match="0 is the root"):
        run_edge(a, dry_run=True, device="cpu")
    a.rank, a.edge_plane = 1, "inproc"
    with pytest.raises(ValueError, match="edge_plane: ranks"):
        run_edge(a, dry_run=True, device="cpu")


def test_cli_device_runs_a_world_on_the_cpu(tmp_path, capsys):
    from fedml_tpu_torch.core.chaos import reset_chaos
    from fedml_tpu_torch.core.telemetry import Telemetry

    cf = tmp_path / "b.yaml"
    cf.write_text(BEEHIVE + f"\ntracking_args: {{checkpoint_dir: {tmp_path / 'ck'}}}\n")
    Telemetry.reset()
    reset_chaos()
    assert cli_main(["device", "--cf", str(cf), "--device", "cpu", "--run-id", "cli-dev"]) == 0
    out = _last_json(capsys.readouterr().out)
    assert len(out["round_records"]) == 2
    assert all(r["close_reason"] == "target" for r in out["round_records"])
    assert out["trace_count"] >= 1


def test_device_and_edge_need_a_card_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["device", "--dry-run"])
    cf = tmp_path / "hier.yaml"
    cf.write_text(HIER)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["edge", "--rank", "1", "--cf", str(cf), "--dry-run"])


@pytest.mark.parametrize("command, item", [
    ("trace", "telemetry exporters"), ("check", "core/invariants.py"),
    ("lint", "analysis planes"), ("audit", "analysis planes"), ("perf", "analysis planes"),
])
def test_refused_subcommands_name_their_item(command, item, tmp_path):
    """Every subcommand of the analysis planes and the exporters is
    ported and answers a usage error with the JAX package's exit code 2:
    ``trace`` and ``check`` a missing directory, ``perf`` a missing
    directory and a call without a mode, ``lint`` and ``audit`` a
    contradictory gate request. No subcommand refuses any more."""
    if command in ("trace", "check", "perf"):
        assert cli_main([command, "--telemetry-dir", str(tmp_path / "x")]) == 2
        if command == "perf":
            assert cli_main([command]) == 2
        return
    assert cli_main([command, "--ci", "--update-baseline"]) == 2


# -- tests/test_cli_observability.py's CLI and agent, on the port -------------

class TestCLI:
    def test_version(self, capsys):
        from fedml_tpu_torch import __version__

        assert cli_main(["version"]) == 0
        assert capsys.readouterr().out.strip() == f"fedml_tpu_torch version {__version__}"

    def test_build_packages_source_and_manifest(self, tmp_path):
        src = tmp_path / "src"
        src.mkdir()
        (src / "main.py").write_text("print('train')\n")
        (src / "util.py").write_text("X = 1\n")
        cfg = tmp_path / "cfg"
        cfg.mkdir()
        (cfg / "fedml_config.yaml").write_text("train_args: {}\n")
        dest = tmp_path / "dist"
        rc = cli_main(["build", "-t", "client", "-sf", str(src), "-ep", "main.py",
                       "-cf", str(cfg), "-df", str(dest)])
        assert rc == 0
        with zipfile.ZipFile(dest / "fedml_client_package.zip") as z:
            names = set(z.namelist())
            assert {"main.py", "util.py", "MANIFEST.json"} <= names
            assert "config/fedml_config.yaml" in names
            manifest = json.loads(z.read("MANIFEST.json"))
            assert manifest["type"] == "client" and manifest["entry"] == "main.py"

    def test_build_rejects_missing_entry(self, tmp_path):
        src = tmp_path / "src"
        src.mkdir()
        assert cli_main(["build", "-t", "server", "-sf", str(src), "-ep", "no.py"]) == 2
        assert cli_main(["build", "-t", "server", "-sf", str(tmp_path / "none"),
                         "-ep", "no.py"]) == 2

    def test_login_logout_no_daemon(self, tmp_path, monkeypatch):
        monkeypatch.setenv("FEDML_TPU_HOME", str(tmp_path))
        assert cli_main(["login", "acct42", "--no-daemon"]) == 0
        with open(tmp_path / "account.json") as f:
            assert json.load(f)["account_id"] == "acct42"
        (tmp_path / "edge_agent.pid").write_text("not-a-pid")
        assert cli_main(["logout"]) == 0
        assert not (tmp_path / "account.json").exists()
        assert not (tmp_path / "edge_agent.pid").exists()


def _package(tmp_path, body: str, config: str = None):
    src = tmp_path / "src"
    src.mkdir()
    (src / "main.py").write_text(body)
    argv = ["build", "-t", "client", "-sf", str(src), "-ep", "main.py",
            "-df", str(tmp_path / "dist")]
    if config is not None:
        cfg = tmp_path / "cfg"
        cfg.mkdir()
        (cfg / "fedml_config.yaml").write_text(config)
        argv += ["-cf", str(cfg)]
    assert cli_main(argv) == 0
    return tmp_path / "dist" / "fedml_client_package.zip"


def _wait(cond, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.05)
    return cond()


class TestEdgeAgent:
    def test_config_rewrite_status_and_orphan_reaping(self, tmp_path):
        seen_cfg = tmp_path / "seen_config.yaml"
        pkg = _package(
            tmp_path,
            "import argparse, shutil, time\n"
            "p = argparse.ArgumentParser()\n"
            "p.add_argument('--cf')\n"
            f"shutil.copy(p.parse_args().cf, {str(seen_cfg)!r})\n"
            "time.sleep(120)\n",
            "common_args: {run_id: '${FEDSYS.RUN_ID}'}\n"
            "data_args: {data_cache_dir: '${FEDSYS.DATA_CACHE_DIR}'}\n"
            "train_args: {client_id_list: '${FEDSYS.CLIENT_ID_LIST}',\n"
            "             learning_rate: 0.5}\n",
        )
        broker = Broker()
        state_dir = str(tmp_path / "agent_state")
        agent = EdgeAgent("acctY", broker.host, broker.port, state_dir=state_dir)
        sub = BrokerClient(broker.host, broker.port)
        statuses = []
        sub.subscribe(agent.status_topic("9"), lambda _t, p: statuses.append(json.loads(p)))
        pub = BrokerClient(broker.host, broker.port)
        time.sleep(0.05)
        pub.publish(agent.topic("start"), json.dumps({
            "run_id": "9", "package_path": str(pkg), "client_id_list": [3, 7],
            "config_overrides": {"train_args": {"learning_rate": 0.9}},
        }).encode())
        assert _wait(seen_cfg.exists, 20), "the rewritten config never reached the entry"
        got = yaml.safe_load(seen_cfg.read_text())
        assert got["common_args"]["run_id"] == "9"
        assert os.path.isdir(got["data_args"]["data_cache_dir"])
        assert json.loads(got["train_args"]["client_id_list"]) == [3, 7]
        assert got["train_args"]["learning_rate"] == 0.9  # the override won
        assert _wait(lambda: len(statuses) >= 2, 10)
        assert [s["status"] for s in statuses[:2]] == ["STARTING", "RUNNING"]
        assert all(s["edge_id"] == "acctY" for s in statuses)

        orphan = agent.runs["9"]
        agent.shutdown(reap=False)  # a crashed agent: its child survives
        assert orphan.poll() is None
        with open(os.path.join(state_dir, "runs.json")) as f:
            assert "9" in json.load(f)

        agent2 = EdgeAgent("acctY", broker.host, broker.port, state_dir=state_dir)
        assert _wait(lambda: orphan.poll() is not None, 10), "orphan not reaped on restart"
        with open(os.path.join(state_dir, "runs.json")) as f:
            assert json.load(f) == {}
        assert _wait(lambda: statuses[-1]["status"] == "KILLED", 10)
        assert statuses[-1]["reason"] == "stale"
        agent2.shutdown()
        sub.close()
        pub.close()
        broker.stop()

    def test_start_finish_and_stop_run(self, tmp_path):
        marker = tmp_path / "started.txt"
        pkg = _package(tmp_path, "import sys, time\n"
                                 f"open({str(marker)!r}, 'w').write('ok')\n"
                                 "time.sleep(0.5 if '--quick' in sys.argv else 60)\n")
        broker = Broker()
        agent = EdgeAgent("acctX", broker.host, broker.port,
                          state_dir=str(tmp_path / "agent_state"))
        sub = BrokerClient(broker.host, broker.port)
        statuses = {"7": [], "8": []}
        for rid in statuses:
            sub.subscribe(agent.status_topic(rid),
                          lambda _t, p, rid=rid: statuses[rid].append(json.loads(p)["status"]))
        pub = BrokerClient(broker.host, broker.port)
        time.sleep(0.05)
        # a run that exits on its own: STARTING -> RUNNING -> FINISHED
        pub.publish(agent.topic("start"), json.dumps(
            {"run_id": "8", "package_path": str(pkg), "args": {"quick": 1}}).encode())
        assert _wait(lambda: statuses["8"][-1:] == ["FINISHED"], 20), statuses["8"]
        assert statuses["8"] == ["STARTING", "RUNNING", "FINISHED"]
        marker.unlink()
        # a run stopped by a stop publish
        pub.publish(agent.topic("start"),
                    json.dumps({"run_id": "7", "package_path": str(pkg)}).encode())
        assert _wait(marker.exists, 20), "the run's entry never started"
        proc = agent.runs["7"]
        pub.publish(agent.topic("stop"), json.dumps({"run_id": "7"}).encode())
        assert _wait(lambda: proc.poll() is not None, 10), "the run was not terminated"
        assert _wait(lambda: statuses["7"][-1:] == ["KILLED"], 20), statuses["7"]
        assert statuses["7"][:2] == ["STARTING", "RUNNING"] and "STOPPING" in statuses["7"]
        agent.shutdown()
        sub.close()
        pub.close()
        broker.stop()
