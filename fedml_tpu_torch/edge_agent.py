"""Edge-agent daemon, the reference's ``FedMLClientRunner`` (port of
``fedml_tpu/edge_agent.py``).

Reference: ``cli/edge_deployment/login.py:31-460``: a daemon that
subscribes to start/stop topics for its account, unpacks the run
package, rewrites the packaged config for the local machine
(``update_local_fedml_config`` :139-210, the ``${FEDSYS.*}`` variables),
spawns the training process, reports each run's status upstream
(``report_client_training_status``), and reaps stale run processes
recorded in its state files on restart (``cleanup_edge_run_process``
:372-441).

Here the same lifecycle runs over the port's broker
(``core/comm/broker.py``):

- Topics: ``fedml_agent_{account}_start`` / ``..._stop``; the start
  payload is a JSON ``{"run_id", "package_path", "args": {...},
  "config_overrides": {...}}`` naming a zip made by ``cli build``.
- Config rewrite: a package's ``config/*.yaml`` gets ``${FEDSYS.RUN_ID}``
  / ``${FEDSYS.RUN_DIR}`` / ``${FEDSYS.DATA_CACHE_DIR}`` /
  ``${FEDSYS.LOG_FILE_DIR}`` / ``${FEDSYS.CLIENT_ID_LIST}`` replaced by
  this run's local values and the request's ``config_overrides`` on top,
  is written into the run dir, and the entry runs with ``--cf
  <rewritten>``. A package without a config gets plain ``--key value``
  arguments.
- Status: every transition publishes ``{"run_id", "edge_id", "status",
  "ts"}`` on ``fedml_run_{run_id}_status_{account}`` (STARTING ->
  RUNNING -> FINISHED/FAILED/KILLED); a monitor thread notices runs that
  exit on their own.
- Stale runs: spawned pids and workdirs persist in
  ``{state_dir}/runs.json``; a restarted agent SIGTERMs recorded pids
  that are still alive (guarded by a command-line match, so a recycled
  pid is never killed), publishes KILLED for them and clears the record.

``run_edge`` launches one edge aggregator rank of the hierarchical
server plane (``cli edge``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import zipfile
from typing import Dict, Optional

from .core.comm.broker import BrokerClient, ensure_broker
from .device import DeviceLike, get_device

RUN_STATUS_STARTING = "STARTING"
RUN_STATUS_RUNNING = "RUNNING"
RUN_STATUS_STOPPING = "STOPPING"
RUN_STATUS_FINISHED = "FINISHED"
RUN_STATUS_FAILED = "FAILED"
RUN_STATUS_KILLED = "KILLED"

_FEDSYS_KEYS = (
    "RUN_ID",
    "RUN_DIR",
    "DATA_CACHE_DIR",
    "LOG_FILE_DIR",
    "CLIENT_ID_LIST",
)


def _pid_alive(pid: int, expect_cmdline: Optional[str] = None) -> bool:
    """Is pid alive (and, when known, still the process we spawned)?
    The cmdline guard keeps a recycled pid from being reaped."""
    try:
        os.kill(pid, 0)
    except (OSError, ProcessLookupError):
        return False
    if expect_cmdline:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmdline = f.read().replace(b"\0", b" ").decode(errors="replace")
            return expect_cmdline in cmdline
        except OSError:
            # no /proc (non-linux): alive is the best answer we have
            return True
    return True


class EdgeAgent:
    def __init__(
        self,
        account_id: str,
        broker_host: str,
        broker_port: int,
        state_dir: Optional[str] = None,
    ) -> None:
        self.account_id = str(account_id)
        self.state_dir = state_dir or os.path.join(
            os.path.expanduser("~"), ".fedml_tpu_torch", f"agent_{self.account_id}"
        )
        os.makedirs(self.state_dir, exist_ok=True)
        host, port = ensure_broker(broker_host, broker_port)
        self.client = BrokerClient(host, port)
        self.runs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        # reap BEFORE subscribing: a new start request must never race
        # an orphan from the previous agent incarnation (login.py:372)
        self._reap_stale_runs()
        self.client.subscribe(self.topic("start"), self._on_start)
        self.client.subscribe(self.topic("stop"), self._on_stop)
        self._monitor = threading.Thread(target=self._watch_runs, daemon=True)
        self._monitor.start()
        logging.info(
            "edge agent %s listening on %s:%s (state: %s)",
            self.account_id, host, port, self.state_dir,
        )

    def topic(self, verb: str) -> str:
        return f"fedml_agent_{self.account_id}_{verb}"

    def status_topic(self, run_id: str) -> str:
        return f"fedml_run_{run_id}_status_{self.account_id}"

    # -- status reporting (report_client_training_status analog) ------
    def _publish_status(self, run_id: str, status: str, **extra) -> None:
        payload = {
            "run_id": run_id,
            "edge_id": self.account_id,
            "status": status,
            "ts": time.time(),
            **extra,
        }
        try:
            self.client.publish(
                self.status_topic(run_id), json.dumps(payload).encode("utf-8")
            )
        except Exception:  # noqa: BLE001 — status must never kill the run
            logging.exception("status publish failed for run %s", run_id)

    # -- persistent run registry (save/cleanup_edge_run_process) -------
    def _registry_path(self) -> str:
        return os.path.join(self.state_dir, "runs.json")

    def _load_registry(self) -> dict:
        try:
            with open(self._registry_path()) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}

    def _save_registry(self, reg: dict) -> None:
        tmp = self._registry_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(reg, f)
        os.replace(tmp, self._registry_path())

    def _record_run(self, run_id: str, proc: subprocess.Popen, workdir: str) -> None:
        reg = self._load_registry()
        reg[run_id] = {
            "pid": proc.pid,
            "workdir": workdir,
            "cmd_marker": workdir,  # workdir appears in the entry path
            "started_at": time.time(),
        }
        self._save_registry(reg)

    def _forget_run(self, run_id: str) -> None:
        reg = self._load_registry()
        if reg.pop(run_id, None) is not None:
            self._save_registry(reg)

    def _reap_stale_runs(self) -> None:
        """Kill run processes that outlived a previous agent. A record
        is dropped only once its process is confirmed dead — a child
        that survives SIGTERM+SIGKILL stays registered so the NEXT
        incarnation tries again (same invariant as the stop path)."""
        reg = self._load_registry()
        survivors = {}
        for run_id, rec in reg.items():
            pid = int(rec.get("pid", -1))
            marker = rec.get("cmd_marker")
            if pid <= 0 or not _pid_alive(pid, marker):
                continue  # already gone: drop the record
            for sig, grace_s in ((signal.SIGTERM, 5.0), (signal.SIGKILL, 2.0)):
                try:
                    os.kill(pid, sig)
                except OSError:
                    break
                deadline = time.time() + grace_s
                while time.time() < deadline and _pid_alive(pid, marker):
                    time.sleep(0.1)
                if not _pid_alive(pid, marker):
                    break
            if _pid_alive(pid, marker):
                logging.warning(
                    "stale run %s (pid %d) survived SIGKILL; keeping record",
                    run_id, pid,
                )
                survivors[run_id] = rec
            else:
                logging.info(
                    "reaped stale run %s (pid %d from previous agent)",
                    run_id, pid,
                )
                self._publish_status(run_id, RUN_STATUS_KILLED, reason="stale")
        if reg != survivors:
            self._save_registry(survivors)

    # -- config rewrite (update_local_fedml_config analog) -------------
    def _rewrite_config(self, workdir: str, run_id: str, req: dict) -> Optional[str]:
        """Substitute ${FEDSYS.*} variables in the packaged yaml with
        this run's local values, apply request overrides, write the
        result into the run dir. Returns the rewritten path or None
        when the package carries no config."""
        cfg_dir = os.path.join(workdir, "config")
        if not os.path.isdir(cfg_dir):
            return None
        yamls = sorted(
            n for n in os.listdir(cfg_dir) if n.endswith((".yaml", ".yml"))
        )
        if not yamls:
            return None
        import yaml

        src = os.path.join(cfg_dir, yamls[0])
        data_dir = os.path.join(workdir, "fedml_data")
        log_dir = os.path.join(workdir, "fedml_logs")
        os.makedirs(data_dir, exist_ok=True)
        os.makedirs(log_dir, exist_ok=True)
        fedsys = {
            "${FEDSYS.RUN_ID}": run_id,
            "${FEDSYS.RUN_DIR}": workdir,
            "${FEDSYS.DATA_CACHE_DIR}": data_dir,
            "${FEDSYS.LOG_FILE_DIR}": log_dir,
            "${FEDSYS.CLIENT_ID_LIST}": json.dumps(
                req.get("client_id_list") or []
            ),
        }

        def _sub(v):
            if isinstance(v, str):
                for key, val in fedsys.items():
                    v = v.replace(key, str(val))
            elif isinstance(v, dict):
                v = {k: _sub(x) for k, x in v.items()}
            elif isinstance(v, list):
                v = [_sub(x) for x in v]
            return v

        with open(src) as f:
            cfg = yaml.safe_load(f) or {}
        cfg = _sub(cfg)
        # request overrides land on top, sectioned or flat — the server
        # owns run-time truth (reference: dynamic_args merge)
        for k, v in (req.get("config_overrides") or {}).items():
            if isinstance(v, dict) and isinstance(cfg.get(k), dict):
                cfg[k].update(v)
            else:
                cfg[k] = v
        out = os.path.join(workdir, "fedml_config_rewritten.yaml")
        with open(out, "w") as f:
            yaml.safe_dump(cfg, f)
        return out

    # -- start: unpack package, rewrite config, spawn entry ------------
    def _on_start(self, _topic: str, payload: bytes) -> None:
        run_id = "?"
        try:
            req = json.loads(payload.decode("utf-8"))
            run_id = str(req["run_id"])
            with self._lock:
                existing = self.runs.get(run_id)
                if existing is not None and existing.poll() is None:
                    # broker redelivery / server retry: the run is live —
                    # spawning again would orphan the first process
                    logging.info("run %s already running; duplicate start ignored", run_id)
                    return
            self._publish_status(run_id, RUN_STATUS_STARTING)
            workdir = tempfile.mkdtemp(prefix=f"fedml_run_{run_id}_")
            with zipfile.ZipFile(req["package_path"]) as z:
                z.extractall(workdir)
            with open(os.path.join(workdir, "MANIFEST.json")) as f:
                manifest = json.load(f)
            cmd = [sys.executable, os.path.join(workdir, manifest["entry"])]
            conf = self._rewrite_config(workdir, run_id, req)
            if conf is not None:
                cmd += ["--cf", conf]
            for k, v in (req.get("args") or {}).items():
                cmd += [f"--{k}", str(v)]
            proc = subprocess.Popen(cmd, cwd=workdir)
            # register + RUNNING under the lock: the monitor must not be
            # able to reap a fast-crashing child (publishing FAILED)
            # before the registry record and RUNNING status exist —
            # that ordering would leave a stale record and a status
            # stream reading terminal-then-live
            with self._lock:
                self.runs[run_id] = proc
                self._record_run(run_id, proc, workdir)
                self._publish_status(run_id, RUN_STATUS_RUNNING, pid=proc.pid)
            logging.info("run %s started (pid %d): %s", run_id, proc.pid, cmd)
        except Exception as e:  # noqa: BLE001
            logging.exception("start request failed")
            self._publish_status(run_id, RUN_STATUS_FAILED, reason=str(e))

    # -- stop: kill the run's process ----------------------------------
    def _on_stop(self, _topic: str, payload: bytes) -> None:
        try:
            run_id = str(json.loads(payload.decode("utf-8"))["run_id"])
            with self._lock:
                proc = self.runs.pop(run_id, None)
            if proc is None:
                # unknown/already-finished run: nothing to stop, and a
                # spurious terminal status on its topic would lie
                logging.info("stop for unknown run %s ignored", run_id)
                return
            if proc.poll() is not None:
                # crashed/completed in the monitor's poll window: report
                # what actually happened, not FINISHED-because-stopped
                self._forget_run(run_id)
                status = (
                    RUN_STATUS_FINISHED if proc.returncode == 0 else RUN_STATUS_FAILED
                )
                self._publish_status(run_id, status, returncode=proc.returncode)
                return
            self._publish_status(run_id, RUN_STATUS_STOPPING)
            proc.terminate()
            # escalation + confirmation happen OFF the broker's single
            # callback thread (a SIGTERM-ignoring child would otherwise
            # stall every other start/stop for up to 20s). The registry
            # record survives until the child is confirmed dead — a
            # kill-proof child must stay reapable by the next agent.
            threading.Thread(
                target=self._confirm_stop, args=(run_id, proc), daemon=True
            ).start()
        except Exception:
            logging.exception("stop request failed")

    def _confirm_stop(self, run_id: str, proc: subprocess.Popen) -> None:
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                logging.warning(
                    "run %s survived SIGKILL; record kept for reaping", run_id
                )
                return
        self._forget_run(run_id)
        self._publish_status(run_id, RUN_STATUS_KILLED, returncode=proc.returncode)
        logging.info("run %s stopped", run_id)

    # -- monitor: notice runs that exit on their own -------------------
    def _watch_runs(self) -> None:
        while not self._stopped.wait(0.2):
            with self._lock:
                done = [
                    (rid, p) for rid, p in self.runs.items()
                    if p.poll() is not None
                ]
                for rid, _ in done:
                    self.runs.pop(rid, None)
            for rid, p in done:
                self._forget_run(rid)
                status = (
                    RUN_STATUS_FINISHED if p.returncode == 0 else RUN_STATUS_FAILED
                )
                self._publish_status(rid, status, returncode=p.returncode)
                logging.info("run %s exited rc=%s", rid, p.returncode)

    def wait(self) -> None:
        self._stopped.wait()

    def shutdown(self, reap: bool = True) -> None:
        """Terminate children and exit. ``reap=False`` models an agent
        crash: children keep running and stay in the registry so the
        next incarnation's _reap_stale_runs can find them."""
        self._stopped.set()
        if reap:
            with self._lock:
                for run_id, proc in self.runs.items():
                    if proc.poll() is None:
                        proc.terminate()
                        self._publish_status(run_id, RUN_STATUS_KILLED)
                    self._forget_run(run_id)
                self.runs.clear()
        self.client.close()


def run_edge(args, dry_run: bool = False, output_dim: int = 10,
             device: DeviceLike = "cuda") -> int:
    """Launch one edge aggregator rank of the hierarchical server plane
    (``cli edge --rank N --cf ...``, docs/hierarchical.md).

    ``args`` is a validated federation ``Arguments`` with
    ``edge_plane=ranks``; ``args.rank`` is this edge's rank (1..E) on the
    root fabric. Builds the model and the client partition on ``device``,
    constructs the ``HierEdge`` facade and blocks in its receive loops.
    ``dry_run`` builds everything that binds no transport, prints one
    status JSON line and returns."""
    from . import models
    from .cross_silo.hierarchical import (
        HierEdge,
        edge_clients,
        edge_fabric_run_id,
        hier_partition,
    )
    from .data import load

    if str(getattr(args, "edge_plane", "inproc")) != "ranks":
        raise ValueError(
            "fedml-tpu edge launches the hierarchical server plane; set "
            "edge_plane: ranks (and edge_num) in the config"
        )
    edge_rank = int(getattr(args, "rank", 0))
    if edge_rank < 1 or edge_rank > int(args.edge_num):
        raise ValueError(
            f"--rank {edge_rank}: an edge rank is 1..edge_num "
            f"(= {args.edge_num}); 0 is the root"
        )
    dev = get_device(device)
    dataset = load(args, device=dev)
    model = models.create(
        args, dataset.class_num if dataset is not None else int(output_dim), device=dev
    )
    partition = hier_partition(args, dataset)
    mine = edge_clients(partition).get(edge_rank, [])
    status = {
        "edge_rank": edge_rank,
        "edge_num": int(args.edge_num),
        "clients": mine,
        "fabric": edge_fabric_run_id(getattr(args, "run_id", "0"), edge_rank),
        "backend": str(getattr(args, "backend", "LOCAL")),
        "model": model.name,
        "agg_mode": str(getattr(args, "agg_mode", "stream")),
    }
    if dry_run:
        print(json.dumps(status))
        return 0
    logging.info("edge agent: starting edge rank %d (%s)", edge_rank, status)
    HierEdge(args, dev, dataset, model, partition=partition).run()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fedml_tpu_torch.edge_agent")
    p.add_argument("--account-id", required=True)
    p.add_argument("--broker-host", default="127.0.0.1")
    p.add_argument("--broker-port", type=int, default=18830)
    p.add_argument("--state-dir", default=None)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    agent = EdgeAgent(
        args.account_id, args.broker_host, args.broker_port, args.state_dir
    )
    signal.signal(signal.SIGTERM, lambda *_: agent.shutdown())
    agent.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
