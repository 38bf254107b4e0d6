"""Command-line interface of the port (of ``fedml_tpu/cli.py``).

Parity with the reference's ``python/fedml/cli/cli.py`` (``fedml
version/login/logout/build``, :17-250), on argparse:

- ``version``: print the package version.
- ``login``: persist the account binding and start the edge-agent daemon
  (``python -m fedml_tpu_torch.edge_agent``; the reference spawns
  ``FedMLClientRunner``, cli/cli.py:27-43 -> edge_deployment/login.py:31).
- ``logout``: stop the daemon and clear the binding (cli/cli.py:131).
- ``build``: package user training code into a client/server zip (the
  user's source, the entry point and a manifest the edge agent runs).
- ``serve``: stand up the serving plane for the federated global model:
  the model from the YAML config (``--cf``), the newest restorable
  checkpoint of ``--checkpoint-dir`` (a corrupt latest falls back to the
  previous one), a fleet of ``--fleet-size`` micro-batching engines
  behind one load-aware frontend on the card, and weights hot-swapped as
  the trainer publishes new rounds. ``--mesh DxF`` serves every endpoint
  over a named (data, fsdp) mesh of a ``torch.distributed`` world of D·F
  ranks (the caller's process group, or one from ``torchrun``'s
  environment; on one card, ``1x1``): rank 0 serves and prints, the
  other ranks follow its collectives.
- ``edge``: launch one edge aggregator rank of the hierarchical server
  plane (``cross_silo/hierarchical``; ``edge_agent.run_edge``).
- ``device``: run the cross-device Beehive federation
  (``cross_device.run_beehive_world``) on the in-process fabric.

``serve``, ``edge`` and ``device`` take ``--device`` (``cuda``, the
default, or ``cpu``); their ``--dry-run`` builds everything, prints one
status JSON line and exits. State lives under ``~/.fedml_tpu_torch/``
(``FEDML_TPU_HOME`` overrides it).

- ``trace``: stitch a run's trace shards (``--telemetry-dir``) into one
  timeline and attribute each round's critical path
  (``core/tracing.trace_run``); one JSON line, exit 2 on a directory
  without shards.
- ``check``: the post-hoc invariant checker over a run's artifacts
  (``core/invariants.py``); one JSON line ``{ok, checked, skipped,
  violations}``, exit 1 on a violation, 2 on a missing directory.

- ``lint``: the port's static-analysis suite (``analysis/``, pure
  stdlib AST: host syncs on hot paths, global RNG and wall clocks in
  seeded paths, exception hygiene, unlocked cross-thread state,
  registry drift), ratcheted against ``lint_baseline_torch.json``
  (``--ci`` exits 0 at HEAD; ``--json``, ``--update-baseline``,
  ``--no-baseline``, ``--root``, ``--baseline``).

- ``audit``: the compiled-artifact audit (``analysis/audit.py``): every
  registered hot executable traced once on fake tensors (nothing
  executes, no card is touched), checked for host transfers, the pow2
  shape census and host constants against ``audit_baseline_torch.json``,
  its static cost written to ``audit_report_torch.json`` (``--ci``,
  ``--json``, ``--only``, ``--report``, ``--update-baseline``,
  ``--no-baseline``, ``--root``, ``--baseline``).
- ``perf``: the performance-attribution plane (``analysis/perf.py``,
  pure stdlib): a run's measured ``exec_device_seconds`` joined to the
  audit's FLOPs (``--telemetry-dir``; the seconds are host wall time),
  the idle-time ledger of its rounds, or the ``--ratchet BENCH_*.json``
  gate; exit 1 on a regression or low coverage, 2 on a usage error.

``serve`` exports the run's artifacts to ``telemetry_dir`` when it stops.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import zipfile

def cmd_lint(args) -> int:
    """Run the port's static-analysis suite (pure stdlib AST, no torch
    work): one ratchet gate against ``lint_baseline_torch.json``."""
    from .analysis.engine import run_cli

    return run_cli(args)


def cmd_audit(args) -> int:
    """Run the compiled-artifact audit: trace every registered hot
    executable on fake tensors (nothing executes) and check host
    transfers, the pow2 shape census and host constants against
    ``audit_baseline_torch.json``, writing the static-cost report."""
    from .analysis.audit import run_cli

    return run_cli(args)


def cmd_perf(args) -> int:
    """The performance-attribution plane: join a run's measured
    ``exec_device_seconds`` to the audit report's FLOPs, summarize the
    per-round idle-time ledger, or (``--ratchet``) gate the BENCH
    records against their best prior record per phase and device kind.
    Pure stdlib, like ``lint``."""
    from .analysis.perf import run_cli

    return run_cli(args)


def _home() -> str:
    root = os.environ.get(
        "FEDML_TPU_HOME", os.path.join(os.path.expanduser("~"), ".fedml_tpu_torch")
    )
    os.makedirs(root, exist_ok=True)
    return root


def _account_path() -> str:
    return os.path.join(_home(), "account.json")


def _pid_path() -> str:
    return os.path.join(_home(), "edge_agent.pid")


def cmd_version(_args) -> int:
    from . import __version__

    print(f"fedml_tpu_torch version {__version__}")
    return 0


def cmd_login(args) -> int:
    account = {
        "account_id": args.account_id,
        "server": args.server,
        "role": args.role,
        "broker_host": args.broker_host,
        "broker_port": args.broker_port,
    }
    with open(_account_path(), "w") as f:
        json.dump(account, f)
    print(f"login: bound account {args.account_id} (role={args.role})")
    if args.no_daemon:
        return 0
    import subprocess

    with open(os.path.join(_home(), "edge_agent.log"), "ab") as log:
        proc = subprocess.Popen(
            [
                sys.executable, "-m", "fedml_tpu_torch.edge_agent",
                "--account-id", str(args.account_id),
                "--broker-host", args.broker_host,
                "--broker-port", str(args.broker_port),
            ],
            stdout=log,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )
    with open(_pid_path(), "w") as f:
        f.write(str(proc.pid))
    print(f"edge agent daemon started (pid {proc.pid})")
    return 0


def cmd_logout(_args) -> int:
    if os.path.exists(_pid_path()):
        try:
            with open(_pid_path()) as f:
                pid = int(f.read().strip())
            os.kill(pid, signal.SIGTERM)
            print(f"edge agent daemon (pid {pid}) stopped")
        except (OSError, ValueError) as e:
            # a stale or corrupt pid file, or a daemon already gone: logout
            # goes on either way, and says what happened
            print(f"logout: daemon already gone ({e})", file=sys.stderr)
        os.remove(_pid_path())
    if os.path.exists(_account_path()):
        os.remove(_account_path())
    print("logout: account binding cleared")
    return 0


def cmd_build(args) -> int:
    """Zip the user's source folder, entry point and a manifest
    (cli/cli.py:141-250's build, without the platform templates)."""
    from . import __version__

    src = os.path.abspath(args.source_folder)
    if not os.path.isdir(src):
        print(f"build: source folder {src!r} not found", file=sys.stderr)
        return 2
    entry = args.entry_point
    if not os.path.exists(os.path.join(src, entry)):
        print(f"build: entry {entry!r} not in {src!r}", file=sys.stderr)
        return 2
    os.makedirs(args.dest_folder, exist_ok=True)
    out = os.path.join(args.dest_folder, f"fedml_{args.type}_package.zip")
    manifest = {
        "type": args.type,
        "entry": entry,
        "config": args.config_folder,
        "version": __version__,
    }
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
        for base, _, files in os.walk(src):
            for name in files:
                path = os.path.join(base, name)
                z.write(path, os.path.relpath(path, src))
        if args.config_folder:
            cfg = os.path.abspath(args.config_folder)
            for base, _, files in os.walk(cfg):
                for name in files:
                    path = os.path.join(base, name)
                    z.write(path, os.path.join("config", os.path.relpath(path, cfg)))
        z.writestr("MANIFEST.json", json.dumps(manifest))
    print(f"build: {args.type} package -> {out}")
    return 0


def cmd_edge(args) -> int:
    """Launch one edge aggregator rank of the hierarchical server plane
    on ``--device``: the federation config (``--cf``) with ``edge_plane:
    ranks`` forced, rank ``--rank`` of the root fabric, server of its own
    client fabric (``edge_agent.run_edge``)."""
    from .arguments import Arguments
    from .edge_agent import run_edge

    ns = argparse.Namespace(
        yaml_config_file=args.cf or "",
        rank=int(args.rank),
        role="edge_server",
        run_id=args.run_id,
    )
    a = Arguments(ns)
    a.edge_plane = "ranks"
    if args.backend:
        a.backend = args.backend
    a._validate()
    return run_edge(a, dry_run=args.dry_run, device=args.device)


def cmd_device(args) -> int:
    """Run the cross-device Beehive federation (docs/cross_device.md):
    the config's device registry, ``comm_round`` connectionless check-in
    rounds on the in-process fabric, the devices training on
    ``--device``."""
    from .arguments import Arguments
    from .cross_device.driver import beehive_cohort, beehive_registry, run_beehive_world
    from .cross_device.protocol import flat_dim
    from .device import get_device

    dev = get_device(args.device)
    ns = argparse.Namespace(
        yaml_config_file=args.cf or "",
        rank=0,
        role="server",
        run_id=args.run_id,
    )
    a = Arguments(ns)
    a._validate()
    registry = beehive_registry(a)
    feature_dim = int(args.feature_dim)
    class_num = int(args.output_dim)
    status = {
        "plane": "crossdevice",
        "registry_size": registry.size,
        "registry_bytes": registry.nbytes(),
        "cohort": beehive_cohort(a),
        "rounds": int(a.comm_round),
        "fold_target_frac": float(a.crossdevice_fold_target_frac),
        "secure_agg": bool(a.crossdevice_secure_agg),
        "quant_scale": float(a.crossdevice_quant_scale),
        "update_dim": flat_dim(feature_dim, class_num),
    }
    if args.dry_run:
        print(json.dumps(status))
        return 0
    out = run_beehive_world(a, feature_dim=feature_dim, class_num=class_num,
                            registry=registry, device=dev)
    status["round_records"] = out["round_records"]
    status["trace_count"] = out["trace_count"]
    print(json.dumps(status))
    return 0


def cmd_serve(args) -> int:
    """Serve the federated global model over LOCAL, TRPC or GRPC (see the
    module docstring). Returns the exit code."""
    from . import process_group
    from .arguments import Arguments
    from .device import get_device

    ns = argparse.Namespace(
        yaml_config_file=args.cf or "",
        rank=0,
        role="server",
        run_id=args.run_id,
    )
    a = Arguments(ns)
    if args.fleet_size is not None:
        a.serve_fleet_size = max(1, int(args.fleet_size))
    if args.mesh:
        try:
            d, f = (int(t) for t in str(args.mesh).lower().split("x"))
        except ValueError:
            print(f"serve: --mesh {args.mesh!r} is not DATAxFSDP (e.g. 2x2)",
                  file=sys.stderr)
            return 2
        a.serve_mesh = {"data": d, "fsdp": f}
    dev = get_device(args.device)
    if not a.serve_mesh:
        return _serve(args, a, dev, None)
    import torch.distributed as dist

    from .parallel.layout import build_fed_mesh

    with process_group(dev) as dev:
        mesh = build_fed_mesh(a.serve_mesh, dist.get_world_size(), dev.type)
        return _serve(args, a, dev, mesh)


def _serve(args, a, dev, mesh) -> int:
    """The fleet on ``dev`` (over ``mesh`` when given), as ``cmd_serve``
    describes; the ranks other than 0 of a mesh follow rank 0."""
    import torch

    from . import models
    from .core.checkpoint import CheckpointWatcher
    from .serving import FleetFrontend, ServingFleet
    from .serving.frontends import build_serving_com

    model = models.create(a, int(args.output_dim), device=dev)
    params = model.init(torch.Generator().manual_seed(int(a.random_seed)))
    fleet = ServingFleet.build(model, params, a, mesh=mesh)
    if mesh is not None:
        import torch.distributed as dist

        if dist.get_rank() != 0:
            fleet.follow()  # rank 0's collectives, until it releases us
            return 0

    watcher = None
    try:
        if args.checkpoint_dir:
            # restore_target: after the first (host-side) publish teaches
            # the fleet the state tree, mesh restores load onto the card
            watcher = CheckpointWatcher(
                args.checkpoint_dir,
                poll_interval_s=a.serve_watch_interval_s,
                restore_target=fleet.restore_target,
            )
            update = watcher.poll()
            if update is not None:
                step, state = update
                fleet.publish_state(state, step)
                print(f"serve: loaded checkpoint step {step}", file=sys.stderr)

        fleet.start()
        engine = fleet.engines[0]
        status = {
            "model": model.name,
            "version": engine.endpoint.version,
            "backend": args.backend,
            "queue_size": engine.queue_size,
            "max_batch": engine.max_batch,
            "bucket_policy": engine.bucket_policy,
            "deadline_ms": a.serve_deadline_ms,
            "checkpoint_dir": args.checkpoint_dir,
            "fleet_size": len(fleet.engines),
            "mesh": a.serve_mesh,
            "route_policy": fleet.route_policy,
        }
        if args.dry_run:
            print(json.dumps(status), flush=True)
            return 0

        com = build_serving_com(a, rank=0, size=int(args.world_size), backend=args.backend)
        frontend = FleetFrontend(fleet, com, a, rank=0)
        if watcher is not None:
            watcher.watch(lambda step, state: fleet.publish_state(state, step))
        print(f"serve: ready ({json.dumps(status)})", file=sys.stderr, flush=True)
        try:
            frontend.serve_forever()
        except KeyboardInterrupt:  # Ctrl-C is the normal way to stop `serve`
            pass
        finally:
            frontend.stop()
            from .core.telemetry import Telemetry

            Telemetry.get_instance().export_run_artifacts(getattr(a, "telemetry_dir", None))
        return 0
    finally:
        fleet.stop()
        fleet.release()
        if watcher is not None:
            watcher.close()


def cmd_trace(args) -> int:
    """Stitch a run's trace shards and analyze its rounds' critical
    paths: one JSON summary line (shards, matched flows, rounds analyzed,
    artifact paths); the per-round detail goes to ``round_report.json``.
    ``--summary`` also prints the per-round segment table to stderr."""
    from .core.tracing import trace_run

    try:
        out = trace_run(args.telemetry_dir, out_dir=args.out)
    except FileNotFoundError as e:
        print(f"trace: {e}", file=sys.stderr)
        return 2
    if args.summary:
        with open(out["round_report"]) as fh:
            report = json.load(fh)
        for r in report["rounds"]:
            segs = ", ".join(f"{k}={v * 1e3:.1f}ms" for k, v in r["segments_s"].items())
            print(
                f"round {r['round']}: wall={r['wall_s'] * 1e3:.1f}ms "
                f"straggler=rank{r['straggler_rank']} [{segs}]",
                file=sys.stderr,
            )
    print(json.dumps(out))
    return 0


def cmd_check(args) -> int:
    """The post-hoc invariant checker over a run's artifacts: one JSON
    line ``{ok, checked, skipped, violations}``; exit 1 when an invariant
    is violated. The WAL is read from ``--checkpoint-dir`` when the run
    kept its checkpoints elsewhere than its telemetry."""
    from .core.invariants import InvariantChecker

    if not os.path.isdir(args.telemetry_dir):
        print(f"check: {args.telemetry_dir!r} not found", file=sys.stderr)
        return 2
    report = InvariantChecker(
        telemetry_dir=args.telemetry_dir, checkpoint_dir=args.checkpoint_dir,
    ).check()
    print(json.dumps(report.to_dict()))
    if not report.ok:
        for v in report.violations:
            print(f"check: VIOLATED {v['invariant']}: {v['detail']}", file=sys.stderr)
        return 1
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fedml-tpu-torch")
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("version").set_defaults(fn=cmd_version)

    login = sub.add_parser("login")
    login.add_argument("account_id")
    login.add_argument("--server", default="local")
    login.add_argument("--role", default="client", choices=["client", "edge_server"])
    login.add_argument("--broker-host", default="127.0.0.1")
    login.add_argument("--broker-port", type=int, default=18830)
    login.add_argument("--no-daemon", action="store_true")
    login.set_defaults(fn=cmd_login)

    sub.add_parser("logout").set_defaults(fn=cmd_logout)

    serve = sub.add_parser("serve")
    serve.add_argument("--cf", "--yaml_config_file", dest="cf", default="")
    serve.add_argument("--checkpoint-dir", default=None)
    serve.add_argument(
        "--backend", default="LOCAL", type=str.upper, choices=["LOCAL", "TRPC", "GRPC"]
    )
    serve.add_argument("--world-size", type=int, default=2)
    serve.add_argument("--output-dim", type=int, default=10)
    serve.add_argument(
        "--fleet-size", type=int, default=None,
        help="endpoints behind the fleet frontend (default: "
        "serve_fleet_size knob)",
    )
    serve.add_argument(
        "--mesh", default=None, metavar="DATAxFSDP",
        help="serve on a named (data, fsdp) mesh of the process group, e.g. "
        "2x2 (default: serve_mesh knob; omit to serve on one device)",
    )
    serve.add_argument("--run-id", dest="run_id", default="0")
    serve.add_argument("--device", default="cuda",
                       help="'cuda' (the default) or 'cpu'")
    serve.add_argument("--dry-run", action="store_true")
    serve.set_defaults(fn=cmd_serve)

    edge = sub.add_parser("edge")
    edge.add_argument("--cf", "--yaml_config_file", dest="cf", default="")
    edge.add_argument(
        "--rank", type=int, required=True,
        help="this edge's rank on the root fabric (1..edge_num)",
    )
    edge.add_argument(
        "--backend", default=None,
        type=lambda s: s.upper(), choices=[None, "LOCAL", "GRPC"],
    )
    edge.add_argument("--run-id", dest="run_id", default="0")
    edge.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    edge.add_argument("--dry-run", action="store_true")
    edge.set_defaults(fn=cmd_edge)

    device = sub.add_parser("device")
    device.add_argument("--cf", "--yaml_config_file", dest="cf", default="")
    device.add_argument("--feature-dim", type=int, default=8)
    device.add_argument("--output-dim", type=int, default=4)
    device.add_argument("--run-id", dest="run_id", default="0")
    device.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    device.add_argument("--dry-run", action="store_true")
    device.set_defaults(fn=cmd_device)

    build = sub.add_parser("build")
    build.add_argument("-t", "--type", required=True, choices=["client", "server"])
    build.add_argument("-sf", "--source-folder", required=True)
    build.add_argument("-ep", "--entry-point", required=True)
    build.add_argument("-cf", "--config-folder", default=None)
    build.add_argument("-df", "--dest-folder", default="./dist")
    build.set_defaults(fn=cmd_build)

    trace = sub.add_parser("trace")
    trace.add_argument("--telemetry-dir", required=True,
                       help="directory holding the run's trace*.json shards")
    trace.add_argument("--out", default=None,
                       help="where to write trace_merged.json / round_report.json "
                       "(default: the telemetry dir itself)")
    trace.add_argument("--summary", action="store_true",
                       help="also print a per-round segment table to stderr")
    trace.set_defaults(fn=cmd_trace)

    check = sub.add_parser("check")
    check.add_argument("--telemetry-dir", required=True,
                       help="directory holding the run's telemetry.jsonl / trace.json")
    check.add_argument("--checkpoint-dir", default=None,
                       help="directory holding round_wal.jsonl (default: the telemetry dir)")
    check.set_defaults(fn=cmd_check)

    lint = sub.add_parser("lint")
    from .analysis.engine import add_lint_arguments

    add_lint_arguments(lint)
    lint.set_defaults(fn=cmd_lint)

    audit = sub.add_parser("audit")
    from .analysis.audit import add_audit_arguments

    add_audit_arguments(audit)
    audit.set_defaults(fn=cmd_audit)

    perf = sub.add_parser("perf")
    from .analysis.perf import add_perf_arguments

    add_perf_arguments(perf)
    perf.set_defaults(fn=cmd_perf)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
