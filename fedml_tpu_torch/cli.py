"""Command-line interface of the port (of ``fedml_tpu/cli.py``).

``python -m fedml_tpu_torch.cli serve`` stands up the serving plane for
the federated global model: the model from the YAML config (``--cf``),
the newest restorable checkpoint of ``--checkpoint-dir`` (a corrupt
latest falls back to the previous one), a fleet of ``--fleet-size``
micro-batching engines behind one load-aware frontend on the card, and
weights hot-swapped as the trainer publishes new rounds. ``--mesh DxF``
serves every endpoint over a named (data, fsdp) mesh of a
``torch.distributed`` world of D·F ranks (the caller's process group, or
one from ``torchrun``'s environment; on one card, ``1x1``): rank 0
serves and prints, the other ranks follow its collectives. ``--dry-run``
builds everything, prints one status JSON line, and exits.

The JAX package's other subcommands (version, login, logout, build, edge,
device, trace, check, lint, audit, perf) are parsed and refused: they
come with the rest of ROADMAP.md queue A item 11 (``edge`` with
``cross_device/`` and ``edge_agent.py``), as does ``telemetry_dir``'s
run-artifact export (with the telemetry exporters).
"""

from __future__ import annotations

import argparse
import json
import sys

_LATER = ("version", "login", "logout", "build", "edge", "device", "trace", "check",
          "lint", "audit", "perf")


def _not_ported(args) -> int:
    raise NotImplementedError(
        f"`{args.command}` is not ported to PyTorch yet; it arrives with "
        "cross_device/ and edge_agent.py, the remainder of ROADMAP.md queue A "
        "item 11 (`cli edge` and the other subcommands). `serve` is the "
        "port's subcommand so far"
    )


def cmd_serve(args) -> int:
    """Serve the federated global model over LOCAL, TRPC or GRPC (see the
    module docstring). Returns the exit code."""
    from . import _process_group
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
    if a.telemetry_dir:
        raise NotImplementedError(
            "telemetry_dir: exporting the run's artifacts (trace.json, metrics.prom, "
            "telemetry.jsonl) is not ported to PyTorch yet; it arrives with the "
            "observability slice (ROADMAP.md, queue A item 11). Unset telemetry_dir"
        )
    dev = get_device(args.device)
    if not a.serve_mesh:
        return _serve(args, a, dev, None)
    import torch.distributed as dist

    from .parallel.layout import build_fed_mesh

    with _process_group(dev) as dev:
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
        return 0
    finally:
        fleet.stop()
        fleet.release()
        if watcher is not None:
            watcher.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fedml-tpu-torch")
    sub = p.add_subparsers(dest="command", required=True)

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

    for name in _LATER:
        sub.add_parser(name).set_defaults(fn=_not_ported)
    return p


def main(argv=None) -> int:
    parser = build_parser()
    # the refused subcommands take the JAX package's flags, unparsed
    args, rest = parser.parse_known_args(argv)
    if rest and args.fn is not _not_ported:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
