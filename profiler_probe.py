"""How many device records torch.profiler drops around a RoundProfiler
window on the card, and where.

Runs the profiled round of ``chip_smoke.py``'s "transformer f32" phase
(the f32 flash TransformerLM configuration through ``run_simulation``, 3
rounds, round 1 profiled, training only) ``--reps`` times for each
``--margins`` value, which sets ``core/tracing.py``'s
``CAPTURE_MARGIN_S`` (0: the capture opens and closes with the round, as
before the margins). ``--load N`` spins N host processes meanwhile. For
each capture it prints the device records, the kernel launches the
capture holds no device record of (``device_records_lost``), the launch
indices and times of those launches, the flash kernels seen, and the
three lowest (device start - host launch) gaps: a negative gap is a
record dated before its own launch.

    python3 profiler_probe.py --reps 6 --load 12 --margins 0 0.5

Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))


def _spin(stop) -> None:
    while not stop.is_set():
        pass


def _positions(prof, real):
    """Wraps ``tracing._device_records``: prints where the dropped
    records' launches sit, then returns what the real one returns."""
    from torch.autograd import DeviceType

    from fedml_tpu_torch.core import tracing

    raw = prof.profiler.kineto_results
    t0 = raw.trace_start_ns()
    launches, starts = {}, {}
    for e in raw.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                starts.setdefault(e.correlation_id(), e.start_ns())
        elif e.name() in tracing._LAUNCH_CALLS:
            launches[e.correlation_id()] = e.start_ns()
    order = sorted(launches.items(), key=lambda kv: kv[1])
    missing = [i for i, (c, _) in enumerate(order) if c not in starts]
    gaps = sorted((starts[c] - t) / 1e6 for c, t in launches.items() if c in starts)
    print("PROBE capture " + json.dumps({
        "launches": len(order), "lost_indices": missing[:10] + (["..."] if len(missing) > 10
                                                               else []),
        "lost_launch_ms": [round((order[i][1] - t0) / 1e6, 3) for i in missing[:10]],
        "first_launch_ms": round((order[0][1] - t0) / 1e6, 3) if order else None,
        "last_launch_ms": round((order[-1][1] - t0) / 1e6, 3) if order else None,
        "lowest_gaps_ms": [round(g, 3) for g in gaps[:3]]}), flush=True)
    return real(prof)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--load", type=int, default=0)
    ap.add_argument("--margins", type=float, nargs="+", default=[0.0, 0.5])
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profiler_probe: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from fedml_tpu_torch.arguments import load_yaml_arguments
    from fedml_tpu_torch.core import tracing

    real = tracing._device_records
    tracing._device_records = lambda prof: _positions(prof, real)
    print(cs.card_line(), flush=True)
    cs.build_kernels()
    stop = mp.Event()
    procs = [mp.Process(target=_spin, args=(stop,)) for _ in range(opts.load)]
    for p in procs:
        p.start()
    try:
        for margin in opts.margins:
            tracing.CAPTURE_MARGIN_S = margin
            for rep in range(opts.reps):
                args = load_yaml_arguments(str(cs.TRANSFORMER_F32_CONFIG))
                args.comm_round = cs.TRANSFORMER_F32_ROUNDS
                run = cs.measured_run(args, cs.TRANSFORMER_F32_PROFILED)
                s = run["summary"]
                flash = {}
                for name, n in s["device_launches_by_kernel"].items():
                    kind = cs.kernel_kind(name, cs.TRANSFORMER_KINDS)
                    if kind.startswith("flash"):
                        flash[kind] = flash.get(kind, 0) + n
                print("PROBE round " + json.dumps({
                    "margin_s": margin, "load": opts.load, "rep": rep,
                    "device_records": s["device_launches"],
                    "device_records_lost": s["device_records_lost"], "flash": flash,
                    "wall_s": s["wall_s"]}), flush=True)
    finally:
        stop.set()
        for p in procs:
            p.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
