#!/usr/bin/env python3
"""Time the port's bf16 flash-attention forward from several source trees on one card, in turns.

Each ROOT is a checkout of this repository (for example the parent
commit unpacked by ``git archive`` into a gitignored directory); its
``fedml_tpu_torch`` builds its kernels from its own sources into its own
``ops/build/``. Each root runs in a process of its own, in the order
given and then back (ROOT1 .. ROOTn, ROOTn .. ROOT1), ``--rounds`` times,
so that a drift of the card's clock over the call shows as a drift and
not as a difference between roots. Every run times the forward at the
transformer-training path's shape, ``[32, 4096, 8, 64]`` bf16 causal, on
the same seeded inputs with CUDA events, and SDPA's call beside it as a
yardstick of the card.

    python3 flash_forward_ab.py ROOT [ROOT ...] [--rounds 2] [--sustain SECONDS]

With ``--sustain``, each run also launches the forward back to back for
that long while ``nvidia-smi`` samples the SM clock, the power draw and
the active clock-event reasons (why the clock is below its maximum: the
software power cap, a thermal or hardware slowdown), and reports the
time a call under that load beside them. Prints one JSON line per run
and, last, each root's times. Needs one CUDA card and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

SHAPE = (32, 4096, 8, 64)
ITERS = 20
# the bits of nvidia-smi's clocks_event_reasons.active that can hold the
# SM clock below its maximum under load
EVENT_BITS = {"sw_power_cap": 0x4, "hw_slowdown": 0x8, "sw_thermal_slowdown": 0x20,
              "hw_thermal_slowdown": 0x40, "hw_power_brake_slowdown": 0x80}


def worker(root: str, sustain: float) -> dict:
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops.flash_attention import FWD_KERNEL

    if not torch.cuda.is_available():
        raise SystemExit("flash_forward_ab: needs a CUDA card")
    B, T, H, D = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((B, T, 3 * H * D), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    scale = D**-0.5

    def timed(fn) -> float:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / ITERS

    def forward():
        return FWD_KERNEL(q, k, v, True, scale)

    o, lse = forward()
    out = {"root": root, "card": torch.cuda.get_device_name(0),
           "finite": bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all()),
           "ms": timed(forward)}
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out["sdpa_ms"] = timed(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    if sustain > 0:
        out.update(sustained(forward, sustain))
    return out


def event_field() -> str:
    """nvidia-smi's name for the clock-event reasons (older drivers call
    them throttle reasons)."""
    for field in ("clocks_event_reasons.active", "clocks_throttle_reasons.active"):
        run = subprocess.run(["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        if run.returncode == 0 and run.stdout.strip().startswith("0x"):
            return field
    raise SystemExit("flash_forward_ab: nvidia-smi reports no clock-event reasons")


def sustained(fn, seconds: float) -> dict:
    """``fn`` launched back to back for ``seconds`` while nvidia-smi
    samples every 100 ms: the mean time a call under sustained load, the
    SM clock and power it ran at, and the share of samples in which each
    clock-event reason was active (the first half second of samples,
    before the load settles, left out)."""
    import torch

    field = event_field()
    smi = subprocess.Popen(
        ["nvidia-smi", f"--query-gpu=clocks.sm,power.draw,{field}",
         "--format=csv,noheader,nounits", "-lms", "100"], stdout=subprocess.PIPE, text=True)
    calls, start = 0, time.perf_counter()
    while time.perf_counter() - start < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        calls += 20
    elapsed = time.perf_counter() - start
    smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines() if line.strip()][5:]
    if not rows:
        raise SystemExit("flash_forward_ab: nvidia-smi gave no samples")
    clocks, watts = [float(r[0]) for r in rows], [float(r[1]) for r in rows]
    masks = [int(r[2], 16) for r in rows]
    return {"sustained_s": elapsed, "sustained_ms": elapsed / calls * 1e3,
            "samples": len(rows),
            "sm_clock_mhz_mean": sum(clocks) / len(clocks), "sm_clock_mhz_min": min(clocks),
            "power_w_mean": sum(watts) / len(watts), "power_w_max": max(watts),
            "clock_event_share": {name: sum(bool(m & bit) for m in masks) / len(masks)
                                  for name, bit in EVENT_BITS.items()},
            "clock_event_masks": sorted({f"{m:#x}" for m in masks})}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("roots", nargs="+")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--sustain", type=float, default=0.0,
                   help="also launch back to back this many seconds, sampling the SM "
                        "clock, the power draw and the clock-event reasons")
    p.add_argument("--worker", help=argparse.SUPPRESS)
    a = p.parse_args()
    if a.worker:
        print(json.dumps(worker(a.worker, a.sustain)))
        return 0
    import os

    roots = [os.path.abspath(r) for r in a.roots]
    times = {r: [] for r in roots}
    for root in (roots + roots[::-1]) * a.rounds:
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root,
                              "--sustain", str(a.sustain), root],
                             capture_output=True, text=True, cwd=root)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return 1
        rec = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        if not rec["finite"]:
            print(f"flash_forward_ab: {root} gave a non-finite output", file=sys.stderr)
            return 1
        times[root].append(rec)
    print(json.dumps({"summary": {r: {key: [rec[key] for rec in recs if key in rec]
                                      for key in ("ms", "sdpa_ms", "sustained_ms")}
                                  for r, recs in times.items()}, "shape": SHAPE}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
