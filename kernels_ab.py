#!/usr/bin/env python3
"""Time the port's kernels from several source trees on one card, in turns.

Each ROOT is a checkout of this repository (for example the parent
commit unpacked by ``git archive`` into a gitignored directory); its
``fedml_tpu_torch`` builds its kernels from its own sources into its own
``ops/build/``. Each root runs in a process of its own, in the order
given and then back (ROOT1 .. ROOTn, ROOTn .. ROOT1), ``--rounds`` times,
so that a drift of the card's clock over the call shows as a drift and
not as a difference between roots. Every run times the kernels named by
``--kernel`` (all three by default) through their wrappers, with CUDA
events around back-to-back calls on the same seeded inputs:

- ``fwd_bf16``: the flash forward at the transformer-training path's
  shape, ``[32, 4096, 8, 64]`` bf16 causal (20 calls after 2 warm-up
  calls), with SDPA's call beside it as a yardstick of the card;
- ``bwd_f32``: the f32 flash backward at ``[8, 4096, 8, 64]`` causal (10
  calls after 2), with SDPA's backward beside it;
- ``synth``: the keyed feature kernel (K2) at the planet path's group
  ``[4096, 128, 60]`` and at ``[64, 512, 784]`` f32 (200 calls after 20:
  a call is ~0.1 ms, and shorter windows read the card's clock ramp).

    python3 kernels_ab.py ROOT [ROOT ...] [--kernel fwd_bf16 --kernel ...]
        [--rounds 2] [--sustain SECONDS]

With ``--sustain``, each run also launches each kernel back to back for
that long while ``nvidia-smi`` samples the SM clock, the power draw and
the active clock-event reasons (why the clock is below its maximum: the
software power cap, a thermal or hardware slowdown), and reports the
time a call under that load beside them. Every output is checked finite.
Prints one JSON line per run and, last, each root's times. Needs one
CUDA card and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

KERNELS = ("fwd_bf16", "bwd_f32", "synth")
FWD_SHAPE = (32, 4096, 8, 64)
BWD_SHAPE = (8, 4096, 8, 64)
SYNTH_SHAPES = ((4096, 128, 60), (64, 512, 784))
# the bits of nvidia-smi's clocks_event_reasons.active that can hold the
# SM clock below its maximum under load
EVENT_BITS = {"sw_power_cap": 0x4, "hw_slowdown": 0x8, "sw_thermal_slowdown": 0x20,
              "hw_thermal_slowdown": 0x40, "hw_power_brake_slowdown": 0x80}


def timed(fn, iters: int, warmup: int) -> float:
    """Mean ms a call of ``fn`` by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def finite(*tensors) -> bool:
    import torch

    return all(bool(torch.isfinite(t.float()).all()) for t in tensors)


def time_fwd_bf16(out: dict, sustain: float) -> None:
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops.flash_attention import FWD_KERNEL

    B, T, H, D = FWD_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((B, T, 3 * H * D), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, dim=-1))

    def forward():
        return FWD_KERNEL(q, k, v, True, D**-0.5)

    out["fwd_bf16_finite"] = finite(*forward())
    out["fwd_bf16_ms"] = timed(forward, 20, 2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out["fwd_bf16_sdpa_ms"] = timed(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 20, 2)
    if sustain > 0:
        out["fwd_bf16_sustained"] = sustained(forward, sustain)


def time_bwd_f32(out: dict, sustain: float) -> None:
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops.flash_attention import BWD_KERNEL, FWD_KERNEL

    B, T, H, D = BWD_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((B, T, 3 * H * D), generator=gen, device="cuda")
    q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    g = torch.randn((B, T, H, D), generator=gen, device="cuda")
    o, lse = FWD_KERNEL(q, k, v, True, D**-0.5)

    def backward():
        return BWD_KERNEL(q, k, v, o, lse, g, True, D**-0.5)

    out["bwd_f32_finite"] = finite(*backward())
    out["bwd_f32_ms"] = timed(backward, 10, 2)
    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    ref = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    gt = g.transpose(1, 2).contiguous()
    out["bwd_f32_sdpa_ms"] = timed(
        lambda: torch.autograd.grad(ref, (qt, kt, vt), gt, retain_graph=True), 10, 2)
    if sustain > 0:
        out["bwd_f32_sustained"] = sustained(backward, sustain)


def time_synth(out: dict, sustain: float) -> None:
    import torch

    from fedml_tpu_torch.ops import synth_features as sf

    gen = torch.Generator(device="cuda").manual_seed(2)
    for C, S, dim in SYNTH_SHAPES:
        y = torch.randint(0, 10, (C, S), generator=gen, device="cuda")
        means = torch.randn((10, dim), generator=gen, device="cuda")
        seeds = torch.randint(0, 2**31 - 1, (C,), generator=gen, device="cuda")

        def call(y=y, means=means, seeds=seeds):
            return sf.SYNTH_KERNEL(y, means, seeds, 1.0)

        key = f"synth_{C}x{S}x{dim}"
        out[f"{key}_finite"] = finite(call())
        out[f"{key}_ms"] = timed(call, 200, 20)
        if sustain > 0 and (C, S, dim) == SYNTH_SHAPES[0]:
            out[f"{key}_sustained"] = sustained(call, sustain)


TIMERS = {"fwd_bf16": time_fwd_bf16, "bwd_f32": time_bwd_f32, "synth": time_synth}


def worker(root: str, kernels: list, sustain: float) -> dict:
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernels_ab: needs a CUDA card")
    out = {"root": root, "card": torch.cuda.get_device_name(0)}
    for name in kernels:
        TIMERS[name](out, sustain)
        torch.cuda.empty_cache()
    return out


def event_field() -> str:
    """nvidia-smi's name for the clock-event reasons (older drivers call
    them throttle reasons)."""
    for field in ("clocks_event_reasons.active", "clocks_throttle_reasons.active"):
        run = subprocess.run(["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        if run.returncode == 0 and run.stdout.strip().startswith("0x"):
            return field
    raise SystemExit("kernels_ab: nvidia-smi reports no clock-event reasons")


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
        raise SystemExit("kernels_ab: nvidia-smi gave no samples")
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
    p.add_argument("--kernel", action="append", choices=KERNELS,
                   help="a kernel to time (repeatable; all three by default)")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--sustain", type=float, default=0.0,
                   help="also launch back to back this many seconds, sampling the SM "
                        "clock, the power draw and the clock-event reasons")
    p.add_argument("--worker", help=argparse.SUPPRESS)
    a = p.parse_args()
    kernels = a.kernel or list(KERNELS)
    if a.worker:
        print(json.dumps(worker(a.worker, kernels, a.sustain)))
        return 0
    roots = [os.path.abspath(r) for r in a.roots]
    runs = []
    for root in (roots + roots[::-1]) * a.rounds:
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", root,
               "--sustain", str(a.sustain)]
        for name in kernels:
            cmd += ["--kernel", name]
        run = subprocess.run(cmd + [root], capture_output=True, text=True, cwd=root)
        if run.returncode != 0:
            print(run.stdout + run.stderr[-3000:], file=sys.stderr)
            return 1
        rec = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        bad = [key for key, value in rec.items() if key.endswith("_finite") and not value]
        if bad:
            print(f"kernels_ab: {root} gave a non-finite output: {bad}", file=sys.stderr)
            return 1
        runs.append(rec)
    summary = {}
    for rec in runs:
        mine = summary.setdefault(rec["root"], {})
        for key, value in rec.items():
            if key.endswith("_ms"):
                mine.setdefault(key, []).append(value)
            elif key.endswith("_sustained"):
                mine.setdefault(f"{key}_ms", []).append(value["sustained_ms"])
    print(json.dumps({"summary": summary, "kernels": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
