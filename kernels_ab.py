#!/usr/bin/env python3
"""Time the port's kernels from several source trees on one card, in turns.

Each ROOT is a checkout of this repository (for example the parent
commit unpacked by ``git archive`` into a gitignored directory); its
``fedml_tpu_torch`` builds its kernels from its own sources into its own
``ops/build/``. Each root runs in a process of its own, in the order
given and then back (ROOT1 .. ROOTn, ROOTn .. ROOT1), ``--rounds`` times,
so that a drift of the card's clock over the call shows as a drift and
not as a difference between roots. Every run times the kernels named by
``--kernel`` (all of them by default) through their wrappers, with CUDA
events around back-to-back calls on the same seeded inputs:

- ``fwd_bf16``: the flash forward at the transformer-training path's
  shape, ``[32, 4096, 8, 64]`` bf16 causal (20 calls after 2 warm-up
  calls), with SDPA's call beside it as a yardstick of the card;
- ``bwd_f32``: the f32 flash backward at ``[8, 4096, 8, 64]`` causal (10
  calls after 2), with SDPA's backward beside it;
- ``synth``: the keyed feature kernel (K2) at the planet path's group
  ``[4096, 128, 60]`` and at ``[64, 512, 784]`` f32 (200 calls after 20:
  a call is ~0.1 ms, and shorter windows read the card's clock ramp);
- ``fold``: the exact fold (K1) at ResNet-18-GN's 11,173,962 params with
  one term and three, its weighted mean at ``[16, 11,173,962]`` f32 and
  ``[10, 8,495,194]`` bf16, and the planet path's two hops at its 4 edges
  and 610 params: a group's edge terms (3 edges with weight) and the
  root merge of 4 edges' limbs, also at 11,173,962 params. A root whose
  wrapper has the one-launch calls (``fold_edges``, ``fold_set``) runs
  each hop as one call; an older root runs it as its loop did, one
  ``fold`` call an edge. Each is timed by events (20 calls after 2, 200
  after 20 below 16 MB) and by the profiler's device time of the fold's
  device kernels over as many calls;
- ``planet``: the planet configuration
  (``fedml_tpu_torch/configs/fedavg_planet_lr.yaml``: a 1,000,000-client
  registry, 10,000 a round, 4 edges) through ``run_simulation`` for 4
  rounds: rounds 1-3 on the card's clock as rounds/s, and the exact
  fold's launches a round (every fold entry the root's wrapper has).

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

KERNELS = ("fwd_bf16", "bwd_f32", "synth", "fold", "planet")
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


def device_ms(fn, iters: int, names) -> float:
    """Mean device time a call of ``fn`` of the device kernels whose names
    contain one of ``names``, under torch.profiler over ``iters`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and any(n in e.name for n in names)]
    if not us:
        raise SystemExit(f"kernels_ab: the profiler saw none of {names}")
    return sum(us) / iters / 1e3


def time_fold(out: dict, sustain: float) -> None:
    import torch

    from fedml_tpu_torch.ops import exact_fold as ef

    gen = torch.Generator(device="cuda").manual_seed(1)
    names = ("fold_kernel", "weighted_mean_kernel")
    one_launch = hasattr(ef, "fold_edges")

    def spread(shape):
        m = torch.rand(shape, generator=gen, device="cuda") + 1.0
        e = torch.randint(-30, 31, shape, generator=gen, device="cuda").float()
        return m * torch.exp2(e)

    def record(key, fn, nbytes, *outputs):
        iters, warm = (200, 20) if nbytes < 2**24 else (20, 2)
        out[f"{key}_finite"] = finite(*outputs)
        out[f"{key}_ms"] = timed(fn, iters, warm)
        out[f"{key}_device_ms"] = device_ms(fn, iters, names)

    n = 11_173_962
    for k in (1, 3):
        limbs, terms = spread((3, n)), spread((k, n))
        record(f"fold_{n}_k{k}", lambda: ef.fold(limbs, terms), (6 + k) * n * 4, limbs)
        del limbs, terms
    for c, m, dtype in ((16, n, torch.float32), (10, 8_495_194, torch.bfloat16)):
        x, w = spread((c, m)).to(dtype), torch.full((c,), 1.0 / c, device="cuda")
        key = f"mean_{c}x{m}_{str(dtype).split('.')[-1]}"
        record(key, lambda: ef.MEAN_KERNEL(x, w), (c + 1) * m * x.element_size(),
               ef.MEAN_KERNEL(x, w))
        del x
    out["fold_one_launch_entries"] = one_launch
    for m in (610, n):
        edges, terms, root = spread((4, 3, m)), spread((4, m)), spread((3, m))
        hit = (0, 1, 3)
        if one_launch:
            group = lambda: ef.fold_edges(edges, terms, 0b1011)  # noqa: E731
            merge = lambda: ef.fold_set(root, edges, 0b1111)  # noqa: E731
        else:
            def group():
                for e in hit:
                    ef.fold(edges[e], terms[e])

            def merge():
                for e in range(4):
                    ef.fold(root, edges[e])
        if m == 610:
            record(f"planet_group_fold_{m}", group, 3 * 7 * m * 4, edges)
        record(f"planet_root_merge_{m}", merge, (6 + 12) * m * 4, root)
        del edges, terms, root
        torch.cuda.empty_cache()


def time_planet(out: dict, sustain: float) -> None:
    import tempfile

    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_arguments
    from fedml_tpu_torch.ops import _build
    from fedml_tpu_torch.ops import exact_fold as ef

    rounds = 4
    args = load_arguments(os.path.join("fedml_tpu_torch", "configs", "fedavg_planet_lr.yaml"))
    args.comm_round, args.frequency_of_the_test, args.log_metrics = rounds, rounds - 1, False
    folds = [k for k in vars(ef).values()
             if isinstance(k, _build.Kernel) and k.name.startswith("exact_fold")]
    with tempfile.TemporaryDirectory(prefix="planet_ab_") as tmp:
        args.metrics_jsonl_path = os.path.join(tmp, "metrics.jsonl")
        args._validate()
        for k in folds:
            k.reset_launches()
        fedml_tpu_torch.run_simulation(device="cuda", args=args)
        torch.cuda.synchronize()
        with open(args.metrics_jsonl_path) as f:
            pipe = [json.loads(line) for line in f if '"pipeline"' in line][-1]
    spans = pipe["round_spans_s"]
    out["planet_rounds_per_s"] = (rounds - 1) / (spans[-1][1] - spans[1][0])
    out["planet_fold_launches_per_round"] = sum(k.launches for k in folds) / rounds
    out["planet_finite"] = True


TIMERS = {"fwd_bf16": time_fwd_bf16, "bwd_f32": time_bwd_f32, "synth": time_synth,
          "fold": time_fold, "planet": time_planet}


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
                   help="a kernel (or the planet path) to time (repeatable; all by default)")
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
            if key.endswith(("_ms", "_per_s", "_per_round")):
                mine.setdefault(key, []).append(value)
            elif key.endswith("_sustained"):
                mine.setdefault(f"{key}_ms", []).append(value["sustained_ms"])
    print(json.dumps({"summary": summary, "kernels": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
