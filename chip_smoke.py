#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fedml_tpu_torch``) on one NVIDIA card.

Drives the port's paths once each through the entry points a user
calls, and holds every hand-written kernel against its plain PyTorch
version on the card:

- serving: ``load_arguments`` on
  ``fedml_tpu_torch/configs/serve_transformer_flash.yaml``,
  ``models.create``, ``convert.params_from_flax``, ``ModelEndpoint`` and
  ``ServingEngine``, at the full width of that configuration (embed 512,
  8 heads of 64, 4096 tokens, 2 layers, seeded random weights);
- FedAvg training: ``fedml_tpu_torch.run_simulation`` on
  ``fedml_tpu_torch/configs/fedavg_femnist_cnn.yaml``, the bench's
  headline cohort at full width (32 clients x 600 samples of the
  FEMNIST stand-in, the 2-conv CNN, 5 local epochs, batch 32);
- dense FedAvg: ``run_simulation`` on
  ``fedml_tpu_torch/configs/fedavg_cifar10_resnet18_bf16.yaml``, the
  repo's north-star cohort at full width (ResNet-18-GN on the CIFAR-10
  stand-in, 10 of 100 clients per round, batch 64, bf16 over f32
  masters) through the round pipeline.
The training paths run no hand-written kernel: their convolutions and
matrix products are cuDNN's and cuBLAS's through PyTorch, as XLA
generated them on the TPU.

Phases, each of which fails the run:

1. card: CUDA present; the card's name and power limit from nvidia-smi;
2. build: every kernel source of the path compiles (one nvcc each, in
   parallel);
3. kernels: each kernel against its plain version at the path's shapes
   and a few more (f32 and bf16, causal and not, head dims 16-128, a
   ragged length), with stated tolerances; kernel, plain and library
   (one PyTorch call computing the same function) times, the library
   call's own device kernel named from a short profiler window, and each
   time's share of the kernel's bound;
4. slice: bursts of 8 requests through ``ServingEngine``; the answers
   have the right shape, are finite and match the same model with
   ``attention_impl: full``; the kernels' launch counts rose on the
   path; a hot swap advances the version and changes the answers; one
   burst runs under ``torch.profiler`` for the device time by kernel;
5. fedavg: FedAvg equals centralized full-batch GD on the card (the
   reference's oracle 1, atol 1e-5); the vectorized round equals the
   sequential one (float64, atol 1e-5; the f32 error is printed); the headline configuration trains through
   ``run_simulation`` (one warm-up round, three timed rounds, one round
   under ``torch.profiler``), its train loss falls and its test accuracy
   ends at least 5x chance. Rounds/s, samples/s, peak memory, the
   per-round loss and accuracy and the profiled round's device time by
   kernel are printed before the JSON lines;
6. dense: one local step's FLOPs (``FlopCounterMode``, one client) and
   launches by kind for 1 and 16 clients (GroupNorm must not launch
   more for 16: vmap batches it); the configuration through
   ``run_simulation`` (round 0 warms up, rounds 1-3 are timed as a whole
   on the card's clock, round 4 runs under ``torch.profiler``, round 5
   evaluates): rounds/s, real and computed samples/s, FLOPs per round,
   the share of the bf16 peak, peak memory, busy share, device time and
   launches by kernel kind; the train loss falls; then depth 4 against
   depth 1 (4 rounds, cuDNN deterministic for this check only): bitwise
   equal params and records, f32 masters, and depth 4's hot loop under
   ``torch.cuda.set_sync_debug_mode("error")`` between flushes.

Run from the repo root, on a machine with one CUDA card and the CUDA
toolkit:  ``python3 chip_smoke.py``.  The last two lines of its output
are one JSON object ``{"kernels": [...]}`` and one
``{"ok": true, "device": {...}}``; it exits 0 only when every phase
passed.
"""

from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "fedml_tpu_torch" / "configs" / "serve_transformer_flash.yaml"
FEDAVG_CONFIG = REPO / "fedml_tpu_torch" / "configs" / "fedavg_femnist_cnn.yaml"
DENSE_CONFIG = REPO / "fedml_tpu_torch" / "configs" / "fedavg_cifar10_resnet18_bf16.yaml"
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit). A
# kernel's bound is the larger of the bytes it must move over the memory
# rate and its operations over the peak rate of the route that computes
# them. f32 attention runs on the tensor cores as 3xTF32: every f32
# product is three TF32 products (lo*hi + hi*lo + hi*hi of a hi/lo
# split), so its operations take three passes at the 495 TFLOP/s TF32
# peak. bf16 is bounded by the 989 TFLOP/s bf16 tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12, torch.bfloat16: 989e12}
PASSES = {torch.float32: 3, torch.bfloat16: 1}
ROUTE = {torch.float32: "3xTF32", torch.bfloat16: "bf16"}

# flash kernel cases: (B, T, H, D, dtype, causal). The first is the
# serving path's own shape (serve_max_batch 8, T 4096, 8 heads of 64, f32).
FLASH_CASES = [
    (8, 4096, 8, 64, torch.float32, True),
    (8, 4096, 8, 64, torch.float32, False),
    (8, 4096, 8, 64, torch.bfloat16, True),
    (8, 4096, 8, 64, torch.bfloat16, False),
    (4, 4096, 4, 32, torch.float32, True),
    (2, 2048, 4, 128, torch.bfloat16, True),
    (2, 2048, 4, 128, torch.float32, True),  # most registers per thread in f32
    (2, 1024, 4, 16, torch.float32, False),
    (2, 1000, 4, 64, torch.float32, True),  # T not a multiple of the tile
]
# O and lse against the plain version. f32: the kernel's 3xTF32 products
# keep f32's accuracy, so the two differ by f32 rounding and summation
# order over up to 4096 keys (~1e-5 at T 4096), so 1e-4.
# bf16: both accumulate in f32 and round O once to bf16, so they may land
# one bf16 step apart, 2**-6 = 0.0156 for |O| in [2, 4): 2e-2. lse is f32
# in both cases.
O_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_ATOL = 1e-4
# served logits, flash vs full attention: the same f32 weights and
# inputs; the two paths differ only in attention's f32 rounding and
# summation order
LOGITS_ATOL = 1e-4
TIMED_BURSTS = 4

# FedAvg phase. Oracle 1: with full-batch clients, one epoch, every
# client and plain SGD, FedAvg's weighted mean of per-client steps is
# one full-batch GD step on the union; they differ by f32 summation
# order (the reference's own tolerance, tests/test_fedavg_oracle.py).
ORACLE_ATOL = 1e-5
# vectorized (vmapped: cuDNN grouped convolutions) against sequential
# (one client at a time), gated in float64: per client the arithmetic is
# the same, so the two agree to f64 rounding. In f32 they need not agree
# to 1e-5 at all: the two convolution algorithms round differently, and
# on the rare example whose ReLU input lands within that rounding of
# zero the client's step changes by O(lr). The f32 error is printed.
VEC_SEQ_ATOL = 1e-5
# the headline: one warm-up round, three timed, one profiled
HEADLINE_WARMUP, HEADLINE_TIMED = 1, 3
CHANCE_FACTOR = 5  # final test accuracy must reach 5x chance
# dense phase, the configuration as it is (6 rounds, evaluation at 0 and
# 5): round 0 warms up, rounds 1-3 are timed as a whole on the card's
# clock, round 4 runs under torch.profiler (training only), round 5
# evaluates
DENSE_TIMED = (1, 3)
DENSE_PROFILED = 4
# the pipeline check: 4 rounds, evaluation every 2 (records 0, 2, 3)
DENSE_CHECK_ROUNDS, DENSE_CHECK_FREQ = 4, 2


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi: exit {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` on the card, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
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


def flash_bound(B, T, H, D, dtype, causal):
    """(bound_ms, bound_by) for one flash forward: 4·D flops per
    unmasked (query, key) pair, in ``PASSES[dtype]`` tensor-core passes
    at ``PEAK_FLOPS[dtype]``; every input read once, O and lse written
    once."""
    pairs = T * (T + 1) / 2 if causal else T * T
    flops = 4.0 * B * H * D * pairs
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = 4.0 * B * T * H * D * itemsize + 4.0 * B * H * T
    t_ops = PASSES[dtype] * flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def device_kernel_names(fn, windows: int = 3):
    """Names of the device kernels one call of ``fn`` launches, the
    longest-running first, from a short ``torch.profiler`` window (up to
    ``windows`` of them while one comes back without device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        if by_name:
            break
    return sorted(by_name, key=lambda name: -by_name[name])


# -- phase 2 -----------------------------------------------------------
def build_kernels():
    from fedml_tpu_torch.ops import _build

    names = ["flash_attention_fwd"]
    t0 = time.perf_counter()
    _build.build(names)
    log(f"build: {names} in {time.perf_counter() - t0:.1f} s")
    for name in names:
        for line in _build.build_log(name).splitlines():
            if "entry function" in line or "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


# -- phase 3 -----------------------------------------------------------
def check_flash_kernel():
    """Every flash case against the plain version; returns the kernel's
    ``kernels`` entry (main-path numbers from the first case)."""
    import torch.nn.functional as F

    from fedml_tpu_torch.ops.flash_attention import (
        FWD_KERNEL,
        flash_attention_reference,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    cases = []
    for B, T, H, D, dtype, causal in FLASH_CASES:
        # q, k, v as views of one fused projection, as the model cuts them
        qkv = torch.randn((B, T, 3 * H * D), generator=gen, device=DEVICE).to(dtype)
        q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, dim=-1))
        scale = D**-0.5
        o, lse = FWD_KERNEL(q, k, v, causal, scale)
        o_ref, lse_ref = flash_attention_reference(q, k, v, causal, scale)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        finite = bool(torch.isfinite(o.float()).all()) and bool(torch.isfinite(lse).all())
        heavy = B * H * T * T >= 2**30
        ms = cuda_time_ms(lambda: FWD_KERNEL(q, k, v, causal, scale), 5 if heavy else 20)
        plain_ms = cuda_time_ms(
            lambda: flash_attention_reference(q, k, v, causal, scale), 2 if heavy else 5, 1
        )
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        library_ms = cuda_time_ms(sdpa, 10)
        library_kernel = device_kernel_names(sdpa)[:1] or ["not measured"]
        bound_ms, bound_by = flash_bound(B, T, H, D, dtype, causal)
        case = {
            "shape": [B, T, H, D], "dtype": str(dtype).replace("torch.", ""),
            "causal": causal, "max_abs_err": err_o, "lse_max_abs_err": err_lse,
            "o_atol": O_ATOL[dtype], "lse_atol": LSE_ATOL,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_kernel": library_kernel[0],
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_route": ROUTE[dtype],
        }
        log(f"flash {case['shape']} {case['dtype']} causal={causal}: "
            f"O err {err_o:.3g} (atol {O_ATOL[dtype]}), lse err {err_lse:.3g} "
            f"(atol {LSE_ATOL}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"sdpa {library_ms:.3f} ms ({library_kernel[0][:90]}), bound "
            f"{bound_ms:.3f} ms ({bound_by}, {ROUTE[dtype]}): "
            f"{bound_ms / ms:.1%} of bound")
        if not finite:
            fail(f"flash {case['shape']} {case['dtype']}: non-finite output")
        if err_o > O_ATOL[dtype] or err_lse > LSE_ATOL:
            fail(f"flash {case['shape']} {case['dtype']} causal={causal}: "
                 f"O err {err_o} / lse err {err_lse} over tolerance")
        if ms < bound_ms:
            fail(f"flash {case['shape']} {case['dtype']}: {ms} ms beats its bound "
                 f"{bound_ms} ms, so the bound is wrong")
        cases.append(case)
        del qkv, q, k, v, o, lse, o_ref, lse_ref
        torch.cuda.empty_cache()
    log(f"flash kernel launches while checking (not counted): {FWD_KERNEL.launches}")
    main = cases[0]
    return {
        "name": FWD_KERNEL.name,
        "route": "cuda",
        "source": "fedml_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "fedml_tpu/ops/flash_attention.py:32",
        "launches": None,  # filled from the slice's run
        **{key: main[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_route",
            "library_ms", "library_kernel")},
        "shape": main["shape"], "dtype": main["dtype"],
        "cases": cases,
    }


# -- phase 4 -----------------------------------------------------------
def flax_params(args, vocab: int, rng: np.random.Generator) -> dict:
    """Random weights in the flax TransformerLM's tree layout (numpy),
    the form a JAX checkpoint arrives in."""
    C = int(args.embed_dim)
    max_len = max(int(args.seq_len), int(args.max_len))

    def normal(shape, std):
        return rng.normal(0.0, std, size=shape).astype(np.float32)

    def dense(i, o):
        return {"kernel": normal((i, o), i**-0.5), "bias": normal((o,), 0.02)}

    def ln():
        return {"scale": 1.0 + normal((C,), 0.1), "bias": normal((C,), 0.02)}

    tree = {
        "Embed_0": {"embedding": normal((vocab, C), 1.0)},
        "Embed_1": {"embedding": normal((max_len, C), 1.0)},
        "LayerNorm_0": ln(),
        "Dense_0": dense(C, vocab),
    }
    for i in range(int(args.num_layers)):
        tree[f"Block_{i}"] = {
            "LayerNorm_0": ln(), "Dense_0": dense(C, 3 * C), "Dense_1": dense(C, C),
            "LayerNorm_1": ln(), "Dense_2": dense(C, 4 * C), "Dense_3": dense(4 * C, C),
        }
    return tree


def burst(engine, rows):
    """Submit ``rows`` as one paused burst (one micro-batch); returns
    (answers [n, T, vocab], per-request latencies in s, wall s)."""
    done = [0.0] * len(rows)
    engine.pause()
    t0 = time.perf_counter()
    futs = engine.submit_many(list(rows), deadline_s=60.0)
    for i, f in enumerate(futs):
        f.add_done_callback(lambda _f, i=i: done.__setitem__(i, time.perf_counter()))
    engine.resume()
    answers = np.stack([f.result(timeout=600) for f in futs])
    wall = time.perf_counter() - t0
    return answers, [d - t0 for d in done], wall


def profile_burst(engine, rows):
    """One burst under ``torch.profiler``: device time by kernel name and
    the device's busy share of the burst's wall time (profiler overhead
    included in the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, wall = burst(engine, rows)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = [(name[:110], ms) for name, ms in
           sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    if not by_name:
        log("profile: the profiler saw no device events; device time not measured")
    else:
        log(f"profile: one burst of {len(rows)}: wall {wall * 1e3:.2f} ms, device "
            f"busy {busy:.2f} ms ({busy / (wall * 1e3):.1%}); device time by kernel:")
        for name, ms in top:
            log(f"  {ms:9.3f} ms  {name}")
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy if by_name else None,
            "top_kernels_ms": top}


def full_attention_logits(args, output_dim, params, rows):
    """The same model with ``attention_impl: full``, on the card."""
    from fedml_tpu_torch import models

    full_args = copy.copy(args)
    full_args.attention_impl = "full"
    full = models.create(full_args, output_dim, device=DEVICE)
    on_card = {k: v.to(DEVICE) for k, v in params.items()}
    with torch.inference_mode():
        out = full.apply(on_card, torch.as_tensor(rows, device=DEVICE)).cpu().numpy()
    del full
    torch.cuda.empty_cache()
    return out


def run_slice(kernels):
    from fedml_tpu_torch import models
    from fedml_tpu_torch.arguments import load_arguments
    from fedml_tpu_torch.convert import params_from_flax
    from fedml_tpu_torch.core import devtime
    from fedml_tpu_torch.ops.flash_attention import FWD_KERNEL
    from fedml_tpu_torch.serving import ModelEndpoint, ServingEngine

    args = load_arguments(str(CONFIG))
    output_dim = 90  # class_num of the shakespeare stand-in
    model = models.create(args, output_dim, device=DEVICE)
    vocab, T, L = model.input_bound, int(args.seq_len), int(args.num_layers)
    rng = np.random.default_rng(int(args.random_seed))
    params = params_from_flax(flax_params(args, vocab, rng))
    n_params = model.param_count(params)
    log(f"slice: {model.name} embed {args.embed_dim}, {args.num_heads} heads, "
        f"{L} layers, T {T}, vocab {vocab}, attention {args.attention_impl}, "
        f"{n_params} params, serve_max_batch {args.serve_max_batch}")
    rows = rng.integers(0, vocab, size=(int(args.serve_max_batch), T))

    endpoint = ModelEndpoint(model, params)
    engine = ServingEngine(endpoint, args).start()
    FWD_KERNEL.reset_launches()  # count only the slice's own launches
    try:
        answers, _, first_wall = burst(engine, rows)
        lat, walls = [], []
        for _ in range(TIMED_BURSTS):
            _, l_s, wall = burst(engine, rows)
            lat += l_s
            walls.append(wall)
        profiled = profile_burst(engine, rows)
        params2 = params_from_flax(flax_params(args, vocab, rng))
        version = engine.hot_swap(params2)
        swapped, _, _ = burst(engine, rows)
    finally:
        engine.stop()
    launches = {FWD_KERNEL.name: FWD_KERNEL.launches}
    batches = engine.telemetry.get_counter("serving_batches_total", bucket=len(rows))
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    log(f"slice: {int(batches)} micro-batches of {len(rows)}, kernel launches {launches}")
    if batches != TIMED_BURSTS + 3:
        fail(f"expected {TIMED_BURSTS + 3} micro-batches, the engine ran {batches}")
    if launches[FWD_KERNEL.name] != L * batches:
        fail(f"flash kernel launched {launches[FWD_KERNEL.name]} times for "
             f"{batches} micro-batches of a {L}-layer model (want {L * batches})")

    if answers.shape != (len(rows), T, vocab) or answers.dtype != np.float32:
        fail(f"answers {answers.shape} {answers.dtype}, want {(len(rows), T, vocab)} float32")
    if not (np.isfinite(answers).all() and np.isfinite(swapped).all()):
        fail("non-finite logits")
    ref = full_attention_logits(args, output_dim, params, rows)
    err = float(np.abs(answers - ref).max())
    log(f"slice: flash vs full-attention logits max abs err {err:.3g} "
        f"(atol {LOGITS_ATOL}, |logits| max {np.abs(ref).max():.3g})")
    if err > LOGITS_ATOL:
        fail(f"served logits differ from the full-attention model by {err}")
    if version != 1:
        fail(f"hot swap returned version {version}, want 1")
    moved = float(np.abs(swapped - answers).max())
    ref2 = full_attention_logits(args, output_dim, params2, rows)
    err2 = float(np.abs(swapped - ref2).max())
    log(f"slice: after hot swap v{version}: answers moved by {moved:.3g}, "
        f"vs full attention err {err2:.3g}")
    if moved < 1e-2 or err2 > LOGITS_ATOL:
        fail("hot swap did not take effect")

    p50 = float(np.median(lat))
    tokens_per_s = TIMED_BURSTS * len(rows) * T / sum(walls)
    fwd = [e["seconds"] for e in devtime.ring_snapshot()
           if e["executable"] == "serving.forward"][1:1 + TIMED_BURSTS]
    log(f"slice: first burst {first_wall * 1e3:.1f} ms; timed {TIMED_BURSTS} bursts "
        f"of {len(rows)}: p50 request latency {p50 * 1e3:.2f} ms, "
        f"{tokens_per_s:.0f} tokens/s, serving.forward median "
        f"{np.median(fwd) * 1e3:.2f} ms")
    return {"p50_request_latency_ms": p50 * 1e3, "tokens_per_s": tokens_per_s,
            "serving_forward_ms": float(np.median(fwd)) * 1e3,
            "logits_max_abs_err": err, "params": n_params, "profile": profiled}


# -- phase 5 -----------------------------------------------------------
def _fedavg_args(**kw):
    from fedml_tpu_torch import init
    from fedml_tpu_torch.arguments import Arguments

    args = Arguments()
    for key, val in kw.items():
        setattr(args, key, val)
    args._validate()
    return init(args)


def _fedavg_api(args):
    from fedml_tpu_torch import data, models
    from fedml_tpu_torch.simulation import FedAvgAPI

    dataset = data.load(args, device=DEVICE)
    model = models.create(args, dataset.class_num, device=DEVICE)
    return FedAvgAPI(args, DEVICE, dataset, model)


def _max_err(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def fedavg_oracle():
    """Oracle 1 on the card: the lr model on the MNIST stand-in, four
    full-batch clients, one epoch, every client, plain SGD, 3 rounds,
    against 3 steps of centralized full-batch GD on the union."""
    from fedml_tpu_torch.core.types import flat_examples

    lr, rounds = 0.1, 3
    api = _fedavg_api(_fedavg_args(
        dataset="mnist", synthetic_train_size=400, synthetic_test_size=100, model="lr",
        partition_method="homo", client_num_in_total=4, client_num_per_round=4,
        comm_round=rounds, epochs=1, batch_size=100, learning_rate=lr, momentum=0.0,
        weight_decay=0.0, frequency_of_the_test=rounds, shuffle=False, log_metrics=False))
    params = {k: v.clone() for k, v in api.global_params.items()}
    api.train()
    g = flat_examples(api.dataset.train_data_global)
    keep = g.mask > 0
    x, y = g.x[keep], g.y[keep]
    ones = torch.ones(len(y), device=DEVICE)

    def loss(p):
        return api.model.loss_fn(api.model.apply(p, x), y, ones)[0]

    for _ in range(rounds):
        grads = torch.func.grad(loss)(params)
        params = {k: params[k] - lr * grads[k] for k in params}
    err = _max_err(api.global_params, params)
    log(f"fedavg oracle 1: FedAvg vs centralized full-batch GD, {rounds} rounds of 4 "
        f"full-batch clients: max abs err {err:.3g} (atol {ORACLE_ATOL})")
    if not err <= ORACLE_ATOL:
        fail(f"FedAvg differs from centralized GD by {err} (atol {ORACLE_ATOL})")
    return err


def _as_float64(api):
    """The API's params and packed federation in float64."""
    from fedml_tpu_torch.core.types import Batches

    api.global_params = {k: v.double() for k, v in api.global_params.items()}
    for split in ("packed_train", "packed_test"):
        b = getattr(api.dataset, split)
        setattr(api.dataset, split, Batches(x=b.x.double(), y=b.y, mask=b.mask.double()))
    return api


def fedavg_vectorized_vs_sequential():
    """The CNN on the FEMNIST stand-in, 4 clients of the hetero
    partition, 2 epochs, 2 rounds, shuffled: the vmapped round against
    the client-by-client round (both draw the round's shuffle once), in
    float64 (gated) and in f32 (printed)."""
    errs = {}
    for dtype in (torch.float64, torch.float32):
        out = {}
        for mode in ("vectorized", "sequential"):
            api = _fedavg_api(_fedavg_args(
                dataset="femnist", synthetic_train_size=480, synthetic_test_size=96,
                model="cnn", partition_method="hetero", partition_alpha=0.5,
                client_num_in_total=4, client_num_per_round=4, comm_round=2, epochs=2,
                batch_size=32, learning_rate=0.03, frequency_of_the_test=2, sim_mode=mode,
                log_metrics=False))
            if dtype == torch.float64:
                _as_float64(api)
            api.train()
            out[mode] = api.global_params
        errs[str(dtype).replace("torch.", "")] = _max_err(out["vectorized"], out["sequential"])
    log(f"fedavg vectorized vs sequential: CNN, 4 hetero clients, 2 rounds x 2 epochs, "
        f"shuffled: max abs err float64 {errs['float64']:.3g} (atol {VEC_SEQ_ATOL}), "
        f"float32 {errs['float32']:.3g} (not gated)")
    if not errs["float64"] <= VEC_SEQ_ATOL:
        fail(f"vectorized and sequential rounds differ by {errs['float64']} in float64 "
             f"(atol {VEC_SEQ_ATOL})")
    return errs


# device kernels of the FedAvg path by kind, first match wins (cuDNN's
# and PyTorch's kernel names)
KERNEL_KINDS = (
    ("conv backward", ("dgrad", "wgrad", "grad_weight", "backward_input", "conv_depthwise2d_backward")),
    ("conv forward", ("fprop", "conv_depthwise2d_forward", "implicit_convolve")),
    ("layout transposes", ("transpose", "nchwtonhwc", "nhwctonchw")),
    ("GroupNorm", ("groupnorm", "group_norm", "rowwisemoments", "computefusedparams",
                   "computeinternalgradients", "computebackwardfusedparams", "gammabeta")),
    ("GEMM", ("gemm", "gemv")),
    ("pooling", ("max_pool",)),
)


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KERNEL_KINDS:
        if any(k in low for k in keys):
            return kind
    return "elementwise, reductions, copies"


def device_busy_ms(fn, calls: int = 5):
    """Device time of one call of ``fn``: the union of its device
    intervals under ``torch.profiler``, averaged over ``calls``, and the
    kernel count per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fedml_tpu_torch.core.tracing import _union_us

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    if not spans:
        return None, 0
    return _union_us(spans) / 1e3 / calls, len(spans) / calls


def fedavg_step_yardstick():
    """One local step of the headline cohort (32 clients x 32 images,
    the CNN, SGD) three ways, on the same params and batch: the port's
    vmapped step; the same step written by hand as grouped convolutions
    over the stacked cohort (a yardstick the port does not use); and the
    port's step for one client. Wall ms per step by CUDA events over
    back-to-back steps, device-busy ms per step by the profiler."""
    import torch.nn.functional as F

    from fedml_tpu_torch import models
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.core import optimizers
    from fedml_tpu_torch.core.local_trainer import make_local_train_fn
    from fedml_tpu_torch.core.types import Batches

    a = Arguments()
    a.model, a.dataset = "cnn", "femnist"
    model = models.create(a, 62, device=DEVICE)
    params = model.init(torch.Generator().manual_seed(0))
    C, B, lr = 32, 32, 0.03
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x = torch.randn((C, 1, B, 28, 28, 1), generator=gen, device=DEVICE)
    y = torch.randint(0, 62, (C, 1, B), generator=gen, device=DEVICE)
    cohort = Batches(x=x, y=y, mask=torch.ones((C, 1, B), device=DEVICE))
    one = Batches(x=x[:1], y=y[:1], mask=cohort.mask[:1])
    step = make_local_train_fn(model.apply, model.loss_fn, optimizers.sgd(lr), epochs=1,
                               shuffle=False)
    stacked = {k: v.expand((C,) + tuple(v.shape)).contiguous() for k, v in params.items()}

    def grouped():
        p = {k: v.detach().requires_grad_(True) for k, v in stacked.items()}
        h = x[:, 0, ..., 0].transpose(0, 1)  # [B, C, 28, 28]: client = channel
        h = F.conv2d(h, p["Conv_0/weight"].flatten(0, 1), p["Conv_0/bias"].flatten(),
                     padding=1, groups=C)
        h = F.max_pool2d(F.relu(h), 2)
        h = F.conv2d(h, p["Conv_1/weight"].flatten(0, 1), p["Conv_1/bias"].flatten(),
                     padding=1, groups=C)
        h = F.max_pool2d(F.relu(h), 2)  # [B, C*64, 7, 7]
        h = h.reshape(B, C, 64, 7, 7).permute(1, 0, 3, 4, 2).reshape(C, B, -1)
        h = F.relu(torch.baddbmm(p["Dense_0/bias"][:, None], h,
                                 p["Dense_0/weight"].transpose(1, 2)))
        logits = torch.baddbmm(p["Dense_1/bias"][:, None], h, p["Dense_1/weight"].transpose(1, 2))
        loss = F.cross_entropy(logits.flatten(0, 1), y[:, 0].flatten(), reduction="sum") / B
        grads = torch.autograd.grad(loss, list(p.values()))
        return {k: v - lr * g for (k, v), g in zip(p.items(), grads)}

    # the hand-written step computes the port's step: both run cuDNN's
    # grouped convolution (vmap batches a convolution over clients as
    # one with groups=C), so they agree to rounding (0 on the card)
    want, _ = step(params, cohort)
    got = grouped()
    err = max(float((got[k].detach() - want[k]).abs().max()) for k in want)
    out = {}
    for name, fn in (("port vmapped step, 32 clients", lambda: step(params, cohort)),
                     ("grouped-conv step by hand, 32 clients", grouped),
                     ("port vmapped step, 1 client", lambda: step(params, one))):
        wall = cuda_time_ms(fn, 20, 3)
        busy, kernels = device_busy_ms(fn)
        out[name] = {"wall_ms": wall, "device_busy_ms": busy, "kernels": kernels}
        log(f"fedavg step yardstick: {name}: {wall:.3f} ms per step, device busy "
            f"{'not measured' if busy is None else f'{busy:.3f} ms'}, {kernels:.0f} device "
            f"kernels per step")
    log(f"fedavg step yardstick: grouped-conv step vs the port's, max abs err {err:.3g}")
    if not err <= 1e-4:
        fail(f"the grouped-conv yardstick computes another step (err {err})")
    out["grouped_vs_port_max_abs_err"] = err
    return out


def profile_summary(tag: str, summary: dict) -> dict:
    """Print a ``profile_rounds`` summary (``core/tracing.py``): wall,
    device busy (the union of device intervals) and idle, kernel time by
    kind and by kernel; returns the numbers."""
    busy, window = summary["device_busy_s"], summary["wall_s"]
    by_kernel = summary["device_s_by_kernel"]
    top = list(by_kernel.items())[:15]
    kinds, kind_launches = {}, {}
    for name, sec in by_kernel.items():
        kinds[kernel_kind(name)] = kinds.get(kernel_kind(name), 0.0) + sec
    for name, n in summary["device_launches_by_kernel"].items():
        kind_launches[kernel_kind(name)] = kind_launches.get(kernel_kind(name), 0) + n
    if busy <= 0:
        log(f"{tag}: the profiler saw no device events; device time not measured")
        return {"wall_ms": window * 1e3, "device_busy_ms": None}
    total = summary["device_kernel_s"]
    log(f"{tag}: wall {window * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
        f"({busy / window:.1%}), idle {(window - busy) * 1e3:.1f} ms; kernel time "
        f"{total * 1e3:.1f} ms summed over streams (cuDNN runs a grouped convolution's "
        f"groups on several streams, so it can exceed the busy time); "
        f"{summary['device_launches']} device intervals, {len(by_kernel)} distinct "
        f"kernels; by kind:")
    for kind, sec in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"  {sec * 1e3:9.3f} ms  {sec / total:6.1%}  {kind_launches[kind]:7d} launches  {kind}")
    log(f"{tag}: kernel time by kernel:")
    for name, sec in top:
        log(f"  {sec * 1e3:9.3f} ms  {name[:110]}")
    return {"wall_ms": window * 1e3, "device_busy_ms": busy * 1e3,
            "busy_share": busy / window, "kernel_sum_ms": total * 1e3,
            "device_launches": summary["device_launches"],
            "by_kind_ms": {k: v * 1e3 for k, v in kinds.items()},
            "launches_by_kind": kind_launches,
            "top_kernels_ms": [(n[:110], sec * 1e3) for n, sec in top]}


def run_fedavg():
    """The headline configuration through ``run_simulation``."""
    import tempfile

    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_arguments
    from fedml_tpu_torch.ops.flash_attention import FWD_KERNEL

    oracle_err = fedavg_oracle()
    vec_seq_errs = fedavg_vectorized_vs_sequential()
    yardstick = fedavg_step_yardstick()

    args = load_arguments(str(FEDAVG_CONFIG))
    profiled = HEADLINE_WARMUP + HEADLINE_TIMED
    with tempfile.TemporaryDirectory(prefix="fedavg_smoke_") as tmp:
        args.comm_round = profiled + 1
        args.frequency_of_the_test = 1
        args.metrics_jsonl_path = str(Path(tmp) / "metrics.jsonl")
        args.telemetry_dir = tmp
        args.profile_rounds = [profiled]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        FWD_KERNEL.reset_launches()  # this path runs no hand-written kernel
        t0 = time.perf_counter()
        final = fedml_tpu_torch.run_simulation(device=DEVICE, args=args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {FWD_KERNEL.name: FWD_KERNEL.launches}
        rounds = [rec for rec in map(json.loads, (Path(tmp) / "metrics.jsonl").read_text()
                                     .splitlines()) if rec["kind"] == "server_train"]
        summary = json.loads((Path(tmp) / "profile" / f"round_{profiled:04d}"
                              / "summary.json").read_text())
    n_clients, epochs = int(args.client_num_per_round), int(args.epochs)
    timed = rounds[HEADLINE_WARMUP:HEADLINE_WARMUP + HEADLINE_TIMED]
    train_s = sum(r["train_time_s"] for r in timed)
    rounds_per_s = len(timed) / train_s
    # real (unmasked) examples each round trains on: the cohort's per
    # epoch count, times the epochs
    samples = timed[0]["cohort_samples"] * epochs
    log(f"fedavg headline: {n_clients} clients x {int(args.synthetic_train_size) // n_clients} "
        f"samples, {args.model}, {epochs} epochs, batch {args.batch_size}, "
        f"{len(rounds)} rounds in {wall:.1f} s (data, init and warm-up included); "
        f"kernel launches on this path {launches}")
    for r in rounds:
        log(f"  round {r['round']}: train {r['train_time_s'] * 1e3:.1f} ms, with eval "
            f"{r['round_time_s'] * 1e3:.1f} ms; train_loss {r['train_loss']:.4f}, "
            f"train_acc {r['train_acc']:.4f}, test_loss {r['test_loss']:.4f}, "
            f"test_acc {r['test_acc']:.4f}, cohort loss {r['train_loss_cohort']:.4f}")
    log(f"fedavg headline: rounds {HEADLINE_WARMUP}-{HEADLINE_WARMUP + HEADLINE_TIMED - 1} "
        f"(timed): {rounds_per_s:.3f} rounds/s, {samples * rounds_per_s:.0f} real samples/s "
        f"({samples} per round), peak memory {peak / 2**20:.1f} MiB")
    profile = profile_summary(f"fedavg profile of round {profiled} (training + eval)", summary)

    losses = [r["train_loss"] for r in rounds]
    final_acc = rounds[-1]["test_acc"]
    floor = CHANCE_FACTOR / 62
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"headline train loss did not fall across the rounds: {losses}")
    if not final_acc >= floor:
        fail(f"headline test accuracy {final_acc} after {len(rounds)} rounds is under "
             f"{CHANCE_FACTOR}x chance ({floor:.3f})")
    if final["round"] != rounds[-1]["round"]:
        fail("run_simulation's result is not the last round's stats")
    if launches[FWD_KERNEL.name] != 0:
        fail(f"the flash kernel ran {launches} times on the FedAvg path, which has no attention")
    return {
        "oracle_max_abs_err": oracle_err, "vectorized_vs_sequential_max_abs_err": vec_seq_errs,
        "rounds_per_s": rounds_per_s, "real_samples_per_s": samples * rounds_per_s,
        "timed_round_train_s": [r["train_time_s"] for r in timed],
        "peak_memory_bytes": peak,
        "train_loss": losses, "test_acc": [r["test_acc"] for r in rounds],
        "step_yardstick": yardstick, "kernel_launches": launches,
        "profile": {"round": profiled, **profile},
    }


# -- phase 6 -----------------------------------------------------------
def launches_by_kind(fn) -> dict:
    """Device kernel launches of one call of ``fn``, by kind, from a
    ``torch.profiler`` window (after one warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            out[kernel_kind(e.name)] = out.get(kernel_kind(e.name), 0) + 1
    return out


def dense_step_census(model, epochs: int) -> dict:
    """One local step of the dense model through the port's trainer, for
    one client and for the 16-client bucket (64 images each):

    - training FLOPs per image, counted by
      ``torch.utils.flop_counter.FlopCounterMode`` over the ONE-client
      step, whose convolutions are ungrouped. Over the vmapped cohort the
      counter prices a grouped convolution's weight gradient as if every
      group saw every input channel (groups x too high), so that count is
      printed, not used;
    - device launches by kind: vmap must batch GroupNorm (and its
      backward) into the same kernels for 16 clients as for one, not
      fall back to a loop over clients."""
    from torch.utils.flop_counter import FlopCounterMode

    from fedml_tpu_torch.core import optimizers
    from fedml_tpu_torch.core.local_trainer import make_local_train_fn
    from fedml_tpu_torch.core.types import Batches

    params = model.init(torch.Generator().manual_seed(0))
    step = make_local_train_fn(model.apply, model.loss_fn, optimizers.sgd(0.03), epochs=epochs,
                               shuffle=False, compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    flops, kinds = {}, {}
    for clients in (1, 16):
        x = torch.randn((clients, 1, 64) + tuple(model.example_shape), generator=gen,
                        device=DEVICE)
        y = torch.randint(0, 10, (clients, 1, 64), generator=gen, device=DEVICE)
        batch = Batches(x=x, y=y, mask=torch.ones((clients, 1, 64), device=DEVICE))
        with FlopCounterMode(display=False) as counter:
            step(params, batch)
        flops[clients] = counter.get_total_flops() / (clients * 64 * epochs)
        kinds[clients] = launches_by_kind(lambda: step(params, batch))
    log(f"dense FLOPs per trained image (FlopCounterMode, one client's step): "
        f"{flops[1] / 1e9:.4f} GFLOP; the same counter over the 16-client vmapped step "
        f"reads {flops[16] / 1e9:.4f} GFLOP per image (grouped weight gradients "
        f"overcounted; not used)")
    log(f"dense step launches by kind, 1 client: {kinds[1]}; 16 clients: {kinds[16]}")
    if kinds[16].get("GroupNorm", 0) != kinds[1].get("GroupNorm", 0) or not kinds[1].get(
            "GroupNorm"):
        fail(f"GroupNorm launches per step differ between 1 and 16 clients "
             f"({kinds[1].get('GroupNorm')} vs {kinds[16].get('GroupNorm')}): vmap is "
             f"not batching it")
    return {"per_image": flops[1], "vmapped_counter_per_image": flops[16],
            "step_launches_by_kind": kinds}


def _dense_sim(depth: int, comm_round: int, freq: int):
    """The dense configuration's simulator, as ``run_simulation`` builds
    it, kept so that its trainer's params can be read afterwards."""
    import fedml_tpu_torch
    from fedml_tpu_torch import data, models
    from fedml_tpu_torch.arguments import load_arguments
    from fedml_tpu_torch.simulation import SimulatorSingleProcess

    args = load_arguments(str(DENSE_CONFIG))
    args.pipeline_depth, args.comm_round, args.frequency_of_the_test = depth, comm_round, freq
    args.log_metrics = False
    args = fedml_tpu_torch.init(args)
    dataset = data.load(args, device=DEVICE)
    model = models.create(args, dataset.class_num, device=DEVICE)
    return SimulatorSingleProcess(args, DEVICE, dataset, model)


@contextlib.contextmanager
def sync_debug_between_flushes():
    """``torch.cuda.set_sync_debug_mode("error")`` over the round
    pipeline's hot loop: any operation that makes the host wait for the
    card raises, except inside the horizon's one upload and the
    deferred-metrics flushes (an event wait is not such an operation)."""
    from fedml_tpu_torch.core.round_pipeline import RoundPipeline
    from fedml_tpu_torch.core.tracking import DeferredMetrics

    real = {"run": RoundPipeline.run, "_precompute": RoundPipeline._precompute,
            "flush": DeferredMetrics.flush}

    def allowed(fn):
        def call(*a, **kw):
            torch.cuda.set_sync_debug_mode("default")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return call

    def run(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real["run"](*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    RoundPipeline.run, RoundPipeline._precompute = run, allowed(real["_precompute"])
    DeferredMetrics.flush = allowed(real["flush"])
    try:
        yield
    finally:
        RoundPipeline.run, RoundPipeline._precompute = real["run"], real["_precompute"]
        DeferredMetrics.flush = real["flush"]
        torch.cuda.set_sync_debug_mode("default")


def dense_pipeline_check():
    """Depth 4 against depth 1 on the dense configuration (4 rounds,
    evaluation every 2), under deterministic cuDNN for this check only:
    cuDNN's grouped kernels need not be bitwise reproducible otherwise.
    The depth-4 run's hot loop runs under sync debug mode "error"."""
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    out = {}
    try:
        for depth in (1, 4):
            sim = _dense_sim(depth, DENSE_CHECK_ROUNDS, DENSE_CHECK_FREQ)
            t0 = time.perf_counter()
            if depth == 4:
                with sync_debug_between_flushes():
                    sim.run()
            else:
                sim.run()
            torch.cuda.synchronize()
            api = sim.fl_trainer
            out[depth] = {
                "params": {k: v.detach().clone() for k, v in api.global_params.items()},
                "history": [{k: v for k, v in h.items()
                             if k not in ("round_time_s", "train_time_s")} for h in api.history],
                "stats": {k: v for k, v in api.pipeline_stats.items() if k != "round_spans_s"},
                "wall_s": time.perf_counter() - t0,
            }
            del sim, api
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    p1, p4 = out[1]["params"], out[4]["params"]
    unequal = [k for k in p1 if not torch.equal(p1[k], p4[k])]
    dtypes = sorted({str(v.dtype) for v in p4.values()})
    log(f"dense pipeline check (cuDNN deterministic for this check only): depth 1 "
        f"{out[1]['stats']} in {out[1]['wall_s']:.1f} s; depth 4 {out[4]['stats']} in "
        f"{out[4]['wall_s']:.1f} s, its hot loop under sync debug mode 'error' between "
        f"flushes; params differing bitwise: {len(unequal)} of {len(p1)}; master dtypes "
        f"{dtypes}")
    if unequal:
        err = max(float((p1[k] - p4[k]).abs().max()) for k in unequal)
        fail(f"depth 4 differs from depth 1 in {len(unequal)} params (max {err})")
    if out[1]["history"] != out[4]["history"]:
        fail(f"depth 4's records differ from depth 1's: {out[1]['history']} vs "
             f"{out[4]['history']}")
    if dtypes != ["torch.float32"]:
        fail(f"master params are {dtypes} after bf16 training, want float32")
    s4 = out[4]["stats"]
    if not (s4["host_syncs"] == s4["flushes"] < DENSE_CHECK_ROUNDS):
        fail(f"depth 4 fetched {s4['host_syncs']} times in {s4['flushes']} flushes")
    return {"bitwise_equal": True, "master_dtypes": dtypes,
            "depth1": out[1]["stats"], "depth4": out[4]["stats"],
            "wall_s": {d: out[d]["wall_s"] for d in out}}


def run_dense():
    """The north-star cohort through ``run_simulation``, as configured."""
    import tempfile

    import fedml_tpu_torch
    from fedml_tpu_torch import models
    from fedml_tpu_torch.arguments import load_arguments
    from fedml_tpu_torch.ops.flash_attention import FWD_KERNEL

    args = load_arguments(str(DENSE_CONFIG))
    model = models.create(args, 10, device=DEVICE)
    flops = dense_step_census(model, int(args.epochs))
    del model
    with tempfile.TemporaryDirectory(prefix="dense_smoke_") as tmp:
        args.metrics_jsonl_path = str(Path(tmp) / "metrics.jsonl")
        args.telemetry_dir = tmp
        args.profile_rounds = [DENSE_PROFILED]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        FWD_KERNEL.reset_launches()  # this path runs no hand-written kernel
        t0 = time.perf_counter()
        final = fedml_tpu_torch.run_simulation(device=DEVICE, args=args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {FWD_KERNEL.name: FWD_KERNEL.launches}
        lines = [json.loads(line) for line in
                 (Path(tmp) / "metrics.jsonl").read_text().splitlines()]
        summary = json.loads((Path(tmp) / "profile" / f"round_{DENSE_PROFILED:04d}"
                              / "summary.json").read_text())
    records = [r for r in lines if r["kind"] == "server_train"]
    pipe = next(r for r in lines if r["kind"] == "pipeline")
    spans = pipe["round_spans_s"]
    first, last = DENSE_TIMED
    timed_s = spans[last][1] - spans[first][0]
    n_timed = last - first + 1
    rounds_per_s = n_timed / timed_s
    bucket, nb, bs = pipe["bucket"], pipe["num_batches"], int(args.batch_size)
    epochs = int(args.epochs)
    # real examples of the timed rounds' cohorts, per round, x epochs
    real = float(np.mean(pipe["round_samples"][first:last + 1])) * epochs
    computed = bucket * nb * bs * epochs
    flops_round = flops["per_image"] * computed
    peak_flops = PEAK_FLOPS[torch.bfloat16]
    card = card_line()
    log(f"dense: {args.model}, {args.client_num_per_round} of {args.client_num_in_total} "
        f"clients per round (pow2 bucket {bucket}), batch {bs}, {epochs} epoch, "
        f"{args.dtype}; {len(spans)} rounds in {wall:.1f} s (data, init and warm-up "
        f"included); kernel launches on this path {launches}; pipeline {dict((k, v) for k, v in pipe.items() if k not in ('round_spans_s', 'ts', 'kind'))}")
    for r, (a, b) in enumerate(spans):
        log(f"  round {r}: {(b - a) * 1e3:.1f} ms on the card's clock")
    for r in records:
        log(f"  round {r['round']} record: train {r['train_time_s'] * 1e3:.1f} ms; "
            f"train_loss {r['train_loss']:.4f}, train_acc {r['train_acc']:.4f}, "
            f"test_loss {r['test_loss']:.4f}, test_acc {r['test_acc']:.4f}, cohort loss "
            f"{r['train_loss_cohort']:.4f}, cohort samples {r['cohort_samples']:.0f}")
    log(f"dense on {card}: rounds {first}-{last} timed as a whole on the card's clock "
        f"(CUDA events; the pipeline reads them after its flushes): {timed_s:.4f} s, "
        f"{rounds_per_s:.4f} rounds/s; {real * rounds_per_s:.1f} real samples/s ({real:.0f} "
        f"per round); {computed * rounds_per_s:.1f} computed samples/s ({computed} per "
        f"round, padded slots counted); model FLOPs per round {flops_round / 1e12:.3f} "
        f"TFLOP computed ({flops['per_image'] / 1e9:.4f} GFLOP per image, FlopCounterMode), "
        f"{flops['per_image'] * real / 1e12:.3f} TFLOP on real samples; "
        f"{flops_round * rounds_per_s / 1e12:.2f} TFLOP/s = "
        f"{flops_round * rounds_per_s / peak_flops:.2%} of the {peak_flops / 1e12:.0f} TFLOP/s "
        f"bf16 dense peak (NVIDIA H100 SXM data sheet), "
        f"{flops['per_image'] * real * rounds_per_s / peak_flops:.2%} counting real samples "
        f"only; peak memory {peak / 2**20:.1f} MiB (torch.cuda.max_memory_allocated)")
    profile = profile_summary(
        f"dense profile of round {DENSE_PROFILED} (training only) on {card}", summary)
    if profile.get("device_launches"):
        steps = nb * epochs
        per_kind = {k: round(n / steps, 1) for k, n in profile["launches_by_kind"].items()}
        log(f"dense on {card}: {profile['device_launches'] / steps:.0f} device launches "
            f"per step ({steps} steps in the profiled round); per step by kind: {per_kind}")

    losses = [r["train_loss"] for r in records]
    if len(records) < 2 or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"dense train loss did not fall across the rounds: {losses}")
    if final["round"] != records[-1]["round"]:
        fail("run_simulation's result is not the last round's stats")
    if launches[FWD_KERNEL.name] != 0:
        fail(f"the flash kernel ran {launches} times on the dense path, which has no attention")
    check = dense_pipeline_check()
    return {
        "card": card, "rounds_per_s": rounds_per_s, "timed_rounds_s": timed_s,
        "round_device_s": [b - a for a, b in spans],
        "real_samples_per_s": real * rounds_per_s,
        "computed_samples_per_s": computed * rounds_per_s,
        "flops_per_image": flops, "flops_per_round": flops_round,
        "bf16_peak_share": flops_round * rounds_per_s / peak_flops,
        "bf16_peak_share_real": flops["per_image"] * real * rounds_per_s / peak_flops,
        "peak_memory_bytes": peak, "train_loss": losses,
        "test_acc": [r["test_acc"] for r in records], "pipeline": pipe,
        "profile": {"round": DENSE_PROFILED, **profile}, "pipeline_check": check,
        "kernel_launches": launches,
    }


def main() -> int:
    sys.path.insert(0, str(REPO))
    try:
        import fedml_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    build_kernels()
    kernels = [check_flash_kernel()]
    slice_numbers = run_slice(kernels)
    log(f"slice numbers on {card}: {json.dumps(slice_numbers)}")
    fedavg_numbers = run_fedavg()
    log(f"fedavg numbers on {card}: {json.dumps(fedavg_numbers)}")
    dense_numbers = run_dense()
    log(f"dense numbers on {card}: {json.dumps(dense_numbers)}")
    for entry in kernels:  # each path's own count, reset just before it
        entry["launches_by_path"] = {
            "serving": entry["launches"],
            "fedavg_headline": fedavg_numbers["kernel_launches"][entry["name"]],
            "fedavg_dense": dense_numbers["kernel_launches"][entry["name"]],
        }
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
