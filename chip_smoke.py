#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fedml_tpu_torch``) on one NVIDIA card.

Drives the port's paths once each through the entry points a user
calls, and holds every hand-written kernel against its plain PyTorch
version on the card:

- serving: ``load_yaml_arguments`` on
  ``fedml_tpu_torch/configs/serve_transformer_flash.yaml``,
  ``models.create``, ``convert.params_from_flax``, ``ModelEndpoint`` and
  ``ServingEngine``, at the full width of that configuration (embed 512,
  8 heads of 64, 4096 tokens, 2 layers, seeded random weights);
- serving over the comm layer: the same configuration with
  ``serve_fleet_size: 2`` behind ``FleetFrontend``, clients on ranks 1-8
  over LOCAL and over TRPC on loopback, ``CheckpointWatcher`` publishes,
  ``MeshModelEndpoint`` in a NCCL world of one, and
  ``python -m fedml_tpu_torch.cli serve --dry-run``;
- FedAvg training: ``fedml_tpu_torch.run_simulation`` on
  ``fedml_tpu_torch/configs/fedavg_femnist_cnn.yaml``, the bench's
  headline cohort at full width (32 clients x 600 samples of the
  FEMNIST stand-in, the 2-conv CNN, 5 local epochs, batch 32);
- dense FedAvg: ``run_simulation`` on
  ``fedml_tpu_torch/configs/fedavg_cifar10_resnet18_bf16.yaml``, the
  repo's north-star cohort at full width (ResNet-18-GN on the CIFAR-10
  stand-in, 10 of 100 clients per round, batch 64, bf16 over f32
  masters) through the round pipeline;
- transformer FedAvg: ``run_simulation`` on
  ``fedml_tpu_torch/configs/fedavg_shakespeare_transformer_flash_bf16.yaml``,
  the flash TransformerLM at the repo's long-context point (embed 512,
  8 heads of 64, T 4096, 2 layers) on the Shakespeare stand-in, 8 of 32
  clients per round, batch 4, bf16 over f32 masters: the flash forward
  and backward kernels, one launch each per layer per step for the
  whole cohort;
- the same transformer at the reference's default dtype, f32:
  ``run_simulation`` on
  ``fedml_tpu_torch/configs/fedavg_shakespeare_transformer_flash.yaml``
  (full width, 3 rounds): the f32 flash forward and backward kernels;
- the fifth slice: FedAvg of the federated RNNs through
  ``run_simulation`` on ``fedml_tpu_torch/configs/fedavg_shakespeare_rnn.yaml``
  (the McMahan et al. Shakespeare LSTM, 10 of 715 clients per round,
  batch 4, T 80) and ``fedavg_stackoverflow_rnn.yaml`` (the Stack
  Overflow LSTM, vocab 10,004, 50 of 1,000 clients per round, batch 16),
  custom operators passed positionally to ``run_simulation``, a
  checkpointed run resumed, and the transformer with ``remat: true``;
- the sixth slice: the registry-backed population plane through
  ``run_simulation`` on ``fedml_tpu_torch/configs/fedavg_planet_lr.yaml``
  (the bench's planet configuration: a 1,000,000-client registry, 10,000
  clients a round, 4 edge aggregators, logistic regression over 60-dim
  synthetic features), whose cohort features come from the keyed
  feature kernel and whose aggregation folds through the exact fold
  kernel, one launch a group and one root merge a round;
- the seventh slice: Stack Overflow tag prediction through
  ``run_simulation`` on ``fedml_tpu_torch/configs/fedavg_stackoverflow_lr.yaml``
  at full width (logistic regression from the 10,000-word bag to 500
  tags, 10,000 stand-in examples over 100 of its 400 clients, 10 a round), the
  LEAF files of ``fedml_data/mnist`` through ``fedavg_mnist_leaf_lr.yaml``,
  and FedProx on synthetic(1, 1) through ``fedprox_synthetic_1_1.yaml``;
- the eighth slice: the poisoned FEMNIST world through ``run_simulation``
  on ``fedml_tpu_torch/configs/fedavg_femnist_cnn_poisoned.yaml`` (the
  headline's CNN and settings, 32 of 64 clients a round, 8 attackers
  training a backdoor, norm-diff clipping at 5.0) and its other worlds
  by overrides (clean, undefended, weak DP, median, S-FedAvg,
  HS-FedAvg), whose clip is one launch a round of the robust term
  kernel, and the encoded and clipped streaming folds at ResNet-18-GN's
  width, each term one launch of it;
- the ninth slice: the other simulation algorithms through
  ``run_simulation``, one configuration each under
  ``fedml_tpu_torch/configs/`` (HierFedAvg, DSGD and PushSum,
  TurboAggregate on the headline cohort; FedGAN on MNIST; FedNAS,
  SplitNN and FedGKT on half the CIFAR-10 stand-in; FedSeg on pascal_voc; VFL on the LEAF
  files), each timed, profiled and held to its algorithm's gate, with no
  hand-written kernel on their paths;
- the tenth slice: ``training_type: distributed`` through
  ``run_distributed`` in a NCCL world of one rank:
  ``distributed_shakespeare_moe_transformer_bf16.yaml`` (the sharded
  mode: the Switch-MoE transformer of docs/distributed.md, 8 layers, 8
  experts, batch 32 in 8 accumulation chunks, at embed 512, 8 heads of
  64, T 4096, bf16; the flash kernels in its attention) and
  ``distributed_shakespeare_transformer_sp_bf16.yaml`` (the sequence
  mode, ring attention, and Ulysses by override: the flash kernels at
  [8, 4096, 8, 64]); and the flash wrappers past their old limits, head
  dims 129-512 on the rows route (``flash_attention_rows.cu``) and T past
  grid y's 65,535 tiles;
- the fourteenth slice, cross silo: ``fedml_tpu_torch/configs/
  cross_silo_femnist_cnn.yaml`` (a server and 8 silos of the headline's
  CNN, 600 FEMNIST stand-in samples each) through the port's
  ``cross_silo.Server`` and ``Client``s as threads: LOCAL stream and
  buffered, TRPC on loopback, TRPC with norm-diff clipping and int8
  uplinks (every streamed upload one launch of the exact fold, every
  clipped or encoded one one of the robust term too), a chaos schedule
  killing the server at ``server.round_close`` and the restarted server
  RESYNCing the clients, the edge tier over ranks (``edge_plane:
  ranks``, 2 edges: each fold and each root merge a launch), and
  ``run_hierarchical_cross_silo_server`` / ``_client`` with 2 one-rank
  silos of the bf16 flash transformer at full width (the flash kernels
  behind the federation's wire);
- the fifteenth slice, cross device: ``run_beehive_world`` on
  ``fedml_tpu_torch/configs/cross_device_beehive_lr.yaml`` (bench.py's
  point: a 100,000-device registry, cohorts of 256, 3 rounds, 30% of
  each cohort vanishing at upload, masked and unmasked; every (tier,
  bucket) group's features one launch of the keyed feature kernel), the
  legacy model-file plane (``run_edge_server``'s ``ServerEdge`` and 10
  ``EdgeClientSim`` threads over MQTT on the port's broker,
  ``cross_device_mnist_lr.yaml``, 3 of its 10 rounds), and
  ``CentralizedTrainer`` on the bf16 flash transformer config (one
  epoch of its 1,024 sequences coalesced: the flash kernels forward and
  backward);
- the seventeenth slice: the serving fleet over MQTT on the port's native
  C++ broker (``FEDML_TPU_NATIVE_BROKER=1``, built with ``g++`` into
  ``fedml_tpu_torch/native/build/``) and on the Python broker, the native
  scheduler, two fresh processes serving at full width through the
  kernels' build cache (``compile_cache_dir``), and ``python -m
  fedml_tpu_torch.cli lint --ci --json``.
The CNN, ResNet, RNN and logistic-regression paths run no other hand-written
kernel: their
convolutions and matrix products are cuDNN's and cuBLAS's through
PyTorch, as XLA generated them on the TPU.

Phases, each of which fails the run:

1. card: CUDA present; the card's name and power limit from nvidia-smi;
2. build: every kernel source of the path compiles (one nvcc each, in
   parallel);
3. kernels: the flash forward and backward each against its plain
   version at the paths' shapes (the forward at serving's and training's)
   and a few more (f32 and bf16, causal and not, head dims 16-128 and
   the zero-padded 48 and 96, a ragged length, batch x heads 65,536),
   with stated tolerances; kernel, plain and library
   (one PyTorch call computing the same function: SDPA, SDPA's backward)
   times, the library call's own device kernel named from a short
   profiler window, and each time's share of the kernel's bound; the
   forward and the backward must each repeat bitwise; the exact fold
   bitwise its plain version at the planet path's shape and at
   ResNet-18-GN's (one term and three), its one-launch calls at the
   planet's 4 edges (a group's edge terms with one edge masked off; the
   root merge, also at ResNet-18-GN's size), its weighted-mean entry at
   16 clients f32 and 10 bf16, each timed by events through its wrapper
   and by the profiler's device time; the keyed feature kernel's Philox words
   bitwise and its features within 1e-5 of its plain version at the
   planet path's largest group and at FEMNIST-sized rows; each repeats
   bitwise (no PyTorch call computes either function: library time
   none); the robust term bitwise its plain version in each of its ten
   modes (raw, top-k and int8 sources; clipped or not; with or without
   the global model as base; weighted or not) at the stacked clip's
   shape (32 clients x 428,350 CNN params) and at one ResNet-18-GN
   upload (11,173,962 params over its leaves), repeating bitwise, timed
   by events (and at the two main-path modes by device time) against its
   bytes bound (library time none);
4. slice: bursts of 8 requests through ``ServingEngine``; the answers
   have the right shape, are finite and match the same model with
   ``attention_impl: full``; the kernels' launch counts rose on the
   path; a hot swap advances the version and changes the answers; one
   burst runs under ``torch.profiler`` for the device time by kernel;
4b. serving comm: the serving configuration with ``serve_fleet_size: 2``
   (two engines on the card) behind ``FleetFrontend``; eight clients
   (ranks 1-8, a thread each) send requests over LOCAL, then over TRPC
   on loopback (free ports): p50 and p99 request latency and requests/s
   (host clock), bytes per request and per response from the
   instrumented counters, and one profiled round of eight requests'
   busy share. Gates: the flash forward launches layers x the engines'
   micro-batches (``serving_batches_total`` over its buckets) and the
   backward and the plain version never; every answer within
   ``LOGITS_ATOL`` of the full-attention logits of its row, over both
   transports; a request dropped by ``fault_injection`` is counted and
   answered on the client's retry; a ``RoundCheckpointer`` publish
   reaches the fleet through ``CheckpointWatcher`` and the answers move
   to the new params' logits; a corrupt latest step falls back to the
   previous one; ``MeshModelEndpoint`` at {data: 1, fsdp: 1} in a NCCL
   world of one answers a bucket bitwise as the plain endpoint does and
   rejects (and counts) a stale version; every bucket the fleet ran is
   among the kernel phase's flash cases; ``python -m
   fedml_tpu_torch.cli serve --dry-run --fleet-size 2`` exits 0 and
   prints its status line;
4c. native and compile cache: ``g++`` on ``PATH`` (its version line) and
   the port's native broker and scheduler built from
   ``fedml_tpu_torch/native/`` (a failed build fails the phase; without
   ``g++`` the Python fallback is taken and said); the serving fleet
   behind ``FleetFrontend`` over MQTT with ``FEDML_TPU_NATIVE_BROKER=1``
   (eight clients, a warm-up and a timed round: p50 and p99, host clock)
   and the same over the Python broker; the broker process the port's
   own binary (its pid and path); native LPT equal to
   ``greedy_makespan`` on 40 seeded jobs and ``best_makespan`` equal to
   brute force on 9 jobs; two child processes (``--compile-cache-child``)
   serving four requests at full width with ``compile_cache_dir`` a fresh
   directory: the cold one counting misses = libraries it built (the
   flash forward's), hits 0, entries 1 and its ``nvcc`` seconds, the
   warm one hits 1, misses 0, entries 1, no ``nvcc`` run and answers
   bitwise the cold one's, each one's time to its first answer; ``cli
   lint --ci --json`` exiting 0 with its counts by rule. Gates: as
   above, every answer within ``LOGITS_ATOL`` of the full-attention
   logits, the flash forward launches layers x micro-batches and no
   plain flash call;
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
   depth 1 (3 rounds, cuDNN deterministic for this check only): bitwise
   equal params and records, f32 masters, and depth 4's hot loop under
   ``torch.cuda.set_sync_debug_mode("error")`` between flushes;
7. transformer: one client's step (dense FLOPs by ``FlopCounterMode``
   against 6 x weights x tokens; attention reckoned from the shapes;
   launches by kind; the port's LayerNorm timed alone at a step's
   shape, since its kernels are not told apart by name); depth 4 against depth 1 (3 rounds, under
   ``torch.use_deterministic_algorithms`` for this check only), with the
   flash launches of each run equal to layers x (steps, and evaluation's
   forward passes); the configuration through ``run_simulation`` (round
   0 warms up, rounds 1-3 are timed as a whole, round 4 is profiled,
   round 5 evaluates): rounds/s, real tokens/s, FLOPs per round, the
   share of the bf16 peak, peak memory, busy share, device time and
   launches by kind; the loss falls; the profiled round launches one
   flash forward and one backward per layer per step;
8. transformer f32: the f32 configuration through ``run_simulation``, 3
   rounds (round 1 profiled, round 2's training timed on the card's clock):
   rounds/s, real tokens/s, peak memory, busy share and launches by
   kind; the loss falls; the f32 flash forward and backward launch once
   a layer and step for the whole cohort (the forward also once a layer
   per forward pass of each evaluation), the profiled round's device
   kernels agree, and no plain version of them runs;
9. rnn: the Shakespeare configuration as it is through
   ``run_simulation`` (rounds 1-3 timed on the card's clock, round 4
   profiled): rounds/s, real tokens/s, peak memory, busy share and
   launches per step by kind; the train loss falls; depth 4 against
   depth 1 bitwise (3 rounds, deterministic algorithms for this check
   only);
10. rnn stackoverflow: the Stack Overflow configuration at full width, 2
   rounds, evaluation after each, over 200 of its 1,000 clients (each
   its 40 sequences: a round's work is the configuration's; the
   stand-in's text is made on the host): the train loss is finite and
   falls;
11. seam: on the Shakespeare RNN configuration (2 rounds), a frozen
   trainer passed positionally to ``run_simulation`` leaves the global
   model as it was (to the reference's tolerance: the weighted mean of
   identical copies rounds; whether it is bitwise is printed), an
   aggregator that keeps the global model keeps it bitwise, the default
   trainer passed explicitly is bitwise the stock engine, and a
   half-step trainer changes training;
12. resume: on the Shakespeare RNN and the transformer configurations, a
   depth-4 run with ``checkpoint_freq: 2`` stopped after round 2 and
   restored to round 3 is bitwise a straight depth-1 run, params and
   records (deterministic algorithms); save and restore times and the
   checkpoint's bytes are printed;
13. remat: the transformer configuration with ``remat: true``: the
   params after one round bitwise those without remat; 3 rounds of each
   through ``run_simulation``: peak memory (below the run without
   remat), rounds/s, and two flash forwards and one backward per layer
   per step for the whole cohort;
14. planet: the planet configuration through ``run_simulation``, 5
   rounds (round 0 warms up, rounds 1-3 are timed as a whole on the
   card's clock, round 4 is profiled; evaluation after rounds 0 and 4):
   rounds/s, clients/s, registry bytes, shape keys against their budget,
   waste fraction, peak memory, busy share and launches by kind; the
   exact fold launches once a group (its edges with weight > 0 in one
   launch) and once a round for the root merge, and the (group, edge)
   folds plus root merges equal what the registry gives; the feature
   kernel launches once a group; the evaluation loss falls; a warm
   re-run's host RSS at a 1M registry within 64 MiB of a 100k one's;
   the two-tier tree bitwise the flat fold, and a run stopped after
   round 1 and resumed bitwise the straight one;
15. tag prediction: the Stack Overflow LR configuration through
   ``run_simulation`` over 100 of its 400 clients (each its 100
   examples), 5 rounds (round 1 profiled, rounds 2-4 timed:
   training on the card's clock, whole rounds with evaluation on the
   host's, each with its spread): rounds/s, examples/s, peak memory,
   launches by kind; the train loss falls; precision, recall and F1
   from ``evaluate_global`` in [0, 1]; no hand-written kernel launches;
16. real files: the fedml_data/mnist LEAF configuration, 5 rounds
   (timed as the tag phase): the loader reports the LEAF files and logs
   no stand-in; the loss falls;
17. fedprox synthetic: the FedProx synthetic(1, 1) configuration, 5
   rounds (timed as the tag phase): the federation's sizes are the
   generator's; the loss falls;
18. poisoned worlds: the poisoned configuration through
   ``run_simulation``, 2 rounds a world: clean, undefended,
   ``norm_diff_clipping``, ``weak_dp`` (stddev 0.158), the clip and weak
   DP at stddev 0 again at a bound that bites (the median of the clip
   world's first-round delta norms, a smoke setting), and ``median``.
   The robust term launches once a round in the clip and weak-DP worlds
   and never in the others; every clip is bitwise its plain version on
   the same deltas; some delta clips in each biting world; every clipped
   delta's norm, re-measured in float64, is within the bound (1e-6
   relative plus the f32 model's rounding); weak DP at stddev 0 is the
   biting clip world bitwise and at 0.158 its noise's sample std is
   within 2% of it; the median is the plain sort midpoint (``kthvalue``)
   bitwise. Rounds/s, peak
   memory, the backdoor success rate, clean test accuracy and the share
   of clients clipped are printed, not gated;
19. defenses: S-FedAvg and HS-FedAvg on the same world, 3 rounds each:
   S-FedAvg's permutations a round and the attackers' sv and phi against
   the honest clients'; S-FedAvg stopped after round 1 and resumed is
   bitwise the straight run, phi and sv included (deterministic
   algorithms); HS-FedAvg's running amplitude is finite and its loss
   falls;
20. robust folds: 16 int8-encoded uploads at ResNet-18-GN's width, half
   of them over the bound, folded in order, shuffled and through a
   4-edge tree, for the int8 and top-k encoded clipped folds, the int8
   encoded and delta-clipped ones and the raw and delta clipped ones:
   the three finalize to identical bits; the robust term launches once
   a fold;
21. other algorithms: HierFedAvg, DSGD, PushSum, TurboAggregate, FedGAN,
   FedNAS, FedSeg, SplitNN, FedGKT and VFL, each through
   ``run_simulation`` for round 0, then round 1 timed on the card's
   clock and round 2 under ``torch.profiler``: rounds/s, examples (DSGD:
   nodes) a second, peak memory, launches by kind, busy share and the
   algorithm's own record are printed. Gates: no hand-written kernel
   launches; the training loss falls (FedGKT's from round 1, its KD
   term being off in round 0; FedNAS: its local search lowers its
   cohort's loss; FedGAN: finite losses, disc_acc in [0, 1]); HierFedAvg
   with one group is a flat FedAvg round (1e-5); DSGD's W is
   row-stochastic and PushSum's column-stochastic, PushSum's mass sum
   conserved (1e-5 relative); TurboAggregate's global model is within
   C / (2 scale) of the plain weighted mean and bitwise the host
   protocol run again with other shares; SplitNN's boundary gradient is
   joint backprop (1e-5); FedGKT's KL of equal logits is 0; every VFL
   party's params move;
22. distributed: ``run_distributed`` on both distributed configurations
   (the MoE one in the sharded mode; the sequence one with ring
   attention and with Ulysses) in a NCCL world of one rank, where every
   collective is the identity (the CPU tests' gloo worlds of 2-8 ranks
   prove the collectives; this phase the kernels, shapes, memory and
   time): optimizer steps a second and tokens a second on the card's
   clock (step 0 warms up, step 2 runs under ``torch.profiler``), peak
   memory, busy share and launches by kind in the profiled step. Gates:
   flash launches as reckoned from each configuration and no plain flash
   call; the loss falls; the MoE's slot occupancy is 0/1; ring, Ulysses
   and dense attention (f32 scores) give one batch's loss within 1e-2 on
   the same weights; the sequence run stopped after 1 of 2 epochs and
   resumed is bitwise the straight run (deterministic algorithms).
23. cross silo (after the mesh phase): World A, the cross-silo
   configuration at 1 local epoch over LOCAL stream and buffered, TRPC
   stream and TRPC with clipping and int8 uplinks (rounds/s on the host's
   clock, upload bytes a round, each close's ms, a profiled round's busy
   share and launches by kind); a chaos kill at ``server.round_close``
   of round 1 and the restart (kill-to-close seconds); World B, the edge
   tier over 2 ranks; World C, 2 one-rank hierarchical silos of the bf16
   flash transformer. Gates: stream = buffered = TRPC = the restarted
   run = World B bitwise (deterministic algorithms), World C bitwise its
   horizontal world; K1 = the uploads (+ the root's merges), K3 = the
   clipped or encoded uploads, flash = layers x steps (+ evaluations);
   no plain fold, term or flash call; the loss falls.
24. cross device (after cross silo): the Beehive world masked and
   unmasked under one churn schedule, and a one-round world under the
   profiler (folds/s and seconds a round on the host's clock, the round
   split into training, masking and folding by the host's timers, busy
   share and launches by kind, K2's device time, the registry's bytes);
   the legacy plane (rounds/s, a model file's bytes); the centralized
   trainer (step ms on the card's clock, tokens/s, peak memory). Gates:
   every round closes on its target, masked == unmasked bitwise, the
   WAL fold ledger = the fold counter, the four device invariants on
   the WAL and counters, one group function a (tier, bucket), K2 = the
   groups trained, no plain K2 call; the legacy history at the
   configured frequency, its test loss falling, every client's FINISH
   ack; the centralized flash launches = layers x (steps + evaluation
   passes) forward and layers x steps backward, no plain flash call, the
   train loss falling. The Beehive worlds export their artifacts and the
   port's ``InvariantChecker`` holds them to the four device invariants;
   in phase 23 the TRPC World A run exports too (the checker's ledger and
   counter balances, ``cli trace`` analyzing every round) and an async
   World A run proves its exactly-once ledger the same way.
25. elastic (last): the bf16 flash transformer at the resume check's
   depth preempted at round 1 (``SimulatedPreemption``) and resumed by a
   world built anew (``recovery_s``); the FEMNIST CNN on the mesh at
   ``{data: 1, fsdp: 1}`` straight (exporting its artifacts, serving
   ``/metrics`` on a free loopback port, scraped once mid-run, with the
   stall watchdog armed), preempted at round 1 and resumed; limb travel
   at the CNN's width, raw and int8. Gates: ``Preempted`` at (1, 1), the
   WAL ``preempt`` then ``resume``, resumed == straight bitwise, the
   checker ok with both preempt invariants, the flash / K1 / K3 launches
   as reckoned and no plain version, the three artifacts and no stall
   bundle, the scrape's counters and ``sys_device`` gauges, ``cli
   trace`` and ``cli check`` exiting 0.
26. examples (after audit and perf): the scripts a user starts first,
   each a child process on the card in a copy of its directory with its
   own YAML unchanged (``device_type`` defaults to ``cuda``):
   ``simulation_sp/one_line``, ``simulation_sp/custom`` and
   ``cross_device/one_line`` of ``fedml_tpu_torch/examples/``, and a
   child that calls ``fedml_tpu_torch.init()`` with no ``--cf`` and
   prints the table it resolved (it trains nothing). The children run
   side by side. Gates: each example exits 0 with one ``FINAL:`` line
   of finite losses at its last round; the default table is the JAX
   package's shipped one (mnist, 1000 clients, 200 rounds, batch 10,
   weight decay 0.001) on ``cuda``. Its seconds are reported against a
   40 s budget.
The kernels phase also holds the rows route (head dims above 128),
forward and backward, f32 and bf16, at D 160, 192, 256, 384 and 512,
causal and not, at [2, 2048, 4, D], and at [8, 4096, 8, 256] causal,
against its plain versions (the same tolerances as the D <= 128 routes;
two launches bitwise; SDPA's time beside each; the ring plan the library
reports equal to ``rows_plan``'s), and runs one bf16 causal forward and
backward at T 4,194,368 (one tile past grid y's 65,535, so the tiles
fold into grid x), D 16, batch x heads 1, holding sampled query and key
rows past tile 65,535 to a plain f32 computation of those rows alone.
Each phase's wall time is printed.

Run from the repo root, on a machine with one CUDA card and the CUDA
toolkit:  ``python3 chip_smoke.py``.  The last two lines of its output
are one JSON object ``{"kernels": [...]}`` and one
``{"ok": true, "device": {...}}``; it exits 0 only when every phase
passed.
"""

from __future__ import annotations

import contextlib
import copy
import faulthandler
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
try:  # the port's device table; without the port, main() exits 2 at once
    from fedml_tpu_torch.constants import hbm_bandwidth_bytes, peak_bf16_flops
except ImportError:
    def hbm_bandwidth_bytes(kind: str) -> float:
        return 0.0

    peak_bf16_flops = hbm_bandwidth_bytes
CONFIG = REPO / "fedml_tpu_torch" / "configs" / "serve_transformer_flash.yaml"
FEDAVG_CONFIG = REPO / "fedml_tpu_torch" / "configs" / "fedavg_femnist_cnn.yaml"
DENSE_CONFIG = REPO / "fedml_tpu_torch" / "configs" / "fedavg_cifar10_resnet18_bf16.yaml"
TRANSFORMER_CONFIG = (REPO / "fedml_tpu_torch" / "configs"
                      / "fedavg_shakespeare_transformer_flash_bf16.yaml")
TRANSFORMER_F32_CONFIG = (REPO / "fedml_tpu_torch" / "configs"
                          / "fedavg_shakespeare_transformer_flash.yaml")
RNN_CONFIG = REPO / "fedml_tpu_torch" / "configs" / "fedavg_shakespeare_rnn.yaml"
SO_RNN_CONFIG = REPO / "fedml_tpu_torch" / "configs" / "fedavg_stackoverflow_rnn.yaml"
DEVICE = "cuda"

# the script's own deadline (s from the start of main), inside the 1,200 s
# its caller allows it
DEADLINE_S = 1140.0

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit). A
# kernel's bound is the larger of the bytes it must move over the memory
# rate and its operations over the peak rate of the route that computes
# them. f32 attention runs on the tensor cores as 3xTF32: every f32
# product is three TF32 products (lo*hi + hi*lo + hi*hi of a hi/lo
# split), so its operations take three passes at the 495 TFLOP/s TF32
# peak. bf16 is bounded by the 989 TFLOP/s bf16 tensor-core peak.
# The bf16 peak and the memory rate come from the port's one device table
# (fedml_tpu_torch/constants.py); the table has no TF32 column.
H100_KIND = "NVIDIA H100 80GB HBM3"
HBM_BYTES_PER_S = hbm_bandwidth_bytes(H100_KIND)
PEAK_FLOPS = {torch.float32: 495e12, torch.bfloat16: peak_bf16_flops(H100_KIND)}
PASSES = {torch.float32: 3, torch.bfloat16: 1}
ROUTE = {torch.float32: "3xTF32", torch.bfloat16: "bf16"}

# flash kernel cases: (B, T, H, D, dtype, causal). The first is the
# serving path's own shape (serve_max_batch 8, T 4096, 8 heads of 64, f32),
# the second the transformer-training path's (8 clients x batch 4 folded
# into the batch, bf16).
FLASH_CASES = [
    (8, 4096, 8, 64, torch.float32, True),
    (32, 4096, 8, 64, torch.bfloat16, True),
    (8, 4096, 8, 64, torch.float32, False),
    (8, 4096, 8, 64, torch.bfloat16, True),
    (8, 4096, 8, 64, torch.bfloat16, False),
    (4, 4096, 4, 32, torch.float32, True),
    (2, 2048, 4, 128, torch.bfloat16, True),
    (2, 2048, 4, 128, torch.float32, True),  # most registers per thread in f32
    (2, 1024, 4, 16, torch.float32, False),
    (2, 1000, 4, 64, torch.float32, True),  # T not a multiple of the tile
    # evaluation's own shape at 16 heads (4,096 sequences of T 48 at
    # once): batch x heads 65,536, T not a multiple of the tile
    (4096, 48, 16, 32, torch.bfloat16, True),
    (2, 1024, 4, 48, torch.bfloat16, True),  # head dims the wrapper zero-pads
    (2, 1024, 4, 96, torch.float32, False),
    # the bf16 wgmma kernel at its edges: T not a multiple of the tile, the
    # narrowest and the widest head dim without the causal skip
    (2, 1000, 4, 64, torch.bfloat16, True),
    (4, 2048, 4, 16, torch.bfloat16, False),
    (2, 2048, 4, 128, torch.bfloat16, False),
    # the f32 transformer-training path's shape (8 clients x batch 4, f32)
    (32, 4096, 8, 64, torch.float32, True),
    # the distributed MoE configuration's chunk (4 sequences of T 4096)
    (4, 4096, 8, 64, torch.bfloat16, True),
    # the pipeline configuration's microbatch (16 sequences of T 4096)
    (16, 4096, 8, 64, torch.bfloat16, True),
    # the serving fleet's smaller pow2 buckets (its engines drain what the
    # clients' requests leave in their queues)
    (1, 4096, 8, 64, torch.float32, True),
    (2, 4096, 8, 64, torch.float32, True),
    (4, 4096, 8, 64, torch.float32, True),
]
# tensor-core passes each forward route makes a tile, against the two
# products the bound counts: bf16 (wgmma) S once and P V twice (P as bf16
# hi + lo), against 2 at the bf16 peak; f32 (mma.sync) 3xTF32 on both
# products, 6, which the bound counts as they are (PASSES)
FWD_ROUTE_PASSES = {torch.bfloat16: (3, 2), torch.float32: (6, 6)}
# exponentials (MUFU ex2) per clock per SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0)
EX2_PER_CLOCK_PER_SM = 16
# O and lse against the plain version. f32: the kernel's 3xTF32 products
# keep f32's accuracy, so the two differ by f32 rounding and summation
# order over up to 4096 keys (~1e-5 at T 4096), so 1e-4.
# bf16: both accumulate in f32 and round O once to bf16, so they may land
# one bf16 step apart, 2**-6 = 0.0156 for |O| in [2, 4): 2e-2. lse is f32
# in both cases.
O_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_ATOL = 1e-4
# bf16 O, element by element, against the plain version's f32 O (o32)
# before its rounding: the kernel rounds its f32 O once, which moves it by
# at most 2**-8 |o32|, so |o - o32| - 2**-8 |o32| is what its own
# arithmetic added. Any rounding of P by a relative eps moves O by at most
# eps * a32, a32 = sum_k p_k |v_k| (the plain version's softmax against
# |V|), so that excess is read in units of a32. P as bf16 hi + lo leaves
# ~2**-17 a term, one bf16 pass 2**-9: a numpy emulation of both (bf16
# inputs, shapes (heads, T, D) (2, 2048, 64) causal, (2, 2048, 16) and
# (1, 2048, 128) not, (4, 48, 32) causal) read 2**-22.6 to 2**-20.6 for hi
# + lo and 2**-11.7 to 2**-8.9 for one pass. So the limit is 2**-15.
BF16_O_EXCESS = 2.0**-15
# the share of O's elements that differ from bf16(o32): in the same
# emulation 0.15-0.25% for hi + lo and 33.5-43.0% for one pass. A dropped,
# doubled or zeroed lo pass reads as one pass; the limit sits between.
BF16_O_MISMATCH = 0.03
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
# the pipeline check: 3 rounds, evaluation every 2 (records 0, 2)
DENSE_CHECK_ROUNDS, DENSE_CHECK_FREQ = 3, 2

# backward kernel cases: (B, T, H, D, dtype, causal). The first is the
# transformer-training path's shape (8 clients x batch 4 folded into the
# batch, T 4096, 8 heads of 64, bf16).
FLASH_BWD_CASES = [
    (32, 4096, 8, 64, torch.bfloat16, True),
    (8, 4096, 8, 64, torch.float32, True),
    (4, 2048, 8, 64, torch.float32, False),
    (4, 2048, 4, 16, torch.bfloat16, True),
    (4, 2048, 4, 32, torch.float32, True),
    (2, 2048, 4, 128, torch.bfloat16, False),
    (2, 2048, 4, 128, torch.bfloat16, True),  # the dK/dV kernel's 32-query tiles, causal
    (2, 2048, 4, 128, torch.float32, True),
    (2, 1000, 4, 64, torch.bfloat16, True),  # T not a multiple of the tile
    (4096, 48, 16, 32, torch.bfloat16, True),  # batch x heads 65,536 (evaluation's)
    (2, 1024, 4, 48, torch.bfloat16, True),  # head dims the wrapper zero-pads
    (2, 1024, 4, 96, torch.float32, False),
    # the f32 transformer-training path's shape (8 clients x batch 4, f32)
    (32, 4096, 8, 64, torch.float32, True),
    (2, 1000, 4, 64, torch.float32, True),  # T not a multiple of the tile
    (1, 300, 2, 128, torch.float32, True),  # T not a multiple of the f32 kernels' 8-query steps
    (2, 1000, 4, 16, torch.float32, False),
    # the distributed MoE configuration's chunk (4 sequences of T 4096)
    (4, 4096, 8, 64, torch.bfloat16, True),
    # the pipeline configuration's microbatch (16 sequences of T 4096)
    (16, 4096, 8, 64, torch.bfloat16, True),
]
# tensor-core passes each backward route makes, against the 5 products
# the bound counts: bf16 (wgmma) S, dP twice and the products with P and
# dS as bf16 hi + lo, 1 + 1 + 2 + 2 in the dK/dV kernel and 1 + 1 + 2 in
# the dQ kernel; f32 (TF32 wgmma) 3xTF32 on all seven products
BWD_ROUTE_PASSES = {torch.bfloat16: 10, torch.float32: 21}
# dQ, dK, dV against the plain version. f32: the JAX package's gradient
# tolerance, 5e-4 absolute; the kernel's 3xTF32 keeps f32's accuracy.
# bf16: both compute in f32 from the same bf16 inputs and round each
# gradient once to bf16, so they may land one bf16 step apart (2^-8 of
# the value): 1e-2 of the largest |gradient| of the output.
BWD_F32_ATOL = 5e-4
BWD_BF16_RTOL_OF_MAX = 1e-2

# transformer phase, the configuration as it is (6 rounds, evaluation at
# 0 and 5): round 0 warms up, rounds 1-3 are timed as a whole on the
# card's clock, round 4 runs under torch.profiler (training only), round
# 5 evaluates
TRANSFORMER_TIMED = (1, 3)
TRANSFORMER_PROFILED = 4
TRANSFORMER_CHECK_ROUNDS, TRANSFORMER_CHECK_FREQ = 3, 2
# device kernels of the transformer path by kind, first match wins. The
# port's LayerNorm is written as elementwise ops and reductions, so its
# time lands in those two kinds with the softmax, loss and metric sums.
TRANSFORMER_KINDS = (
    ("flash forward", ("flash_fwd_kernel", "flash_fwd_wgmma_kernel", "rows_fwd_wgmma_kernel",
                       "rows_fwd_bf16_kernel", "rows_fwd_split_kernel")),
    ("flash backward", ("dkdv_tf32_kernel", "dq_tf32_kernel", "dkdv_wgmma_kernel",
                        "dq_wgmma_kernel", "delta_kernel", "rows_dq_wgmma_kernel",
                        "rows_dkdv_wgmma_kernel", "rows_dq128_kernel", "rows_dkdv128_kernel",
                        "rows_bwd_split_kernel")),
    ("GEMM", ("gemm", "gemv", "nvjet", "cutlass", "xmma")),
    ("embedding", ("embedding", "index", "scatter", "gather", "radix", "sort")),
    ("reductions (LayerNorm statistics, softmax, loss)", ("reduce", "softmax")),
)


# RNN phase, the Shakespeare configuration as it is (6 rounds, evaluation
# at 0 and 5): round 0 warms up, rounds 1-3 are timed as a whole on the
# card's clock, round 4 runs under torch.profiler, round 5 evaluates
RNN_TIMED = (1, 3)
RNN_PROFILED = 4
RNN_CHECK_ROUNDS, RNN_CHECK_FREQ = 3, 2
# device kernels of the RNN path by kind, first match wins
RNN_KINDS = (
    ("GEMM", ("gemm", "gemv", "nvjet", "cutlass", "xmma")),
    ("LSTM gates (sigmoid, tanh and their backward)", ("sigmoid", "tanh")),
    ("embedding", ("embedding", "index", "scatter", "gather", "radix", "sort")),
    ("reductions (softmax, loss, metric sums)", ("reduce", "softmax")),
    ("copies (stack, cat, slices)", ("copy", "cat", "stack")),
)
SO_RNN_ROUNDS = 2  # Stack Overflow at full width: 2 rounds, evaluation after each
# ... over 200 of the configuration's 1,000 clients, each with its 40
# sequences, so a round (50 clients) does the configuration's work: the
# stand-in's Markov text is made on the host (~110 s for 40,000
# sequences), and the script must stay inside its time limit
SO_RNN_CLIENTS = 200
SEAM_ROUNDS = 1
# a frozen trainer under the default (weighted-mean) aggregation: the
# reference's own tolerance (np.allclose's rtol, tests/test_operator_seam.py),
# since the weighted mean of identical copies rounds
FROZEN_RTOL = 1e-5
# resume: stopped after round 2, restored to round 3, evaluation every 2
RESUME_ROUNDS, RESUME_FREQ = 3, 2
REMAT_ROUNDS = 3


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


def all_kernels():
    """Every hand-written kernel entry of the port with a launch count:
    the flash forward and backward, their rows route (D above 128), the
    exact fold and its weighted-mean
    entry, the keyed feature generator and the robust term."""
    from fedml_tpu_torch.ops.exact_fold import FOLD_KERNEL, MEAN_KERNEL
    from fedml_tpu_torch.ops.flash_attention import (
        BWD_KERNEL,
        FWD_KERNEL,
        ROWS_BWD_KERNEL,
        ROWS_FWD_KERNEL,
    )
    from fedml_tpu_torch.ops.robust_term import TERM_KERNEL
    from fedml_tpu_torch.ops.synth_features import SYNTH_KERNEL

    return (FWD_KERNEL, BWD_KERNEL, ROWS_FWD_KERNEL, ROWS_BWD_KERNEL, FOLD_KERNEL,
            MEAN_KERNEL, SYNTH_KERNEL, TERM_KERNEL)


def reset_launches() -> None:
    """Every hand-written kernel's launch count to 0, just before a path
    runs."""
    for kernel in all_kernels():
        kernel.reset_launches()


def launch_counts() -> dict:
    return {kernel.name: kernel.launches for kernel in all_kernels()}


def no_launches() -> dict:
    """Every kernel's name with a count of 0."""
    return {kernel.name: 0 for kernel in all_kernels()}


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


# the plain versions materialize [B, H, T, T] f32 panels: they run on
# batch slices of at most this many panel elements (4 GiB each)
PLAIN_PANEL_ELEMENTS = 2**30


def plain_in_slices(fn, tensors, rest):
    """``fn(*tensors, *rest)`` of a plain version, run on batch slices
    small enough for the card's memory and concatenated: the same
    function on the same inputs, one slice at a time."""
    B, T, H = tensors[0].shape[0], tensors[0].shape[1], tensors[0].shape[2]
    step = max(1, PLAIN_PANEL_ELEMENTS // (H * T * T))
    outs = [fn(*(x[i:i + step] for x in tensors), *rest) for i in range(0, B, step)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def attention_bound(B, T, H, D, dtype, causal, products, tensors):
    """(bound_ms, bound_by) of an attention kernel that does ``products``
    [T, T]-by-D products, 2·D flops each per unmasked (query, key) pair,
    in ``PASSES[dtype]`` tensor-core passes at ``PEAK_FLOPS[dtype]``, and
    reads or writes ``tensors`` [B, T, H, D] tensors once each and the f32
    lse [B, H, T] once."""
    pairs = T * (T + 1) / 2 if causal else T * T
    flops = 2.0 * products * B * H * D * pairs
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = tensors * B * T * H * D * itemsize + 4.0 * B * H * T
    t_ops = PASSES[dtype] * flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def flash_bound(B, T, H, D, dtype, causal):
    """The forward's bound: Q K^T and P V; q, k, v read, O written."""
    return attention_bound(B, T, H, D, dtype, causal, products=2, tensors=4)


def plain_bf16_readings(q, k, v, causal, scale):
    """The plain version's O in f32 before its rounding (o32), its error
    scale a32 = sum_k p_k |v_k|, and the one-pass control: O with the
    unnormalised P = exp(s - max) rounded once to bf16 for P V, divided by
    the f32 row sum, as a kernel that drops P's lo pass computes it. All
    f32 [B, T, H, D]."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        T = q.shape[1]
        keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, -1e30)
    p = torch.softmax(s, dim=-1)
    o32 = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    a32 = torch.einsum("bhqk,bkhd->bqhd", p, vf.abs())
    del p
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    rows = e.sum(dim=-1).transpose(1, 2)[..., None]
    o_one = torch.einsum("bhqk,bkhd->bqhd", e.to(torch.bfloat16).float(), vf) / rows
    return o32, a32, o_one


def bf16_o_readings(o, o32, a32):
    """(max over elements of (|o - o32| - 2**-8 |o32|) / a32, the share
    of elements unequal to bf16(o32), mean |o - o32|) of a bf16 O against
    the plain version's f32 O."""
    of = o.float()
    excess = ((of - o32).abs() - 2.0**-8 * o32.abs()) / a32.clamp_min(1e-30)
    mismatch = (o != o32.to(torch.bfloat16)).float().mean()
    return excess.max().item(), mismatch.item(), (of - o32).abs().mean().item()


def mufu_floor_ms(B, T, H, causal, sm_count, sm_clock_hz):
    """The least time the card's special-function units take for one
    exponential per unmasked (query, key) pair: a floor under the
    forward beside its bound, not part of it."""
    pairs = T * (T + 1) / 2 if causal else T * T
    return B * H * pairs / (EX2_PER_CLOCK_PER_SM * sm_count * sm_clock_hz) * 1e3


def sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi clocks.max.sm: exit {out.returncode}: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def flash_bwd_bound(B, T, H, D, dtype, causal):
    """The backward's bound: S, dP, dV, dK and dQ; q, k, v, O and dO read,
    dQ, dK and dV written."""
    return attention_bound(B, T, H, D, dtype, causal, products=5, tensors=8)


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

    names = ["flash_attention_fwd", "flash_attention_bwd", "flash_attention_rows",
             "exact_fold", "synth_features", "robust_term"]
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
    sms, clock = torch.cuda.get_device_properties(0).multi_processor_count, sm_clock_hz()
    cases = []
    for B, T, H, D, dtype, causal in FLASH_CASES:
        # q, k, v as views of one fused projection, as the model cuts them
        qkv = torch.randn((B, T, 3 * H * D), generator=gen, device=DEVICE).to(dtype)
        q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, dim=-1))
        scale = D**-0.5
        o, lse = FWD_KERNEL(q, k, v, causal, scale)
        o_ref, lse_ref = plain_in_slices(flash_attention_reference, (q, k, v), (causal, scale))
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        finite = bool(torch.isfinite(o.float()).all()) and bool(torch.isfinite(lse).all())
        o2, lse2 = FWD_KERNEL(q, k, v, causal, scale)
        deterministic = torch.equal(o, o2) and torch.equal(lse, lse2)
        del o2, lse2
        bf16 = {}
        if dtype == torch.bfloat16:
            # the kernel and the one-pass control on the same inputs
            o32, a32, o_one = plain_in_slices(plain_bf16_readings, (q, k, v), (causal, scale))
            for name, got in (("kernel", o), ("one_pass", o_one.to(torch.bfloat16))):
                excess, mismatch, mean_err = bf16_o_readings(got, o32, a32)
                bf16[name] = {"o_excess_a32": excess, "o_mismatch_share": mismatch,
                              "o_mean_abs_err": mean_err}
            del o32, a32, o_one
        heavy = B * H * T * T >= 2**30
        ms = cuda_time_ms(lambda: FWD_KERNEL(q, k, v, causal, scale), 5 if heavy else 20)
        plain_ms = cuda_time_ms(
            lambda: plain_in_slices(flash_attention_reference, (q, k, v), (causal, scale)),
            2 if heavy else 5, 1,
        )
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        library_ms = cuda_time_ms(sdpa, 10)
        library_kernel = device_kernel_names(sdpa)[:1] or ["not measured"]
        bound_ms, bound_by = flash_bound(B, T, H, D, dtype, causal)
        mufu_ms = mufu_floor_ms(B, T, H, causal, sms, clock)
        passes, bound_passes = FWD_ROUTE_PASSES[dtype]
        case = {
            "shape": [B, T, H, D], "dtype": str(dtype).replace("torch.", ""),
            "causal": causal, "max_abs_err": err_o, "lse_max_abs_err": err_lse,
            "o_atol": O_ATOL[dtype], "lse_atol": LSE_ATOL, "deterministic": deterministic,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_kernel": library_kernel[0],
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_route": ROUTE[dtype],
        }
        if bf16:
            case["bf16_o"] = {**bf16, "o_excess_limit": BF16_O_EXCESS,
                              "o_mismatch_limit": BF16_O_MISMATCH}
            log(f"flash {case['shape']} bf16 causal={causal}: O against the plain f32 O, "
                f"kernel / one-pass control: excess over one bf16 step "
                f"{bf16['kernel']['o_excess_a32']:.3g} / {bf16['one_pass']['o_excess_a32']:.3g}"
                f" a32 (limit {BF16_O_EXCESS:.3g}), share unequal to bf16(o32) "
                f"{bf16['kernel']['o_mismatch_share']:.4%} / "
                f"{bf16['one_pass']['o_mismatch_share']:.4%} (limit {BF16_O_MISMATCH:.0%}), "
                f"mean |err| {bf16['kernel']['o_mean_abs_err']:.3g} / "
                f"{bf16['one_pass']['o_mean_abs_err']:.3g}")
        log(f"flash {case['shape']} {case['dtype']} causal={causal}: "
            f"O err {err_o:.3g} (atol {O_ATOL[dtype]}), lse err {err_lse:.3g} "
            f"(atol {LSE_ATOL}), bitwise repeatable {deterministic}; kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, sdpa {library_ms:.3f} ms ({library_kernel[0][:90]}), "
            f"bound {bound_ms:.3f} ms ({bound_by}, {ROUTE[dtype]}): "
            f"{bound_ms / ms:.1%} of bound, the route making {passes} passes where the "
            f"bound counts {bound_passes}; exponentials' floor {mufu_ms:.3f} ms "
            f"({EX2_PER_CLOCK_PER_SM} ex2 a clock on each of {sms} SMs at "
            f"{clock / 1e6:.0f} MHz)")
        if not finite:
            fail(f"flash {case['shape']} {case['dtype']}: non-finite output")
        if not deterministic:
            fail(f"flash {case['shape']} {case['dtype']}: two launches differ")
        if err_o > O_ATOL[dtype] or err_lse > LSE_ATOL:
            fail(f"flash {case['shape']} {case['dtype']} causal={causal}: "
                 f"O err {err_o} / lse err {err_lse} over tolerance")
        if bf16 and (bf16["kernel"]["o_excess_a32"] > BF16_O_EXCESS
                     or bf16["kernel"]["o_mismatch_share"] > BF16_O_MISMATCH):
            fail(f"flash {case['shape']} bf16 causal={causal}: O off the plain f32 O by more "
                 f"than one bf16 step and P's rounding allows: {bf16['kernel']}")
        if bf16 and (bf16["one_pass"]["o_excess_a32"] <= BF16_O_EXCESS
                     or bf16["one_pass"]["o_mismatch_share"] <= BF16_O_MISMATCH):
            fail(f"flash {case['shape']} bf16 causal={causal}: the one-pass control passes "
                 f"the bf16 O limits, so they cannot tell P's hi + lo from one pass: "
                 f"{bf16['one_pass']}")
        if ms < bound_ms:
            fail(f"flash {case['shape']} {case['dtype']}: {ms} ms beats its bound "
                 f"{bound_ms} ms, so the bound is wrong")
        cases.append(case)
        del qkv, q, k, v, o, lse, o_ref, lse_ref
        torch.cuda.empty_cache()
    log(f"flash kernel launches while checking (not counted): {FWD_KERNEL.launches}")
    main, training = cases[0], cases[1]
    training_f32 = path_case(cases, F32_TRAINING_SHAPE, "float32")
    return {
        "name": FWD_KERNEL.name,
        "route": "cuda",
        "source": "fedml_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "fedml_tpu/ops/flash_attention.py:32",
        "launches": None,  # filled from the paths' runs
        **{key: main[key] for key in MAIN_KEYS},
        "shape": main["shape"], "dtype": main["dtype"],
        # the same numbers at the transformer-training paths' shapes
        "fedavg_transformer": {key: training[key] for key in MAIN_KEYS + ("shape", "dtype")},
        "fedavg_transformer_f32": {key: training_f32[key]
                                   for key in MAIN_KEYS + ("shape", "dtype")},
        "cases": cases,
    }


MAIN_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_route",
             "library_ms", "library_kernel")
# the f32 transformer-training path's flash shape: 8 clients x batch 4
# folded into the batch, T 4096, 8 heads of 64
F32_TRAINING_SHAPE = [32, 4096, 8, 64]


def path_case(cases, shape, dtype) -> dict:
    """The kernel case at a path's shape and dtype."""
    return next(c for c in cases if c["shape"] == shape and c["dtype"] == dtype)


def check_flash_backward():
    """Every backward case against the plain version; returns the
    kernel's ``kernels`` entry (main-path numbers from the first case).
    The library call is SDPA's backward on the same inputs."""
    import torch.nn.functional as F

    from fedml_tpu_torch.ops.flash_attention import (
        BWD_KERNEL,
        FWD_KERNEL,
        flash_attention_backward_reference,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    cases = []
    for B, T, H, D, dtype, causal in FLASH_BWD_CASES:
        # q, k, v as views of one fused projection, O and lse from the
        # forward kernel, as the training step hands them over
        qkv = torch.randn((B, T, 3 * H * D), generator=gen, device=DEVICE).to(dtype)
        q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, dim=-1))
        g = torch.randn((B, T, H, D), generator=gen, device=DEVICE).to(dtype)
        scale = D**-0.5
        o, lse = FWD_KERNEL(q, k, v, causal, scale)
        inputs = (q, k, v, o, lse, g)

        def kernel():
            return BWD_KERNEL(*inputs, causal, scale)

        def plain():
            return plain_in_slices(flash_attention_backward_reference, inputs, (causal, scale))

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)]
        peaks = [float(b.float().abs().max()) for b in want]
        tols = [BWD_F32_ATOL if dtype == torch.float32 else BWD_BF16_RTOL_OF_MAX * p
                for p in peaks]
        finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
        deterministic = all(torch.equal(a, b) for a, b in zip(got, kernel()))
        del want
        heavy = B * H * T * T >= 2**30
        ms = cuda_time_ms(kernel, 3 if heavy else 10)
        plain_ms = cuda_time_ms(plain, 1 if heavy else 3, 1)
        qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        gt = g.transpose(1, 2).contiguous()

        def sdpa_backward():
            return torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)

        library_ms = cuda_time_ms(sdpa_backward, 10)
        library_kernel = device_kernel_names(sdpa_backward)[:1] or ["not measured"]
        bound_ms, bound_by = flash_bwd_bound(B, T, H, D, dtype, causal)
        case = {
            "shape": [B, T, H, D], "dtype": str(dtype).replace("torch.", ""),
            "causal": causal, "max_abs_err": max(errs), "dq_dk_dv_max_abs_err": errs,
            "dq_dk_dv_max_abs": peaks, "dq_dk_dv_atol": tols, "deterministic": deterministic,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_kernel": library_kernel[0],
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_route": ROUTE[dtype],
        }
        log(f"flash backward {case['shape']} {case['dtype']} causal={causal}: dQ/dK/dV err "
            f"{'/'.join(f'{e:.3g}' for e in errs)} (atol "
            f"{'/'.join(f'{t:.3g}' for t in tols)}; max |grad| "
            f"{'/'.join(f'{p:.3g}' for p in peaks)}), bitwise repeatable {deterministic}; "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, sdpa backward {library_ms:.3f} ms "
            f"({library_kernel[0][:90]}), bound {bound_ms:.3f} ms ({bound_by}, "
            f"{ROUTE[dtype]}): {bound_ms / ms:.1%} of bound, the route making "
            f"{BWD_ROUTE_PASSES[dtype]} passes where the bound counts 5")
        if not finite:
            fail(f"flash backward {case['shape']} {case['dtype']}: non-finite gradients")
        if any(e > t for e, t in zip(errs, tols)):
            fail(f"flash backward {case['shape']} {case['dtype']} causal={causal}: errors "
                 f"{errs} over tolerance {tols}")
        if not deterministic:
            fail(f"flash backward {case['shape']} {case['dtype']}: two launches differ")
        if ms < bound_ms:
            fail(f"flash backward {case['shape']}: {ms} ms beats its bound {bound_ms} ms, "
                 "so the bound is wrong")
        cases.append(case)
        del qkv, q, k, v, g, o, lse, got, inputs, qt, kt, vt, out, gt
        torch.cuda.empty_cache()
    main = cases[0]
    training_f32 = path_case(cases, F32_TRAINING_SHAPE, "float32")
    return {
        "name": BWD_KERNEL.name,
        "route": "cuda",
        "source": "fedml_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        "replaces": "fedml_tpu/ops/flash_attention.py:140",
        "launches": None,  # filled from the paths' runs
        **{key: main[key] for key in MAIN_KEYS},
        "shape": main["shape"], "dtype": main["dtype"],
        # the same numbers at the f32 transformer-training path's shape
        "fedavg_transformer_f32": {key: training_f32[key]
                                   for key in MAIN_KEYS + ("shape", "dtype")},
        "cases": cases,
    }


# the rows route (head dims above 128): (B, T, H, D, dtype, causal), each
# forward and backward against its plain version: every padded width the
# route has (160 runs at 192) at [2, 2048, 4, D], then the serving width's
# B, T and H at D 256, where launch latency does not swamp the bound
ROWS_CASES = [
    (2, 2048, 4, D, dtype, causal)
    for D in (160, 192, 256, 384, 512) for dtype in (torch.float32, torch.bfloat16)
    for causal in (True, False)
] + [(8, 4096, 8, 256, dtype, True) for dtype in (torch.float32, torch.bfloat16)]
# the long sequence: T one tile past the 65,535 tiles of 64 that grid y
# holds, batch x heads 1, D 16, bf16, causal; sampled query rows past tile
# 65,535 (and two early ones) for O, lse and dQ, sampled key rows past it
# for dK and dV, each against a plain f32 computation of those rows alone
LONG_T = 64 * 65536 + 64
LONG_EARLY_ROWS = (0, 4095)
LONG_LATE_ROWS = (64 * 65535 + 5, 64 * 65536 + 17, LONG_T - 64, LONG_T - 1)
LONG_QUERY_ROWS = LONG_EARLY_ROWS + LONG_LATE_ROWS
LONG_KEY_ROWS = (64 * 65535 + 3, LONG_T - 64, LONG_T - 1)
# O, dQ, dK and dV of the sampled rows, element by element against the
# plain f32 values x32: |x - x32| <= 2**-7 |x32| + 1e-2 max|x32| of the
# element's group, the bf16 rule of the other flash checks with the
# scale taken per group. The groups are the early query rows, the late
# ones (past tile 65,535: an output row there averages ~4.2 M random
# rows, |O| ~ sqrt(e / T) ~ 8e-4, so only its own scale can hold it),
# and each sampled key row alone (1, 64 and ~65 k queries reach them:
# their dK and dV differ in scale by ~256). A late row's O or dQ left at
# zero or read one tile off fails by a factor of 10 or more (rehearsed
# on the CPU, tests/test_torch_flash_limits.py), while a right output
# rounded once to bf16 stays near 0.15 of it. The kernel's O and dQ
# there reach ~0.6-0.7 of it, dK and dV ~0.12 (H100, T 4,194,368)
LONG_ROUND_RTOL = 2**-7
LONG_GROUP_RTOL = 1e-2
# lse over 4.2 M keys: the kernel's f32 row sum folds 65,537 tile sums in
# turn, the plain version sums in a tree; their rounding apart is
# ~sqrt(65,537) f32 steps (~1.5e-5 relative), so 1e-3 absolute on lse
LONG_LSE_ATOL = 1e-3


def sdpa_ms(q, k, v, causal, backward: bool):
    """SDPA's time (forward, or backward on the same inputs) and its
    kernel, or (None, reason) where no SDPA backend takes the shape."""
    import torch.nn.functional as F

    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_(backward)
                  for x in (q, k, v))
    try:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    except RuntimeError as e:  # no backend for this head dim: the library has no call
        return None, f"no SDPA backend: {str(e)[:80]}"
    if backward:
        gt = torch.randn_like(out)

        def call():
            return torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)
    else:
        def call():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    return cuda_time_ms(call, 10), (device_kernel_names(call)[:1] or ["not measured"])[0]


def check_rows_plan() -> None:
    """The rows route's rings as the built library reports them
    (``flash_rows_plan``) against ``rows_plan``, the Python arithmetic the
    CPU tests hold: stage bytes, stages, exchange (or resident Q) bytes and
    shared memory of each kernel and dtype, at every head dim the bf16
    forward instantiates."""
    import ctypes

    from fedml_tpu_torch.ops import _build
    from fedml_tpu_torch.ops.flash_attention import rows_head_dim, rows_plan

    fn = _build.load("flash_attention_rows").flash_rows_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for kernel, kid in (("fwd", 0), ("dkdv", 1), ("dq", 2)):
            for D in (160, 192, 256, 384, 512):
                bf16 = dtype == torch.bfloat16
                dp = rows_head_dim(D, bf16 and kid == 0)
                buf = (ctypes.c_int * 4)()
                fn(code, kid, dp, ctypes.addressof(buf))
                want = rows_plan(dtype, kernel, D)
                if list(buf) != list(want.values()):
                    fail(f"flash rows plan {dtype} {kernel} D {D}: the library's {list(buf)}, "
                         f"rows_plan's {want}")
            log(f"flash rows plan {dtype} {kernel}: {want} (D {D})")


def check_flash_rows():
    """The rows route, forward and backward, at every case against the
    plain versions; returns the two kernels' ``kernels`` entries (main
    numbers from the first case)."""
    from fedml_tpu_torch.ops.flash_attention import (
        ROWS_BWD_KERNEL,
        ROWS_FWD_KERNEL,
        flash_attention_backward_reference,
        flash_attention_reference,
    )

    check_rows_plan()
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    fwd_cases, bwd_cases = [], []
    for B, T, H, D, dtype, causal in ROWS_CASES:
        qkv = torch.randn((B, T, 3 * H * D), generator=gen, device=DEVICE).to(dtype)
        q, k, v = (t.view(B, T, H, D) for t in qkv.split(H * D, dim=-1))
        g = torch.randn((B, T, H, D), generator=gen, device=DEVICE).to(dtype)
        scale = D**-0.5
        o, lse = ROWS_FWD_KERNEL(q, k, v, causal, scale)
        o_ref, lse_ref = flash_attention_reference(q, k, v, causal, scale)
        grads = ROWS_BWD_KERNEL(q, k, v, o, lse, g, causal, scale)
        want = flash_attention_backward_reference(q, k, v, o, lse, g, causal, scale)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(grads, want)]
        peaks = [float(b.float().abs().max()) for b in want]
        tols = [BWD_F32_ATOL if dtype == torch.float32 else BWD_BF16_RTOL_OF_MAX * p
                for p in peaks]
        finite = all(bool(torch.isfinite(x.float()).all()) for x in (o, lse, *grads))
        repeat = ROWS_FWD_KERNEL(q, k, v, causal, scale)
        deterministic = (torch.equal(o, repeat[0]) and torch.equal(lse, repeat[1]) and all(
            torch.equal(a, b) for a, b in zip(grads, ROWS_BWD_KERNEL(q, k, v, o, lse, g,
                                                                     causal, scale))))
        del repeat, want
        ms = cuda_time_ms(lambda: ROWS_FWD_KERNEL(q, k, v, causal, scale), 10)
        plain_ms = cuda_time_ms(lambda: flash_attention_reference(q, k, v, causal, scale), 5, 1)
        bwd_ms = cuda_time_ms(lambda: ROWS_BWD_KERNEL(q, k, v, o, lse, g, causal, scale), 5)
        bwd_plain_ms = cuda_time_ms(lambda: flash_attention_backward_reference(
            q, k, v, o, lse, g, causal, scale), 3, 1)
        lib_ms, lib_kernel = sdpa_ms(q, k, v, causal, backward=False)
        lib_bwd_ms, lib_bwd_kernel = sdpa_ms(q, k, v, causal, backward=True)
        bound_ms, bound_by = flash_bound(B, T, H, D, dtype, causal)
        bwd_bound_ms, bwd_bound_by = flash_bwd_bound(B, T, H, D, dtype, causal)
        common = {"shape": [B, T, H, D], "dtype": str(dtype).replace("torch.", ""),
                  "causal": causal, "deterministic": deterministic,
                  "bound_route": ROUTE[dtype]}
        fwd_cases.append({**common, "max_abs_err": err_o, "lse_max_abs_err": err_lse,
                          "o_atol": O_ATOL[dtype], "lse_atol": LSE_ATOL, "ms": ms,
                          "plain_ms": plain_ms, "library_ms": lib_ms,
                          "library_kernel": lib_kernel, "bound_ms": bound_ms,
                          "bound_by": bound_by})
        bwd_cases.append({**common, "max_abs_err": max(errs), "dq_dk_dv_max_abs_err": errs,
                          "dq_dk_dv_atol": tols, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
                          "library_ms": lib_bwd_ms, "library_kernel": lib_bwd_kernel,
                          "bound_ms": bwd_bound_ms, "bound_by": bwd_bound_by})
        log(f"flash rows {common['shape']} {common['dtype']} causal={causal}: O err "
            f"{err_o:.3g} (atol {O_ATOL[dtype]}), lse err {err_lse:.3g} (atol {LSE_ATOL}), "
            f"dQ/dK/dV err {'/'.join(f'{e:.3g}' for e in errs)} (atol "
            f"{'/'.join(f'{t:.3g}' for t in tols)}), bitwise repeatable {deterministic}; "
            f"forward {ms:.3f} ms (plain {plain_ms:.3f}, sdpa {lib_ms}, bound {bound_ms:.3f} "
            f"{bound_by}), backward {bwd_ms:.3f} ms (plain {bwd_plain_ms:.3f}, sdpa "
            f"{lib_bwd_ms}, bound {bwd_bound_ms:.3f} {bwd_bound_by}); sdpa kernels "
            f"{str(lib_kernel)[:60]} / {str(lib_bwd_kernel)[:60]}")
        if not finite:
            fail(f"flash rows {common['shape']} {common['dtype']}: non-finite output")
        if not deterministic:
            fail(f"flash rows {common['shape']} {common['dtype']}: two launches differ")
        if err_o > O_ATOL[dtype] or err_lse > LSE_ATOL or any(e > t for e, t in zip(errs, tols)):
            fail(f"flash rows {common['shape']} {common['dtype']} causal={causal}: O err "
                 f"{err_o}, lse err {err_lse}, gradient errors {errs} over tolerance {tols}")
        if ms < bound_ms or bwd_ms < bwd_bound_ms:
            fail(f"flash rows {common['shape']}: a time beats its bound, so the bound is wrong")
        del qkv, q, k, v, g, o, lse, o_ref, lse_ref, grads
        torch.cuda.empty_cache()
    entries = []
    for kernel, cases, replaces in ((ROWS_FWD_KERNEL, fwd_cases, "fedml_tpu/ops/flash_attention.py:32"),
                                    (ROWS_BWD_KERNEL, bwd_cases, "fedml_tpu/ops/flash_attention.py:140")):
        main = cases[0]
        entries.append({
            "name": kernel.name, "route": "cuda",
            "source": "fedml_tpu_torch/ops/csrc/flash_attention_rows.cu",
            "replaces": replaces, "launches": None,  # filled from the paths' runs
            **{key: main[key] for key in MAIN_KEYS},
            "shape": main["shape"], "dtype": main["dtype"], "cases": cases,
        })
    return entries


def _long_rows_plain(q, k, v, rows, scale):
    """O and lse of the sampled causal query ``rows`` of [1, T, 1, D]
    inputs, in f32, each from its own keys alone."""
    os_, lses = [], []
    for i in rows:
        s = (k[0, :i + 1, 0].float() @ q[0, i, 0].float()) * scale
        lse = torch.logsumexp(s, 0)
        os_.append(torch.exp(s - lse) @ v[0, :i + 1, 0].float())
        lses.append(lse)
    return torch.stack(os_), torch.stack(lses)


def _long_grads_plain(q, k, v, o, lse, g, q_rows, k_rows, scale):
    """dQ of the sampled query rows and dK, dV of the sampled key rows of
    the causal backward on [1, T, 1, D] inputs with the forward's O and
    lse, in f32, from those rows' own terms alone."""
    qf, kf, vf, of, gf = (x[0, :, 0].float() for x in (q, k, v, o, g))
    lse = lse[0, 0]
    dq = []
    for i in q_rows:
        p = torch.exp((kf[:i + 1] @ qf[i]) * scale - lse[i])
        ds = p * (vf[:i + 1] @ gf[i] - (gf[i] * of[i]).sum()) * scale
        dq.append(ds @ kf[:i + 1])
    dk, dv = [], []
    for j in k_rows:
        p = torch.exp((qf[j:] @ kf[j]) * scale - lse[j:])
        delta = (gf[j:] * of[j:]).sum(-1)
        ds = p * (gf[j:] @ vf[j] - delta) * scale
        dk.append(ds @ qf[j:])
        dv.append(p @ gf[j:])
    return torch.stack(dq), torch.stack(dk), torch.stack(dv)


def long_sequence_shares(q, k, v, g, o, lse, dq, dk, dv, scale):
    """Each sampled output's largest error over its tolerance (above 1
    fails), and lse's largest absolute error, against the plain f32
    values of the sampled rows (``LONG_ROUND_RTOL``, ``LONG_GROUP_RTOL``).
    Takes the kernels' outputs, so a CPU run can hold planted faults to
    the same rule."""
    def share(got, want, groups):
        worst = 0.0
        for rows in groups:
            w, x = want[list(rows)], got[list(rows)].float()
            tol = LONG_ROUND_RTOL * w.abs() + LONG_GROUP_RTOL * w.abs().max()
            worst = max(worst, float(((x - w).abs() / tol).max()))
        return worst

    n_early, n_late = len(LONG_EARLY_ROWS), len(LONG_LATE_ROWS)
    query_groups = (range(n_early), range(n_early, n_early + n_late))
    key_groups = [(i,) for i in range(len(LONG_KEY_ROWS))]
    rows, keys = list(LONG_QUERY_ROWS), list(LONG_KEY_ROWS)
    o_ref, lse_ref = _long_rows_plain(q, k, v, LONG_QUERY_ROWS, scale)
    dq_ref, dk_ref, dv_ref = _long_grads_plain(q, k, v, o, lse, g, LONG_QUERY_ROWS,
                                               LONG_KEY_ROWS, scale)
    return {
        "o": share(o[0, rows, 0], o_ref, query_groups),
        "dq": share(dq[0, rows, 0], dq_ref, query_groups),
        "dk": share(dk[0, keys, 0], dk_ref, key_groups),
        "dv": share(dv[0, keys, 0], dv_ref, key_groups),
    }, (lse[0, 0, rows] - lse_ref).abs().max().item()


def sdpa_once_s(q, k, v, g) -> dict:
    """SDPA's causal forward and backward on the long sequence, one call
    each on the host clock as the kernels are timed there, and the kernel
    it ran; or the reason no backend takes the shape."""
    import torch.nn.functional as F

    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    gt = g.transpose(1, 2).contiguous()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        torch.autograd.grad(out, (qt, kt, vt), gt)
        torch.cuda.synchronize()
        bwd_s = time.perf_counter() - t0
    except (RuntimeError, torch.cuda.OutOfMemoryError) as e:
        torch.cuda.synchronize()
        return {"refused": str(e)[:160]}
    finally:
        del qt, kt, vt, gt
        torch.cuda.empty_cache()
    return {"forward_s": fwd_s, "backward_s": bwd_s}


def check_long_sequence():
    """One bf16 causal forward and backward at T one tile past grid y's
    65,535 tiles (the tiles fold into grid x): sampled rows past tile
    65,535 against a plain f32 computation of those rows alone, each
    element held to its own row group's scale (``long_sequence_shares``)."""
    from fedml_tpu_torch.ops.flash_attention import BWD_KERNEL, FWD_KERNEL, tile_grid

    T, D, dtype = LONG_T, 16, torch.bfloat16
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    q, k, v, g = (torch.randn((1, T, 1, D), generator=gen, device=DEVICE).to(dtype)
                  for _ in range(4))
    scale = D**-0.5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o, lse = FWD_KERNEL(q, k, v, True, scale)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dq, dk, dv = BWD_KERNEL(q, k, v, o, lse, g, True, scale)
    torch.cuda.synchronize()
    bwd_s = time.perf_counter() - t0
    shares, err_lse = long_sequence_shares(q, k, v, g, o, lse, dq, dk, dv, scale)
    finite = all(bool(torch.isfinite(x.float()).all()) for x in (o, lse, dq, dk, dv))
    bound_ms, bound_by = flash_bound(1, T, 1, D, dtype, True)
    bwd_bound_ms, bwd_bound_by = flash_bwd_bound(1, T, 1, D, dtype, True)
    sdpa = sdpa_once_s(q, k, v, g)
    out = {"shape": [1, T, 1, D], "dtype": "bfloat16", "causal": True,
           "grid": list(tile_grid(1, T)), "forward_s": fwd_s, "backward_s": bwd_s,
           "bound_ms": bound_ms, "bound_by": bound_by, "backward_bound_ms": bwd_bound_ms,
           "backward_bound_by": bwd_bound_by, "sdpa": sdpa,
           "share_of_tolerance": shares, "round_rtol": LONG_ROUND_RTOL,
           "group_rtol": LONG_GROUP_RTOL, "lse_max_abs_err": err_lse,
           "lse_atol": LONG_LSE_ATOL, "query_rows": list(LONG_QUERY_ROWS),
           "key_rows": list(LONG_KEY_ROWS)}
    log(f"flash long sequence {out['shape']} bf16 causal, grid {out['grid']}: forward "
        f"{fwd_s:.2f} s, backward {bwd_s:.2f} s (one call each, host clock; bound "
        f"{bound_ms:.1f} / {bwd_bound_ms:.1f} ms, {bound_by}); SDPA {sdpa}; sampled rows, "
        f"largest error over its tolerance (fails above 1): "
        f"{', '.join(f'{name} {x:.3g}' for name, x in shares.items())}; lse err "
        f"{err_lse:.3g} (atol {LONG_LSE_ATOL})")
    if not finite:
        fail("flash long sequence: non-finite output")
    if err_lse > LONG_LSE_ATOL or any(not x <= 1.0 for x in shares.values()):
        fail(f"flash long sequence: sampled rows off their plain values: {out}")
    del q, k, v, g, o, lse, dq, dk, dv
    torch.cuda.empty_cache()
    return out


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
    from fedml_tpu_torch.arguments import load_yaml_arguments
    from fedml_tpu_torch.convert import params_from_flax
    from fedml_tpu_torch.core import devtime
    from fedml_tpu_torch.ops.flash_attention import FWD_KERNEL
    from fedml_tpu_torch.serving import ModelEndpoint, ServingEngine

    args = load_yaml_arguments(str(CONFIG))
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
    reset_launches()  # count only the slice's own launches
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
    launches = launch_counts()
    batches = engine.telemetry.get_counter("serving_batches_total", bucket=len(rows))
    log(f"slice: {int(batches)} micro-batches of {len(rows)}, kernel launches {launches}")
    if batches != TIMED_BURSTS + 3:
        fail(f"expected {TIMED_BURSTS + 3} micro-batches, the engine ran {batches}")
    if launches[FWD_KERNEL.name] != L * batches:
        fail(f"flash kernel launched {launches[FWD_KERNEL.name]} times for "
             f"{batches} micro-batches of a {L}-layer model (want {L * batches})")
    if launches["flash_attention_bwd"] != 0:
        fail(f"the flash backward ran {launches} on the serving path, which trains nothing")

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
            "kernel_launches": launches,
            "serving_forward_ms": float(np.median(fwd)) * 1e3,
            "logits_max_abs_err": err, "params": n_params, "profile": profiled}


# -- phase 4b: serving over the comm layer -------------------------------
SERVE_COMM_CLIENTS = 8  # ranks 1-8, a thread each
SERVE_COMM_REQUESTS = 16  # requests each client sends in the timed round
SERVE_COMM_FLEET = 2
# the fault round's client waits this long for its dropped request
SERVE_COMM_DROP_TIMEOUT_S = 3.0


def free_port_block(n: int) -> int:
    """The first of ``n`` consecutive free loopback ports."""
    import random
    import socket

    rng = random.Random(os.getpid())
    for _ in range(100):
        base = rng.randint(20000, 55000)
        socks = []
        try:
            for i in range(n):
                sock = socket.socket()
                sock.bind(("127.0.0.1", base + i))
                socks.append(sock)
            return base
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
    fail(f"no {n} consecutive free ports")


def client_round(clients, pool, requests, timeout_s=120.0, retries=1):
    """Every client in its own thread asks for ``requests`` rows of
    ``pool`` (client c its rows c, c + 1, ...); returns [(row index,
    answer, seconds)] and the round's wall seconds."""
    import threading

    out, errors = [], []
    lock = threading.Lock()

    def run(c, cl):
        try:
            for i in range(requests):
                j = (c + i) % len(pool)
                t0 = time.perf_counter()
                y = cl.request(pool[j], timeout_s=timeout_s, retries=retries)
                dt = time.perf_counter() - t0
                with lock:
                    out.append((j, y, dt))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"client {c}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=(c, cl)) for c, cl in enumerate(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        fail(f"serving comm: {errors[:3]}")
    return out, wall


def answers_err(answers, ref) -> float:
    return max(float(np.abs(y - ref[j]).max()) for j, y, _ in answers)


@contextlib.contextmanager
def fleet_clients(args, fleet, backend, run_id, clients=SERVE_COMM_CLIENTS, faults=None):
    """A ``FleetFrontend`` of ``fleet`` on rank 0 over ``backend`` and
    ``clients`` ``ServingClient``s on ranks 1..clients (with ``faults``
    as their ``fault_injection``); stopped on the way out."""
    import threading

    from fedml_tpu_torch.serving import FleetFrontend, ServingClient, build_serving_com

    world = clients + 1
    a = copy.copy(args)
    a.run_id = run_id
    a.grpc_port_base = free_port_block(world)
    fe = FleetFrontend(fleet, build_serving_com(a, 0, world, backend), a)
    server = threading.Thread(target=fe.serve_forever, daemon=True)
    server.start()
    ca = copy.copy(a)
    ca.fault_injection = faults
    made = []
    try:
        for r in range(1, world):
            ca.rank = r
            made.append(ServingClient(build_serving_com(ca, r, world, backend), rank=r,
                                      args=ca))
        yield made
    finally:
        for cl in made:
            cl.close()
        fe.stop()
        server.join(10)


def serve_transport(args, fleet, backend, pool, ref, tag=None, profiled=True):
    """Eight clients over ``backend``: a warm-up round, one timed round and
    (``profiled``) one profiled round. Returns the numbers."""
    from fedml_tpu_torch.core.telemetry import Telemetry

    tel = Telemetry.get_instance()

    def wire_counts():
        """(messages, bytes) sent so far of requests (40) and responses (41)."""
        return {t: (tel.get_counter("comm_messages_sent_total", msg_type=t),
                    tel.get_counter("comm_bytes_sent_total", msg_type=t)) for t in (40, 41)}

    tag = tag or backend.lower()
    with fleet_clients(args, fleet, backend, f"chip_serving_comm_{tag}") as clients:
        client_round(clients, pool, 1)  # warm-up: every client's pipe open
        before = wire_counts()
        answers, wall = client_round(clients, pool, SERVE_COMM_REQUESTS)
        after = wire_counts()
        profiled = profile_clients(clients, pool) if profiled else None
    per_message = {t: (after[t][1] - before[t][1]) / max(after[t][0] - before[t][0], 1)
                   for t in (40, 41)}
    lat = np.array([dt for _, _, dt in answers])
    err = answers_err(answers, ref)
    out = {
        "requests": len(answers), "clients": SERVE_COMM_CLIENTS,
        "p50_request_latency_ms": float(np.percentile(lat, 50)) * 1e3,
        "p99_request_latency_ms": float(np.percentile(lat, 99)) * 1e3,
        "requests_per_s": len(answers) / wall,
        "request_bytes": per_message[40], "response_bytes": per_message[41],
        "logits_max_abs_err": err, "profile": profiled,
    }
    log(f"serving comm {tag}: {len(answers)} requests from {SERVE_COMM_CLIENTS} clients "
        f"in {wall:.3f} s: p50 {out['p50_request_latency_ms']:.2f} ms, p99 "
        f"{out['p99_request_latency_ms']:.2f} ms, {out['requests_per_s']:.2f} requests/s "
        f"(host clock); {out['request_bytes']:.0f} B a request, {out['response_bytes']:.0f} B "
        f"a response (instrumented counters); busy share of a profiled round "
        f"{profiled['busy_share'] if profiled else 'not profiled'}; logits err {err:.3g} "
        f"(atol {LOGITS_ATOL})")
    if err > LOGITS_ATOL:
        fail(f"serving comm {tag}: answers off the full-attention logits by {err}")
    return out


def profile_clients(clients, pool):
    """One round of one request from each client under ``torch.profiler``:
    the device's busy share of the round's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = client_round(clients, pool, 1)
    busy = sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if e.device_type == DeviceType.CUDA)
    if not busy:
        log("serving comm: the profiler saw no device events; busy share not measured")
        return {"wall_ms": wall * 1e3, "device_busy_ms": None, "busy_share": None}
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy, "busy_share": busy / (wall * 1e3)}


def serve_fault_round(args, fleet, pool, ref) -> dict:
    """One client whose first request ``fault_injection`` drops: counted,
    and answered on the client's retry."""
    from fedml_tpu_torch import constants
    from fedml_tpu_torch.core.telemetry import Telemetry

    tel = Telemetry.get_instance()
    retries0 = tel.get_counter("serving_client_retries_total")
    faults = {"drop_prob": 1.0, "max_faults": 1,
              "msg_types": [constants.MSG_TYPE_C2S_INFER_REQUEST]}
    with fleet_clients(args, fleet, "LOCAL", "chip_serving_comm_fault", clients=1,
                       faults=faults) as (cl,):
        y = cl.request(pool[0], timeout_s=SERVE_COMM_DROP_TIMEOUT_S, retries=2)
    dropped = tel.get_counter("comm_faults_injected_total", fault="drop",
                              msg_type=constants.MSG_TYPE_C2S_INFER_REQUEST)
    retries = tel.get_counter("serving_client_retries_total") - retries0
    err = float(np.abs(y - ref[0]).max())
    log(f"serving comm fault: {dropped:.0f} request dropped by fault_injection, "
        f"{retries:.0f} client retry, answer err {err:.3g}")
    if dropped != 1 or retries < 1 or err > LOGITS_ATOL:
        fail(f"serving comm fault: dropped {dropped}, retries {retries}, err {err}")
    return {"dropped": dropped, "retries": retries, "logits_max_abs_err": err}


def serve_publish_rounds(args, fleet, pool, params_by_step, output_dim, ref0) -> dict:
    """Checkpoint publishes into the serving fleet: step 1 through
    ``CheckpointWatcher.watch``, which the answers follow; then steps 2
    and 3 with step 3 corrupt: a watcher falls back to step 2."""
    import tempfile

    from fedml_tpu_torch.core.checkpoint import CheckpointWatcher, RoundCheckpointer

    out = {}
    with tempfile.TemporaryDirectory() as ckpt_dir:
        ckpt = RoundCheckpointer(ckpt_dir)
        watcher = CheckpointWatcher(ckpt_dir, poll_interval_s=0.05,
                                    restore_target=fleet.restore_target)
        watcher.watch(lambda step, state: fleet.publish_state(state, step))
        t0 = time.perf_counter()
        ckpt.save(1, {"params": params_by_step[1], "round_idx": 1})
        deadline = time.monotonic() + 60
        while (any(e.endpoint.version != 1 for e in fleet.engines)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        out["publish_to_swap_s"] = time.perf_counter() - t0
        watcher.close()
        if any(e.endpoint.version != 1 for e in fleet.engines):
            fail("serving comm: the step-1 publish never reached the fleet")
        ref1 = full_attention_logits(args, output_dim, params_by_step[1], np.stack(pool))
        out["step1"] = serve_local_check(args, fleet, pool, ref1, "after publish 1")
        out["moved"] = float(np.abs(ref1 - ref0).max())
        if out["moved"] < 1e-2:
            fail(f"serving comm: the published params moved the logits by {out['moved']} only")
        ckpt.save(2, {"params": params_by_step[2], "round_idx": 2})
        ckpt.save(3, {"params": params_by_step[1], "round_idx": 3})
        for root, _, names in os.walk(os.path.join(ckpt_dir, "3")):
            for name in names:
                with open(os.path.join(root, name), "wb") as fh:
                    fh.write(b"GARBAGE")
        watcher2 = CheckpointWatcher(ckpt_dir, restore_target=fleet.restore_target)
        watcher2.published_step = 1
        update = watcher2.poll()
        bad = sorted(watcher2._bad)
        watcher2.close()
        if update is None or update[0] != 2 or bad != [3]:
            fail(f"serving comm: the corrupt step 3 did not fall back to step 2 "
                 f"(poll {None if update is None else update[0]}, bad steps {bad})")
        fleet.publish_state(update[1], update[0])
        ref2 = full_attention_logits(args, output_dim, params_by_step[2], np.stack(pool))
        out["step2"] = serve_local_check(args, fleet, pool, ref2, "after the fallback to 2")
    log(f"serving comm publish: step 1 reached both engines "
        f"{out['publish_to_swap_s'] * 1e3:.1f} ms after its save; corrupt step 3 fell "
        f"back to step 2; answers followed (logits moved by {out['moved']:.3g})")
    return out


def serve_local_check(args, fleet, pool, ref, tag) -> dict:
    """Eight LOCAL clients, one request each: every answer against ``ref``."""
    run_id = f"chip_serving_comm_check_{tag.replace(' ', '_')}"
    with fleet_clients(args, fleet, "LOCAL", run_id) as clients:
        answers, _ = client_round(clients, pool, 1)
    err = answers_err(answers, ref)
    log(f"serving comm {tag}: logits err {err:.3g} (atol {LOGITS_ATOL})")
    if err > LOGITS_ATOL:
        fail(f"serving comm {tag}: answers off the published params' logits by {err}")
    return {"logits_max_abs_err": err}


def serve_mesh_check(model, params, params2, pool) -> dict:
    """``MeshModelEndpoint`` at {data: 1, fsdp: 1} in a NCCL world of one:
    a bucket's answers bitwise the plain endpoint's; a stale version
    rejected and counted."""
    import torch.distributed as dist

    from fedml_tpu_torch.core.telemetry import Telemetry
    from fedml_tpu_torch.ops.flash_attention import FWD_KERNEL
    from fedml_tpu_torch.parallel.layout import build_fed_mesh
    from fedml_tpu_torch.serving import MeshModelEndpoint, ModelEndpoint

    rows = np.stack(pool)
    with world_of_one():
        mesh = build_fed_mesh({"data": 1, "fsdp": 1}, dist.get_world_size(), DEVICE)
        mep = MeshModelEndpoint(model, params, mesh)
        plain = ModelEndpoint(model, params)
        launches0 = FWD_KERNEL.launches
        y_mesh = mep.infer(rows).cpu()
        y_plain = plain.infer(rows).cpu()
        launched = FWD_KERNEL.launches - launches0
        bitwise = torch.equal(y_mesh, y_plain)
        v_new = mep.swap(params2, version=5)
        v_stale = mep.swap(params, version=3)
        rejected = Telemetry.get_instance().get_counter(
            "serving_swaps_rejected_total", reason="stale_version")
        mep.release()
        del mep, plain
    torch.cuda.empty_cache()
    log(f"serving comm mesh: {{data: 1, fsdp: 1}} bucket of {len(rows)} bitwise the plain "
        f"endpoint's: {bitwise}; swap to version 5 -> {v_new}, stale version 3 -> "
        f"{v_stale}, rejected {rejected:.0f}")
    if not bitwise:
        fail("serving comm: the mesh endpoint's answers differ from the plain endpoint's "
             f"by {float((y_mesh - y_plain).abs().max())}")
    if v_new != 5 or v_stale != 5 or rejected != 1:
        fail(f"serving comm: the stale version was not rejected and counted "
             f"({v_new}, {v_stale}, {rejected})")
    return {"bitwise": bitwise, "stale_rejected": rejected, "launches": launched}


def serve_cli_dry_run() -> dict:
    """``python -m fedml_tpu_torch.cli serve --dry-run`` as a user runs it."""
    argv = [sys.executable, "-m", "fedml_tpu_torch.cli", "serve", "--dry-run", "--cf",
            str(CONFIG), "--fleet-size", str(SERVE_COMM_FLEET), "--output-dim", "90"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    out = subprocess.run(argv, cwd=str(REPO), env=env, capture_output=True, text=True,
                         timeout=300)
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    try:
        status = json.loads(lines[-1])
    except (IndexError, ValueError):
        status = None
    log(f"serving comm cli: exit {out.returncode} in {wall:.1f} s, status {status}")
    if out.returncode != 0 or not status or status.get("fleet_size") != SERVE_COMM_FLEET \
            or status.get("model") != "transformer_lm":
        fail(f"cli serve --dry-run: exit {out.returncode}, stdout {out.stdout[-500:]!r}, "
             f"stderr {out.stderr[-1500:]!r}")
    return {"status": status, "wall_s": wall}


def run_serving_comm():
    from fedml_tpu_torch import models
    from fedml_tpu_torch.arguments import load_yaml_arguments
    from fedml_tpu_torch.convert import params_from_flax
    from fedml_tpu_torch.core.telemetry import Telemetry
    from fedml_tpu_torch.ops.flash_attention import FWD_KERNEL
    from fedml_tpu_torch.serving import ServingFleet

    args = load_yaml_arguments(str(CONFIG))
    args.serve_fleet_size = SERVE_COMM_FLEET
    args.serve_deadline_ms = 0.0  # no default deadline: every request is answered
    output_dim = 90
    model = models.create(args, output_dim, device=DEVICE)
    vocab, T, L = model.input_bound, int(args.seq_len), int(args.num_layers)
    rng = np.random.default_rng(int(args.random_seed) + 17)
    params_by_step = {s: params_from_flax(flax_params(args, vocab, rng)) for s in (0, 1, 2)}
    pool = list(rng.integers(0, vocab, size=(SERVE_COMM_CLIENTS, T)))
    ref0 = full_attention_logits(args, output_dim, params_by_step[0], np.stack(pool))
    Telemetry.reset()
    fleet = ServingFleet.build(model, params_by_step[0], args).start()
    log(f"serving comm: {len(fleet.engines)} engines, {SERVE_COMM_CLIENTS} clients, T {T}, "
        f"{L} layers; a request's x is {T * 8} B of token ids, a response's y "
        f"{T * output_dim * 4} B of f32 logits")
    reset_launches()  # count only this path's own launches
    out = {}
    try:
        with plain_flash_calls() as plain:
            out["local"] = serve_transport(args, fleet, "LOCAL", pool, ref0)
            out["trpc"] = serve_transport(args, fleet, "TRPC", pool, ref0)
            out["fault"] = serve_fault_round(args, fleet, pool, ref0)
            out["publish"] = serve_publish_rounds(args, fleet, pool, params_by_step,
                                                  output_dim, ref0)
    finally:
        fleet.stop()
    tel = Telemetry.get_instance()
    batches = tel.counters_matching("serving_batches_total")
    n_batches = int(sum(batches.values()))
    buckets = sorted(int(k.split("bucket=")[1].rstrip("}")) for k in batches)
    launches = launch_counts()
    log(f"serving comm: micro-batches by bucket {batches}, kernel launches {launches}, "
        f"plain flash calls {plain}")
    if launches[FWD_KERNEL.name] != L * n_batches:
        fail(f"serving comm: flash forward launched {launches[FWD_KERNEL.name]} times for "
             f"{n_batches} micro-batches of a {L}-layer model (want {L * n_batches})")
    if launches["flash_attention_bwd"] != 0 or plain["forward"] or plain["backward"]:
        fail(f"serving comm: backward launches {launches['flash_attention_bwd']}, plain "
             f"flash calls {plain}: the serving path runs the forward kernel only")
    cases = {(b, T, int(args.num_heads), int(args.embed_dim) // int(args.num_heads),
              torch.float32, True) for b in buckets}
    missing = sorted(c[0] for c in cases - set(FLASH_CASES))
    if missing:
        fail(f"serving comm: the fleet ran buckets {missing} that the kernels phase "
             "does not hold against the plain version")
    out["mesh"] = serve_mesh_check(model, params_by_step[0], params_by_step[1], pool)
    out["cli"] = serve_cli_dry_run()
    out["micro_batches"] = batches
    out["kernel_launches"] = launch_counts()
    if out["kernel_launches"][FWD_KERNEL.name] != L * (n_batches + 2):
        fail(f"serving comm: the mesh check launched "
             f"{out['kernel_launches'][FWD_KERNEL.name] - L * n_batches} flash forwards "
             f"for 2 buckets of a {L}-layer model")
    del fleet
    torch.cuda.empty_cache()
    return out


# -- phase 4c: the native plane and the kernels' build cache -------------
NATIVE_JOBS = 40  # native LPT against greedy_makespan on this many seeded jobs
NATIVE_BNB_JOBS = (9, 3)  # branch-and-bound against brute force: jobs, resources
CACHE_CHILD_ROWS = 4  # requests each build-cache child serves (one, then a burst)
CACHE_CHILD_FLAG = "--compile-cache-child"
CACHE_CHILD_TIMEOUT_S = 240


def gxx_version():
    """(path, first ``--version`` line) of ``g++`` on ``PATH``, or Nones."""
    import shutil

    path = shutil.which("g++")
    if path is None:
        return None, None
    out = subprocess.run([path, "--version"], capture_output=True, text=True, timeout=60)
    return path, (out.stdout.splitlines() or [""])[0]


def native_build(gxx) -> dict:
    """Build the port's native broker and scheduler (when ``g++`` is
    there, a failed build fails the phase)."""
    from fedml_tpu_torch.core import native
    from fedml_tpu_torch.core.comm.native_broker import build_native_broker

    t0 = time.perf_counter()
    broker = build_native_broker()
    lib = native._scheduler_lib()
    secs = time.perf_counter() - t0
    build = os.path.realpath(native.BUILD_DIR)
    log(f"native: g++ {gxx[0]} ({gxx[1]}); broker {broker}, scheduler "
        f"{'built' if lib is not None else 'missing'} in {secs:.2f} s")
    if gxx[0] is not None and (broker is None or lib is None):
        fail("native: g++ is on PATH but the port's native broker or scheduler did not "
             "build (the Python fallback does not count here)")
    if broker is not None and os.path.dirname(os.path.realpath(broker)) != build:
        fail(f"native: the broker binary {broker} lies outside {build}")
    return {"gxx": gxx[1], "build_s": secs, "broker": broker}


@contextlib.contextmanager
def native_broker_env():
    """``FEDML_TPU_NATIVE_BROKER=1`` while open; yields the native brokers
    ``ensure_broker`` started (host, port, process), terminated on the way
    out."""
    from fedml_tpu_torch.core.comm import native_broker

    spawned, real = [], native_broker.spawn_native_broker

    def recording(port=0, timeout_s=10.0):
        out = real(port, timeout_s)
        if out is not None:
            spawned.append(out)
        return out

    native_broker.spawn_native_broker = recording
    os.environ["FEDML_TPU_NATIVE_BROKER"] = "1"
    try:
        yield spawned
    finally:
        del os.environ["FEDML_TPU_NATIVE_BROKER"]
        native_broker.spawn_native_broker = real
        for _, _, proc in spawned:
            proc.terminate()
            proc.wait(10)


def native_scheduler_checks() -> dict:
    """Native LPT against ``greedy_makespan``; the branch-and-bound behind
    ``best_makespan`` against brute force."""
    import itertools

    from fedml_tpu_torch.core import native, scheduler

    rng = np.random.default_rng(40)
    w = rng.uniform(1, 10, size=NATIVE_JOBS).tolist()
    got = native.lpt_makespan_native(w, 5)
    _, greedy = scheduler.greedy_makespan(w, 5)
    n, m = NATIVE_BNB_JOBS
    small = rng.uniform(1, 10, size=n).tolist()
    brute = min(max(sum(small[j] for j in range(n) if a[j] == r) for r in range(m))
                for a in itertools.product(range(m), repeat=n))
    _, best = scheduler.best_makespan(small, m)
    log(f"native scheduler: LPT {None if got is None else got[1]} vs greedy {greedy} on "
        f"{NATIVE_JOBS} jobs; best_makespan {best} vs brute force {brute} on {n} jobs")
    if got is None or abs(got[1] - greedy) > 1e-9 * greedy or abs(best - brute) > 1e-9 * brute:
        fail(f"native scheduler: LPT {got and got[1]} / greedy {greedy}, best {best} / "
             f"brute force {brute}")
    return {"lpt": got[1], "greedy": greedy, "best": best, "brute_force": brute}


def compile_cache_child(cache_dir: str, answers_path: str) -> int:
    """A fresh process serving ``CACHE_CHILD_ROWS`` requests at full width
    with ``compile_cache_dir`` set: prints one JSON line of its counters,
    its ``nvcc`` runs and seconds and its time to the first answer, and
    saves its answers."""
    t0 = time.perf_counter()
    sys.path.insert(0, str(REPO))
    from fedml_tpu_torch import models
    from fedml_tpu_torch.arguments import load_yaml_arguments
    from fedml_tpu_torch.convert import params_from_flax
    from fedml_tpu_torch.core import compile_cache
    from fedml_tpu_torch.core.telemetry import Telemetry
    from fedml_tpu_torch.ops import _build
    from fedml_tpu_torch.serving import ModelEndpoint, ServingEngine

    nvcc, builds = [], []
    real_popen, real_build = subprocess.Popen, _build.build

    def popen(cmd, *a, **kw):
        if isinstance(cmd, (list, tuple)) and os.path.basename(str(cmd[0])) == "nvcc":
            nvcc.append(cmd)
        return real_popen(cmd, *a, **kw)

    def timed_build(names):
        b0 = time.perf_counter()
        out = real_build(names)
        builds.append(time.perf_counter() - b0)
        return out

    subprocess.Popen, _build.build = popen, timed_build
    args = load_yaml_arguments(str(CONFIG))
    args.compile_cache_dir = cache_dir
    args.serve_deadline_ms = 0.0
    args._validate()
    Telemetry.reset()
    tel = Telemetry.get_instance(args)
    model = models.create(args, 90, device=DEVICE)
    vocab, T = model.input_bound, int(args.seq_len)
    rng = np.random.default_rng(int(args.random_seed) + 29)
    params = params_from_flax(flax_params(args, vocab, rng))
    rows = list(rng.integers(0, vocab, size=(CACHE_CHILD_ROWS, T)))
    with ServingEngine(ModelEndpoint(model, params), args) as engine:
        first, _, _ = burst(engine, rows[:1])
        first_s = time.perf_counter() - t0
        rest, _, _ = burst(engine, rows[1:])
    np.save(answers_path, np.concatenate([first, rest]))
    print(json.dumps({
        "enabled_dir": compile_cache.enabled_dir(),
        "hits": tel.get_counter("compile_cache_hits_total"),
        "misses": tel.get_counter("compile_cache_misses_total"),
        "entries": compile_cache.cache_entries(),
        "nvcc_runs": len(nvcc), "build_s": sum(builds),
        "first_answer_s": first_s, "wall_s": time.perf_counter() - t0,
    }), flush=True)
    return 0


def run_cache_child(cache_dir: str, answers_path: str) -> dict:
    argv = [sys.executable, str(REPO / "chip_smoke.py"), CACHE_CHILD_FLAG, cache_dir,
            answers_path]
    t0 = time.perf_counter()
    out = subprocess.run(argv, cwd=str(REPO), capture_output=True, text=True,
                         timeout=CACHE_CHILD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    try:
        numbers = json.loads(out.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        numbers = None
    if out.returncode != 0 or numbers is None:
        fail(f"compile cache child: exit {out.returncode}, stdout {out.stdout[-500:]!r}, "
             f"stderr {out.stderr[-1500:]!r}")
    numbers["process_wall_s"] = wall
    return numbers


def run_lint_ci():
    """``python -m fedml_tpu_torch.cli lint --ci --json``, started now."""
    argv = [sys.executable, "-m", "fedml_tpu_torch.cli", "lint", "--ci", "--json"]
    return subprocess.Popen(argv, cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def lint_result(proc) -> dict:
    stdout, stderr = proc.communicate(timeout=300)
    try:
        payload = json.loads(stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        payload = None
    if proc.returncode != 0 or not payload or not payload.get("ok"):
        fail(f"cli lint --ci --json: exit {proc.returncode}, stdout {stdout[-800:]!r}, "
             f"stderr {stderr[-800:]!r}")
    by_rule = {}
    for f in payload["findings"]:
        by_rule[f["rule"]] = by_rule.get(f["rule"], 0) + 1
    log(f"lint: exit 0, {payload['total']} findings, all baselined; by rule {by_rule}")
    return {"total": payload["total"], "by_rule": by_rule}


def compile_cache_children() -> dict:
    """The cold and the warm child on one fresh directory, with the lint
    gate running beside the cold one."""
    import shutil
    import tempfile

    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="compile_cache_", dir=str(out_dir))
    cache_dir = os.path.join(work, "cache")
    try:
        lint = run_lint_ci()
        cold = run_cache_child(cache_dir, os.path.join(work, "cold.npy"))
        lint_numbers = lint_result(lint)
        warm = run_cache_child(cache_dir, os.path.join(work, "warm.npy"))
        bitwise = bool(np.array_equal(np.load(os.path.join(work, "cold.npy")),
                                      np.load(os.path.join(work, "warm.npy"))))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for tag, n in (("cold", cold), ("warm", warm)):
        log(f"compile cache {tag}: hits {n['hits']:.0f}, misses {n['misses']:.0f}, entries "
            f"{n['entries']}, nvcc runs {n['nvcc_runs']} ({n['build_s']:.2f} s in build), "
            f"first answer {n['first_answer_s']:.2f} s after the child's start, process "
            f"{n['process_wall_s']:.2f} s")
    log(f"compile cache: warm answers bitwise the cold ones: {bitwise}")
    if os.path.realpath(cold["enabled_dir"]) != os.path.realpath(cache_dir):
        fail(f"compile cache: the child's cache sat at {cold['enabled_dir']}")
    if (cold["misses"], cold["hits"], cold["entries"]) != (cold["nvcc_runs"], 0, 1) \
            or cold["nvcc_runs"] != 1:
        fail(f"compile cache cold child: misses {cold['misses']}, hits {cold['hits']}, "
             f"entries {cold['entries']}, nvcc runs {cold['nvcc_runs']}")
    if (warm["hits"], warm["misses"], warm["entries"], warm["nvcc_runs"]) != (1, 0, 1, 0):
        fail(f"compile cache warm child: hits {warm['hits']}, misses {warm['misses']}, "
             f"entries {warm['entries']}, nvcc runs {warm['nvcc_runs']}")
    if not bitwise:
        fail("compile cache: the warm child's answers differ from the cold child's")
    return {"cold": cold, "warm": warm, "bitwise": bitwise, "lint": lint_numbers}


def run_native_and_cache():
    from fedml_tpu_torch import models
    from fedml_tpu_torch.arguments import load_yaml_arguments
    from fedml_tpu_torch.convert import params_from_flax
    from fedml_tpu_torch.core.telemetry import Telemetry
    from fedml_tpu_torch.ops.flash_attention import FWD_KERNEL
    from fedml_tpu_torch.serving import ServingFleet

    gxx = gxx_version()
    log(f"native: g++ on PATH: {gxx[0] or 'no'}" + (f", {gxx[1]}" if gxx[0] else
        "; ensure_broker takes the Python broker (the JAX package's fallback)"))
    out = {"build": native_build(gxx)}
    args = load_yaml_arguments(str(CONFIG))
    args.serve_fleet_size = SERVE_COMM_FLEET
    args.serve_deadline_ms = 0.0
    output_dim = 90
    model = models.create(args, output_dim, device=DEVICE)
    vocab, L = model.input_bound, int(args.num_layers)
    rng = np.random.default_rng(int(args.random_seed) + 23)
    params = params_from_flax(flax_params(args, vocab, rng))
    pool = list(rng.integers(0, vocab, size=(SERVE_COMM_CLIENTS, int(args.seq_len))))
    ref = full_attention_logits(args, output_dim, params, np.stack(pool))
    Telemetry.reset()
    fleet = ServingFleet.build(model, params, args).start()
    reset_launches()  # count only this path's own launches
    try:
        with plain_flash_calls() as plain:
            mqtt = copy.copy(args)
            with native_broker_env() as spawned:
                mqtt.broker_port = free_port_block(1)
                out["native"] = serve_transport(mqtt, fleet, "MQTT", pool, ref,
                                                tag="mqtt_native", profiled=False)
                brokers = [(proc.pid, os.path.realpath(proc.args[0]),
                            os.readlink(f"/proc/{proc.pid}/exe")) for _, _, proc in spawned]
            mqtt.broker_port = free_port_block(1)
            out["python"] = serve_transport(mqtt, fleet, "MQTT", pool, ref,
                                            tag="mqtt_python", profiled=False)
    finally:
        fleet.stop()
    build = os.path.realpath(REPO / "fedml_tpu_torch" / "native" / "build")
    log(f"native broker: {brokers} (pid, binary, /proc exe)")
    if gxx[0] is not None and (len(brokers) != 1 or any(
            os.path.dirname(p) != build or os.path.dirname(os.path.realpath(e)) != build
            for _, p, e in brokers)):
        fail(f"native: the MQTT world did not run on the port's own broker under {build}: "
             f"{brokers}")
    out["native_broker"] = brokers
    batches = Telemetry.get_instance().counters_matching("serving_batches_total")
    n_batches = int(sum(batches.values()))
    launches = launch_counts()
    log(f"native and compile cache: micro-batches {batches}, kernel launches {launches}, "
        f"plain flash calls {plain}; p50/p99 native {out['native']['p50_request_latency_ms']:.2f}"
        f"/{out['native']['p99_request_latency_ms']:.2f} ms, python "
        f"{out['python']['p50_request_latency_ms']:.2f}/"
        f"{out['python']['p99_request_latency_ms']:.2f} ms")
    if launches[FWD_KERNEL.name] != L * n_batches or plain["forward"] or plain["backward"]:
        fail(f"native: flash forward launched {launches[FWD_KERNEL.name]} times for "
             f"{n_batches} micro-batches of a {L}-layer model (want {L * n_batches}); plain "
             f"flash calls {plain}")
    out["micro_batches"] = batches
    out["kernel_launches"] = launches
    del fleet
    torch.cuda.empty_cache()
    out["scheduler"] = native_scheduler_checks()
    out["compile_cache"] = compile_cache_children()
    return out


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


def kernel_kind(name: str, kinds=KERNEL_KINDS) -> str:
    low = name.lower()
    for kind, keys in kinds:
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


def kernel_device_ms(fn, name: str, calls: int) -> float:
    """Mean device time of the device kernel whose name contains
    ``name`` over ``calls`` calls of ``fn`` under ``torch.profiler``
    (after a warm-up call); fails if the profiler saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name]
    if not times:
        fail(f"the profiler saw no {name} on the card")
    return sum(times) / len(times) / 1e3


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


def profile_summary(tag: str, summary: dict, kind_table=KERNEL_KINDS) -> dict:
    """Print a ``profile_rounds`` summary (``core/tracing.py``): wall,
    device busy (the union of device intervals) and idle, kernel time by
    kind and by kernel; returns the numbers."""
    busy, window = summary["device_busy_s"], summary["wall_s"]
    by_kernel = summary["device_s_by_kernel"]
    top = list(by_kernel.items())[:15]
    kinds, kind_launches = {}, {}
    for name, sec in by_kernel.items():
        kind = kernel_kind(name, kind_table)
        kinds[kind] = kinds.get(kind, 0.0) + sec
    for name, n in summary["device_launches_by_kernel"].items():
        kind = kernel_kind(name, kind_table)
        kind_launches[kind] = kind_launches.get(kind, 0) + n
    if busy <= 0:
        log(f"{tag}: the profiler saw no device events; device time not measured")
        return {"wall_ms": window * 1e3, "device_busy_ms": None}
    total = summary["device_kernel_s"]
    # RoundProfiler's summaries count the launches with no device record
    lost = ("" if "device_records_lost" not in summary else
            f", {summary['device_records_lost']} launches the profiler holds no device "
            f"record of")
    log(f"{tag}: wall {window * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
        f"({busy / window:.1%}), idle {(window - busy) * 1e3:.1f} ms; kernel time "
        f"{total * 1e3:.1f} ms summed over streams (cuDNN runs a grouped convolution's "
        f"groups on several streams, so it can exceed the busy time); "
        f"{summary['device_launches']} device intervals, {len(by_kernel)} distinct "
        f"kernels{lost}; by kind:")
    for kind, sec in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"  {sec * 1e3:9.3f} ms  {sec / total:6.1%}  {kind_launches[kind]:7d} launches  {kind}")
    log(f"{tag}: kernel time by kernel:")
    for name, sec in top:
        log(f"  {sec * 1e3:9.3f} ms  {name[:110]}")
    return {"wall_ms": window * 1e3, "device_busy_ms": busy * 1e3,
            "busy_share": busy / window, "kernel_sum_ms": total * 1e3,
            "device_launches": summary["device_launches"],
            "device_records_lost": summary.get("device_records_lost"),
            "by_kind_ms": {k: v * 1e3 for k, v in kinds.items()},
            "launches_by_kind": kind_launches,
            "top_kernels_ms": [(n[:110], sec * 1e3) for n, sec in top]}


def run_fedavg():
    """The headline configuration through ``run_simulation``."""
    import tempfile

    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_yaml_arguments

    oracle_err = fedavg_oracle()
    vec_seq_errs = fedavg_vectorized_vs_sequential()
    yardstick = fedavg_step_yardstick()

    args = load_yaml_arguments(str(FEDAVG_CONFIG))
    profiled = HEADLINE_WARMUP + HEADLINE_TIMED
    with tempfile.TemporaryDirectory(prefix="fedavg_smoke_") as tmp:
        args.comm_round = profiled + 1
        args.frequency_of_the_test = 1
        args.metrics_jsonl_path = str(Path(tmp) / "metrics.jsonl")
        args.telemetry_dir = tmp
        args.profile_rounds = [profiled]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()  # this path runs no hand-written kernel
        t0 = time.perf_counter()
        final = fedml_tpu_torch.run_simulation(device=DEVICE, args=args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = launch_counts()
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
    if any(launches.values()):
        fail(f"the flash kernels ran {launches} times on the FedAvg path, which has no attention")
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
def launches_by_kind(fn, kind_table=KERNEL_KINDS) -> dict:
    """Device kernel launches of one call of ``fn``, by kind, from a
    ``torch.profiler`` window (after one warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fedml_tpu_torch.core.tracing import CAPTURE_MARGIN_S

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # idle margins: the profiler drops records it dates outside its window
        time.sleep(CAPTURE_MARGIN_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(CAPTURE_MARGIN_S)
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            kind = kernel_kind(e.name, kind_table)
            out[kind] = out.get(kind, 0) + 1
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


def _sim(config: Path, depth: int, comm_round: int, freq: int, client_trainer=None,
         server_aggregator=None, **knobs):
    """A configuration's simulator, as ``run_simulation`` builds it
    (custom operators and other ``knobs`` passed through), kept so that
    its trainer's params can be read afterwards."""
    import fedml_tpu_torch
    from fedml_tpu_torch import data, models
    from fedml_tpu_torch.arguments import load_yaml_arguments
    from fedml_tpu_torch.simulation import SimulatorSingleProcess

    args = load_yaml_arguments(str(config))
    args.pipeline_depth, args.comm_round, args.frequency_of_the_test = depth, comm_round, freq
    args.log_metrics = False
    for knob, value in knobs.items():
        setattr(args, knob, value)
    args = fedml_tpu_torch.init(args)
    dataset = data.load(args, device=DEVICE)
    model = models.create(args, dataset.class_num, device=DEVICE)
    return SimulatorSingleProcess(args, DEVICE, dataset, model, client_trainer=client_trainer,
                                  server_aggregator=server_aggregator)


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


def eval_passes(dataset) -> int:
    """Forward passes of one evaluation of the global model (every
    client's train and test batches, ``make_eval_fn``'s chunking)."""
    from fedml_tpu_torch.core.local_trainer import eval_batches_per_pass

    total = 0
    for b in (dataset.packed_train, dataset.packed_test):
        batches = b.mask.numel() // b.batch_size
        total += -(-batches // eval_batches_per_pass(b))
    return total


def depth_runs(config: Path, rounds: int, freq: int) -> dict:
    """The configuration at pipeline depth 1, then depth 4 (its hot loop
    under sync debug mode "error" between flushes): per depth the final
    params, the records without their times, the pipeline stats, the
    wall time, the flash kernels' launches and the forward passes of one
    evaluation."""
    out = {}
    for depth in (1, 4):
        sim = _sim(config, depth, rounds, freq)
        reset_launches()
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
            "launches": launch_counts(),
            "eval_passes": eval_passes(api.dataset),
        }
        del sim, api
        torch.cuda.empty_cache()
    return out


def check_depths(tag: str, out: dict, rounds: int) -> list:
    """The gates on ``depth_runs``: depth 4 bitwise equal to depth 1
    (params and records), f32 masters, and depth 4 fetching only at its
    flushes. Returns the master dtypes."""
    p1, p4 = out[1]["params"], out[4]["params"]
    unequal = [k for k in p1 if not torch.equal(p1[k], p4[k])]
    dtypes = sorted({str(v.dtype) for v in p4.values()})
    log(f"{tag}: depth 1 {out[1]['stats']} in {out[1]['wall_s']:.1f} s; depth 4 "
        f"{out[4]['stats']} in {out[4]['wall_s']:.1f} s, its hot loop under sync debug mode "
        f"'error' between flushes; params differing bitwise: {len(unequal)} of {len(p1)}; "
        f"master dtypes {dtypes}")
    if unequal:
        err = max(float((p1[k] - p4[k]).abs().max()) for k in unequal)
        fail(f"{tag}: depth 4 differs from depth 1 in {len(unequal)} params (max {err})")
    if out[1]["history"] != out[4]["history"]:
        fail(f"{tag}: depth 4's records differ from depth 1's: {out[1]['history']} vs "
             f"{out[4]['history']}")
    if dtypes != ["torch.float32"]:
        fail(f"{tag}: master params are {dtypes} after bf16 training, want float32")
    s4 = out[4]["stats"]
    if not (s4["host_syncs"] == s4["flushes"] < rounds):
        fail(f"{tag}: depth 4 fetched {s4['host_syncs']} times in {s4['flushes']} flushes")
    return dtypes


def dense_pipeline_check():
    """Depth 4 against depth 1 on the dense configuration (3 rounds,
    evaluation every 2), under deterministic cuDNN for this check only:
    cuDNN's grouped kernels need not be bitwise reproducible otherwise."""
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        out = depth_runs(DENSE_CONFIG, DENSE_CHECK_ROUNDS, DENSE_CHECK_FREQ)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    dtypes = check_depths("dense pipeline check (cuDNN deterministic for this check only)",
                          out, DENSE_CHECK_ROUNDS)
    return {"bitwise_equal": True, "master_dtypes": dtypes,
            "depth1": out[1]["stats"], "depth4": out[4]["stats"],
            "wall_s": {d: out[d]["wall_s"] for d in out}}


def run_dense():
    """The north-star cohort through ``run_simulation``, as configured."""
    import tempfile

    import fedml_tpu_torch
    from fedml_tpu_torch import models
    from fedml_tpu_torch.arguments import load_yaml_arguments

    args = load_yaml_arguments(str(DENSE_CONFIG))
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
        reset_launches()  # this path runs no hand-written kernel
        t0 = time.perf_counter()
        final = fedml_tpu_torch.run_simulation(device=DEVICE, args=args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = launch_counts()
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
    if any(launches.values()):
        fail(f"the flash kernels ran {launches} times on the dense path, which has no attention")
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


# -- phase 7 -----------------------------------------------------------
def transformer_step_census(model, args) -> dict:
    """One local step of one client (a batch of ``batch_size`` sequences
    of ``seq_len`` tokens) through the port's trainer, bf16 over f32
    masters: the dense layers' FLOPs counted by ``FlopCounterMode`` (the
    flash kernels are opaque to it; attention is reckoned from the
    shapes) against the reckoning 6 x weights x tokens, and the device
    launches by kind."""
    from torch.utils.flop_counter import FlopCounterMode

    from fedml_tpu_torch.core import optimizers
    from fedml_tpu_torch.core.local_trainer import make_local_train_fn
    from fedml_tpu_torch.core.types import Batches

    params = model.init(torch.Generator().manual_seed(0))
    step = make_local_train_fn(model.apply, model.loss_fn, optimizers.sgd(0.05), epochs=1,
                               shuffle=False, compute_dtype=torch.bfloat16)
    bs, T, vocab = int(args.batch_size), int(args.seq_len), model.input_bound
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x = torch.randint(0, vocab, (1, 1, bs, T), generator=gen, device=DEVICE, dtype=torch.int32)
    y = torch.randint(0, vocab, (1, 1, bs, T), generator=gen, device=DEVICE)
    batch = Batches(x=x, y=y, mask=torch.ones((1, 1, bs), device=DEVICE))
    with FlopCounterMode(display=False) as counter:
        step(params, batch)
    counted = counter.get_total_flops()
    weights = sum(int(v.numel()) for k, v in params.items()
                  if "Dense" in k and k.endswith("weight"))
    reckoned = 6.0 * weights * bs * T
    L, H = int(args.num_layers), int(args.num_heads)
    D = int(args.embed_dim) // H
    # per layer: forward 2 products, backward 5, 2·D flops each per
    # unmasked causal pair
    attention = 14.0 * D * (T * (T + 1) / 2) * H * bs * L
    kinds = launches_by_kind(lambda: step(params, batch), TRANSFORMER_KINDS)
    log(f"transformer step of one client ({bs} x {T} tokens): dense FLOPs "
        f"{counted / 1e9:.2f} G by FlopCounterMode, {reckoned / 1e9:.2f} G reckoned "
        f"(6 x {weights} weights x {bs * T} tokens; ratio {counted / reckoned:.4f}); "
        f"attention {attention / 1e9:.2f} G reckoned; launches by kind {kinds}")
    if not 0.98 < counted / reckoned < 1.02:
        fail(f"FlopCounterMode counts {counted} dense FLOPs per step, the reckoning {reckoned}")
    return {"dense_counted": counted, "dense_reckoned": reckoned, "attention": attention,
            "weights": weights, "step_launches_by_kind": kinds,
            "layernorm_ms": layernorm_ms(args)}


def layernorm_ms(args) -> float:
    """The port's LayerNorm, forward and backward, timed alone on the
    card at one step's activation shape (the cohort's clients vmapped
    with their own bf16 params, [batch, T, embed] bf16 each). Its
    kernels are elementwise ops and reductions that the profile cannot
    tell from the others by name, so this is its share of the step."""
    from fedml_tpu_torch.models.transformer import LayerNorm

    clients, bs, T, E = (int(args.client_num_per_round), int(args.batch_size),
                         int(args.seq_len), int(args.embed_dim))
    ln = LayerNorm(E).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x = torch.randn((clients, bs, T, E), generator=gen, device=DEVICE).to(torch.bfloat16)
    w = torch.ones((clients, E), device=DEVICE, dtype=torch.bfloat16)
    b = torch.zeros((clients, E), device=DEVICE, dtype=torch.bfloat16)

    def loss(w, b, x):
        y = torch.func.functional_call(ln, {"weight": w, "bias": b}, (x,))
        return y.float().square().sum()

    step = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))
    return cuda_time_ms(lambda: step(w, b, x), 10)


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms`` for a bitwise check only
    (the embedding's backward may sum with atomics otherwise; cuBLAS
    needs its workspace setting for it)."""
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


def transformer_pipeline_check(layers: int) -> dict:
    """Depth 4 against depth 1 on the transformer configuration (3
    rounds, evaluation every 2) under ``deterministic()`` for this check
    only. Also counts the flash kernels' launches of each run against
    layers x (training steps, and forward passes of evaluation)."""
    with deterministic():
        out = depth_runs(TRANSFORMER_CONFIG, TRANSFORMER_CHECK_ROUNDS, TRANSFORMER_CHECK_FREQ)
    dtypes = check_depths("transformer pipeline check (deterministic algorithms for this check "
                          "only)", out, TRANSFORMER_CHECK_ROUNDS)
    for depth, run in out.items():
        steps = TRANSFORMER_CHECK_ROUNDS * run["stats"]["num_batches"]
        evals = len(run["history"])
        want = {**no_launches(),
                "flash_attention_fwd": layers * (steps + evals * run["eval_passes"]),
                "flash_attention_bwd": layers * steps}
        log(f"transformer pipeline check, depth {depth}: flash launches {run['launches']}, "
            f"want {want} ({layers} layers x {steps} steps, + {evals} evaluations of "
            f"{run['eval_passes']} forward passes)")
        if run["launches"] != want:
            fail(f"depth {depth}: flash launches {run['launches']}, want {want}")
    return {"bitwise_equal": True, "master_dtypes": dtypes,
            "depth1": out[1]["stats"], "depth4": out[4]["stats"],
            "launches": {d: out[d]["launches"] for d in out},
            "eval_passes": out[1]["eval_passes"],
            "wall_s": {d: out[d]["wall_s"] for d in out}}


def run_transformer():
    """FedAvg of the flash TransformerLM at T 4096 through
    ``run_simulation``, as configured."""
    import tempfile

    import fedml_tpu_torch
    from fedml_tpu_torch import models
    from fedml_tpu_torch.arguments import load_yaml_arguments
    from fedml_tpu_torch.ops.flash_attention import BWD_KERNEL, FWD_KERNEL

    args = load_yaml_arguments(str(TRANSFORMER_CONFIG))
    L, T = int(args.num_layers), int(args.seq_len)
    model = models.create(args, 90, device=DEVICE)
    census = transformer_step_census(model, args)
    del model
    check = transformer_pipeline_check(L)
    with tempfile.TemporaryDirectory(prefix="transformer_smoke_") as tmp:
        args.metrics_jsonl_path = str(Path(tmp) / "metrics.jsonl")
        args.telemetry_dir = tmp
        args.profile_rounds = [TRANSFORMER_PROFILED]
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # by earlier phases
        reset_launches()
        t0 = time.perf_counter()
        final = fedml_tpu_torch.run_simulation(device=DEVICE, args=args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        launches = launch_counts()
        lines = [json.loads(line) for line in
                 (Path(tmp) / "metrics.jsonl").read_text().splitlines()]
        summary = json.loads((Path(tmp) / "profile" / f"round_{TRANSFORMER_PROFILED:04d}"
                              / "summary.json").read_text())
    records = [r for r in lines if r["kind"] == "server_train"]
    pipe = next(r for r in lines if r["kind"] == "pipeline")
    spans = pipe["round_spans_s"]
    first, last = TRANSFORMER_TIMED
    timed_s = spans[last][1] - spans[first][0]
    rounds_per_s = (last - first + 1) / timed_s
    bucket, nb, bs = pipe["bucket"], pipe["num_batches"], int(args.batch_size)
    epochs = int(args.epochs)
    steps = nb * epochs
    # real tokens of the timed rounds' cohorts, per round
    tokens = float(np.mean(pipe["round_samples"][first:last + 1])) * T * epochs
    computed_tokens = bucket * nb * bs * T * epochs
    flops_step = bucket * (census["dense_counted"] + census["attention"])
    flops_round = flops_step * steps
    peak_flops = PEAK_FLOPS[torch.bfloat16]
    card = card_line()
    log(f"transformer: {args.model} ({args.attention_impl}), embed {args.embed_dim}, "
        f"{args.num_heads} heads, {L} layers, T {T}, {args.client_num_per_round} of "
        f"{args.client_num_in_total} clients per round (pow2 bucket {bucket}), batch {bs}, "
        f"{epochs} epoch, {args.dtype}; {len(spans)} rounds in {wall:.1f} s (data, init and "
        f"warm-up included); flash launches {launches}; pipeline "
        f"{dict((k, v) for k, v in pipe.items() if k not in ('round_spans_s', 'ts', 'kind'))}")
    for r, (a, b) in enumerate(spans):
        log(f"  round {r}: {(b - a) * 1e3:.1f} ms on the card's clock")
    for r in records:
        log(f"  round {r['round']} record: train {r['train_time_s'] * 1e3:.1f} ms, with eval "
            f"{r['round_time_s'] * 1e3:.1f} ms; train_loss {r['train_loss']:.4f}, train_acc "
            f"{r['train_acc']:.4f}, test_loss {r['test_loss']:.4f}, test_acc "
            f"{r['test_acc']:.4f}, cohort loss {r['train_loss_cohort']:.4f}, cohort tokens "
            f"{r['cohort_samples']:.0f}")
    log(f"transformer on {card}: rounds {first}-{last} timed as a whole on the card's clock: "
        f"{timed_s:.4f} s, {rounds_per_s:.4f} rounds/s; {tokens * rounds_per_s:.0f} real "
        f"tokens/s ({tokens:.0f} per round; {computed_tokens} computed); model FLOPs per "
        f"round {flops_round / 1e12:.3f} TFLOP ({steps} steps of {flops_step / 1e12:.3f}: "
        f"dense {bucket * census['dense_counted'] * steps / 1e12:.3f} by FlopCounterMode, "
        f"attention {bucket * census['attention'] * steps / 1e12:.3f} reckoned); "
        f"{flops_round * rounds_per_s / 1e12:.2f} TFLOP/s = "
        f"{flops_round * rounds_per_s / peak_flops:.2%} of the {peak_flops / 1e12:.0f} TFLOP/s "
        f"bf16 dense peak (NVIDIA H100 SXM data sheet); peak memory {peak / 2**20:.1f} MiB "
        f"(torch.cuda.max_memory_allocated, less the {held / 2**20:.1f} MiB earlier phases "
        f"still held)")
    profile = profile_summary(
        f"transformer profile of round {TRANSFORMER_PROFILED} (training only) on {card}",
        summary, TRANSFORMER_KINDS)
    norms = 2 * L + 1  # two per block and the final one
    step_ms = 1e3 / rounds_per_s / steps
    log(f"transformer on {card}: LayerNorm (forward and backward, timed alone at a step's "
        f"shape) {census['layernorm_ms']:.3f} ms, x {norms} per step = "
        f"{norms * census['layernorm_ms']:.1f} ms of a {step_ms:.1f} ms step "
        f"({norms * census['layernorm_ms'] / step_ms:.1%}); in the profile it is part of "
        f"'elementwise' and 'reductions'")
    if profile.get("device_launches"):
        per_kind = {k: round(n / steps, 1) for k, n in profile["launches_by_kind"].items()}
        log(f"transformer on {card}: {profile['device_launches'] / steps:.0f} device launches "
            f"per step ({steps} steps in the profiled round); per step by kind: {per_kind}")
        if (profile["launches_by_kind"].get("flash forward") != L * steps
                or profile["launches_by_kind"].get("flash backward") != 3 * L * steps):
            fail(f"the profiled round launched {profile['launches_by_kind']}: want {L * steps} "
                 f"flash forward and {3 * L * steps} flash backward kernels (3 per call), one "
                 f"call per layer per step for the whole cohort ({profile['device_records_lost']} "
                 f"launches without a device record)")

    losses = [r["train_loss"] for r in records]
    if len(records) < 2 or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"transformer train loss did not fall across the rounds: {losses}")
    if final["round"] != records[-1]["round"]:
        fail("run_simulation's result is not the last round's stats")
    all_steps = len(spans) * steps
    want = {**no_launches(),
            FWD_KERNEL.name: L * (all_steps + len(records) * check["eval_passes"]),
            BWD_KERNEL.name: L * all_steps}
    log(f"transformer: flash launches {launches}, want {want} ({L} layers x {all_steps} steps, "
        f"+ {len(records)} evaluations of {check['eval_passes']} forward passes)")
    if launches != want:
        fail(f"flash launches {launches} on the transformer path, want {want}")
    return {
        "card": card, "rounds_per_s": rounds_per_s, "timed_rounds_s": timed_s,
        "round_device_s": [b - a for a, b in spans],
        "real_tokens_per_s": tokens * rounds_per_s,
        "flops_per_round": flops_round, "step_census": census,
        "bf16_peak_share": flops_round * rounds_per_s / peak_flops,
        "peak_memory_bytes": peak, "train_loss": losses,
        "test_acc": [r["test_acc"] for r in records], "pipeline": pipe,
        "profile": {"round": TRANSFORMER_PROFILED, **profile}, "pipeline_check": check,
        "kernel_launches": launches,
    }


# -- phase 8: the reference's default dtype -------------------------------
# the f32 transformer: 3 rounds (evaluation at 0 and 2): round 0 warms up,
# round 1 runs under torch.profiler (training only: no evaluation in it),
# round 2's training is timed on the card's clock (a round's span holds
# its training, not its evaluation)
TRANSFORMER_F32_ROUNDS = 3
TRANSFORMER_F32_TIMED = (2, 2)
TRANSFORMER_F32_PROFILED = 1


@contextlib.contextmanager
def plain_flash_calls():
    """Counts the calls of the flash plain versions (the dense forward
    and the blockwise backward) while it is open: a path on the card
    must make none."""
    from fedml_tpu_torch.ops import flash_attention as fa

    calls = {"forward": 0, "backward": 0}
    real = {"forward": fa.flash_attention_reference, "backward": fa._flash_backward}

    def counted(kind):
        def call(*a, **kw):
            calls[kind] += 1
            return real[kind](*a, **kw)
        return call

    fa.flash_attention_reference = counted("forward")
    fa._flash_backward = counted("backward")
    try:
        yield calls
    finally:
        fa.flash_attention_reference, fa._flash_backward = real["forward"], real["backward"]


def run_transformer_f32(passes: int):
    """FedAvg of the flash TransformerLM in f32, the reference's default
    dtype, through ``run_simulation``: 3 rounds of the configuration
    (round 1 profiled, round 2 timed). The f32 flash kernels launch once
    a layer and step for the whole cohort (forward also once a layer per
    forward pass of each evaluation, ``passes`` of them), no plain version
    runs, and the loss falls."""
    from fedml_tpu_torch.arguments import load_yaml_arguments
    from fedml_tpu_torch.ops.flash_attention import BWD_KERNEL, FWD_KERNEL

    args = load_yaml_arguments(str(TRANSFORMER_F32_CONFIG))
    args.comm_round = TRANSFORMER_F32_ROUNDS
    L, T, epochs = int(args.num_layers), int(args.seq_len), int(args.epochs)
    with plain_flash_calls() as plain:
        run = measured_run(args, TRANSFORMER_F32_PROFILED)
    card = card_line()
    losses = log_records("transformer f32", run)
    pipe = run["pipe"]
    first, last = TRANSFORMER_F32_TIMED
    timed_s, rounds_per_s, samples = timed_rounds(pipe, first, last)
    steps = pipe["num_batches"] * epochs
    tokens = samples * T * epochs
    log(f"transformer f32 on {card}: {args.model} ({args.attention_impl}), embed "
        f"{args.embed_dim}, {args.num_heads} heads, {L} layers, T {T}, "
        f"{args.client_num_per_round} of {args.client_num_in_total} clients (pow2 bucket "
        f"{pipe['bucket']}), batch {args.batch_size}, {args.dtype}, matmul_precision "
        f"{args.matmul_precision}: round {first} on the card's clock {timed_s:.4f} s, "
        f"{rounds_per_s:.4f} rounds/s, {tokens * rounds_per_s:.0f} real tokens/s ({tokens:.0f} "
        f"a round); peak memory {run['peak_bytes'] / 2**20:.1f} MiB (less the "
        f"{run['held_bytes'] / 2**20:.1f} MiB earlier phases still held); {len(pipe['round_spans_s'])}"
        f" rounds in {run['wall_s']:.1f} s (data, init and warm-up included)")
    profile = profile_summary(
        f"transformer f32 profile of round {TRANSFORMER_F32_PROFILED} (training only) on {card}",
        run["summary"], TRANSFORMER_KINDS)
    if profile.get("device_launches"):
        per_kind = {k: round(n / steps, 1) for k, n in profile["launches_by_kind"].items()}
        log(f"transformer f32 on {card}: {profile['device_launches'] / steps:.0f} device "
            f"launches per step ({steps} steps in the profiled round); per step by kind: "
            f"{per_kind}")
        if (profile["launches_by_kind"].get("flash forward") != L * steps
                or profile["launches_by_kind"].get("flash backward") != 3 * L * steps):
            fail(f"transformer f32: the profiled round launched {profile['launches_by_kind']}: "
                 f"want {L * steps} flash forward and {3 * L * steps} flash backward kernels "
                 f"({profile['device_records_lost']} launches without a device record)")
    all_steps = len(pipe["round_spans_s"]) * steps
    evals = len(run["records"])
    want = {**no_launches(), FWD_KERNEL.name: L * (all_steps + evals * passes),
            BWD_KERNEL.name: L * all_steps}
    log(f"transformer f32: flash launches {run['launches']}, want {want} ({L} layers x "
        f"{all_steps} steps, + {evals} evaluations of {passes} forward passes); plain "
        f"versions called {plain}")
    if run["launches"] != want:
        fail(f"transformer f32: flash launches {run['launches']}, want {want}")
    if any(plain.values()):
        fail(f"transformer f32: the flash plain versions ran on the card path: {plain}")
    torch.cuda.empty_cache()
    return {"card": card, "rounds_per_s": rounds_per_s, "timed_rounds_s": timed_s,
            "real_tokens_per_s": tokens * rounds_per_s, "peak_memory_bytes": run["peak_bytes"],
            "train_loss": losses, "test_acc": [r["test_acc"] for r in run["records"]],
            "round_device_s": [b - a for a, b in pipe["round_spans_s"]],
            "profile": {"round": TRANSFORMER_F32_PROFILED, **profile}, "pipeline": pipe,
            "plain_calls": plain, "kernel_launches": run["launches"]}


# -- phases 9-13: the fifth slice ---------------------------------------
def measured_run(args, profiled=None, backend: str = "single_process", **operators) -> dict:
    """``run_simulation`` on ``args`` as a user calls it, with its metrics
    written (and round ``profiled`` under ``torch.profiler``): the
    result, the history records, the pipeline record, the profile
    summary, the wall time, the peak memory less what earlier phases
    still hold, and the flash kernels' launches."""
    import tempfile

    import fedml_tpu_torch

    with tempfile.TemporaryDirectory(prefix="smoke_") as tmp:
        args.metrics_jsonl_path = str(Path(tmp) / "metrics.jsonl")
        args.log_metrics = False
        if profiled is not None:
            args.telemetry_dir = tmp
            args.profile_rounds = [profiled]
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        final = fedml_tpu_torch.run_simulation(backend, device=DEVICE, args=args, **operators)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        launches = launch_counts()
        lines = [json.loads(line) for line in
                 (Path(tmp) / "metrics.jsonl").read_text().splitlines()]
        summary = None if profiled is None else json.loads(
            (Path(tmp) / "profile" / f"round_{profiled:04d}" / "summary.json").read_text())
    records = [r for r in lines if r["kind"] == "server_train"]
    if final["round"] != records[-1]["round"]:
        fail("run_simulation's result is not the last round's stats")
    return {"final": final, "records": records,
            # the synchronous loop (S-FedAvg's) writes no pipeline record
            "pipe": next((r for r in lines if r["kind"] == "pipeline"), None),
            "summary": summary,
            "wall_s": wall, "peak_bytes": peak, "held_bytes": held, "launches": launches}


def timed_rounds(pipe: dict, first: int, last: int):
    """Rounds ``first``-``last`` as a whole on the card's clock: (seconds,
    rounds/s, the mean real examples a round's cohort holds)."""
    spans = pipe["round_spans_s"]
    timed_s = spans[last][1] - spans[first][0]
    return timed_s, (last - first + 1) / timed_s, float(
        np.mean(pipe["round_samples"][first:last + 1]))


def log_records(tag: str, run: dict) -> list:
    """Print a run's round spans and records; returns the train losses,
    failing unless they are finite and fell."""
    for r, (a, b) in enumerate(run["pipe"]["round_spans_s"]):
        log(f"  {tag} round {r}: {(b - a) * 1e3:.1f} ms on the card's clock")
    for r in run["records"]:
        log(f"  {tag} round {r['round']} record: train {r['train_time_s'] * 1e3:.1f} ms, with "
            f"eval {r['round_time_s'] * 1e3:.1f} ms; train_loss {r['train_loss']:.4f}, "
            f"train_acc {r['train_acc']:.4f}, test_loss {r['test_loss']:.4f}, test_acc "
            f"{r['test_acc']:.4f}, cohort loss {r['train_loss_cohort']:.4f}, cohort tokens "
            f"{r['cohort_samples']:.0f}")
    losses = [r["train_loss"] for r in run["records"]]
    if len(losses) < 2 or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{tag} train loss did not fall across the rounds: {losses}")
    return losses


def run_rnn():
    """FedAvg of the Shakespeare LSTM through ``run_simulation``, as
    configured: rounds 1-3 timed on the card's clock, round 4 profiled;
    then depth 4 against depth 1 under ``deterministic()``."""
    from fedml_tpu_torch.arguments import load_yaml_arguments

    args = load_yaml_arguments(str(RNN_CONFIG))
    T, bs, epochs = int(args.seq_len), int(args.batch_size), int(args.epochs)
    run = measured_run(args, RNN_PROFILED)
    pipe = run["pipe"]
    first, last = RNN_TIMED
    timed_s, rounds_per_s, seqs = timed_rounds(pipe, first, last)
    tokens = seqs * T * epochs
    steps = pipe["num_batches"] * epochs
    card = card_line()
    log(f"rnn (Shakespeare): {args.model}, {args.client_num_per_round} of "
        f"{args.client_num_in_total} clients per round (pow2 bucket {pipe['bucket']}), batch "
        f"{bs}, T {T}, {epochs} epoch, {args.dtype}, {steps} steps a round; "
        f"{len(pipe['round_spans_s'])} rounds in {run['wall_s']:.1f} s (data, init and "
        f"warm-up included); flash launches {run['launches']}")
    losses = log_records("rnn", run)
    log(f"rnn on {card}: rounds {first}-{last} timed as a whole on the card's clock: "
        f"{timed_s:.4f} s, {rounds_per_s:.4f} rounds/s; {tokens * rounds_per_s:.0f} real "
        f"tokens/s ({tokens:.0f} per round); peak memory {run['peak_bytes'] / 2**20:.1f} MiB")
    profile = profile_summary(f"rnn profile of round {RNN_PROFILED} (training only) on {card}",
                              run["summary"], RNN_KINDS)
    if profile.get("device_launches"):
        per_kind = {k: round(n / steps, 1) for k, n in profile["launches_by_kind"].items()}
        log(f"rnn on {card}: {profile['device_launches'] / steps:.0f} device launches per step "
            f"({steps} steps in the profiled round, {T} time steps each); per step by kind: "
            f"{per_kind}")
    if any(run["launches"].values()):
        fail(f"the flash kernels ran {run['launches']} times on the RNN path, which has no "
             f"attention")
    with deterministic():
        out = depth_runs(RNN_CONFIG, RNN_CHECK_ROUNDS, RNN_CHECK_FREQ)
    check_depths("rnn pipeline check (deterministic algorithms for this check only)", out,
                 RNN_CHECK_ROUNDS)
    return {"card": card, "rounds_per_s": rounds_per_s, "timed_rounds_s": timed_s,
            "real_tokens_per_s": tokens * rounds_per_s, "steps_per_round": steps,
            "peak_memory_bytes": run["peak_bytes"], "train_loss": losses,
            "pipeline": pipe, "profile": {"round": RNN_PROFILED, **profile},
            "depth_check_wall_s": {d: out[d]["wall_s"] for d in out},
            "kernel_launches": run["launches"]}


def run_rnn_stackoverflow():
    """FedAvg of the Stack Overflow LSTM at full width through
    ``run_simulation``, 2 rounds, evaluation after each, over
    ``SO_RNN_CLIENTS`` of the configuration's clients (each its own
    number of sequences)."""
    from fedml_tpu_torch.arguments import load_yaml_arguments

    args = load_yaml_arguments(str(SO_RNN_CONFIG))
    args.comm_round, args.frequency_of_the_test = SO_RNN_ROUNDS, 1
    per_client = int(args.synthetic_train_size) // int(args.client_num_in_total)
    args.client_num_in_total = SO_RNN_CLIENTS
    args.synthetic_train_size = SO_RNN_CLIENTS * per_client
    args._validate()
    run = measured_run(args)
    pipe = run["pipe"]
    T, epochs = int(args.seq_len), int(args.epochs)
    _, rounds_per_s, seqs = timed_rounds(pipe, 1, SO_RNN_ROUNDS - 1)
    card = card_line()
    log(f"rnn (Stack Overflow): {args.client_num_per_round} of {args.client_num_in_total} "
        f"clients per round (pow2 bucket {pipe['bucket']}), batch {args.batch_size}, T {T}, "
        f"{pipe['num_batches'] * epochs} steps a round; {SO_RNN_ROUNDS} rounds in "
        f"{run['wall_s']:.1f} s (the stand-in's data made on the host included)")
    losses = log_records("rnn stackoverflow", run)
    log(f"rnn stackoverflow on {card}: round 1 on the card's clock: {rounds_per_s:.4f} rounds/s, "
        f"{seqs * T * epochs * rounds_per_s:.0f} real tokens/s; peak memory "
        f"{run['peak_bytes'] / 2**20:.1f} MiB")
    if any(run["launches"].values()):
        fail(f"the flash kernels ran {run['launches']} times on the Stack Overflow RNN path")
    return {"card": card, "rounds_per_s": rounds_per_s, "train_loss": losses,
            "wall_s": run["wall_s"], "peak_memory_bytes": run["peak_bytes"],
            "kernel_launches": run["launches"]}


def _seam_operators():
    """The trainers and aggregators of ``tests/test_operator_seam.py``,
    written for the port, and a default aggregator that keeps its last
    result (so that a run through ``run_simulation`` can be read)."""
    from fedml_tpu_torch.core.frame import DefaultClientTrainer, DefaultServerAggregator

    class FrozenTrainer(DefaultClientTrainer):
        def make_train_fn(self, args):
            inner = super().make_train_fn(args)

            def train(params, batches, rng):
                _, metrics = inner(params, batches, rng)
                return params, metrics

            return train

    class HalfStepTrainer(DefaultClientTrainer):
        def make_train_fn(self, args):
            inner = super().make_train_fn(args)

            def train(params, batches, rng):
                new, metrics = inner(params, batches, rng)
                return {k: params[k] + 0.5 * (new[k] - params[k]) for k in params}, metrics

            return train

    class Recording(DefaultServerAggregator):
        def aggregate(self, global_params, stacked_params, weights, rng):
            self.last = super().aggregate(global_params, stacked_params, weights, rng)
            return self.last

    class GlobalKeepAggregator(Recording):
        def aggregate(self, global_params, stacked_params, weights, rng):
            self.last = global_params
            return global_params

    return DefaultClientTrainer, FrozenTrainer, HalfStepTrainer, Recording, GlobalKeepAggregator


def run_seam():
    """The operator seam on the Shakespeare RNN configuration (SEAM_ROUNDS):
    a frozen trainer and a keep-the-global aggregator passed positionally
    to ``run_simulation``; the default trainer passed explicitly against
    the stock engine, and a half-step trainer, through the simulator."""
    import fedml_tpu_torch
    from fedml_tpu_torch import constants
    from fedml_tpu_torch.arguments import load_yaml_arguments

    Default, Frozen, HalfStep, Recording, GlobalKeep = _seam_operators()
    t0 = time.perf_counter()

    def through_run_simulation(trainer, aggregator):
        args = load_yaml_arguments(str(RNN_CONFIG))
        args.comm_round, args.log_metrics = SEAM_ROUNDS, False
        fedml_tpu_torch.run_simulation(constants.FEDML_SIMULATION_TYPE_SP, trainer, aggregator,
                                       device=DEVICE, args=args)
        init = aggregator.model.init(torch.Generator().manual_seed(int(args.random_seed)))
        return {k: v.to(DEVICE) for k, v in init.items()}, aggregator.last

    reset_launches()
    init, frozen = through_run_simulation(Frozen(None), Recording(None))
    frozen_err = max(float((frozen[k] - init[k]).abs().max()) for k in init)
    frozen_rel = max(float(((frozen[k] - init[k]).abs() / init[k].abs().clamp_min(1e-30)).max())
                     for k in init)
    frozen_bitwise = all(torch.equal(frozen[k], init[k]) for k in init)
    log(f"seam: FrozenTrainer through run_simulation (positional), default aggregation: global "
        f"params bitwise unchanged: {frozen_bitwise}; max |change| {frozen_err:.3e}, max "
        f"relative {frozen_rel:.3e} (the weighted mean of identical copies rounds)")
    if not frozen_rel <= FROZEN_RTOL:
        fail(f"FrozenTrainer moved the global model by {frozen_rel} (relative), past "
             f"{FROZEN_RTOL}")
    init, kept = through_run_simulation(None, GlobalKeep(None))
    if not all(torch.equal(kept[k], init[k]) for k in init):
        fail("a custom aggregator that keeps the global model did not keep it")
    log("seam: GlobalKeepAggregator through run_simulation (positional): the global params "
        "bitwise the initial ones")

    runs = {}
    with deterministic():
        for name, trainer in (("stock", None), ("default", Default(None)),
                              ("half", HalfStep(None))):
            sim = _sim(RNN_CONFIG, 1, SEAM_ROUNDS, 5, client_trainer=trainer)
            sim.run()
            api = sim.fl_trainer
            runs[name] = ({k: v.detach().clone() for k, v in api.global_params.items()},
                          [{k: v for k, v in h.items()
                            if k not in ("round_time_s", "train_time_s")} for h in api.history])
            del sim, api
    stock, default, half = runs["stock"], runs["default"], runs["half"]
    if not all(torch.equal(stock[0][k], default[0][k]) for k in stock[0]):
        fail("the default trainer passed explicitly differs from the stock engine")
    if stock[1] != default[1]:
        fail(f"the default trainer's records differ from the stock engine's: {default[1]} vs "
             f"{stock[1]}")
    half_moved = max(float((half[0][k] - stock[0][k]).abs().max()) for k in stock[0])
    if not half_moved > 0:
        fail("HalfStepTrainer trained exactly as the stock engine")
    launches = launch_counts()
    log(f"seam: the default trainer passed explicitly is bitwise the stock engine (params and "
        f"records, deterministic algorithms); HalfStepTrainer ends {half_moved:.3e} from it; "
        f"flash launches {launches}; {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return {"frozen_bitwise": frozen_bitwise, "frozen_max_abs_change": frozen_err,
            "frozen_max_rel_change": frozen_rel, "half_vs_stock_max_abs": half_moved,
            "kernel_launches": launches}


@contextlib.contextmanager
def timed_calls(cls, *names):
    """Wall time of every call of the methods ``names`` of ``cls`` (a
    ``torch.cuda.synchronize`` first, so that queued work is not
    counted), collected per name while the context is open."""
    real = {n: getattr(cls, n) for n in names}
    times = {n: [] for n in names}

    def timed(n):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[n](*a, **kw)
            times[n].append(time.perf_counter() - t0)
            return out
        return call

    for n in names:
        setattr(cls, n, timed(n))
    try:
        yield times
    finally:
        for n in names:
            setattr(cls, n, real[n])


# each resume check's straight run's final params, by tag
RESUME_STRAIGHT: dict = {}


def resume_check(tag: str, config: Path) -> dict:
    """Depth 4 with ``checkpoint_freq: 2`` run 2 rounds, then started again
    to run to round RESUME_ROUNDS from the checkpoint of round 2, against
    a straight depth-1 run of RESUME_ROUNDS rounds (evaluation every 2), under
    ``deterministic()``: params bitwise equal, and the resumed run's
    records equal the straight run's of the same rounds."""
    import tempfile

    from fedml_tpu_torch.core.checkpoint import RoundCheckpointer

    out = {}
    with tempfile.TemporaryDirectory(prefix="resume_smoke_") as ckdir, \
            timed_calls(RoundCheckpointer, "save", "restore") as times, deterministic():
        for name, depth, rounds, knobs in (
                ("stopped", 4, 2, {"checkpoint_dir": ckdir, "checkpoint_freq": 2}),
                ("resumed", 4, RESUME_ROUNDS, {"checkpoint_dir": ckdir, "checkpoint_freq": 2}),
                ("straight", 1, RESUME_ROUNDS, {})):
            sim = _sim(config, depth, rounds, RESUME_FREQ, **knobs)
            sim.run()
            api = sim.fl_trainer
            out[name] = ({k: v.detach().clone() for k, v in api.global_params.items()},
                         [{k: v for k, v in h.items()
                           if k not in ("round_time_s", "train_time_s")} for h in api.history])
            del sim, api
            torch.cuda.empty_cache()
        ckpt = RoundCheckpointer(ckdir)
        steps = ckpt.steps()
        step_bytes = sum(f.stat().st_size for f in (Path(ckdir) / str(steps[-1])).iterdir())
    resumed, straight = out["resumed"], out["straight"]
    RESUME_STRAIGHT[tag] = straight[0]  # the elastic drill's reference
    unequal = [k for k in straight[0] if not torch.equal(resumed[0][k], straight[0][k])]
    tail = [h for h in straight[1] if h["round"] >= 2]
    log(f"resume ({tag}): stopped after round 2 (depth 4, checkpoint_freq 2), restored and run "
        f"to round {RESUME_ROUNDS}; against a straight depth-1 run: params differing bitwise "
        f"{len(unequal)} of {len(straight[0])}; resumed records rounds "
        f"{[h['round'] for h in resumed[1]]}; steps kept {steps}; checkpoint {step_bytes} bytes; "
        f"saves {['%.4f' % t for t in times['save']]} s, restores "
        f"{['%.4f' % t for t in times['restore']]} s")
    if unequal:
        err = max(float((resumed[0][k] - straight[0][k]).abs().max()) for k in unequal)
        fail(f"resume ({tag}): the resumed run differs from the straight one in {len(unequal)} "
             f"params (max {err})")
    if resumed[1] != tail or not tail:
        fail(f"resume ({tag}): the resumed run's records {resumed[1]} differ from the straight "
             f"run's {tail}")
    return {"bitwise_equal": True, "checkpoint_bytes": step_bytes, "steps_kept": steps,
            "save_s": times["save"], "restore_s": times["restore"]}


def run_resume():
    reset_launches()
    out = {"rnn": resume_check("Shakespeare RNN", RNN_CONFIG),
           "transformer": resume_check("transformer", TRANSFORMER_CONFIG)}
    out["kernel_launches"] = launch_counts()
    log(f"resume: flash launches {out['kernel_launches']}")
    return out


def run_remat(passes: int):
    """The transformer configuration with ``remat: true``: one round
    bitwise against the same round without remat (``deterministic()``),
    then 3 rounds of each through ``run_simulation``: peak memory,
    rounds/s, and the flash launches of the remat run (two forwards and
    one backward per layer per step for the whole cohort; ``passes``
    forward passes per evaluation)."""
    from fedml_tpu_torch.arguments import load_yaml_arguments

    params = {}
    with deterministic():
        for remat in (False, True):
            sim = _sim(TRANSFORMER_CONFIG, 1, 1, 5, remat=remat)
            sim.run()
            params[remat] = {k: v.detach().clone() for k, v in sim.fl_trainer.global_params.items()}
            del sim
            torch.cuda.empty_cache()
    unequal = [k for k in params[False] if not torch.equal(params[False][k], params[True][k])]
    log(f"remat: params after round 0 (one round), with and without remat: differing bitwise "
        f"{len(unequal)} of {len(params[False])}")
    if unequal:
        fail(f"remat changes the trained params: {unequal}")
    del params

    runs = {}
    for remat in (False, True):
        args = load_yaml_arguments(str(TRANSFORMER_CONFIG))
        args.comm_round, args.remat = REMAT_ROUNDS, remat
        runs[remat] = measured_run(args)
    card = card_line()
    L = int(args.num_layers)
    out = {}
    for remat, run in runs.items():
        _, rounds_per_s, _ = timed_rounds(run["pipe"], 1, REMAT_ROUNDS - 1)
        out["remat" if remat else "plain"] = {
            "rounds_per_s": rounds_per_s, "peak_memory_bytes": run["peak_bytes"],
            "train_loss": [r["train_loss"] for r in run["records"]]}
        log(f"remat on {card}: remat {remat}: rounds 1-{REMAT_ROUNDS - 1} {rounds_per_s:.4f} "
            f"rounds/s on the card's clock; peak memory {run['peak_bytes'] / 2**20:.1f} MiB "
            f"(less the {run['held_bytes'] / 2**20:.1f} MiB earlier phases still held); "
            f"flash launches {run['launches']}")
    run = runs[True]
    steps = REMAT_ROUNDS * run["pipe"]["num_batches"] * int(args.epochs)
    evals = len(run["records"])
    want = {**no_launches(), "flash_attention_fwd": L * (2 * steps + evals * passes),
            "flash_attention_bwd": L * steps}
    log(f"remat: flash launches {run['launches']}, want {want} ({L} layers x {steps} steps x "
        f"(2 forwards, 1 backward), + {evals} evaluations of {passes} forward passes)")
    if run["launches"] != want:
        fail(f"remat: flash launches {run['launches']}, want {want}")
    if not runs[True]["peak_bytes"] < runs[False]["peak_bytes"]:
        fail(f"remat: peak memory {runs[True]['peak_bytes']} is not below the run without remat "
             f"({runs[False]['peak_bytes']})")
    if not all(np.isfinite(out["remat"]["train_loss"])):
        fail(f"remat: train loss {out['remat']['train_loss']}")
    torch.cuda.empty_cache()
    return {"card": card, "bitwise_equal": True, **out, "kernel_launches": run["launches"]}


# -- the sixth slice: the exact fold (K1), the keyed features (K2), planet -
# f32 operations outside the tensor cores (H100 SXM data sheet, 700 W):
# the rate the fold's adds and the feature generator's float work run at
F32_FLOPS = 67e12
# K1 cases, (N, K): ``fold`` at the planet path's model
# (logistic regression, 60 x 10 + 10 = 610 params, one term a fold),
# then ResNet-18-GN's 11,173,962 params with one term (a streaming fold)
# and three (a limb-set merge), and the cross-silo path's: the FEMNIST
# CNN's 428,350 params, an upload's fold and an edge report's merge
FOLD_CASES = [(610, 1), (11_173_962, 1), (11_173_962, 3), (428_350, 1), (428_350, 3)]
# the one-launch calls at the planet path's 4 edges: a group's edge
# terms into their edges (E, N, mask; the planet's model, edge 2 skipped
# as a group with no client of it skips it) and the root merge of the
# touched edges' limbs (E, N, mask), at the planet's model and at
# ResNet-18-GN's
EDGE_FOLD_CASES = [(4, 610, 0b1011)]
MERGE_CASES = [(4, 610, 0b1111), (4, 11_173_962, 0b1111)]
# exact_weighted_mean, (C, N, dtype): 16 clients of ResNet-18-GN in f32,
# 10 of the flash TransformerLM (8,495,194 params) in bf16; the fed-mesh
# FedAvg path's own calls, one a leaf of the FEMNIST CNN over its 32
# clients, are added at run time (mesh_mean_cases)
MEAN_CASES = [(16, 11_173_962, torch.float32), (10, 8_495_194, torch.bfloat16)]
# K2 cases, (C, S, dim): one of the planet path's two largest groups
# (4,096 clients x 4 batches of 32, 60 features), FEMNIST-sized rows,
# then samples a client that are not a power of two (100), so that the
# kernels' multiply-high for a row's client is not a shift
SYNTH_CASES = [(4096, 128, 60), (64, 512, 784), (3000, 100, 60),
               # the Beehive group: a tier padded to 128 devices x 13
               # batches of 32, 8 features (cross_device_beehive_lr.yaml)
               (128, 416, 8)]
# K2 against its plain version: the Philox words bitwise; the features
# (|x| below ~10) to 1e-5, the kernel's logf, sqrtf and sincosf against
# PyTorch's log, sqrt, sin and cos (both IEEE-rounded adds and products
# otherwise)
SYNTH_ATOL = 1e-5
# K2's time ("ms"), as every kernel's here: CUDA events around 20
# back-to-back calls through its wrapper. A call is under 0.1 ms, near
# what the wrapper's host work takes, so that can read the host as well;
# the kernel's own device time under torch.profiler over 200 calls is
# printed beside it ("device_ms")
SYNTH_TIMED, SYNTH_PROFILED = 20, 200
# planet phase: the configuration through run_simulation for 5 rounds:
# round 0 warms up, rounds 1-3 are timed as a whole on the card's clock,
# round 4 runs under torch.profiler; evaluation after rounds 0 and 4
PLANET_CONFIG = REPO / "fedml_tpu_torch" / "configs" / "fedavg_planet_lr.yaml"
PLANET_ROUNDS, PLANET_TIMED, PLANET_PROFILED = 5, (1, 3), 4
# the phase's rounds/s when the exact fold launched once a fold (20 a
# round): printed beside this run's for comparison, checked against nothing
PLANET_EARLIER_ROUNDS_PER_S = 3.5103
# host RSS of a warm re-run (every shape seen) at a 10x smaller registry:
# the 1M registry's must stay within 64 MiB of it (bench.py:2717-2725)
PLANET_SMALL_REGISTRY = 100_000
PLANET_RSS_SLACK = 64 * 2**20
# tree vs flat and resume: 3 rounds, stopped after round 1 and resumed
PLANET_CHECK_ROUNDS = 3
PLANET_KINDS = (
    ("exact fold", ("fold_kernel",)),
    ("synth features", ("synth_kernel",)),
    ("GEMM", ("gemm", "gemv", "nvjet", "cutlass", "xmma")),
    ("reductions", ("reduce",)),
    ("copies, fills", ("copy", "memcpy", "memset", "fill")),
)
_INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(_INT_VIEW[a.dtype]), b.view(_INT_VIEW[b.dtype])))


def bytes_bound(nbytes: float, f32_ops: float):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the f32 operations over the f32 rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, f32_ops / F32_FLOPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def spread(shape, gen) -> torch.Tensor:
    """f32 values with exponents over [-30, 30] and random signs."""
    m = torch.rand(shape, generator=gen, device=DEVICE) + 1.0
    e = torch.randint(-30, 31, shape, generator=gen, device=DEVICE).to(torch.float32)
    sign = torch.where(torch.rand(shape, generator=gen, device=DEVICE) < 0.5, -1.0, 1.0)
    return sign * m * torch.exp2(e)


def _timing_iters(nbytes: float) -> int:
    return 200 if nbytes < 2**24 else 20


def kernel_entry(case: dict, **fixed) -> dict:
    return {**fixed, "launches": None,  # filled from the paths' runs
            **{key: case[key] for key in MAIN_KEYS}, "shape": case["shape"],
            "dtype": case["dtype"]}


def _fold_case(label: str, limbs, run_kernel, run_plain, nbytes: int, f32_ops: int,
               **fields) -> dict:
    """One K1 fold case: ``run_kernel`` and ``run_plain`` each fold into a
    clone of ``limbs`` in place; bitwise equal, the kernel repeating
    bitwise; timed by events through the wrapper, by the profiler's
    device time and against its bytes bound."""
    got, want, again = limbs.clone(), limbs.clone(), limbs.clone()
    run_kernel(got)
    run_plain(want)
    run_kernel(again)
    torch.cuda.synchronize()
    if not bits_equal(got, want):
        fail(f"{label}: the kernel differs from its plain version "
             f"(max {float((got - want).abs().max())})")
    if not bits_equal(got, again):
        fail(f"{label}: two launches differ")
    iters = _timing_iters(nbytes)
    ms = cuda_time_ms(lambda: run_kernel(got), iters)
    device_ms = kernel_device_ms(lambda: run_kernel(got), "fold_kernel", iters)
    plain_ms = cuda_time_ms(lambda: run_plain(want), max(2, iters // 10))
    bound_ms, bound_by = bytes_bound(nbytes, f32_ops)
    log(f"{label}: bitwise its plain version and repeatable; kernel {ms:.4f} ms a call through "
        f"the wrapper, by events ({device_ms:.4f} ms device time), bound {bound_ms:.6f} ms "
        f"({bound_by}, {nbytes / 1e6:.3f} MB), {bound_ms / ms:.1%} of it "
        f"({bound_ms / device_ms:.1%} of the device time); plain {plain_ms:.4f} ms; library: "
        f"none (no PyTorch call computes an exact fold)")
    return {**fields, "dtype": "float32", "max_abs_err": 0.0, "bitwise": True,
            "repeats_bitwise": True, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_route": "f32 (no tensor cores)",
            "share_of_bound": bound_ms / ms, "device_share_of_bound": bound_ms / device_ms,
            "library_ms": None, "library_kernel": None}


def mesh_mean_cases():
    """K1's ``weighted_mean`` calls on the fed-mesh FedAvg path
    (``fedavg_femnist_cnn.yaml``): one a leaf, [clients a round, leaf
    size], f32."""
    from fedml_tpu_torch.arguments import load_yaml_arguments
    from fedml_tpu_torch.models.cnn import CNNFedAvg

    clients = int(load_yaml_arguments(str(FEDAVG_CONFIG)).client_num_per_round)
    return [(clients, p.numel(), torch.float32) for p in CNNFedAvg().parameters()]


def check_exact_fold():
    """K1 against its plain version, bitwise, at FOLD_CASES (``fold``),
    EDGE_FOLD_CASES (``fold_edges``: a group's edge terms, one launch),
    MERGE_CASES (``fold_set``: the root merge, one launch) and, its
    weighted-mean entry, MEAN_CASES; each repeats bitwise. Returns the
    kernel's ``kernels`` entry (main numbers from the planet path's
    per-group edge fold, its most launched call)."""
    from fedml_tpu_torch.ops import exact_fold as ef

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    folds, edge_folds, merges, means = [], [], [], []
    for n, k in FOLD_CASES:
        limbs, terms = spread((3, n), gen), spread((k, n), gen)
        folds.append(_fold_case(
            f"exact fold [3, {n}] += [{k}, {n}] f32", limbs,
            lambda t: ef.fold(t, terms), lambda t: ef.fold_reference(t, terms),
            (6 + k) * n * 4, 13 * k * n, call="fold", shape=[3, n], terms=k))
        del limbs, terms
    for E, n, mask in EDGE_FOLD_CASES:
        limbs, terms = spread((E, 3, n), gen), spread((E, n), gen)
        hit = bin(mask).count("1")
        edge_folds.append(_fold_case(
            f"exact fold edges [{E}, 3, {n}] += [{E}, {n}], mask {mask:#06b}", limbs,
            lambda t: ef.fold_edges(t, terms, mask),
            lambda t: ef.fold_edges_reference(t, terms, mask),
            hit * 7 * n * 4, 13 * hit * n, call="fold_edges", shape=[E, 3, n],
            mask=mask, edges_folded=hit))
        del limbs, terms
    for E, n, mask in MERGE_CASES:
        root, src = spread((3, n), gen), spread((E, 3, n), gen)
        hit = bin(mask).count("1")
        merges.append(_fold_case(
            f"exact fold root merge [3, {n}] += [{E}, 3, {n}], mask {mask:#06b}", root,
            lambda t: ef.fold_set(t, src, mask), lambda t: ef.fold_set_reference(t, src, mask),
            (6 + 3 * hit) * n * 4, 13 * 3 * hit * n, call="fold_set", shape=[E, 3, n],
            mask=mask, terms=3 * hit))
        del root, src
        torch.cuda.empty_cache()
    for c, n, dtype in MEAN_CASES + mesh_mean_cases():
        x = spread((c, n), gen).to(dtype)
        w = torch.rand(c, generator=gen, device=DEVICE)
        w = w / w.sum()
        got, want, again = ef.MEAN_KERNEL(x, w), ef.weighted_mean_reference(x, w), ef.MEAN_KERNEL(x, w)
        torch.cuda.synchronize()
        if not bits_equal(got, want):
            fail(f"exact weighted mean [{c}, {n}] {dtype}: the kernel differs from its plain "
                 f"version (max {float((got.float() - want.float()).abs().max())})")
        if not bits_equal(got, again):
            fail(f"exact weighted mean [{c}, {n}] {dtype}: two launches differ")
        size = x.element_size()
        nbytes = c * n * size + c * 4 + n * size
        ms = cuda_time_ms(lambda: ef.MEAN_KERNEL(x, w), 20)
        device_ms = kernel_device_ms(lambda: ef.MEAN_KERNEL(x, w), "weighted_mean_kernel", 20)
        plain_ms = cuda_time_ms(lambda: ef.weighted_mean_reference(x, w), 3)
        scale_ms = cuda_time_ms(lambda: w.to(dtype) @ x, 20)
        bound_ms, bound_by = bytes_bound(nbytes, 14 * c * n + 2 * n)
        log(f"exact weighted mean [{c}, {n}] {str(dtype).split('.')[-1]}: bitwise its plain "
            f"version and repeatable; kernel {ms:.4f} ms by events ({device_ms:.4f} ms device "
            f"time), bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of it "
            f"({bound_ms / device_ms:.1%} of the device time); plain {plain_ms:.4f} ms; for "
            f"scale only, NOT the same function (one rounded product over the clients): "
            f"w @ x {scale_ms:.4f} ms")
        means.append({"shape": [c, n], "dtype": str(dtype).split(".")[-1], "bitwise": True,
                      "repeats_bitwise": True, "ms": ms, "device_ms": device_ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                      "share_of_bound": bound_ms / ms,
                      "device_share_of_bound": bound_ms / device_ms, "library_ms": None,
                      "w_matmul_ms_not_the_same_function": scale_ms})
        del x, got, want, again
    torch.cuda.empty_cache()
    log(f"exact fold launches while checking (not counted): {ef.FOLD_KERNEL.launches} fold, "
        f"{ef.MEAN_KERNEL.launches} weighted mean")
    return {**kernel_entry(edge_folds[0], name=ef.FOLD_KERNEL.name, route="cuda",
                           source="fedml_tpu_torch/ops/csrc/exact_fold.cu",
                           replaces="fedml_tpu/core/aggregation.py:201",
                           kind="not a TPU kernel (XLA-generated in the reference)"),
            "device_ms": edge_folds[0]["device_ms"],
            "cases": folds + edge_folds + merges, "weighted_mean_cases": means}


def check_synth_features():
    """K2 against its plain version at SYNTH_CASES: the Philox words
    bitwise, the features to SYNTH_ATOL (bitwise is reported), each
    repeating bitwise. Returns the kernel's ``kernels`` entry (main
    numbers from the planet path's group)."""
    from fedml_tpu_torch.ops import synth_features as sf

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    cases = []
    for C, S, dim in SYNTH_CASES:
        classes = 10
        y = torch.randint(0, classes, (C, S), generator=gen, device=DEVICE)
        means = torch.randn((classes, dim), generator=gen, device=DEVICE)
        seeds = torch.randint(0, 2**31 - 1, (C,), generator=gen, device=DEVICE)
        got, again = sf.SYNTH_KERNEL(y, means, seeds, 1.0), sf.SYNTH_KERNEL(y, means, seeds, 1.0)
        want = sf.synth_features_reference(y, means, seeds, 1.0)
        blocks4 = -(-dim // 4)
        words = sf.WORDS_KERNEL(seeds, S, blocks4)
        words_ref = sf.philox_words_reference(seeds, S, blocks4)
        torch.cuda.synchronize()
        if not torch.equal(words, words_ref):
            fail(f"synth features [{C}, {S}, {dim}]: the kernel's Philox words differ from the "
                 "plain version's")
        err = float((got - want).abs().max())
        if not err <= SYNTH_ATOL:
            fail(f"synth features [{C}, {S}, {dim}]: max abs err {err} > {SYNTH_ATOL}")
        if not bits_equal(got, again):
            fail(f"synth features [{C}, {S}, {dim}]: two launches differ")
        nbytes = C * S * dim * 4 + C * S * 8 + C * 8 + classes * dim * 4
        call = lambda: sf.SYNTH_KERNEL(y, means, seeds, 1.0)  # noqa: E731
        ms = cuda_time_ms(call, SYNTH_TIMED)
        device_ms = kernel_device_ms(call, "synth_kernel", SYNTH_PROFILED)
        plain_ms = cuda_time_ms(lambda: sf.synth_features_reference(y, means, seeds, 1.0), 3)
        bound_ms, bound_by = bytes_bound(nbytes, 8 * C * S * dim)
        bitwise = bits_equal(got, want)
        log(f"synth features [{C}, {S}, {dim}] f32: Philox words bitwise, features max abs err "
            f"{err:.3g} (atol {SYNTH_ATOL}; bitwise: {bitwise}), repeatable; kernel {ms:.4f} ms "
            f"a call through the wrapper, by events ({device_ms:.4f} ms device time), "
            f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB), "
            f"{bound_ms / ms:.1%} of it ({bound_ms / device_ms:.1%} of the device time); "
            f"plain {plain_ms:.4f} ms; library: none (torch.randn does not key a draw by "
            f"sample)")
        cases.append({"shape": [C, S, dim], "dtype": "float32", "max_abs_err": err,
                      "bitwise": bitwise, "words_bitwise": True, "repeats_bitwise": True,
                      "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "bound_route": "HBM write",
                      "share_of_bound": bound_ms / ms,
                      "device_share_of_bound": bound_ms / device_ms,
                      "library_ms": None, "library_kernel": None})
        del y, means, seeds, got, again, want, words, words_ref
        torch.cuda.empty_cache()
    log(f"synth features launches while checking (not counted): {sf.SYNTH_KERNEL.launches}")
    return {**kernel_entry(cases[0], name=sf.SYNTH_KERNEL.name, route="cuda",
                           source="fedml_tpu_torch/ops/csrc/synth_features.cu",
                           replaces="fedml_tpu/data/synthetic.py:150",
                           kind="not a TPU kernel (XLA-generated in the reference)"),
            "device_ms": cases[0]["device_ms"], "cases": cases}


def planet_args(**knobs):
    """The planet configuration's args, ``knobs`` set over the YAML."""
    from fedml_tpu_torch.arguments import load_yaml_arguments

    args = load_yaml_arguments(str(PLANET_CONFIG))
    args.log_metrics = False
    for knob, value in knobs.items():
        setattr(args, knob, value)
    args._validate()
    return args


def planet_api(**knobs):
    """The configuration's FedAvg API, as ``run_simulation`` builds it,
    kept so that its params and stats can be read and ``train()`` called
    again."""
    import fedml_tpu_torch
    from fedml_tpu_torch import data, models
    from fedml_tpu_torch.simulation import SimulatorSingleProcess

    args = fedml_tpu_torch.init(planet_args(**knobs))
    dataset = data.load(args, device=DEVICE)
    model = models.create(args, dataset.class_num, device=DEVICE)
    return SimulatorSingleProcess(args, DEVICE, dataset, model).fl_trainer


def planet_launches_wanted(args, rounds):
    """(folds, groups, fold launches) a round, reckoned on the host from
    the registry alone: each group folds once per edge whose weight is >
    0, all of them in one launch, the tree merges each edge that received
    a fold, all of them in one launch, and each group's features are one
    launch."""
    from fedml_tpu_torch.scale import ClientRegistry, pack_cohort

    reg = ClientRegistry(int(args.client_registry_size), seed=int(args.random_seed))
    E = max(1, int(args.edge_num))
    tree = int(args.edge_num) >= 2 and not bool(args.edge_flat_fold)
    folds, groups, launches = [], [], []
    for r in rounds:
        idx = reg.sample_cohort(r, int(args.cohort_size or args.client_num_per_round))
        plan = pack_cohort(reg.num_samples[idx], idx, int(args.batch_size),
                           speed_tier=reg.speed_tier[idx], waste_cap=float(args.packing_waste_cap))
        touched, n, group_launches = set(), 0, 0
        for g in plan.groups:
            w = np.zeros(E)
            np.add.at(w, g.client_idx % E, g.num_samples.astype(np.float64) * g.valid)
            hit = np.nonzero(w > 0)[0]
            n += len(hit)
            group_launches += bool(len(hit))
            touched |= set(hit.tolist())
        folds.append(n + (len(touched) if tree else 0))
        groups.append(len(plan.groups))
        launches.append(group_launches + int(tree and bool(touched)))
    return folds, groups, launches


def run_planet():
    """The registry-backed population plane at full size: the planet
    configuration through ``run_simulation`` (timed, profiled, launches
    of K1 and K2 reckoned against the registry), the host RSS of a warm
    re-run at 100k and 1M registries, tree == flat bitwise, and a run
    stopped and resumed bitwise the straight one."""
    import tempfile

    from fedml_tpu_torch.core.sys_stats import current_rss_bytes, peak_rss_bytes

    card = card_line()
    args = planet_args(comm_round=PLANET_ROUNDS, frequency_of_the_test=PLANET_ROUNDS - 1)
    run = measured_run(args, PLANET_PROFILED)
    pipe, launches = run["pipe"], run["launches"]
    first, last = PLANET_TIMED
    timed_s, rounds_per_s, samples = timed_rounds(pipe, first, last)
    cohort = int(args.cohort_size)
    folds_want, groups_want, fold_launches = planet_launches_wanted(args, range(PLANET_ROUNDS))
    fold_want = sum(fold_launches)
    log(f"planet: registry {pipe['registry_clients']} clients ({pipe['registry_bytes']} bytes "
        f"of columns), cohort {cohort}, {pipe['edge_num']} edges; {PLANET_ROUNDS} rounds in "
        f"{run['wall_s']:.1f} s (registry, holdouts and warm-up included); groups a round "
        f"{pipe['round_groups']}, folds a round {pipe['round_folds']} (reckoned from the "
        f"registry: {folds_want}); kernel launches {launches}")
    for r, (a, b) in enumerate(pipe["round_spans_s"]):
        log(f"  planet round {r}: {(b - a) * 1e3:.1f} ms on the card's clock, "
            f"{pipe['round_samples'][r]} packed samples")
    if pipe["round_folds"] != folds_want or pipe["round_groups"] != groups_want:
        fail(f"planet: folds {pipe['round_folds']} / groups {pipe['round_groups']} a round, "
             f"the registry gives {folds_want} / {groups_want}")
    if launches["exact_fold"] != fold_want:
        fail(f"planet: {launches['exact_fold']} exact-fold launches, the registry gives "
             f"{fold_want} (one a group, one root merge a round: {fold_launches})")
    if launches["synth_features"] != sum(groups_want):
        fail(f"planet: {launches['synth_features']} feature launches, want {sum(groups_want)}")
    others = {k: v for k, v in launches.items() if k not in ("exact_fold", "synth_features")}
    if any(others.values()):
        fail(f"planet: kernels off the path launched: {others}")
    losses = [r["test_loss"] for r in run["records"]]
    for r in run["records"]:
        log(f"  planet round {r['round']} record: train {r['train_time_s'] * 1e3:.1f} ms, with "
            f"eval {r['round_time_s'] * 1e3:.1f} ms; test_loss {r['test_loss']:.4f}, test_acc "
            f"{r['test_acc']:.4f}, train_loss {r['train_loss']:.4f}, cohort loss "
            f"{r['train_loss_cohort']:.4f}, cohort samples {r['cohort_samples']:.0f}")
    if len(losses) < 2 or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"planet: the evaluation loss did not fall: {losses}")
    max_nb = max(nb for _, nb in pipe["shape_keys"])
    budget = (cohort.bit_length() + 1) * (int(max_nb).bit_length() + 1)
    if pipe["trace_count"] != len(pipe["shape_keys"]) or pipe["trace_count"] > budget:
        fail(f"planet: {pipe['trace_count']} first calls for {len(pipe['shape_keys'])} shape keys "
             f"(budget {budget})")
    log(f"planet on {card}: rounds {first}-{last} timed as a whole on the card's clock: "
        f"{timed_s:.4f} s, {rounds_per_s:.4f} rounds/s, {cohort * rounds_per_s:.1f} clients/s, "
        f"{samples * rounds_per_s:.0f} packed samples/s; shape keys {pipe['shape_keys']} "
        f"({pipe['trace_count']} first calls, budget {budget}); waste fraction "
        f"{pipe['waste_frac_mean']:.4f}; peak memory {run['peak_bytes'] / 2**20:.1f} MiB; "
        f"{fold_want / PLANET_ROUNDS:.1f} exact-fold launches a round for "
        f"{sum(folds_want) / PLANET_ROUNDS:.1f} folds ({fold_launches} a round; one a fold "
        f"before they were merged into a launch a group) and "
        f"{sum(groups_want) / PLANET_ROUNDS:.1f} feature launches a round; with one launch a fold "
        f"this phase read {PLANET_EARLIER_ROUNDS_PER_S} rounds/s (NVIDIA H100 80GB HBM3, 700 W)")
    profile = profile_summary(f"planet profile of round {PLANET_PROFILED} (with evaluation) on "
                              f"{card}", run["summary"], PLANET_KINDS)

    deltas = {}
    for size in (PLANET_SMALL_REGISTRY, int(args.client_registry_size)):
        api = planet_api(client_registry_size=size, client_num_in_total=size)
        api.train()  # warm: every (bucket, nb) shape of these rounds seen
        torch.cuda.synchronize()
        gc.collect()
        rss0 = current_rss_bytes()
        t0 = time.perf_counter()
        api.train()
        torch.cuda.synchronize()
        deltas[size] = {"rss_delta_bytes": max(0, current_rss_bytes() - rss0),
                        "wall_s": time.perf_counter() - t0, "rss_bytes": rss0,
                        "rounds": api.pipeline_stats["rounds"]}
        del api
        gc.collect()
        torch.cuda.empty_cache()
    small, big = deltas[PLANET_SMALL_REGISTRY], deltas[int(args.client_registry_size)]
    log(f"planet: warm re-run host RSS delta: registry {PLANET_SMALL_REGISTRY}: "
        f"{small['rss_delta_bytes'] / 2**20:.1f} MiB ({small['rounds']} rounds in "
        f"{small['wall_s']:.2f} s), registry {args.client_registry_size}: "
        f"{big['rss_delta_bytes'] / 2**20:.1f} MiB ({big['wall_s']:.2f} s); process RSS "
        f"{big['rss_bytes'] / 2**20:.1f} MiB, peak {peak_rss_bytes() / 2**20:.1f} MiB")
    if not big["rss_bytes"] > 0:
        fail("planet: the host RSS is not measurable here")
    if big["rss_delta_bytes"] > small["rss_delta_bytes"] + PLANET_RSS_SLACK:
        fail(f"planet: warm re-run RSS grew with the registry: {big['rss_delta_bytes']} against "
             f"{small['rss_delta_bytes']} + {PLANET_RSS_SLACK}")

    out = {}
    with tempfile.TemporaryDirectory(prefix="planet_resume_") as ckdir:
        for name, knobs in (
                ("tree", {"comm_round": PLANET_CHECK_ROUNDS}),
                ("flat", {"comm_round": PLANET_CHECK_ROUNDS, "edge_flat_fold": True}),
                ("stopped", {"comm_round": 2, "checkpoint_dir": ckdir, "checkpoint_freq": 1}),
                ("resumed", {"comm_round": PLANET_CHECK_ROUNDS, "checkpoint_dir": ckdir,
                             "checkpoint_freq": 1})):
            api = planet_api(**knobs)
            api.train()
            torch.cuda.synchronize()
            out[name] = ({k: v.detach().clone() for k, v in api.global_params.items()},
                         api.pipeline_stats["round_folds"], api.history)
            del api
            torch.cuda.empty_cache()
    checks = {}
    for name in ("flat", "resumed"):
        unequal = [k for k in out["tree"][0] if not torch.equal(out[name][0][k], out["tree"][0][k])]
        checks[name] = not unequal
        log(f"planet: {name} against the straight tree run ({PLANET_CHECK_ROUNDS} rounds): params "
            f"differing bitwise {len(unequal)} of {len(out['tree'][0])}; folds a round "
            f"{out[name][1]} (tree {out['tree'][1]})")
        if unequal:
            err = max(float((out[name][0][k] - out["tree"][0][k]).abs().max()) for k in unequal)
            fail(f"planet: the {name} run differs from the tree run (max {err})")
    return {"card": card, "rounds_per_s": rounds_per_s, "timed_rounds_s": timed_s,
            "clients_per_s": cohort * rounds_per_s, "packed_samples_per_s": samples * rounds_per_s,
            "registry_bytes": pipe["registry_bytes"], "shape_keys": pipe["shape_keys"],
            "trace_count": pipe["trace_count"], "trace_budget": budget,
            "waste_frac_mean": pipe["waste_frac_mean"], "peak_memory_bytes": run["peak_bytes"],
            "test_loss": losses, "folds_per_round": folds_want, "groups_per_round": groups_want,
            "fold_launches_per_round": fold_launches,
            "profile": {"round": PLANET_PROFILED, **profile}, "warm_rerun": deltas,
            "tree_equals_flat": checks["flat"], "resume_bitwise": checks["resumed"],
            "pipeline": pipe, "kernel_launches": launches}


# -- the seventh slice: tag prediction, real files, FedProx synthetic ----
TAG_CONFIG = REPO / "fedml_tpu_torch" / "configs" / "fedavg_stackoverflow_lr.yaml"
# tag prediction over 100 of the configuration's 400 clients, each with
# its 100 train and 20 test examples: a round (10 clients) does the
# configuration's work, while the stand-in's examples, made on the host,
# take a quarter of the time
TAG_CLIENTS = 100
LEAF_CONFIG = REPO / "fedml_tpu_torch" / "configs" / "fedavg_mnist_leaf_lr.yaml"
FEDPROX_CONFIG = REPO / "fedml_tpu_torch" / "configs" / "fedprox_synthetic_1_1.yaml"
# each config through run_simulation for 5 rounds, evaluation after each:
# round 0 warms up, round 1 runs under torch.profiler (the tag phase),
# rounds 2-4 are timed: their training on the card's clock, and whole,
# evaluation included, on the host's
SLICE7_ROUNDS, SLICE7_PROFILED, SLICE7_TIMED = 5, 1, (2, 4)
# what each of these phases reports of its timed rounds
SLICE7_TIMES = ("rounds_per_s", "rounds_per_s_by_round", "timed_rounds_s", "whole_rounds_per_s",
                "whole_rounds_per_s_by_round", "real_examples_per_s")
TAG_PARAMS = 10_000 * 500 + 500
LR_KINDS = (
    ("GEMM", ("gemm", "gemv", "nvjet", "cutlass", "xmma")),
    ("reductions", ("reduce",)),
    ("copies, fills", ("copy", "memcpy", "memset", "fill")),
)


@contextlib.contextmanager
def simulated_api():
    """The FedAvg API that ``run_simulation`` builds, held (appended to the
    yielded list) so that its dataset and ``evaluate_global`` can be read
    after the run returns; the run itself is untouched."""
    from fedml_tpu_torch.simulation import SimulatorSingleProcess

    held, run = [], SimulatorSingleProcess.run

    def holding(self):
        held.append(self.fl_trainer)
        return run(self)

    SimulatorSingleProcess.run = holding
    try:
        yield held
    finally:
        SimulatorSingleProcess.run = run


@contextlib.contextmanager
def logged_warnings():
    """Messages of the warnings logged inside the block."""
    import logging

    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    handler = Keep(logging.WARNING)
    logging.getLogger().addHandler(handler)
    try:
        yield seen
    finally:
        logging.getLogger().removeHandler(handler)


def to_spread(x: float, values) -> str:
    """``x`` printed to the last decimal digit that the spread (max - min)
    of ``values`` reaches."""
    spread = max(values) - min(values)
    if not spread > 0:
        return repr(x)
    decimals = -int(np.floor(np.log10(spread)))
    return f"{x:.{decimals}f}" if decimals > 0 else str(int(round(x, decimals)))


def slice7_run(config: Path, tag: str, profiled=None, **knobs):
    """``config`` through ``run_simulation`` for SLICE7_ROUNDS rounds
    (evaluation after each): the measured run, the API it built, the
    warnings logged, the train losses (which must fall) and, over rounds
    SLICE7_TIMED, the training's rounds/s and real examples/s on the
    card's clock and the whole rounds' rounds/s (evaluation included) on
    the host's, each with its spread over the rounds."""
    from fedml_tpu_torch.arguments import load_yaml_arguments

    args = load_yaml_arguments(str(config))
    args.comm_round, args.frequency_of_the_test = SLICE7_ROUNDS, 1
    for knob, value in knobs.items():
        setattr(args, knob, value)
    args._validate()
    with simulated_api() as held, logged_warnings() as warned:
        run = measured_run(args, profiled)
    losses = log_records(tag, run)
    # each round's training span on the card's clock, summed: the window
    # from the first to the last would hold the evaluations between them
    first, last = SLICE7_TIMED
    spans = [b - a for a, b in run["pipe"]["round_spans_s"][first:last + 1]]
    timed_s, per_round = sum(spans), [1.0 / t for t in spans]
    rounds_per_s = len(spans) / timed_s
    examples = float(np.mean(run["pipe"]["round_samples"][first:last + 1]))
    whole = [r["round_time_s"] for r in run["records"] if first <= r["round"] <= last]
    whole_per_s, whole_per_round = len(whole) / sum(whole), [1.0 / t for t in whole]
    ds = held[-1].dataset
    log(f"{tag} on {card_line()}: {args.dataset} ({ds.source}), {args.model}, "
        f"{args.client_num_per_round} of {ds.client_num} clients per round, batch "
        f"{args.batch_size}, {args.epochs} epochs, {args.dtype}: rounds {first}-{last}: training "
        f"on the card's clock {to_spread(rounds_per_s, per_round)} rounds/s (a round "
        f"{to_spread(min(per_round), per_round)}-{to_spread(max(per_round), per_round)}), "
        f"{to_spread(examples * args.epochs * rounds_per_s, [examples * args.epochs * v for v in per_round])} "
        f"real examples/s ({examples:.0f} a round); whole rounds with evaluation on the host's "
        f"clock {to_spread(whole_per_s, whole_per_round)} rounds/s (a round "
        f"{to_spread(min(whole_per_round), whole_per_round)}-"
        f"{to_spread(max(whole_per_round), whole_per_round)}); peak memory "
        f"{run['peak_bytes'] / 2**20:.1f} MiB; {SLICE7_ROUNDS} rounds in {run['wall_s']:.1f} s "
        f"(data and init included)")
    if any(run["launches"].values()):
        fail(f"{tag}: hand-written kernels launched on a path that reckons none: {run['launches']}")
    return {"run": run, "api": held[-1], "args": args, "warnings": warned, "train_loss": losses,
            "rounds_per_s": rounds_per_s, "rounds_per_s_by_round": per_round,
            "timed_rounds_s": timed_s, "whole_rounds_per_s": whole_per_s,
            "whole_rounds_per_s_by_round": whole_per_round,
            "real_examples_per_s": examples * args.epochs * rounds_per_s}


def run_tag_prediction():
    """Stack Overflow tag prediction at full width (10,000 -> 500 LR in
    f32) through ``run_simulation`` over TAG_CLIENTS of its clients: 5
    rounds, round 1 profiled; the loss falls, precision, recall and F1
    from ``evaluate_global`` lie in [0, 1], and no hand-written kernel
    launches (the path reckons none: its product is cuBLAS's, as XLA's
    was)."""
    from fedml_tpu_torch.arguments import load_yaml_arguments

    args = load_yaml_arguments(str(TAG_CONFIG))
    share = TAG_CLIENTS / int(args.client_num_in_total)
    out = slice7_run(TAG_CONFIG, "tag prediction", SLICE7_PROFILED,
                     client_num_in_total=TAG_CLIENTS,
                     synthetic_train_size=round(int(args.synthetic_train_size) * share),
                     synthetic_test_size=round(int(args.synthetic_test_size) * share))
    api, run, card = out["api"], out["run"], card_line()
    params = api.model.param_count(api.global_params)
    if api.dataset.task != "tag_prediction" or params != TAG_PARAMS:
        fail(f"tag prediction: task {api.dataset.task}, {params} params (want {TAG_PARAMS})")
    stats = api.evaluate_global()
    log(f"tag prediction on {card}: evaluate_global: precision {stats['precision']:.4f}, recall "
        f"{stats['recall']:.4f}, F1 {stats['acc']:.4f}, loss {stats['loss']:.4f} over "
        f"{stats['count']:.0f} test examples; {params} params; test F1 a round "
        f"{[round(r['test_acc'], 4) for r in run['records']]}")
    if not all(0.0 <= stats[k] <= 1.0 for k in ("precision", "recall", "acc")):
        fail(f"tag prediction: precision, recall and F1 outside [0, 1]: {stats}")
    profile = profile_summary(f"tag prediction profile of round {SLICE7_PROFILED} (with "
                              f"evaluation) on {card}", run["summary"], LR_KINDS)
    if profile.get("device_launches"):
        log(f"tag prediction on {card}: launches by kind in the profiled round "
            f"{profile['launches_by_kind']}")
    torch.cuda.empty_cache()
    return {"card": card, **{k: out[k] for k in SLICE7_TIMES},
            "peak_memory_bytes": run["peak_bytes"], "train_loss": out["train_loss"],
            "evaluate_global": stats, "params": params,
            "profile": {"round": SLICE7_PROFILED, **profile}, "pipeline": run["pipe"],
            "kernel_launches": run["launches"]}


def run_real_files():
    """The LEAF files in fedml_data/mnist (100 users) through
    ``run_simulation``: 5 rounds; the loader must report that it read
    them and log no stand-in; the loss falls."""
    out = slice7_run(LEAF_CONFIG, "real files", data_cache_dir=str(REPO / "fedml_data"))
    ds, card = out["api"].dataset, card_line()
    standin = [m for m in out["warnings"] if "stand-in" in m]
    log(f"real files on {card}: the loader read {ds.source!r}: {ds.client_num} clients, "
        f"{ds.train_data_num} train and {ds.test_data_num} test samples; stand-in warnings "
        f"{standin}")
    if not ds.source.startswith("LEAF json") or standin or ds.train_data_num != 1395:
        fail(f"real files: the loader read {ds.source!r} ({ds.train_data_num} train samples), "
             f"warnings {standin}; want the LEAF files' 1,395 samples and no stand-in")
    torch.cuda.empty_cache()
    return {"card": card, "source": ds.source, "clients": ds.client_num,
            **{k: out[k] for k in SLICE7_TIMES},
            "train_loss": out["train_loss"], "peak_memory_bytes": out["run"]["peak_bytes"],
            "kernel_launches": out["run"]["launches"]}


def run_fedprox_synthetic():
    """FedProx on synthetic(1, 1) through ``run_simulation``: 5 rounds;
    the federation's sizes are the generator's (80/20 a device, the
    packer's cap), and the loss falls."""
    from fedml_tpu_torch.data.synthetic import synthetic_fedprox

    out = slice7_run(FEDPROX_CONFIG, "fedprox synthetic")
    api, args, card = out["api"], out["args"], card_line()
    ds = api.dataset
    xs, _ = synthetic_fedprox(num_clients=int(args.client_num_in_total),
                              alpha=float(args.synthetic_alpha), beta=float(args.synthetic_beta),
                              input_dim=int(args.input_dim), num_classes=int(args.output_dim),
                              seed=int(args.random_seed))
    train = [max(1, int(0.8 * len(x))) for x in xs]
    cap = int(ds.packed_train.mask.shape[1]) * int(args.batch_size)
    want = [min(n, cap) for n in train]
    test = sum(len(x) - n for x, n in zip(xs, train))
    log(f"fedprox synthetic on {card}: {api.algorithm}, mu {args.fedprox_mu}, {len(xs)} devices "
        f"of {min(map(len, xs))}-{max(map(len, xs))} samples, {sum(train)} train ({sum(want)} "
        f"packed, cap {cap}) and {test} test samples")
    if (ds.packed_num_samples.astype(int).tolist() != want or ds.train_data_num != sum(want)
            or ds.test_data_num != test or not ds.source.startswith("FedProx")):
        fail(f"fedprox synthetic: the federation ({ds.source}) holds "
             f"{ds.packed_num_samples.tolist()} / {ds.train_data_num} / {ds.test_data_num}, the "
             f"generator gives {want} / {sum(want)} / {test}")
    torch.cuda.empty_cache()
    return {"card": card, "algorithm": api.algorithm, **{k: out[k] for k in SLICE7_TIMES},
            "train_loss": out["train_loss"],
            "client_sizes": want, "peak_memory_bytes": out["run"]["peak_bytes"],
            "kernel_launches": out["run"]["launches"]}


# -- the eighth slice: poisoned worlds, the robust planes and K3 ------------
POISONED_CONFIG = REPO / "fedml_tpu_torch" / "configs" / "fedavg_femnist_cnn_poisoned.yaml"
# each world through run_simulation for 3 rounds, evaluation after each;
# round 0 warms up, rounds 1-2 are timed (their training on the card's
# clock)
POISONED_ROUNDS, POISONED_TIMED = 3, (1, 2)
# the seven worlds run 2 rounds each (round 1 timed), the defenses 3
WORLD_ROUNDS, WORLD_TIMED = 2, (1, 1)
# world -> (overrides of the configuration, K3 launches a round, whether
# the clip must bite). The configuration's bound (5.0) clips no delta of
# the first rounds: the two biting worlds take a smoke setting, not a
# configuration change, as their norm_bound: the median of the
# norm_diff_clipping world's first-round delta norms, so about half the
# cohort clips there
POISONED_WORLDS = {
    "clean": (dict(poison_type=None, defense_type=None), 0, False),
    "undefended": (dict(defense_type=None), 0, False),
    "norm_diff_clipping": ({}, 1, False),
    "weak_dp": (dict(defense_type="weak_dp"), 1, False),
    "norm_diff_clipping biting": ({}, 1, True),
    "weak_dp stddev 0 biting": (dict(defense_type="weak_dp", stddev=0.0), 1, True),
    "median": (dict(defense_type="median"), 0, False),
}
# a clipped delta's norm, re-measured in float64 against the global
# model, may exceed the bound by 1e-6 relative (the f32 norm and scale)
# plus the f32 rounding of the clipped model's elements
CLIP_SLACK = 1e-6
# weak DP's noise: its sample standard deviation within 2% of stddev
NOISE_STD_RTOL = 0.02
# phase 20: 16 uploads of ResNet-18-GN (the dense configuration's model,
# 11,173,962 params), int8-encoded and clipped, folded on the card three
# ways: in order (buffered), shuffled (streamed) and through 4 edges
ROBUST_UPLOADS, ROBUST_EDGES = 16, 4
RESNET18_PARAMS = 11_173_962
# K3 against its plain version: every mode at both path shapes, the
# stacked clip's (32 clients of the CNN) and one upload of ResNet-18-GN,
# the operands laid out by the port's own producers; then one operand
# whose rows are off 16 bytes, which the wrapper copies onto them;
# (name, source, add_g, clipped, weighted)
K3_MODES = [
    ("clip stacked", "f32", True, True, False),
    ("clipped term", "f32", True, True, True),
    ("delta clipped", "f32", False, True, True),
    ("topk encoded", "f32", True, False, True),
    ("topk delta", "f32", False, False, True),
    ("topk encoded clipped", "f32", True, True, True),
    ("int8 encoded", "int8", True, False, True),
    ("int8 encoded clipped", "int8", True, True, True),
    ("int8 delta", "int8", False, False, True),
    ("int8 delta clipped", "int8", False, True, True),
]
K3_UNALIGNED = ("clip stacked, rows off 16 bytes (copied)", "f32", True, True, False)


def _path_shapes():
    """(CNN params, ResNet-18-GN's leaf sizes): the stacked clip's row and
    the streamed upload's leaves, read from the models."""
    from fedml_tpu_torch import models
    from fedml_tpu_torch.arguments import load_yaml_arguments

    cnn = load_yaml_arguments(str(POISONED_CONFIG))
    dense = load_yaml_arguments(str(DENSE_CONFIG))
    n_cnn = sum(p.numel() for p in models.create(cnn, 62, device="cpu").module.parameters())
    sizes = [p.numel() for p in models.create(dense, 10, device="cpu").module.parameters()]
    if sum(sizes) != RESNET18_PARAMS:
        fail(f"ResNet-18-GN holds {sum(sizes)} params, not {RESNET18_PARAMS}")
    return int(n_cnn), sizes


def cnn_leaf_sizes():
    """The cross-silo configuration's CNN, leaf by leaf."""
    from fedml_tpu_torch import models
    from fedml_tpu_torch.arguments import load_yaml_arguments

    args = load_yaml_arguments(str(CROSS_SILO_CONFIG))
    sizes = [p.numel() for p in models.create(args, 62, device="cpu").module.parameters()]
    if sum(sizes) != CROSS_SILO_CNN_PARAMS:
        fail(f"the cross-silo CNN holds {sum(sizes)} params, not {CROSS_SILO_CNN_PARAMS}")
    return sizes


def _k3_operands(R, sizes, gen):
    """K3's operands at a path shape, laid out by the port's own
    producers: the global model flat (``_FlatSpec.flatten``); the deltas
    of a cohort of R > 1 as the stacked clip lays them out
    (``flatten_stacked`` with ``minus``), of one upload as the clipped
    terms do (one flat row); int8 payloads by ``_payload`` for one upload,
    in ``aligned_rows`` as it lays them for a cohort; leaf scales, clip
    scales and weights random."""
    from fedml_tpu_torch.core.aggregation import _FlatSpec, _payload
    from fedml_tpu_torch.core.compression import Int8Codec
    from fedml_tpu_torch.ops.robust_term import aligned_rows

    names = [f"l{i}" for i in range(len(sizes))]
    g = {k: torch.randn(n, generator=gen, device=DEVICE) for k, n in zip(names, sizes)}
    spec = _FlatSpec(g)
    gf = spec.flatten(g)
    theta = {k: torch.randn(R, n, generator=gen, device=DEVICE) for k, n in zip(names, sizes)}
    if R > 1:
        delta = spec.flatten_stacked(theta, minus=gf)
        q = aligned_rows(R, spec.numel, torch.int8, DEVICE)
        q.copy_(torch.randint(-127, 128, (R, spec.numel), generator=gen, device=DEVICE))
        sc = torch.rand(R, len(sizes), generator=gen, device=DEVICE) * 1e-3
    else:
        delta = (spec.flatten({k: v[0] for k, v in theta.items()}) - gf)[None]
        q, sc = _payload(spec, Int8Codec(), Int8Codec().encode({k: v[0] for k, v in theta.items()}))
    s = torch.rand(R, generator=gen, device=DEVICE)
    w = torch.rand(R, generator=gen, device=DEVICE) * 100
    return delta, gf, q, spec.leaf_offsets(DEVICE), sc, s, w


def check_robust_term():
    """K3 against its plain version, bitwise, for every mode of K3_MODES at
    both path shapes, the operands laid out as the main path lays them
    (each must reach the kernel uncopied), and for one operand off 16
    bytes (copied by the wrapper); each repeats bitwise; timed by events
    through the wrapper and, at the two main-path modes, by the
    profiler's device time; against its bytes bound. Returns the kernel's
    ``kernels`` entry (main numbers from the stacked clip, the training
    path's launch)."""
    from fedml_tpu_torch.ops import robust_term as rt

    n_cnn, resnet = _path_shapes()
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    cases = []
    # the cross-silo path's one: an int8, clipped upload of the CNN, one
    # scale a leaf
    for R, sizes, only in ((32, [n_cnn], None), (1, resnet, None),
                           (1, cnn_leaf_sizes(), "int8 encoded clipped")):
        n = sum(sizes)
        delta, g, q, off, sc, s, w = _k3_operands(R, sizes, gen)
        modes = K3_MODES + ([K3_UNALIGNED] if R > 1 else [])
        if only is not None:
            modes = [m for m in modes if m[0] == only]
        for name, src, base, clipped, weighted in modes:
            kw = dict(g=g if base else None, add_g=base, s=s if clipped else None,
                      w=w if weighted else None)
            if src == "int8":
                kw.update(leaf_scales=sc, leaf_offsets=off)
            x = q if src == "int8" else delta
            label = f"robust term {name} [{R}, {n}]"
            if name == K3_UNALIGNED[0]:
                x = x.contiguous()  # rows n * 4 bytes apart, n = 2 mod 4
                if rt._on_16_bytes(x) is x:
                    fail(f"{label}: the operand is on 16 bytes; the case tests the copy")
            elif any(rt._on_16_bytes(v) is not v for v in (x, g)):
                fail(f"{label}: the path's operand is off 16 bytes and would be copied")
            got, want, again = rt.TERM_KERNEL(x, **kw), rt.robust_term_reference(x, **kw), \
                rt.TERM_KERNEL(x, **kw)
            torch.cuda.synchronize()
            if not bits_equal(got, want):
                fail(f"{label}: the kernel differs from its plain version "
                     f"(max {float((got - want).abs().max())})")
            if not bits_equal(got, again):
                fail(f"{label}: two launches differ")
            nbytes = R * n * (1 if src == "int8" else 4) + R * n * 4 + (n * 4 if base else 0)
            nbytes += (R * 4 if clipped else 0) + (R * 4 if weighted else 0)
            nbytes += (R * len(sizes) * 4 + (len(sizes) + 1) * 8) if src == "int8" else 0
            ops = R * n * (int(base) + int(clipped) + int(weighted) + int(src == "int8"))
            iters = _timing_iters(nbytes)
            ms = cuda_time_ms(lambda: rt.TERM_KERNEL(x, **kw), iters)
            main = (R == 32 and name == "clip stacked") or (R == 1 and name == "int8 encoded clipped")
            device_ms = (kernel_device_ms(lambda: rt.TERM_KERNEL(x, **kw), "robust_term_kernel",
                                         iters) if main else None)
            plain_ms = cuda_time_ms(lambda: rt.robust_term_reference(x, **kw), max(2, iters // 10))
            bound_ms, bound_by = bytes_bound(nbytes, ops)
            log(f"{label}: bitwise its plain version and repeatable; kernel {ms:.4f} ms by events"
                + (f" ({device_ms:.4f} ms device time)" if device_ms else "")
                + f", bound {bound_ms:.6f} ms ({bound_by}, {nbytes / 1e6:.3f} MB), "
                f"{bound_ms / ms:.1%} of it; plain {plain_ms:.4f} ms; library: none (no PyTorch "
                f"call clips and weights without contracting)")
            cases.append({"mode": name, "shape": [R, n], "dtype": "float32" if src == "f32" else
                          "int8", "max_abs_err": 0.0, "bitwise": True, "repeats_bitwise": True,
                          "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "bound_route": "f32 (no tensor cores)", "share_of_bound": bound_ms / ms,
                          "library_ms": None, "library_kernel": None})
        del delta, g, q, off, sc, s, w
        torch.cuda.empty_cache()
    log(f"robust term launches while checking (not counted): {rt.TERM_KERNEL.launches}")
    main = cases[0]
    return {**kernel_entry(main, name=rt.TERM_KERNEL.name, route="cuda",
                           source="fedml_tpu_torch/ops/csrc/robust_term.cu",
                           replaces="fedml_tpu/core/aggregation.py:709",
                           kind="not a TPU kernel (XLA-generated in the reference: "
                                "clip_updates :709-720 and the terms :281-406)"),
            "device_ms": main["device_ms"], "cases": cases}


@contextlib.contextmanager
def robust_records():
    """Wraps ``RobustAggregator``'s clip, noise and median for the block:
    each clip's pre-clip and post-clip delta norms, whether the clip is
    bitwise K3's plain version on the same flat deltas, global model and
    clip scales, each noise draw's sample mean and standard deviation, and
    whether each median equals the plain sort midpoint (``kthvalue`` of
    the two middle ranks, ``(lo + hi) * 0.5``) bitwise. The aggregation
    itself is untouched."""
    from fedml_tpu_torch.core.aggregation import (RobustAggregator, _clip_scale, _FlatSpec,
                                                  _stacked_norms)
    from fedml_tpu_torch.ops.robust_term import robust_term_reference

    rec = {"norms_before": [], "norms_after": [], "rounding": [], "noise": [],
           "median_bitwise": [], "clip_bitwise": []}
    clip, noise, median = (RobustAggregator.clip_updates, RobustAggregator.add_noise,
                           RobustAggregator.coordinate_median)

    def clip_rec(self, stacked, g):
        out = clip(self, stacked, g)
        spec = _FlatSpec(g)
        gf = spec.flatten(g)
        # in float64 from the f32 values (an f32 norm of 428,350 elements
        # is itself ~1e-6 off); the clipped model g + delta is f32, whose
        # rounding moves the re-measured delta by at most the norm of half
        # an ulp of each element (the triangle inequality): the slack
        g64, after = gf.double(), spec.flatten_stacked(out)
        # the clip again through the plain version, from the same deltas
        delta = spec.flatten_stacked(stacked, minus=gf)
        plain = robust_term_reference(delta, gf, add_g=True,
                                      s=_clip_scale(_stacked_norms(delta), self.norm_bound))
        rec["clip_bitwise"].append(bits_equal(after, plain))
        mag = after.abs()
        ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
        rec["norms_before"].append(
            (spec.flatten_stacked(stacked).double() - g64).norm(dim=1).tolist())
        rec["norms_after"].append((after.double() - g64).norm(dim=1).tolist())
        rec["rounding"].append((ulp.double() * 0.5).norm(dim=1).tolist())
        return out

    def noise_rec(self, params, generator):
        # the noise drawn, redrawn from a copy of the generator's state
        # (the aggregate it lands on may already be inf or NaN)
        again = torch.Generator(device=generator.device)
        again.set_state(generator.get_state())
        out = noise(self, params, generator)
        draws = torch.cat([self.stddev * torch.randn(v.shape, generator=again,
                                                     device=v.device, dtype=v.dtype).reshape(-1)
                           for v in params.values()])
        rec["noise"].append((float(draws.mean()), float(draws.std())))
        return out

    def median_rec(stacked):
        out = median(stacked)
        same = True
        for k, v in stacked.items():
            c = v.shape[0]
            lo = torch.kthvalue(v, (c - 1) // 2 + 1, dim=0).values
            hi = torch.kthvalue(v, c // 2 + 1, dim=0).values
            same &= bits_equal(out[k], (lo + hi) * 0.5)
        rec["median_bitwise"].append(same)
        return out

    RobustAggregator.clip_updates = clip_rec
    RobustAggregator.add_noise = noise_rec
    RobustAggregator.coordinate_median = staticmethod(median_rec)
    try:
        yield rec
    finally:
        RobustAggregator.clip_updates, RobustAggregator.add_noise = clip, noise
        RobustAggregator.coordinate_median = staticmethod(median)


def backdoor_rate_and_accuracy(api) -> tuple:
    """The backdoor success rate of the API's global model on its clean
    test examples (``backdoor_attack_success_rate``: the non-target ones,
    the trigger stamped) and its accuracy on them unstamped."""
    from fedml_tpu_torch.data.poison import backdoor_attack_success_rate

    test = api.dataset.test_data_global
    keep = test.mask.reshape(-1) > 0
    x = test.x.reshape((-1,) + tuple(test.x.shape[2:]))[keep].float().cpu().numpy()
    y = test.y.reshape(-1)[keep].cpu().numpy()

    def predict(batch):
        with torch.no_grad():
            logits = api.model.apply(api.global_params, torch.as_tensor(batch, device=DEVICE))
        return logits.argmax(-1).cpu().numpy()

    rate = backdoor_attack_success_rate(predict, x, y, int(api.args.target_label))
    return rate, float((predict(x) == y).mean())


def poisoned_run(tag: str, rounds: int = POISONED_ROUNDS, timed=POISONED_TIMED,
                 **knobs) -> dict:
    """The poisoned configuration (with ``knobs``) through ``run_simulation``
    for ``rounds`` rounds, its robust aggregator recorded: the run,
    the API, the records, rounds/s of the timed rounds' training on the
    card's clock, the backdoor rate and clean accuracy."""
    from fedml_tpu_torch.arguments import load_yaml_arguments

    args = load_yaml_arguments(str(POISONED_CONFIG))
    args.comm_round, args.frequency_of_the_test = rounds, 1
    for knob, value in knobs.items():
        setattr(args, knob, value)
    args._validate()
    with simulated_api() as held, robust_records() as rec:
        run = measured_run(args)
    api = held[-1]
    first, last = timed
    # each timed round's training on the card's clock (the round pipeline's
    # span; the synchronous loop of S-FedAvg: round start to its training
    # and Shapley scoring done on the card)
    spans = [r["train_time_s"] for r in run["records"] if first <= r["round"] <= last]
    finite = all(bool(torch.isfinite(v).all()) for v in api.global_params.values())
    # a model gone inf or NaN predicts class 0 everywhere: no rates then
    rate, acc = backdoor_rate_and_accuracy(api) if finite else (None, None)
    losses = [r["train_loss"] for r in run["records"]]
    if not all(np.isfinite(losses)) and not knobs.get("defense_type") == "weak_dp":
        fail(f"{tag}: train loss not finite: {losses}")
    return {"run": run, "api": api, "rec": rec, "losses": losses,
            "rounds_per_s": len(spans) / sum(spans) if spans else float("nan"),
            "backdoor_rate": rate, "clean_acc": acc}


def run_poisoned_worlds():
    """Phase 18: the poisoned FEMNIST world through ``run_simulation``,
    clean, undefended, clipped, with weak DP (stddev 0.158), clipped and
    with weak DP at stddev 0 at a bound that bites (the median of the clip
    world's first-round delta norms), and with the median, WORLD_ROUNDS
    rounds each.
    K3 launches once a round in the clip and weak-DP worlds and never in
    the others; every clip is bitwise K3's plain version; some delta clips
    in each biting world; every clipped delta's norm is within the bound;
    weak DP at stddev 0 is the biting clip world bitwise,
    and at 0.158 its noise's sample std is within 2% of it; the median is
    the plain sort midpoint bitwise. Rounds/s, peak memory, the backdoor
    success rate, clean test accuracy and the share of clients clipped are
    reported, not gated (so few rounds show no reliable defense effect). At
    stddev 0.158 the noise on every parameter swamps the CNN (its weights
    are ~0.02-0.05): the loss leaves the finite range, as the reference's
    formula does; that world's loss is not gated, its noise is."""
    from fedml_tpu_torch.ops.robust_term import TERM_KERNEL

    card = card_line()
    out, params, bite_bound = {}, {}, None
    for world, (knobs, per_round, bite) in POISONED_WORLDS.items():
        if bite:
            knobs = {**knobs, "norm_bound": bite_bound}
        r = poisoned_run(world, WORLD_ROUNDS, WORLD_TIMED, **knobs)
        api, rec, launches = r["api"], r["rec"], r["run"]["launches"]
        bound = float(api.args.norm_bound)
        if world == "norm_diff_clipping":
            bite_bound = float(np.median(rec["norms_before"][0]))
        clipped = [n > bound for rnd in rec["norms_before"] for n in rnd]
        share = sum(clipped) / len(clipped) if clipped else None
        log(f"poisoned world {world} on {card}: {api.algorithm}, defense "
            f"{api.args.defense_type}, poison {api.args.poison_type}: rounds {WORLD_TIMED} "
            f"{r['rounds_per_s']:.4f} rounds/s on the card's clock; peak memory "
            f"{r['run']['peak_bytes'] / 2**20:.1f} MiB; train loss {r['losses']}; test acc "
            f"{[round(h['test_acc'], 4) for h in r['run']['records']]}; backdoor success rate "
            f"{r['backdoor_rate']}; clean test accuracy {r['clean_acc']}; norm bound {bound}; "
            f"clients clipped {share}; clip bitwise K3's plain version {rec['clip_bitwise']}; "
            f"K3 launches {launches[TERM_KERNEL.name]}")
        if launches[TERM_KERNEL.name] != per_round * WORLD_ROUNDS:
            fail(f"poisoned world {world}: K3 launched {launches[TERM_KERNEL.name]} times, "
                 f"want {per_round} a round")
        if not all(rec["clip_bitwise"]):
            fail(f"poisoned world {world}: a clip differs from K3's plain version "
                 f"{rec['clip_bitwise']}")
        if bite and not share:
            fail(f"poisoned world {world}: no delta clipped at the bound {bound}")
        over = [(n, e) for rnd, ends in zip(rec["norms_after"], rec["rounding"])
                for n, e in zip(rnd, ends) if n > bound * (1 + CLIP_SLACK) + e]
        if over:
            fail(f"poisoned world {world}: clipped deltas' norms {over} (norm, the f32 model's "
                 f"rounding) exceed {bound}")
        if rec["median_bitwise"] and not all(rec["median_bitwise"]):
            fail(f"poisoned world {world}: the median differs from the plain sort midpoint")
        if world == "median" and len(rec["median_bitwise"]) != WORLD_ROUNDS:
            fail(f"poisoned world median: {len(rec['median_bitwise'])} medians in "
                 f"{WORLD_ROUNDS} rounds")
        stds = [sd for _, sd in rec["noise"]]
        if world == "weak_dp" and (len(stds) != WORLD_ROUNDS or not all(
                abs(sd / float(api.args.stddev) - 1) <= NOISE_STD_RTOL for sd in stds)):
            fail(f"poisoned world weak_dp: noise std {stds}, want {api.args.stddev} within "
                 f"{NOISE_STD_RTOL:.0%}")
        params[world] = {k: v.detach().clone() for k, v in api.global_params.items()}
        out[world] = {"rounds_per_s": r["rounds_per_s"], "peak_memory_bytes": r["run"]["peak_bytes"],
                      "train_loss": r["losses"], "backdoor_success_rate": r["backdoor_rate"],
                      "clean_test_accuracy": r["clean_acc"], "norm_bound": bound,
                      "clipped_share": share, "clip_bitwise": rec["clip_bitwise"],
                      "noise_mean_std": rec["noise"], "kernel_launches": launches}
        del r, api
        torch.cuda.empty_cache()
    same = all(bits_equal(params["weak_dp stddev 0 biting"][k],
                          params["norm_diff_clipping biting"][k])
               for k in params["norm_diff_clipping biting"])
    log(f"poisoned worlds: weak_dp at stddev 0 bitwise the clip world, both at the bound "
        f"{bite_bound}: {same}")
    if not same:
        fail("weak_dp at stddev 0 differs from the clip world")
    launches = {name: sum(w["kernel_launches"][name] for w in out.values())
                for name in out["clean"]["kernel_launches"]}
    return {"card": card, "worlds": out, "weak_dp_zero_bitwise_clip": same,
            "kernel_launches": launches}


def run_defenses():
    """Phase 19: S-FedAvg and HS-FedAvg on the poisoned world, 3 rounds
    each through ``run_simulation``. S-FedAvg's permutations a round and
    the attackers' ``sv`` / ``phi`` against the honest clients' are
    printed; a run stopped after round 1 and resumed is bitwise the
    straight run, ``phi`` and ``sv`` included (deterministic algorithms).
    HS-FedAvg's running amplitude is finite and its loss falls."""
    import tempfile

    from fedml_tpu_torch.data.loader import _resolve_poisoned_idxs

    card = card_line()
    reset_launches()
    out = {}
    with deterministic():
        s = poisoned_run("SFedAvg", federated_optimizer="SFedAvg", defense_type=None)
        api = s["api"]
        attackers = _resolve_poisoned_idxs(api.args, api.dataset.client_num,
                                           int(api.args.random_seed))
        honest = [i for i in range(api.dataset.client_num) if i not in attackers]
        log(f"SFedAvg on {card}: permutations a round "
            f"{[h['perms'] for h in api.sv_history]}; attackers {attackers}: sv mean "
            f"{api.sv[attackers].mean():.6f}, phi mean {api.phi[attackers].mean():.6f}; honest: "
            f"sv mean {api.sv[honest].mean():.6f}, phi mean {api.phi[honest].mean():.6f}; "
            f"backdoor success rate {s['backdoor_rate']}, clean accuracy "
            f"{s['clean_acc']}; {s['rounds_per_s']:.4f} rounds/s")
        straight = ({k: v.clone() for k, v in api.global_params.items()}, api.phi.copy(),
                    api.sv.copy())
        out["SFedAvg"] = {"perms_by_round": [h["perms"] for h in api.sv_history],
                          "attackers": attackers,
                          "sv_attackers": float(api.sv[attackers].mean()),
                          "sv_honest": float(api.sv[honest].mean()),
                          "phi_attackers": float(api.phi[attackers].mean()),
                          "phi_honest": float(api.phi[honest].mean()),
                          "backdoor_success_rate": s["backdoor_rate"],
                          "clean_test_accuracy": s["clean_acc"], "rounds_per_s": s["rounds_per_s"],
                          "train_loss": s["losses"]}
        del s, api
        with tempfile.TemporaryDirectory(prefix="sfedavg_resume_") as ckdir:
            knobs = dict(federated_optimizer="SFedAvg", defense_type=None, checkpoint_dir=ckdir,
                         checkpoint_freq=1)
            poisoned_run("SFedAvg stopped", comm_round=2, **knobs)
            resumed = poisoned_run("SFedAvg resumed", **knobs)["api"]
    unequal = [k for k in straight[0] if not bits_equal(resumed.global_params[k], straight[0][k])]
    same_rep = np.array_equal(resumed.phi, straight[1]) and np.array_equal(resumed.sv, straight[2])
    log(f"SFedAvg resume: stopped after round 1, resumed to round {POISONED_ROUNDS - 1}: params "
        f"differing bitwise {len(unequal)} of {len(straight[0])}; phi and sv bitwise: {same_rep}")
    if unequal or not same_rep:
        fail(f"SFedAvg resume: params {unequal} or the reputation differ from the straight run")
    out["SFedAvg"]["resume_bitwise"] = True
    h = poisoned_run("HSFedAvg", federated_optimizer="HSFedAvg")
    amp = h["api"].server_state
    log(f"HSFedAvg on {card}: running amplitude {tuple(amp.shape)}, finite "
        f"{bool(torch.isfinite(amp).all())}, max {float(amp.max()):.4f}; train loss {h['losses']}; "
        f"backdoor success rate {h['backdoor_rate']}, clean accuracy {h['clean_acc']}; "
        f"{h['rounds_per_s']:.4f} rounds/s")
    if not bool(torch.isfinite(amp).all()) or not float(amp.abs().sum()) > 0:
        fail("HSFedAvg: the running amplitude is not finite and set")
    if not h["losses"][-1] < h["losses"][0]:
        fail(f"HSFedAvg: the train loss did not fall: {h['losses']}")
    out["HSFedAvg"] = {"train_loss": h["losses"], "amplitude_max": float(amp.max()),
                       "backdoor_success_rate": h["backdoor_rate"],
                       "clean_test_accuracy": h["clean_acc"], "rounds_per_s": h["rounds_per_s"]}
    del h, amp, resumed
    torch.cuda.empty_cache()
    return {"card": card, **out, "kernel_launches": launch_counts()}


def run_robust_folds():
    """Phase 20: 16 int8-encoded uploads of ResNet-18-GN's width
    (11,173,962 params, its leaves), half with deltas far over the bound,
    folded on the card in order (buffered), in a shuffled order (streamed)
    and through a 4-edge tree: the three finalize to identical bits, for
    every encoded, clipped and delta fold and the raw clipped one. K3
    launches once a fold."""
    from fedml_tpu_torch.core.aggregation import StreamingAccumulator
    from fedml_tpu_torch.core.compression import Int8Codec, TopKCodec
    from fedml_tpu_torch.ops.robust_term import TERM_KERNEL
    from fedml_tpu_torch.scale import EdgeAggregationTree

    card = card_line()
    _, sizes = _path_shapes()
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    names = [f"l{i}" for i in range(len(sizes))]
    g = {k: torch.randn(n, generator=gen, device=DEVICE) * 0.05 for k, n in zip(names, sizes)}
    bound = 5.0
    scales = [0.0005 if i % 2 else 0.005 for i in range(ROBUST_UPLOADS)]
    deltas = [{k: torch.randn(v.shape, generator=gen, device=DEVICE) * sc for k, v in g.items()}
              for sc in scales]
    weights = [float(w) for w in np.random.RandomState(5).randint(100, 700, ROBUST_UPLOADS)]
    order = np.random.RandomState(6).permutation(ROBUST_UPLOADS)
    int8, topk = Int8Codec(), TopKCodec(0.01)
    folds = {
        "int8 encoded clipped": lambda a, i: a.fold_encoded_clipped(int8, enc8[i], g, bound, weights[i]),
        "int8 encoded": lambda a, i: a.fold_encoded(int8, enc8[i], g, weights[i]),
        "int8 delta clipped": lambda a, i: a.fold_encoded_delta_clipped(int8, enc8[i], g, bound, weights[i]),
        "topk encoded clipped": lambda a, i: a.fold_encoded_clipped(topk, enck[i], g, bound, weights[i]),
        "raw clipped": lambda a, i: a.fold_clipped(thetas[i], g, bound, weights[i]),
        "delta clipped": lambda a, i: a.fold_delta_clipped(deltas[i], bound, weights[i]),
    }
    enc8 = [int8.encode(d) for d in deltas]
    enck = [topk.encode(d) for d in deltas]
    thetas = [{k: g[k] + d[k] for k in g} for d in deltas]
    norms = [float(torch.cat([v.reshape(-1) for v in d.values()]).norm()) for d in deltas]
    reset_launches()
    out = {}
    t0 = time.perf_counter()
    for name, fold in folds.items():
        buffered = StreamingAccumulator(g)
        for i in range(ROBUST_UPLOADS):
            fold(buffered, i)
        stream = StreamingAccumulator(g)
        for i in order:
            fold(stream, int(i))
        tree = EdgeAggregationTree(g, ROBUST_EDGES)
        for i in order:
            fold(tree.acc_for(int(i)), int(i))
        want, got_s, got_t = buffered.finalize(), stream.finalize(), tree.finalize()
        same = all(bits_equal(got_s[k], want[k]) and bits_equal(got_t[k], want[k]) for k in g)
        log(f"robust folds {name} at {RESNET18_PARAMS} params ({len(sizes)} leaves), "
            f"{ROBUST_UPLOADS} uploads: buffered == streamed == {ROBUST_EDGES}-edge tree "
            f"bitwise: {same}")
        if not same:
            fail(f"robust folds {name}: the streamed or tree fold differs from the buffered one")
        out[name] = {"bitwise": True}
        del buffered, stream, tree, want, got_s, got_t
    torch.cuda.synchronize()
    launches = launch_counts()
    want_k3 = 3 * ROBUST_UPLOADS * len(folds)
    log(f"robust folds on {card}: {time.perf_counter() - t0:.1f} s; delta norms "
        f"{min(norms):.3f}-{max(norms):.3f} against the bound {bound}; launches {launches}")
    if launches[TERM_KERNEL.name] != want_k3:
        fail(f"robust folds: K3 launched {launches[TERM_KERNEL.name]} times, want {want_k3}")
    del enc8, enck, thetas, deltas, g
    torch.cuda.empty_cache()
    return {"card": card, "folds": out, "uploads": ROBUST_UPLOADS, "edges": ROBUST_EDGES,
            "params": RESNET18_PARAMS, "delta_norms": [min(norms), max(norms)],
            "kernel_launches": launches}


# -- the ninth slice: the other simulation algorithms ----------------------

A8_CONFIGS = REPO / "fedml_tpu_torch" / "configs"
# (path, config, overrides): each through run_simulation on the card
# SplitNN and FedGKT train every client's data each round: on half of
# the CIFAR-10 stand-in's default 20,000 / 4,000 examples, so that the
# script stays inside its time limit
A8_HALF_CIFAR = {"synthetic_train_size": 10000, "synthetic_test_size": 2000}
A8_PATHS = (
    ("HierFedAvg", "hierfedavg_femnist_cnn.yaml", {}),
    ("DSGD", "dsgd_femnist_cnn.yaml", {}),
    ("PushSum", "dsgd_femnist_cnn.yaml", {"federated_optimizer": "PushSum"}),
    ("TurboAggregate", "turboaggregate_femnist_cnn.yaml", {}),
    ("FedGAN", "fedgan_mnist.yaml", {}),
    ("FedNAS", "fednas_cifar10_darts.yaml", {}),
    ("FedSeg", "fedseg_pascal_voc_deeplab.yaml", {}),
    ("SplitNN", "splitnn_cifar10.yaml", A8_HALF_CIFAR),
    ("FedGKT", "fedgkt_cifar10.yaml", A8_HALF_CIFAR),
    ("VFL", "vfl_mnist_leaf.yaml", {"data_cache_dir": str(REPO / "fedml_data")}),
)
# round 0 (run_simulation, data and init included) warms up; round 1
# is timed on the card's clock; round 2 runs under torch.profiler (cut
# from rounds 1-3 and 4 to keep the script inside its time limit)
A8_TIMED, A8_PROFILED = (1, 1), 2
A8_KINDS = KERNEL_KINDS + (("transposed conv", ("conv_transpose", "col2im", "im2col")),)
HIER_FLAT_ATOL = 1e-5
MASS_RTOL = 1e-5
BOUNDARY_ATOL = 1e-5
KL_EQUAL_ATOL = 1e-7  # |KL| of equal logits in f32


def profiled_call(fn):
    """``fn()`` under ``torch.profiler``: its result and a summary in
    ``core/tracing.py``'s form (wall, device busy, kernels by name)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the card's activity only: a round's host events would be millions
    activity = ProfilerActivity.CUDA if DEVICE == "cuda" else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, kineto_summary(prof, time.perf_counter() - t0)


def kineto_summary(prof, wall: float) -> dict:
    """A finished profiler's device events in ``core/tracing.py``'s
    summary form (wall, device busy, kernels by name)."""
    from torch.autograd import DeviceType

    from fedml_tpu_torch.core.tracing import _union_us

    by_name, counts, spans, end_ns = {}, {}, [], 0
    # the raw records: prof.events() builds a Python object tree, ~30 s
    # for 500,000 events
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            name, start = e.name(), e.start_ns() / 1e3
            by_name[name] = by_name.get(name, 0.0) + e.duration_ns() / 1e9
            counts[name] = counts.get(name, 0) + 1
            spans.append((start, start + e.duration_ns() / 1e3))
            end_ns = max(end_ns, e.start_ns() + e.duration_ns())
    return {"wall_s": wall, "device_busy_s": _union_us(spans) / 1e6, "device_end_ns": end_ns,
            "device_kernel_s": sum(by_name.values()), "device_launches": len(spans),
            "device_s_by_kernel": dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
            "device_launches_by_kernel": counts}


def round_samples(api, round_idx: int) -> float:
    """Real training examples one round of ``api`` passes over: every
    local epoch of every client it trains (every group round of
    HierFedAvg's)."""
    from fedml_tpu_torch.simulation.fedavg_api import deterministic_client_sampling

    ns = np.asarray(api.dataset.packed_num_samples, dtype=np.float64)
    epochs = int(api.args.epochs)
    if api.algorithm == "VFL":
        return float(api._train[2].sum()) * epochs
    if api.algorithm == "HierFedAvg":
        return float(ns.sum()) * epochs * int(api.args.group_comm_round)
    if api.algorithm in ("DSGD", "PushSum", "SplitNN", "FedGKT"):
        return float(ns.sum()) * epochs
    idx = deterministic_client_sampling(round_idx, api.dataset.client_num,
                                        int(api.args.client_num_per_round))
    return float(ns[idx].sum()) * epochs


def a8_losses(tag: str, sums: list) -> list:
    key = "d_loss" if tag == "FedGAN" else "loss_sum"
    den = "n" if tag == "FedGAN" else "count"
    return [s[key] / max(s[den], 1.0) for s in sums]


def a8_stats(api, round_idx: int, summed) -> dict:
    """The algorithm's own record of a round (evaluation included)."""
    if hasattr(api, "round_stats"):
        return api.round_stats(round_idx, summed)
    return api._local_test_on_all_clients(round_idx)


def a8_run(tag: str, config: str, overrides: dict) -> dict:
    """One path: round 0 through ``run_simulation`` (data, init, the
    first round and its evaluation), rounds A8_TIMED timed on the
    card's clock, round A8_PROFILED profiled, then the algorithm's
    record."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_yaml_arguments
    from fedml_tpu_torch.simulation.round_loop import host_sums

    args = load_yaml_arguments(str(A8_CONFIGS / config))
    for knob, value in dict(overrides, comm_round=1, frequency_of_the_test=1).items():
        setattr(args, knob, value)
    args._validate()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_bytes = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    with simulated_api() as held:
        first = fedml_tpu_torch.run_simulation(device=DEVICE, args=args)
    api = held[-1]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    spans, sums = [], []
    for r in range(A8_TIMED[0], A8_TIMED[1] + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        summed = api.run_round(r)
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end) / 1e3)
        sums.append(host_sums(summed))
    t_timed = time.perf_counter()
    summed, summary = profiled_call(lambda: api.run_round(A8_PROFILED))
    t_prof = time.perf_counter()
    stats = a8_stats(api, A8_PROFILED, summed)
    t_stats = time.perf_counter()
    sums.append(host_sums(summed))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held_bytes
    launches = launch_counts()
    card = card_line()
    per_round = [1.0 / s for s in spans]
    rounds_per_s = len(spans) / sum(spans)
    samples = [round_samples(api, r) for r in range(A8_TIMED[0], A8_TIMED[1] + 1)]
    samples_per_s = sum(samples) / sum(spans)
    losses = a8_losses(tag, sums)
    profile = profile_summary(f"{tag} profile of round {A8_PROFILED} (training only) on {card}",
                              summary, A8_KINDS)
    unit = "nodes" if tag in ("DSGD", "PushSum") else "real examples"
    rate = (api.dataset.client_num * rounds_per_s if unit == "nodes" else samples_per_s)
    log(f"{tag}: host wall: round 0 {warm_s:.1f} s, timed rounds "
        f"{t_timed - t0 - warm_s:.1f} s, profiled round {t_prof - t_timed:.1f} s, record "
        f"{t_stats - t_prof:.1f} s")
    log(f"{tag} on {card}: {args.dataset} ({api.dataset.source or 'loaded'}), "
        f"{api.dataset.client_num} clients: rounds {A8_TIMED[0]}-{A8_TIMED[1]} on the card's "
        f"clock {to_spread(rounds_per_s, per_round)} rounds/s (a round "
        f"{to_spread(min(per_round), per_round)}-{to_spread(max(per_round), per_round)}), "
        f"{rate:.1f} {unit}/s ({samples[0]:.0f} real examples a round); peak memory "
        f"{peak / 2**20:.1f} MiB; round 0 through run_simulation {warm_s:.1f} s (data and init "
        f"included); train loss by round {[round(v, 4) for v in losses]}; round "
        f"{A8_PROFILED} record {stats}; hand-written launches {launches}")
    if any(launches.values()):
        fail(f"{tag}: hand-written kernels launched on a path that has none: {launches}")
    if not all(np.isfinite(losses)):
        fail(f"{tag}: a round's training loss is not finite: {losses}")
    # the training loss after round 0 and after round 4; FedGKT's from
    # round 1 (its clients' KD term is off in round 0), FedNAS's in
    # fednas_local_search_gain, FedGAN's has nothing to fall to
    if tag == "FedGKT":
        fell, seen = losses[-1] < losses[0], (losses[0], losses[-1])
    else:
        fell, seen = stats.get("train_loss", 0) < first.get("train_loss", 0), (
            first.get("train_loss"), stats.get("train_loss"))
    if tag not in ("FedGAN", "FedNAS") and not fell:
        fail(f"{tag}: the train loss did not fall by round {A8_PROFILED}: {seen}")
    return {"api": api, "args": args, "first": first, "stats": stats,
            "numbers": {"card": card, "rounds_per_s": rounds_per_s,
                        "rounds_per_s_by_round": per_round, "timed_rounds_s": sum(spans),
                        f"{unit.replace(' ', '_')}_per_s": rate,
                        "real_examples_per_s": samples_per_s,
                        "real_examples_a_round": samples[0], "peak_memory_bytes": peak,
                        "round0_through_run_simulation_s": warm_s, "train_loss": losses,
                        "stats": {k: v for k, v in stats.items() if k != "round_time_s"},
                        "profile": {"round": A8_PROFILED, **profile},
                        "kernel_launches": launches}}


def hier_one_group_is_flat() -> float:
    """HierFedAvg with one group and one group round against a FedAvg
    round over the same 32 clients from the same init (shuffle off, so
    both see the same batches): the largest parameter difference."""
    import fedml_tpu_torch
    from fedml_tpu_torch import data, models
    from fedml_tpu_torch.arguments import load_yaml_arguments
    from fedml_tpu_torch.simulation import FedAvgAPI, HierarchicalFLAPI

    out = []
    for alg, extra in (("HierFedAvg", {"group_num": 1, "group_comm_round": 1}), ("FedAvg", {})):
        args = load_yaml_arguments(str(A8_CONFIGS / "hierfedavg_femnist_cnn.yaml"))
        for knob, value in dict(extra, federated_optimizer=alg, shuffle=False).items():
            setattr(args, knob, value)
        args._validate()
        fedml_tpu_torch.init(args)
        ds = data.load(args, device=DEVICE)
        cls = HierarchicalFLAPI if alg == "HierFedAvg" else FedAvgAPI
        api = cls(args, DEVICE, ds, models.create(args, ds.class_num, device=DEVICE))
        api.run_round(0)
        out.append(api.global_params)
    return max(float((out[0][k] - out[1][k]).abs().max()) for k in out[1])


def fednas_local_search_gain(api, round_idx: int) -> tuple:
    """FedNAS's loss gate. Its global model's test loss need not fall in
    a few rounds of 4 hetero clients (the cells end in a global mean,
    which hardly reads the stand-in's per-pixel class template, and each
    client first fits its own label skew), so the gate is the search
    itself: the round's cohort, on its training halves, before the round
    (the global model) and during it (the local searches' mean loss)."""
    from fedml_tpu_torch.core.types import Batches
    from fedml_tpu_torch.simulation.fedavg_api import deterministic_client_sampling
    from fedml_tpu_torch.simulation.fednas import halves
    from fedml_tpu_torch.simulation.round_loop import host_sums

    idx = deterministic_client_sampling(round_idx, api.dataset.client_num,
                                        int(api.args.client_num_per_round))
    sel = torch.as_tensor(idx, dtype=torch.int64, device=api.dataset.packed_train.x.device)
    p = api.dataset.packed_train
    tr, _ = halves(Batches(x=p.x.index_select(0, sel), y=p.y.index_select(0, sel),
                           mask=p.mask.index_select(0, sel)))
    before = api.model.metrics_from_sums(api._evaluate(api.global_params, tr))["loss"]
    sums = host_sums(api.run_round(round_idx))
    during = sums["loss_sum"] / max(sums["count"], 1.0)
    return before, during


def turboaggregate_checks(api) -> dict:
    """One more round with the cohort's stacked updates kept: the new
    global model against the plain weighted mean (float64 on the host)
    and against the host protocol run again on the same updates."""
    from fedml_tpu_torch.core.secure_agg import TurboAggregateProtocol

    kept, post = {}, api._post_round_stacked

    def keep(stacked, idx, round_idx):
        kept["flat"] = api._spec.flatten_stacked(stacked).cpu().numpy()
        kept["idx"] = np.array(idx)
        post(stacked, idx, round_idx)

    api._post_round_stacked = keep
    try:
        api.run_round(A8_PROFILED + 1)
    finally:
        api._post_round_stacked = post
    flat, idx = kept["flat"], kept["idx"]
    got = torch.cat([v.reshape(-1) for v in api.global_params.values()]).cpu().numpy()
    from fedml_tpu_torch.core.aggregation import normalize_weights

    w = normalize_weights(torch.as_tensor(np.take(api.dataset.packed_num_samples, idx))
                          ).numpy().astype(np.float64)
    plain = (w[:, None] * flat.astype(np.float64)).sum(axis=0)
    C, scale = len(idx), float(api.args.ta_quant_scale)
    err = float(np.abs(got.astype(np.float64) - plain).max())
    again = TurboAggregateProtocol(C, int(api.args.ta_groups), scale, seed=12345)
    rerun = again.secure_weighted_sum(list(flat), w).astype(np.float32)
    bitwise = bool(np.array_equal(rerun, got))
    log(f"TurboAggregate: the new global model is {err:.3e} from the plain weighted mean "
        f"(bound C / (2 scale) = {C / (2 * scale):.3e}); the host protocol run again on the "
        f"same {C} x {flat.shape[1]} updates with other shares is bitwise it: {bitwise}")
    if not err <= C / (2 * scale) or not bitwise:
        fail(f"TurboAggregate: {err} from the plain mean (bound {C / (2 * scale)}), "
             f"bitwise a rerun {bitwise}")
    return {"plain_mean_max_err": err, "bound": C / (2 * scale), "rerun_bitwise": bitwise}


def splitnn_boundary_err(api) -> float:
    """The split's boundary gradient path against joint backprop through
    bottom + top on one batch: the largest difference over both nets'
    gradients."""
    from fedml_tpu_torch.simulation.split_learning import masked_ce

    b = api.dataset.packed_train
    x, y, m = b.x[0, 0], b.y[0, 0], b.mask[0, 0]
    _, _, g_b, g_t, _ = api.boundary_grads(api.bottom_params, api.top_params, x, y, m)

    def joint(pb, pt):
        feats, _ = api.bottom.apply(pb, x)
        return masked_ce(api.top.apply(pt, feats), y, m)[0]

    jb, jt = torch.func.grad(joint, argnums=(0, 1))(api.bottom_params, api.top_params)
    return max(float((got[k] - want[k]).abs().max())
               for got, want in ((g_b, jb), (g_t, jt)) for k in want)


def run_other_algorithms():
    """Phase 21: HierFedAvg, DSGD, PushSum, TurboAggregate, FedGAN,
    FedNAS, FedSeg, SplitNN, FedGKT and VFL through ``run_simulation``,
    each timed, profiled and checked: the loss falls (FedGAN: finite
    losses, disc_acc in [0, 1]); no hand-written kernel launches; and
    each algorithm's own gate."""
    from fedml_tpu_torch.simulation.split_learning import kl_loss

    out = {}
    for tag, config, overrides in A8_PATHS:
        t0 = time.perf_counter()
        run = a8_run(tag, config, overrides)
        api, stats, numbers = run["api"], run["stats"], run["numbers"]
        if tag in ("DSGD", "PushSum"):
            W = api.W.double()
            axis = 1 if tag == "DSGD" else 0
            stoch = float((W.sum(dim=axis) - 1).abs().max())
            numbers["mixing_sum_err"] = stoch
            log(f"{tag}: W {tuple(W.shape)} {'row' if axis else 'column'}-stochastic to "
                f"{stoch:.2e}; consensus_dist {stats['consensus_dist']:.6g}")
            if stoch > 1e-6:
                fail(f"{tag}: W is not {'row' if axis else 'column'}-stochastic ({stoch})")
            if tag == "PushSum":
                mass = float(api.mass.double().sum())
                n = api.dataset.client_num
                numbers["mass_sum"] = mass
                log(f"PushSum: mass sum {mass!r} over {n} nodes")
                if abs(mass / n - 1) > MASS_RTOL:
                    fail(f"PushSum: the mass sum {mass} is not conserved ({n})")
        elif tag == "HierFedAvg":
            err = hier_one_group_is_flat()
            numbers["one_group_vs_flat_max_err"] = err
            log(f"HierFedAvg: {len(api.groups)} groups of {[len(g) for g in api.groups]}; one "
                f"group and one group round vs a flat FedAvg round: {err:.3e}")
            if not err <= HIER_FLAT_ATOL:
                fail(f"HierFedAvg with group_num 1 differs from flat FedAvg by {err}")
        elif tag == "TurboAggregate":
            numbers["secure_sum"] = turboaggregate_checks(api)
        elif tag == "FedNAS":
            before, during = fednas_local_search_gain(api, A8_PROFILED + 1)
            first = run["first"]
            numbers["local_search_loss"] = {"before": before, "during": during}
            numbers["test_loss_round0_round4"] = [first["test_loss"], stats["test_loss"]]
            log(f"FedNAS: round {A8_PROFILED + 1}'s cohort on its training halves: the "
                f"global model's loss {before:.4f}, the local searches' mean {during:.4f}; "
                f"the global test loss {first['test_loss']:.4f} after round 0, "
                f"{stats['test_loss']:.4f} after round {A8_PROFILED}; genotype "
                f"{stats['genotype']}")
            if not during < before:
                fail(f"FedNAS: the local search did not lower its cohort's loss: "
                     f"{before} -> {during}")
        elif tag == "FedGAN":
            if not (np.isfinite(stats["d_loss"]) and np.isfinite(stats["g_loss"])
                    and 0.0 <= stats["disc_acc"] <= 1.0):
                fail(f"FedGAN: d_loss/g_loss not finite or disc_acc outside [0, 1]: {stats}")
        elif tag == "SplitNN":
            err = splitnn_boundary_err(api)
            numbers["boundary_vs_joint_max_err"] = err
            log(f"SplitNN: the boundary gradient vs joint backprop: {err:.3e}")
            if not err <= BOUNDARY_ATOL:
                fail(f"SplitNN: the boundary gradient differs from joint backprop by {err}")
        elif tag == "FedGKT":
            z = api.server_logits[0, 0]
            kl = float(kl_loss(z, z, torch.ones(z.shape[0], device=z.device),
                               api.temperature))
            numbers["kl_equal_logits"] = kl
            log(f"FedGKT: KL of equal logits {kl!r}; server_loss {stats['server_loss']:.4f}")
            if abs(kl) > KL_EQUAL_ATOL:
                fail(f"FedGKT: KL of equal logits is {kl}")
        elif tag == "VFL":
            # a fresh API draws the same initial params from the seed
            start = type(api)(api.args, DEVICE, api.dataset).party_params
            moved = [all(not torch.equal(api.party_params[k][n], start[k][n])
                         for n in start[k]) for k in range(api.n_parties)]
            numbers["parties_moved"] = moved
            log(f"VFL: {api.n_parties} parties of {[x.shape[-1] for x in api._train[0]]} "
                f"columns; every party's params moved: {moved}")
            if not all(moved):
                fail(f"VFL: a party's params did not move in the first rounds: {moved}")
        numbers["wall_s"] = time.perf_counter() - t0
        out[tag] = numbers
        del run, api
        torch.cuda.empty_cache()
    return out


# -- phase 22: the distributed platform (the tenth slice) -----------------
MOE_CONFIG = REPO / "fedml_tpu_torch" / "configs" / "distributed_shakespeare_moe_transformer_bf16.yaml"
SP_CONFIG = REPO / "fedml_tpu_torch" / "configs" / "distributed_shakespeare_transformer_sp_bf16.yaml"
PP_CONFIG = REPO / "fedml_tpu_torch" / "configs" / "distributed_shakespeare_transformer_pp_bf16.yaml"
# the pipeline's resume check: 2 epochs of this many sequences (2 steps an
# epoch) straight, and 1 + 1 resumed
PP_RESUME_SEQUENCES = 64
# the optimizer step (counted from 0 over a run) that runs under
# torch.profiler; step 0 warms up; the others are timed on the card's clock
DIST_PROFILED_STEP = 2
# device kernels of the distributed paths by kind, first match wins
DIST_KINDS = TRANSFORMER_KINDS[:2] + (
    ("GEMM (attention, MLP, MoE dispatch / experts / combine)",
     ("gemm", "gemv", "nvjet", "cutlass", "xmma")),
    ("MoE routing (one-hots, cumsum, argmax)", ("cumsum", "scan", "argmax", "arange",
                                                "compare", "eq_")),
    ("NCCL (world of one)", ("nccl",)),
) + TRANSFORMER_KINDS[3:]
# ring, Ulysses (the flash kernel) and dense attention (f32 scores) on the
# same bf16 weights and batch: the ring and the kernel both keep f32
# scores and round O once to bf16, dense rounds it once too, so their
# mean losses (~4.5) differ by bf16 rounding of O carried through 2
# layers, ~1e-3; 1e-2 absolute
SP_LOSS_ATOL = 1e-2


@contextlib.contextmanager
def world_of_one():
    """A NCCL process group of one rank on this card (tcp://localhost, a
    free port), destroyed on the way out."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


class StepRecorder:
    """Wraps ``DistributedTrainer._step`` while open: CUDA events around
    every optimizer step, each step's mean loss, step ``profiled`` under
    ``torch.profiler``, and the trainer it ran in."""

    def __init__(self, profiled=None) -> None:
        self.profiled, self.spans, self.losses, self.summary = profiled, [], [], None
        self.trainer = None

    def __enter__(self):
        from fedml_tpu_torch import distributed

        self._cls, self._orig = distributed.DistributedTrainer, distributed.DistributedTrainer._step
        recorder = self

        def step(trainer, x, y, m):
            recorder.trainer = trainer
            i = len(recorder.losses)
            if i == recorder.profiled:
                out, recorder.summary = profiled_call(lambda: recorder._orig(trainer, x, y, m))
                recorder.spans.append(None)
            else:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                start.record()
                out = recorder._orig(trainer, x, y, m)
                end.record()
                recorder.spans.append((start, end))
            recorder.losses.append(out[0] / out[2].clamp_min(1.0))
            return out

        self._cls._step = step
        return self

    def __exit__(self, *exc):
        self._cls._step = self._orig

    def step_ms(self, skip: int = 1):
        """The timed steps' times (ms) after ``skip`` warm-up steps."""
        torch.cuda.synchronize()
        return [span[0].elapsed_time(span[1]) for span in self.spans[skip:]
                if span is not None]


def dist_launches_wanted(args, trainer, attention: str) -> dict:
    """The flash launches a distributed run makes, reckoned from its
    config: per chunk of a step, one forward and one backward per layer
    (no remat); per test batch of an evaluation, one forward per layer
    (the whole batch, whatever the accumulation). The ring launches
    none. In the pipeline mode a rank runs its L / S layers once a tick,
    M + S - 1 ticks a batch of M microbatches (the bubble's ticks too),
    M from the reference's rule at the chunk's and the test batch's
    size."""
    L, accum = int(args.num_layers), int(getattr(args, "grad_accum_steps", 1) or 1)
    epochs = int(args.epochs)
    steps = trainer.dataset.train_data_global.num_batches * epochs
    freq = int(getattr(args, "frequency_of_the_test", 1) or 1)
    evals = sum(1 for ep in range(epochs) if (ep + 1) % freq == 0 or ep == epochs - 1)
    test_passes = trainer.dataset.test_data_global.num_batches * evals
    if attention == "ring":
        return {**no_launches()}
    train_ticks = eval_ticks = 1
    if trainer.mode == "pipeline":
        S = trainer.shape["pp"]
        L //= S
        train_ticks = trainer._microbatches(trainer.bs // accum) + S - 1
        eval_ticks = trainer._microbatches(trainer.bs) + S - 1
    return {**no_launches(),
            "flash_attention_fwd": L * (train_ticks * accum * steps + eval_ticks * test_passes),
            "flash_attention_bwd": L * train_ticks * accum * steps}


def distributed_run(tag: str, args, attention: str) -> dict:
    """``run_distributed`` on ``args`` in the world of one, timed and
    profiled; every number a line reports, the launches held to the
    reckoning and the loss to fall."""
    import fedml_tpu_torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with plain_flash_calls() as plain, StepRecorder(DIST_PROFILED_STEP) as rec:
        stats = fedml_tpu_torch.run_distributed(args, device=DEVICE)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() - held
    trainer = rec.trainer
    steps_ms = rec.step_ms()
    tokens = trainer.bs * trainer.seq_len
    step_s = float(np.mean(steps_ms)) / 1e3
    losses = [float(x) for x in rec.losses]
    per_epoch = trainer.dataset.train_data_global.num_batches
    first, last = np.mean(losses[:per_epoch]), np.mean(losses[-per_epoch:])
    if int(args.epochs) == 1:  # one epoch: its first steps against its last
        half = max(1, per_epoch // 4)
        first, last = np.mean(losses[:half]), np.mean(losses[-half:])
    want = dist_launches_wanted(args, trainer, attention)
    summary = profile_summary(f"{tag} step {DIST_PROFILED_STEP} (profiled)", rec.summary,
                              DIST_KINDS)
    # the profiler's own wall is mostly its set-up and flush: the busy
    # share is the profiled step's device time against a timed step
    busy = (summary["device_busy_ms"] / float(np.mean(steps_ms))
            if summary.get("device_busy_ms") else None)
    out = {"card": card_line(), "mesh_shape": trainer.shape, "attention": attention,
           "busy_share_of_timed_step": busy,
           "steps": len(losses), "timed_steps": len(steps_ms), "step_ms": steps_ms,
           "steps_per_s": 1.0 / step_s, "tokens_per_s": tokens / step_s,
           "peak_mib": peak / 2**20, "held_mib": held / 2**20, "wall_s": wall,
           "loss_first": float(first), "loss_last": float(last), "stats": stats,
           "profiled_step": summary, "kernel_launches": launches, "launches_wanted": want,
           "plain_flash_calls": dict(plain)}
    log(f"{tag}: {len(losses)} steps in {wall:.1f} s wall; steps 1-{len(losses) - 1} but "
        f"the profiled one on the card's clock: {1.0 / step_s:.4f} steps/s "
        f"({min(steps_ms):.1f}-{max(steps_ms):.1f} ms a step), {tokens / step_s:.0f} tokens/s "
        f"({tokens} a step); peak {peak / 2**20:.1f} MiB (less {held / 2**20:.1f} MiB held "
        f"before); loss {first:.4f} -> {last:.4f}; flash launches {launches} (reckoned "
        f"{want}); plain flash calls {plain}; the profiled step's device time "
        f"{summary.get('device_busy_ms')} ms against a timed step's mean "
        f"{float(np.mean(steps_ms)):.1f} ms: busy share {busy}; last stats {stats}")
    if launches != want:
        fail(f"{tag}: kernel launches {launches}, reckoned from the config {want}")
    if any(plain.values()):
        fail(f"{tag}: the flash plain versions ran on the card: {plain}")
    if not all(np.isfinite(losses)) or not last < first:
        fail(f"{tag}: the loss did not fall: {first} -> {last} ({losses})")
    out["occupancy_zero_one"] = all(
        bool(((o == 0) | (o == 1)).all()) for o in trainer.last_occupancy)
    out["moe_layers_checked"] = len(trainer.last_occupancy)
    return out, trainer


def sp_attention_losses(args) -> dict:
    """One batch's mean loss through ring, Ulysses and dense attention (f32
    scores, ``flash_attention_reference``) on the same seeded bf16 weights,
    in a trainer of the sequence configuration."""
    from fedml_tpu_torch import data, models
    from fedml_tpu_torch.distributed import DistributedTrainer
    from fedml_tpu_torch.ops.flash_attention import flash_attention_reference

    dev = torch.device(DEVICE)
    dataset = data.load(args, device=dev)
    out = {}
    for name in ("ring", "ulysses", "dense"):
        a = copy.copy(args)
        a.sp_strategy = "ring" if name == "dense" else name
        a.sp_ring_block = int(args.sp_ring_block) if name == "ring" else 0
        model = models.create(a, dataset.class_num, device=dev)
        trainer = DistributedTrainer(a, dev, dataset, model)
        if name == "dense":
            model.module.set_attention(lambda q, k, v: flash_attention_reference(q, k, v, True)[0])
        b = trainer._local_batches(dataset.train_data_global, trainer.bs)
        with torch.no_grad():
            nll, _, count, _, _ = trainer._sums(trainer.params, b.x[0], b.y[0], b.mask[0])
        out[name] = float(nll / count)
        del model, trainer
    return out


def pp_plain_losses(args) -> dict:
    """One batch's mean loss through the pipeline mode and through the
    plain ``TransformerLM`` forward on the same seeded bf16 weights (the
    pipeline trainer's start params are the model's init, stacked)."""
    from fedml_tpu_torch import data, models
    from fedml_tpu_torch.core.local_trainer import _cast_floats, compute_dtype_from_args
    from fedml_tpu_torch.distributed import DistributedTrainer

    dev = torch.device(DEVICE)
    dataset = data.load(args, device=dev)
    model = models.create(args, dataset.class_num, device=dev)
    trainer = DistributedTrainer(args, dev, dataset, model)
    b = trainer._local_batches(dataset.train_data_global, trainer.bs)
    x, y, m = b.x[0], b.y[0], b.mask[0]
    with torch.no_grad():
        nll, _, count, _, _ = trainer._sums(trainer.params, x, y, m)
        flat = model.init(torch.Generator().manual_seed(trainer.seed))
        flat = _cast_floats({k: v.to(dev) for k, v in flat.items()},
                            compute_dtype_from_args(args))
        loss, _ = model.loss_fn(model.apply(flat, x).to(torch.float32), y, m)
    return {"pipeline": float(nll / count), "plain": float(loss)}


def pp_resume_check(tempfile) -> dict:
    """The pipeline configuration cut to PP_RESUME_SEQUENCES sequences,
    2 epochs straight against 1 epoch, checkpointed, then resumed to 2:
    the params bitwise equal, under deterministic algorithms."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_yaml_arguments

    def run(epochs, ckpt=None):
        args = load_yaml_arguments(str(PP_CONFIG))
        args.epochs, args.checkpoint_dir = epochs, ckpt
        args.synthetic_train_size = PP_RESUME_SEQUENCES
        with StepRecorder() as rec:
            fedml_tpu_torch.run_distributed(args, device=DEVICE)
        return {k: v.detach().clone() for k, v in rec.trainer.full_params().items()}

    t0 = time.perf_counter()
    with deterministic(), tempfile.TemporaryDirectory() as ckpt:
        straight = run(2)
        run(1, ckpt)
        resumed = run(2, ckpt)
    equal = all(torch.equal(straight[k], resumed[k]) for k in straight)
    log(f"distributed pipeline resume: 2 epochs straight vs 1 + resumed 1, params bitwise "
        f"equal {equal} ({time.perf_counter() - t0:.1f} s)")
    if not equal:
        fail("distributed pipeline resume: the resumed run's params differ from the straight "
             "run's")
    return {"bitwise_equal": equal}


def run_distributed_phase():
    """The tenth slice's path: ``run_distributed`` on the distributed
    configurations in a NCCL world of one rank, where every collective is
    the identity (the CPU tests' gloo worlds of 2-8 ranks prove the
    collectives; this phase proves the kernels, shapes, memory and time):
    the MoE transformer (sharded mode, {dp: 1, tp: 1, ep: 1}, the flash
    kernels), the sequence mode with ring attention (no flash launch) and
    with Ulysses (the flash kernels at [8, 4096, 8, 64]), and (the twelfth
    slice) the pipeline mode at {pp: 1} (the flash kernels at the
    microbatch's [16, 4096, 8, 64]). Gates: flash launches as reckoned
    from each config and no plain flash call; the loss falls; the MoE's
    slot occupancy 0/1; ring, Ulysses and dense attention give one
    batch's loss within SP_LOSS_ATOL, and so do the pipeline and the plain
    model on the same weights; the sequence and pipeline runs stopped
    after 1 of 2 epochs and resumed are bitwise the straight runs
    (deterministic algorithms)."""
    import tempfile

    from fedml_tpu_torch.arguments import load_yaml_arguments

    out = {}
    with world_of_one():
        moe_args = load_yaml_arguments(str(MOE_CONFIG))
        out["moe"], trainer = distributed_run("distributed moe (sharded)", moe_args, "flash")
        if not out["moe"]["occupancy_zero_one"] or not out["moe"]["moe_layers_checked"]:
            fail("distributed moe: a slot occupancy is not 0/1")
        del trainer
        for strategy in ("ring", "ulysses"):
            args = load_yaml_arguments(str(SP_CONFIG))
            args.sp_strategy = strategy
            if strategy == "ulysses":
                args.sp_ring_block = 0
            out[f"sp_{strategy}"], trainer = distributed_run(
                f"distributed sequence ({strategy})", args, strategy)
            del trainer
        losses = sp_attention_losses(load_yaml_arguments(str(SP_CONFIG)))
        gap = max(abs(losses[a] - losses[b]) for a in losses for b in losses)
        out["sp_attention_losses"] = {**losses, "max_gap": gap, "atol": SP_LOSS_ATOL}
        log(f"distributed sequence: one batch's loss by ring / Ulysses / dense attention "
            f"{losses['ring']:.6f} / {losses['ulysses']:.6f} / {losses['dense']:.6f}, max gap "
            f"{gap:.3g} (atol {SP_LOSS_ATOL})")
        if not gap <= SP_LOSS_ATOL:
            fail(f"distributed sequence: attention strategies disagree: {losses}")
        out["resume"] = distributed_resume_check(tempfile)
        out["pipeline"], trainer = distributed_run("distributed pipeline",
                                                   load_yaml_arguments(str(PP_CONFIG)), "flash")
        out["pipeline"]["microbatches"] = trainer._microbatches(trainer.bs)
        del trainer
        pp_losses = pp_plain_losses(load_yaml_arguments(str(PP_CONFIG)))
        gap = abs(pp_losses["pipeline"] - pp_losses["plain"])
        out["pp_plain_losses"] = {**pp_losses, "gap": gap, "atol": SP_LOSS_ATOL}
        log(f"distributed pipeline: one batch's loss pipelined / plain TransformerLM "
            f"{pp_losses['pipeline']:.6f} / {pp_losses['plain']:.6f}, gap {gap:.3g} "
            f"(atol {SP_LOSS_ATOL})")
        if not gap <= SP_LOSS_ATOL:
            fail(f"distributed pipeline: the pipelined loss is not the plain model's: {pp_losses}")
        out["pp_resume"] = pp_resume_check(tempfile)
    launches = {name: sum(run["kernel_launches"][name] for key, run in out.items()
                          if isinstance(run, dict) and "kernel_launches" in run)
                for name in no_launches()}
    return {**out, "kernel_launches": launches}


def distributed_resume_check(tempfile) -> dict:
    """The sequence configuration (ring), 2 epochs straight against 1
    epoch, checkpointed, then resumed to 2: the params bitwise equal,
    under deterministic algorithms."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_yaml_arguments

    def run(epochs, ckpt=None):
        args = load_yaml_arguments(str(SP_CONFIG))
        args.epochs, args.checkpoint_dir = epochs, ckpt
        with StepRecorder() as rec:
            fedml_tpu_torch.run_distributed(args, device=DEVICE)
        return {k: v.detach().clone() for k, v in rec.trainer.full_params().items()}

    t0 = time.perf_counter()
    with deterministic(), tempfile.TemporaryDirectory() as ckpt:
        straight = run(2)
        run(1, ckpt)
        resumed = run(2, ckpt)
    equal = all(torch.equal(straight[k], resumed[k]) for k in straight)
    log(f"distributed resume: 2 epochs straight vs 1 + resumed 1, params bitwise equal "
        f"{equal} ({time.perf_counter() - t0:.1f} s)")
    if not equal:
        fail("distributed resume: the resumed run's params differ from the straight run's")
    return {"bitwise_equal": equal}


# -- the twelfth slice: the mesh simulator ------------------------------
# the fed mesh's shape on one card; the planet's rounds on it (cut from
# the configuration's 3)
MESH_SHAPE = {"data": 1, "fsdp": 1}
MESH_PLANET_ROUNDS = 2
MESH_FEDAVG_ROUNDS = 3  # of the headline configuration's 4
MESH_ATOL = 1e-5


@contextlib.contextmanager
def captured_trainers():
    """The FedAvg APIs that the simulators ``run`` while open, in order."""
    from fedml_tpu_torch.simulation import simulator

    got, origs = [], {}
    for cls in (simulator.SimulatorSingleProcess, simulator.SimulatorMesh):
        origs[cls] = cls.run

        def run(self, _orig=origs[cls]):
            got.append(self.fl_trainer)
            return _orig(self)

        cls.run = run
    try:
        yield got
    finally:
        for cls, orig in origs.items():
            cls.run = orig


def mesh_pair(tag: str, make_args, wanted, **flat_operators) -> dict:
    """``make_args(mesh=True)`` through ``run_simulation(backend="MESH")``
    in a NCCL world of one rank (timed; its launches held to
    ``wanted(api)``), then, under deterministic algorithms, that run again
    and ``make_args(mesh=False)`` through the single-process backend with
    ``flat_operators``: the largest distance between their params, held to
    MESH_ATOL. The mesh run is made a second time under the default
    algorithms, and the distance between the two default runs
    (``default_repeat``) and between the first and the deterministic one
    (``default_vs_deterministic``) are printed beside it: what the
    default algorithms move between two runs of one configuration and
    one aggregator."""

    def mesh_run():
        with world_of_one(), captured_trainers() as got:
            run = measured_run(make_args(mesh=True), backend="MESH")
            api = got[-1]
            return run, api, {k: v.detach().clone() for k, v in api.full_params().items()}

    def distance(a, b):
        return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)

    mesh, api, default_params = mesh_run()
    local = {k: tuple(v.shape) for k, v in api.global_params.items()}
    want = wanted(api)
    repeat = distance(mesh_run()[2], default_params)
    with deterministic():
        det, _, params = mesh_run()
    drift = distance(params, default_params)
    with deterministic():
        with captured_trainers() as got:
            flat_run = measured_run(make_args(mesh=False), **flat_operators)
            flat = {k: v.detach().clone() for k, v in got[-1].global_params.items()}
    err = distance(params, flat)
    spans = mesh["pipe"]["round_spans_s"]
    rounds_s = [b - a for a, b in spans]
    # the same rounds with and without the mesh, both under deterministic
    # algorithms: what the mesh's plumbing costs at world one
    det_s = {name: [b - a for a, b in run["pipe"]["round_spans_s"]]
             for name, run in (("mesh", det), ("flat", flat_run))}
    log(f"{tag}: mesh {api.mesh.shape}, {len(spans)} rounds in {mesh['wall_s']:.1f} s wall; "
        f"rounds on the card's clock {[round(r * 1e3, 1) for r in rounds_s]} ms; peak "
        f"{mesh['peak_bytes'] / 2**20:.1f} MiB; kernel launches {mesh['launches']} (reckoned "
        f"{want}); params at rest {local}; under deterministic algorithms, the largest "
        f"distance from the run without a mesh {err:.3g} (atol {MESH_ATOL}), their rounds "
        f"on the card's clock {[round(r * 1e3, 1) for r in det_s['mesh']]} and "
        f"{[round(r * 1e3, 1) for r in det_s['flat']]} ms; under the default algorithms "
        f"two mesh runs are {repeat:.3g} apart, and the first is {drift:.3g} from the "
        f"deterministic one")
    if mesh["launches"] != want:
        fail(f"{tag}: kernel launches {mesh['launches']}, reckoned {want}")
    if not err <= MESH_ATOL:
        fail(f"{tag}: the mesh run is {err} from the run without a mesh")
    return {"card": card_line(), "mesh_shape": dict(api.mesh.shape), "rounds": len(spans),
            "round_s": rounds_s, "wall_s": mesh["wall_s"], "peak_bytes": mesh["peak_bytes"],
            "max_abs_vs_flat": err, "default_repeat": repeat,
            "default_vs_deterministic": drift,
            "deterministic_round_s": det_s,
            "records": mesh["records"], "pipeline": mesh["pipe"],
            "kernel_launches": mesh["launches"], "launches_wanted": want}


def plain_fold_aggregator():
    """The fed mesh's plain aggregation, the exact fold, as a custom
    server aggregator of the single-process backend, computed by K1's
    plain PyTorch version (``weighted_mean_reference``) and not by the
    kernel: the same run without a mesh, its fold independent of the
    kernel the mesh run launches."""
    from fedml_tpu_torch.core.frame import ServerAggregator
    from fedml_tpu_torch.ops.exact_fold import weighted_mean_reference

    class PlainFold(ServerAggregator):
        def aggregate(self, global_params, stacked_params, weights, rng):
            w = weights.to(torch.float32)
            return {k: weighted_mean_reference(v.reshape(v.shape[0], -1), w).reshape(v.shape[1:])
                    for k, v in stacked_params.items()}

    return PlainFold(None)


def run_mesh_phase():
    """The twelfth slice's fed mesh on one card: the headline FedAvg
    configuration (``fedavg_femnist_cnn.yaml``, MESH_FEDAVG_ROUNDS of its
    rounds) through ``run_simulation(backend="MESH")`` at MESH_SHAPE, whose plain FedAvg
    aggregation is the exact fold (K1's ``weighted_mean``, one launch a
    leaf a round), and the planet configuration there, its rounds cut to
    MESH_PLANET_ROUNDS (K1's group folds and root merges and K2's
    features, as the registry reckons them). Gates: those launches and no
    other kernel; each within MESH_ATOL of its run without a mesh (the
    FedAvg one with K1's plain version as its aggregator), under
    deterministic algorithms; the FedAvg loss falls."""
    from fedml_tpu_torch.arguments import load_yaml_arguments

    def fedavg_args(mesh):
        args = load_yaml_arguments(str(FEDAVG_CONFIG))
        args.comm_round = MESH_FEDAVG_ROUNDS
        if mesh:
            args.mesh_shape = dict(MESH_SHAPE)
        return args

    def fedavg_wanted(api):
        rounds = int(api.args.comm_round)
        from fedml_tpu_torch.ops.exact_fold import MEAN_KERNEL

        return {**no_launches(), MEAN_KERNEL.name: len(api.global_params) * rounds}

    out = {"fedavg": mesh_pair("mesh fedavg", fedavg_args, fedavg_wanted,
                               server_aggregator=plain_fold_aggregator())}
    log_records("mesh fedavg", {"pipe": out["fedavg"]["pipeline"],
                                "records": out["fedavg"]["records"]})

    def planet_wanted(api):
        rounds = range(MESH_PLANET_ROUNDS)
        _, groups, fold_launches = planet_launches_wanted(api.args, rounds)
        from fedml_tpu_torch.ops.exact_fold import FOLD_KERNEL
        from fedml_tpu_torch.ops.synth_features import SYNTH_KERNEL

        return {**no_launches(), FOLD_KERNEL.name: sum(fold_launches),
                SYNTH_KERNEL.name: sum(groups)}

    def planet_mesh_args(mesh):
        knobs = {"mesh_shape": dict(MESH_SHAPE)} if mesh else {}
        return planet_args(comm_round=MESH_PLANET_ROUNDS, **knobs)

    out["planet"] = mesh_pair("mesh planet", planet_mesh_args, planet_wanted)
    return out


# -- the fourteenth slice: cross silo ------------------------------------
CROSS_SILO_CONFIG = REPO / "fedml_tpu_torch" / "configs" / "cross_silo_femnist_cnn.yaml"
CROSS_SILO_CNN_PARAMS = 428_350
# the round each World A run profiles: from its broadcast to the next
# broadcast (the clients' training, the folds and the close)
CROSS_SILO_PROFILED = 1
CROSS_SILO_JOIN_S = 300.0  # a world's threads must end within this
# the profiler stays on this long past the window's end before it stops.
# Stopped at the window's end, late in the whole script it kept 1 of a
# round's 8 K1 launches (the round's last kernels: its folds and its
# evaluation), while the counters saw all 8; it drops the events it dates
# after its stop. The pause is left out of the window and of the run's
# rounds/s, and cs_run fails if the trace still misses a counted launch.
CROSS_SILO_TRACE_PAUSE_S = 0.5
# local epochs a round on the card: the configuration's 5 cut to 1, a cut
# of the script's time limit. At 5 a round of the 8 silo threads took
# 9.1-11.4 s on the host (3.1-3.8% busy: the host dispatches each silo's
# steps), and the phase's 19 rounds took 200.5 s
CROSS_SILO_EPOCHS = 1
# World C: the bf16 flash transformer config as 2 one-rank silos of 32
# sequences each, 2 rounds, evaluated on 8 test sequences
CROSS_SILO_HIER_SILOS = 2
CROSS_SILO_HIER_SEQS = 32
CROSS_SILO_HIER_TEST = 8
CROSS_SILO_HIER_ROUNDS = 2
CROSS_SILO_KINDS = (
    ("exact fold (K1)", ("fold_kernel",)),
    ("robust term (K3)", ("robust_term_kernel",)),
    *KERNEL_KINDS,
)


@contextlib.contextmanager
def plain_fold_calls():
    """Counts the calls of the exact fold's and the robust term's plain
    versions while it is open: a path on the card must make none."""
    from fedml_tpu_torch.ops import exact_fold as ef
    from fedml_tpu_torch.ops import robust_term as rt

    names = [(ef, "fold_reference"), (ef, "fold_edges_reference"), (ef, "fold_set_reference"),
             (ef, "weighted_mean_reference"), (rt, "robust_term_reference")]
    calls = {name: 0 for _, name in names}
    real = {name: getattr(mod, name) for mod, name in names}

    def counted(name):
        def call(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return call

    for mod, name in names:
        setattr(mod, name, counted(name))
    try:
        yield calls
    finally:
        for mod, name in names:
            setattr(mod, name, real[name])


def cs_args(run_id: str, rank: int, backend: str = "LOCAL", config=None, **kw):
    """One rank's args of the cross-silo configuration (or ``config``)."""
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_yaml_arguments

    args = load_yaml_arguments(str(config or CROSS_SILO_CONFIG))
    if config is None:
        args.epochs = CROSS_SILO_EPOCHS
    args.training_type = "cross_silo"
    args.rank, args.run_id, args.backend = rank, run_id, backend
    for k, v in kw.items():
        setattr(args, k, v)
    args._validate()
    return fedml_tpu_torch.init(args, DEVICE)


def cs_world(run_id: str, backend: str = "LOCAL", dataset=None, **kw):
    """(server, clients, dataset): the configuration's server and silos
    on the card, each rank with its own model (``FedModel.apply`` loads
    the params into the module: two threads must never share one), the
    one federation shared read-only."""
    from fedml_tpu_torch import data, models
    from fedml_tpu_torch.cross_silo import Client, Server

    if backend == "TRPC":
        kw["trpc_port_base"] = free_port_block(9)
    a0 = cs_args(run_id, 0, backend, **kw)
    ds = dataset if dataset is not None else data.load(a0, device=DEVICE)
    server = Server(a0, DEVICE, ds, models.create(a0, ds.class_num, device=DEVICE))
    clients = []
    for r in range(1, int(a0.client_num_per_round) + 1):
        a = cs_args(run_id, r, backend, **kw)
        clients.append(Client(a, DEVICE, ds, models.create(a, ds.class_num, device=DEVICE)))
    return server, clients, ds


class RoundWindowProfiler:
    """``torch.profiler`` over the card's activity between ``start`` and
    ``stop`` (called from the server's dispatch thread), summarized as
    ``profiled_call`` summarizes, with the hand-written kernels' counted
    launches in the window (``launches``) to hold the trace against."""

    def __init__(self):
        self.prof, self.summary, self._t0 = None, None, 0.0
        self.launches, self.paused_s, self.late_ms = None, 0.0, None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        activity = ProfilerActivity.CUDA if DEVICE == "cuda" else ProfilerActivity.CPU
        self.prof = profile(activities=[activity])
        self.prof.__enter__()
        self.launches = launch_counts()
        self._t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        stop_ns = time.time_ns()
        self.launches = _delta(launch_counts(), self.launches)
        time.sleep(CROSS_SILO_TRACE_PAUSE_S)
        self.paused_s = time.perf_counter() - self._t0 - wall
        self.prof.__exit__(None, None, None)
        self.summary, self.prof = kineto_summary(self.prof, wall), None
        # how far past the host's stop the profiler dated the last event
        self.late_ms = (self.summary["device_end_ns"] - stop_ns) / 1e6


def cs_instrument(server, profile_round=None) -> dict:
    """Wraps the server for measurement only: each close's aggregate on
    the host clock (the finalize fetches the limbs, so it waits for the
    card), each evaluation's loss, the first broadcast's and the finish's
    times, and a profiler window over round ``profile_round``."""
    agg, mgr = server.aggregator, server.manager
    rec = {"close_ms": [], "losses": [], "t_first": None, "t_end": None,
           "window": RoundWindowProfiler()}
    aggregate, test, bcast, finish = (agg.aggregate, agg.test_on_server_for_all_clients,
                                      mgr._broadcast_model, mgr.send_finish)

    def timed_aggregate():
        t0 = time.perf_counter()
        out = aggregate()
        torch.cuda.synchronize()
        rec["close_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def evaluated(round_idx):
        stats = test(round_idx)
        rec["losses"].append(float(stats["loss"]))
        return stats

    def broadcast(msg_type):
        if rec["t_first"] is None:
            rec["t_first"] = time.perf_counter()
        window = rec["window"]
        if profile_round is not None:
            if mgr.round_idx == profile_round and window.prof is None and window.summary is None:
                window.start()
            elif mgr.round_idx == profile_round + 1 and window.prof is not None:
                window.stop()
        bcast(msg_type)

    def finished():
        rec["t_end"] = time.perf_counter()
        finish()

    agg.aggregate, agg.test_on_server_for_all_clients = timed_aggregate, evaluated
    mgr._broadcast_model, mgr.send_finish = broadcast, finished
    return rec


def cs_threads(fns, names):
    import threading

    errors = []

    def guarded(fn):
        def run():
            try:
                fn()
            except BaseException as e:  # surfaced by cs_join, never swallowed
                errors.append(e)
        return run

    threads = [threading.Thread(target=guarded(f), daemon=True, name=n)
               for f, n in zip(fns, names)]
    for t in threads:
        t.start()
    return threads, errors


def cs_join(tag, threads, errors, timeout=CROSS_SILO_JOIN_S):
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    hung = [t.name for t in threads if t.is_alive()]
    if hung:
        fail(f"{tag}: threads still alive after {timeout} s: {hung}")
    if errors:
        fail(f"{tag}: a rank failed: {errors[0]!r}")


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def cs_params(server) -> dict:
    return {k: v.detach().clone() for k, v in server.aggregator.get_global_model_params().items()}


def cs_run(tag, run_id, backend="LOCAL", dataset=None, **kw) -> dict:
    """One World A run: the server on this thread, the silos on theirs;
    rounds/s on the host clock (first broadcast to finish), upload bytes a
    round from the instrumented counters, each close's milliseconds, the
    profiled round's busy share and launches by kind, and K1/K3's
    launches against the counts the uploads reckon."""
    from fedml_tpu_torch import constants
    from fedml_tpu_torch.core.telemetry import Telemetry

    Telemetry.reset()
    server, clients, ds = cs_world(run_id, backend, dataset, **kw)
    rec = cs_instrument(server, CROSS_SILO_PROFILED)
    before = launch_counts()
    threads, errors = cs_threads([c.run for c in clients],
                                 [f"{tag}-silo{i + 1}" for i in range(len(clients))])
    server.run()
    cs_join(tag, threads, errors)
    launches = _delta(launch_counts(), before)
    tel = Telemetry.get_instance()
    up = constants.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER
    uploads = int(tel.get_counter("comm_messages_received_total", msg_type=up))
    up_bytes = tel.get_counter("comm_bytes_sent_total", msg_type=up)
    rounds = server.manager.round_idx
    args = server.args
    defended = bool(getattr(args, "defense_type", None)) or args.compression != "none"
    from fedml_tpu_torch.ops.exact_fold import FOLD_KERNEL
    from fedml_tpu_torch.ops.robust_term import TERM_KERNEL

    want = {**no_launches(), FOLD_KERNEL.name: uploads,
            TERM_KERNEL.name: uploads if defended else 0}
    window = rec["window"]
    wall = rec["t_end"] - rec["t_first"] - window.paused_s
    card = card_line()
    profile = profile_summary(f"{tag}: profile of round {CROSS_SILO_PROFILED} (broadcast to "
                              f"the next broadcast) on {card}", window.summary,
                              CROSS_SILO_KINDS)
    traced = {FOLD_KERNEL.name: profile.get("launches_by_kind", {}).get("exact fold (K1)", 0),
              TERM_KERNEL.name: profile.get("launches_by_kind", {}).get("robust term (K3)", 0)}
    counted = {k: window.launches[k] for k in traced}
    log(f"{tag}: the profiled round's K1/K3 launches: traced {traced}, counted {counted}; the "
        f"last traced event ends {window.late_ms:.3f} ms after the window's stop on the host "
        f"clock (the trace ran {window.paused_s * 1e3:.1f} ms past it)")
    if traced != counted or counted[FOLD_KERNEL.name] != len(clients):
        fail(f"{tag}: the profiled round's trace holds K1/K3 launches {traced}, the counters "
             f"{counted} ({len(clients)} uploads a round)")
    log(f"{tag} on {card}: {rounds} rounds of {len(clients)} silos ({args.epochs} local "
        f"epoch(s) of batch {args.batch_size}, deterministic algorithms) in {wall:.3f} s "
        f"({rounds / wall:.4f} rounds/s on the host clock, first broadcast to finish); "
        f"{uploads} uploads, {up_bytes / rounds:.0f} B of uploads a round "
        f"({up_bytes / max(uploads, 1):.0f} B each); round close (aggregate) "
        f"{[round(x, 3) for x in rec['close_ms']]} ms; evaluation losses "
        f"{[round(x, 5) for x in rec['losses']]}; kernel launches {launches} (reckoned from "
        f"the uploads: {want}); folds {server.aggregator.folds_total}, clipped "
        f"{server.aggregator.defense_clipped}")
    if rounds != int(args.comm_round):
        fail(f"{tag}: {rounds} rounds closed, want {args.comm_round}")
    if uploads != rounds * len(clients) or server.aggregator.folds_total != uploads:
        fail(f"{tag}: {uploads} uploads and {server.aggregator.folds_total} folds for "
             f"{rounds} rounds of {len(clients)} silos")
    if launches != want:
        fail(f"{tag}: kernel launches {launches}, reckoned {want}")
    if not rec["losses"][-1] < rec["losses"][0]:
        fail(f"{tag}: the evaluation loss did not fall: {rec['losses']}")
    return {"card": card, "rounds": rounds, "wall_s": wall, "rounds_per_s": rounds / wall,
            "uploads": uploads, "upload_bytes_per_round": up_bytes / rounds,
            "close_ms": rec["close_ms"], "losses": rec["losses"], "profile": profile,
            "launches": launches, "launches_reckoned": want,
            "clipped": server.aggregator.defense_clipped,
            "params": cs_params(server), "dataset": ds}


def cs_restart(straight: dict) -> dict:
    """A chaos schedule kills the LOCAL server at ``server.round_close``
    of round 1; a new server restores the checkpoint and WAL, the silos
    re-announce by heartbeat and are RESYNCed. Gate: the final global is
    bitwise the straight run's; K1 = the two incarnations' folds."""
    import shutil
    import tempfile

    from fedml_tpu_torch import models
    from fedml_tpu_torch.core.chaos import ProcessKilled, reset_chaos
    from fedml_tpu_torch.cross_silo import Server

    ck = tempfile.mkdtemp(prefix="cross_silo_restart-")
    kw = dict(checkpoint_dir=ck, checkpoint_freq=1, heartbeat_interval_s=0.2,
              heartbeat_timeout_s=600.0,
              chaos_schedule=[{"at": {"event": "barrier", "name": "server.round_close",
                                      "round": 1}, "fault": "kill_server"}])
    try:
        server1, clients, ds = cs_world("cs_restart", dataset=straight["dataset"], **kw)
        before = launch_counts()
        threads, errors = cs_threads([c.run for c in clients],
                                     [f"restart-silo{i + 1}" for i in range(len(clients))])
        try:
            server1.run()
            fail("cross silo restart: the chaos schedule never killed the server")
        except ProcessKilled:
            t_kill = time.perf_counter()
        server1.manager._failure_detector.stop()
        a0 = cs_args("cs_restart", 0, **kw)
        server2 = Server(a0, DEVICE, ds, models.create(a0, ds.class_num, device=DEVICE))
        if not server2.manager._resumed:
            fail("cross silo restart: the second server did not resume from the checkpoint")
        closes = []
        report = server2.manager._report_round

        def reported(*a):
            closes.append(time.perf_counter())
            report(*a)

        server2.manager._report_round = reported
        resumed_at = server2.manager.round_idx
        server2.run()
        cs_join("cross silo restart", threads, errors)
        launches = _delta(launch_counts(), before)
        recs = [r["round_idx"] for r in server2.manager._wal.records()]
    finally:
        reset_chaos()
        shutil.rmtree(ck, ignore_errors=True)
    from fedml_tpu_torch.ops.exact_fold import FOLD_KERNEL

    folds = server1.aggregator.folds_total + server2.aggregator.folds_total
    want = {**no_launches(), FOLD_KERNEL.name: folds}
    params = cs_params(server2)
    same = all(bits_equal(params[k], straight["params"][k]) for k in params)
    seconds = closes[0] - t_kill
    log(f"cross silo restart on {card_line()}: killed at server.round_close of round 1; the "
        f"second server resumed at round {resumed_at}, WAL rounds {recs}; {seconds:.3f} s from "
        f"the kill to the first round closed after the restart; folds {folds} "
        f"({server1.aggregator.folds_total} before the kill); kernel launches {launches} "
        f"(reckoned {want}); final global bitwise the straight run's: {same}")
    if not same:
        fail("cross silo restart: the restarted federation's global differs from the straight run's")
    if launches != want:
        fail(f"cross silo restart: kernel launches {launches}, reckoned {want}")
    if server2.manager.round_idx != 3 or recs != [0, 1, 2]:
        fail(f"cross silo restart: round {server2.manager.round_idx}, WAL rounds {recs}")
    return {"kill_to_close_s": seconds, "resumed_at": resumed_at, "wal_rounds": recs,
            "folds": folds, "launches": launches, "bitwise": same}


def cs_edge_world(straight: dict) -> dict:
    """World B: the same 8 silos behind 2 edge aggregators that are ranks
    (``edge_plane: ranks``), LOCAL fabrics. Gates: the root's global is
    bitwise World A's LOCAL stream result; K1 = the edges' folds + the
    root's merges."""
    from fedml_tpu_torch import models
    from fedml_tpu_torch.core.telemetry import Telemetry
    from fedml_tpu_torch.cross_silo.hierarchical import run_local_hier_world
    from fedml_tpu_torch.ops.exact_fold import FOLD_KERNEL

    Telemetry.reset()
    ds = straight["dataset"]

    def mk(role, rank):
        a = cs_args("cs_edges", rank, edge_plane="ranks", edge_num=2)
        return a, ds, models.create(a, ds.class_num, device=DEVICE)

    before = launch_counts()
    t0 = time.perf_counter()
    world = run_local_hier_world(mk, 8, 2, join_timeout_s=CROSS_SILO_JOIN_S)
    wall = time.perf_counter() - t0
    launches = _delta(launch_counts(), before)
    tel = Telemetry.get_instance()
    merges = int(sum(tel.counters_matching("hier_edge_merges_total").values()))
    edge_folds = sum(e.aggregator.folds_total for e in world["edges"].values())
    want = {**no_launches(), FOLD_KERNEL.name: edge_folds + merges}
    params = cs_params(world["root"])
    same = all(bits_equal(params[k], straight["params"][k]) for k in params)
    rounds = world["root"].manager.round_idx
    log(f"cross silo edges on {card_line()}: partition {world['partition']}; {rounds} rounds in "
        f"{wall:.3f} s wall (set-up included); {edge_folds} edge folds + {merges} root merges; "
        f"kernel launches {launches} (reckoned {want}); root global bitwise World A's LOCAL "
        f"stream: {same}")
    if not same:
        fail("cross silo edges: the root's global differs from the flat server's")
    if launches != want:
        fail(f"cross silo edges: kernel launches {launches}, reckoned {want}")
    if rounds != 3 or edge_folds != 24 or merges != 6:
        fail(f"cross silo edges: {rounds} rounds, {edge_folds} folds, {merges} merges")
    return {"rounds": rounds, "wall_s": wall, "edge_folds": edge_folds, "root_merges": merges,
            "launches": launches, "bitwise": same}


def cs_hier_args(run_id, rank):
    return cs_args(run_id, rank, config=TRANSFORMER_CONFIG,
                   client_num_in_total=CROSS_SILO_HIER_SILOS,
                   client_num_per_round=CROSS_SILO_HIER_SILOS,
                   synthetic_train_size=CROSS_SILO_HIER_SILOS * CROSS_SILO_HIER_SEQS,
                   synthetic_test_size=CROSS_SILO_HIER_TEST,
                   comm_round=CROSS_SILO_HIER_ROUNDS, frequency_of_the_test=1)


def cs_hier_world(run_id, server_fn, client_fn) -> tuple:
    """World C through the one-line entry points: the server on this
    thread, each silo's process 0 on its own; the server's final global
    read where the aggregator evaluates it (measurement only)."""
    from fedml_tpu_torch.cross_silo.horizontal import fedml_aggregator as fa

    seen = {}
    test = fa.FedMLAggregator.test_on_server_for_all_clients

    def evaluated(self, round_idx):
        seen["params"] = {k: v.detach().clone() for k, v in self.global_params.items()}
        return test(self, round_idx)

    fa.FedMLAggregator.test_on_server_for_all_clients = evaluated
    try:
        threads, errors = cs_threads(
            [lambda r=r: client_fn(cs_hier_args(run_id, r), device=DEVICE)
             for r in range(1, CROSS_SILO_HIER_SILOS + 1)],
            [f"{run_id}-silo{r}" for r in range(1, CROSS_SILO_HIER_SILOS + 1)])
        t0 = time.perf_counter()
        stats = server_fn(cs_hier_args(run_id, 0), device=DEVICE)
        wall = time.perf_counter() - t0
        cs_join(run_id, threads, errors)
    finally:
        fa.FedMLAggregator.test_on_server_for_all_clients = test
    return seen["params"], stats, wall


def cs_hierarchical() -> dict:
    """World C: ``run_hierarchical_cross_silo_server`` / ``_client`` with
    2 one-rank silos of the bf16 flash transformer at full width. Gates:
    flash forward and backward launches = layers x steps (+ the server's
    evaluations' forward passes); the global bitwise the horizontal
    ``Client`` world's on the same configuration; no plain flash runs."""
    import fedml_tpu_torch
    from fedml_tpu_torch import data
    from fedml_tpu_torch.core.local_trainer import eval_batches_per_pass
    from fedml_tpu_torch.ops.exact_fold import FOLD_KERNEL
    from fedml_tpu_torch.ops.flash_attention import BWD_KERNEL, FWD_KERNEL

    args = cs_hier_args("cs_hier_probe", 0)
    ds = data.load(args, device=DEVICE)
    L, epochs = int(args.num_layers), int(args.epochs)
    nb, bs = ds.packed_train.num_batches, ds.packed_train.batch_size
    test = ds.test_data_global
    passes = -(-(test.mask.numel() // test.batch_size) // eval_batches_per_pass(test))
    del ds
    steps = CROSS_SILO_HIER_ROUNDS * CROSS_SILO_HIER_SILOS * epochs * nb
    # and the server's fold of each upload
    want = {**no_launches(), FWD_KERNEL.name: L * (steps + CROSS_SILO_HIER_ROUNDS * passes),
            BWD_KERNEL.name: L * steps,
            FOLD_KERNEL.name: CROSS_SILO_HIER_ROUNDS * CROSS_SILO_HIER_SILOS}
    out = {}
    with plain_flash_calls() as plain, deterministic():
        before = launch_counts()
        hier, stats, wall = cs_hier_world("cs_hier", fedml_tpu_torch.run_hierarchical_cross_silo_server,
                                          fedml_tpu_torch.run_hierarchical_cross_silo_client)
        launches = _delta(launch_counts(), before)
        flat, flat_stats, flat_wall = cs_hier_world("cs_hier_flat",
                                                    fedml_tpu_torch.run_cross_silo_server,
                                                    fedml_tpu_torch.run_cross_silo_client)
    same = all(bits_equal(hier[k], flat[k]) for k in hier)
    card = card_line()
    log(f"cross silo hierarchical on {card}: {CROSS_SILO_HIER_SILOS} one-rank silos of "
        f"{args.model} ({args.attention_impl}, {args.dtype}), embed {args.embed_dim}, "
        f"{args.num_heads} heads, {L} layers, T {args.seq_len}, batch {bs}, "
        f"{CROSS_SILO_HIER_SEQS} sequences a silo ({nb} steps a local epoch), "
        f"{CROSS_SILO_HIER_ROUNDS} rounds in {wall:.3f} s (set-up included; the horizontal "
        f"world {flat_wall:.3f} s); final stats {stats}; flash launches {launches} (reckoned "
        f"{want}: {L} layers x {steps} steps, + {CROSS_SILO_HIER_ROUNDS} evaluations of "
        f"{passes} forward passes); plain flash calls {plain}; the global bitwise the "
        f"horizontal Client world's: {same}")
    if launches != want:
        fail(f"cross silo hierarchical: flash launches {launches}, reckoned {want}")
    if any(plain.values()):
        fail(f"cross silo hierarchical: the flash plain versions ran: {plain}")
    if not same:
        fail("cross silo hierarchical: the hierarchical global differs from the horizontal one")
    out.update(wall_s=wall, horizontal_wall_s=flat_wall, stats=stats, launches=launches,
               launches_reckoned=want, bitwise=same, steps=steps, eval_passes=passes)
    return out


def cs_artifacts(run: dict, telemetry_dir: str, checkpoint_dir: str) -> dict:
    """A World A run's exported artifacts read back: the port's invariant
    checker (ok, the ledger's counter balances checked) and ``cli trace``
    (one round analyzed a round run)."""
    report = checked_run("cross silo TRPC stream", telemetry_dir, checkpoint_dir,
                         ("ledger_counter_match", "counters_cover_ledger", "cohort_accounting"))
    trace = cli_json(["trace", "--telemetry-dir", telemetry_dir])
    log(f"cross silo TRPC stream: cli trace {trace}")
    if trace["rounds_analyzed"] != run["rounds"] or trace["flows"]["unmatched_starts"]:
        fail(f"cross silo TRPC stream: cli trace analyzed {trace['rounds_analyzed']} of "
             f"{run['rounds']} rounds, flows {trace['flows']}")
    return {"checked": report["checked"], "skipped": report["skipped"],
            "trace": {k: trace[k] for k in ("events", "flows", "rounds_analyzed")},
            "artifact_bytes": artifact_bytes(telemetry_dir), "telemetry_dir": telemetry_dir}


def cs_async_checked(dataset) -> dict:
    """World A in ``agg_mode: async`` (FedBuff-style publishes, the
    exactly-once ledger of ``[rank, seq]`` pairs) with its artifacts
    exported; the port's checker over them must be ok with the async
    ledger's invariants checked. K1 folds each upload."""
    import tempfile

    from fedml_tpu_torch.core.telemetry import Telemetry
    from fedml_tpu_torch.ops.exact_fold import FOLD_KERNEL

    Telemetry.reset()
    td, ck = tempfile.mkdtemp(prefix="cs_async_td_"), tempfile.mkdtemp(prefix="cs_async_ck_")
    server, clients, _ = cs_world("cs_async", "LOCAL", dataset, agg_mode="async",
                                  telemetry_dir=td, checkpoint_dir=ck)
    before = launch_counts()
    t0 = time.perf_counter()
    threads, errors = cs_threads([c.run for c in clients],
                                 [f"async-silo{i + 1}" for i in range(len(clients))])
    server.run()
    cs_join("cross silo async", threads, errors)
    wall = time.perf_counter() - t0
    launches = _delta(launch_counts(), before)
    folds = server.manager.async_folds
    report = checked_run("cross silo async", td, ck, (
        "exactly_once_folds", "no_reissued_seqs", "version_monotone", "published_counter_match",
        "no_lost_unreported_folds", "counters_cover_ledger"))
    log(f"cross silo async: {folds} folds in {server.manager.version} publishes, {wall:.3f} s "
        f"(host clock); K1 launches {launches[FOLD_KERNEL.name]}")
    if launches[FOLD_KERNEL.name] != folds:
        fail(f"cross silo async: K1 launched {launches[FOLD_KERNEL.name]} times for {folds} folds")
    return {"folds": folds, "publishes": server.manager.version, "wall_s": wall,
            "checked": report["checked"], "artifact_bytes": artifact_bytes(td),
            "launches": launches}


def run_cross_silo():
    """The fourteenth slice's phase: World A (the cross-silo config four
    ways), the restart, World B (the edge tier over ranks) and World C
    (hierarchical silos of the flash transformer). Every World A run, the
    restart and World B run under deterministic algorithms (their results
    are compared bitwise; cuDNN's convolution backward may sum with
    atomics otherwise)."""
    import tempfile

    reset_launches()  # count only this path's own launches
    out = {}
    with plain_fold_calls() as plain:
        with deterministic():
            runs = {
                "local_stream": cs_run("cross silo LOCAL stream", "cs_local_stream"),
            }
            ds = runs["local_stream"]["dataset"]
            runs["local_buffered"] = cs_run("cross silo LOCAL buffered", "cs_local_buffered",
                                            dataset=ds, agg_mode="buffered")
            # the exporters' rider: this run writes its artifacts and WAL,
            # which the port's checker and trace stitcher then read
            cs_dirs = {"telemetry_dir": tempfile.mkdtemp(prefix="cs_td_"),
                       "checkpoint_dir": tempfile.mkdtemp(prefix="cs_ck_")}
            runs["trpc_stream"] = cs_run("cross silo TRPC stream", "cs_trpc_stream", "TRPC",
                                         dataset=ds, **cs_dirs)
            runs["trpc_clip_int8"] = cs_run("cross silo TRPC clip int8", "cs_trpc_defended",
                                            "TRPC", dataset=ds,
                                            defense_type="norm_diff_clipping",
                                            compression="int8")
            base = runs["local_stream"]["params"]
            for name in ("local_buffered", "trpc_stream"):
                if not all(bits_equal(runs[name]["params"][k], base[k]) for k in base):
                    fail(f"cross silo: {name} differs from LOCAL stream")
            log("cross silo: LOCAL stream, LOCAL buffered and TRPC stream are bitwise equal")
            out["trpc_stream_artifacts"] = cs_artifacts(runs["trpc_stream"], **cs_dirs)
            out["async_artifacts"] = cs_async_checked(ds)
            out["restart"] = cs_restart(runs["local_stream"])
            out["edges"] = cs_edge_world(runs["local_stream"])
        out["hierarchical"] = cs_hierarchical()
    log(f"cross silo: plain fold and robust term calls {plain}")
    if any(plain.values()):
        fail(f"cross silo: the exact fold's or the robust term's plain version ran: {plain}")
    for name, run in runs.items():
        out[name] = {k: v for k, v in run.items() if k not in ("params", "dataset")}
    del runs
    torch.cuda.empty_cache()
    out["kernel_launches"] = launch_counts()
    return out


# -- the fifteenth slice: cross device -----------------------------------
BEEHIVE_CONFIG = REPO / "fedml_tpu_torch" / "configs" / "cross_device_beehive_lr.yaml"
LEGACY_CONFIG = REPO / "fedml_tpu_torch" / "configs" / "cross_device_mnist_lr.yaml"
# bench.py's point (bench.py:3833-3845): 8 features, 4 classes, 30% of
# each round's cohort vanishing at device.upload
BEEHIVE_FEATURES, BEEHIVE_CLASSES, BEEHIVE_VANISH = 8, 4, 0.3
CD_JOIN_S = 300.0  # the legacy world's threads must end within this
# the legacy plane runs 3 of the config's 10 rounds (tested after rounds 0
# and 2): at 10 it took 59.6 s of a 1,081.7 s script (1,200 s allowed) on
# an NVIDIA H100 80GB HBM3 at 700 W, whose host-bound phases vary 30-50%
# from call to call, and at 5 a run of the script on another such machine
# outlasted the 1,200 s
LEGACY_ROUNDS = 3
# the profiled Beehive world's trace runs this long before and after the
# world (left out of its wall). One whole-script call's trace missed ~3
# training steps and one K2 launch (2 of 3 K2, 2,067 of 2,135 launches);
# eight probes of the world alone missed none. A trace that does not
# hold every K2 launch is taken again, up to CD_TRACE_ATTEMPTS worlds;
# the phase fails if none does
CD_TRACE_PAUSE_S = 0.5
CD_TRACE_ATTEMPTS = 3


def paused_profiled_call(fn, pause: float = CD_TRACE_PAUSE_S):
    """``profiled_call`` with the profiler running ``pause`` seconds
    before and after ``fn``; the summary's wall is ``fn``'s alone."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activity = ProfilerActivity.CUDA if DEVICE == "cuda" else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        time.sleep(pause)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(pause)
    return out, kineto_summary(prof, wall)


@contextlib.contextmanager
def plain_synth_calls():
    """Counts the calls of K2's plain version while it is open: a path on
    the card must make none."""
    from fedml_tpu_torch.ops import synth_features as sf

    calls = {"synth_features_reference": 0}
    real = sf.synth_features_reference

    def counted(*a, **kw):
        calls["synth_features_reference"] += 1
        return real(*a, **kw)

    sf.synth_features_reference = counted
    try:
        yield calls
    finally:
        sf.synth_features_reference = real


def beehive_schedule(args) -> list:
    """bench.py's churn: each round's cohort drawn from a twin registry,
    its first 30% vanishing at upload."""
    from fedml_tpu_torch.cross_device.driver import beehive_cohort, beehive_registry

    twin, cohort, steps = beehive_registry(args), beehive_cohort(args), []
    for r in range(int(args.comm_round)):
        ids = twin.sample_available_cohort(r, cohort)
        for d in ids[:max(1, int(BEEHIVE_VANISH * len(ids)))]:
            steps.append({"at": {"event": "device.upload", "device": int(d), "round": r},
                          "fault": {"kind": "vanish"}})
    return steps


DEVICE_INVARIANTS = ("device_fold_requires_checkin", "device_masked_folds_balance",
                     "device_round_close_accounted", "device_mask_recovery_verified")


def checked_run(tag: str, telemetry_dir: str, checkpoint_dir: str, must_check) -> dict:
    """The port's ``InvariantChecker`` over a run's exported artifacts:
    fails unless the report is ``ok`` and checked every invariant of
    ``must_check``; returns the report."""
    from fedml_tpu_torch.core.invariants import InvariantChecker

    rep = InvariantChecker(telemetry_dir, checkpoint_dir).check().to_dict()
    log(f"{tag}: invariant checker ok={rep['ok']}, checked {rep['checked']}")
    missing = [n for n in must_check if n not in rep["checked"]]
    if not rep["ok"] or missing:
        fail(f"{tag}: the invariant checker's report {rep} (unchecked: {missing})")
    return rep


def beehive_world(tag: str, schedule, masked: bool, rounds=None, profiled=False) -> dict:
    """One world of the Beehive config on the card; its gates checked,
    its numbers returned."""
    import tempfile

    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_yaml_arguments
    from fedml_tpu_torch.core.chaos import reset_chaos
    from fedml_tpu_torch.core.checkpoint import RoundWAL
    from fedml_tpu_torch.core.telemetry import Telemetry
    from fedml_tpu_torch.cross_device import run_beehive_world

    a = load_yaml_arguments(str(BEEHIVE_CONFIG))
    a.run_id = f"cd-{tag.replace(' ', '-')}"
    a.crossdevice_secure_agg = masked
    a.chaos_schedule = schedule
    a.checkpoint_dir = tempfile.mkdtemp(prefix="cd_ck_")
    a.telemetry_dir = tempfile.mkdtemp(prefix="cd_td_")
    if rounds is not None:
        a.comm_round = rounds
    a._validate()
    fedml_tpu_torch.init(a)
    Telemetry.reset()
    reset_chaos()

    def world():
        return run_beehive_world(a, feature_dim=BEEHIVE_FEATURES, class_num=BEEHIVE_CLASSES,
                                 device=DEVICE)

    t0 = time.perf_counter()
    out, summary = paused_profiled_call(world) if profiled else (world(), None)
    wall = time.perf_counter() - t0
    tel = Telemetry.get_instance()
    counters = {k: tel.get_counter(k) for k in (
        "device_checkins_total", "device_uploads_folded_total", "device_uploads_late_total",
        "device_mask_recoveries_total", "device_mask_recovery_failures_total")}
    wal = [r for r in RoundWAL(a.checkpoint_dir).records() if r.get("kind") == "crossdevice"]
    recs = out["round_records"]
    folds = sum(r["folds"] for r in recs)
    for rec in recs:
        if rec["close_reason"] != "target" or rec["folds"] < rec["fold_target"]:
            fail(f"cross device {tag}: round {rec['round_idx']} closed {rec}")
    if counters["device_uploads_folded_total"] != sum(len(r["folded"]) for r in wal):
        fail(f"cross device {tag}: the WAL's fold ledger differs from the fold counter "
             f"{counters}")
    report = checked_run(f"cross device {tag}", a.telemetry_dir, a.checkpoint_dir,
                         DEVICE_INVARIANTS)
    if out["trace_count"] != len(out["shape_keys"]):
        fail(f"cross device {tag}: {out['trace_count']} group functions for "
             f"{len(out['shape_keys'])} (tier, bucket) shapes")
    n = len(recs)
    numbers = {"rounds": n, "wall_s": wall, "seconds_a_round": wall / n,
               "folds": folds, "folds_per_s": folds / wall,
               "train_s_a_round": out["train_s"] / n, "mask_s_a_round": out["mask_s"] / n,
               "fold_s_a_round": out["fold_s"] / n, "round_records": recs,
               "shape_keys": [list(k) for k in out["shape_keys"]],
               "groups_trained": out["groups_trained"], "counters": counters,
               "final_flat": out["final_flat"], "invariants": report["checked"]}
    log(f"cross device {tag}: {n} rounds in {wall:.3f} s (host clock), {folds} folds, "
        f"{folds / wall:.1f} folds/s, {wall / n:.3f} s a round: training "
        f"{out['train_s'] / n:.3f} s, masking {out['mask_s'] / n:.3f} s, folding "
        f"{out['fold_s'] / n:.3f} s (host timers); {out['groups_trained']} groups, shapes "
        f"{out['shape_keys']}; records {recs}")
    if summary is not None:
        numbers["profile"] = profile_summary(f"cross device {tag} (profiled)", summary,
                                             PLANET_KINDS)
        k2 = {k: v for k, v in summary["device_s_by_kernel"].items() if "synth_kernel" in k}
        k2n = sum(v for k, v in summary["device_launches_by_kernel"].items()
                  if "synth_kernel" in k)
        numbers["k2_device_ms"] = sum(k2.values()) * 1e3 / max(k2n, 1)
        numbers["k2_traced_launches"] = k2n
        log(f"cross device {tag}: K2 {k2n} launches in the trace, "
            f"{numbers['k2_device_ms']:.4f} ms device time each")
    return numbers


def cd_beehive() -> dict:
    """The Beehive part: masked and unmasked worlds under one churn
    schedule, then a one-round masked world under the profiler."""
    from fedml_tpu_torch.arguments import load_yaml_arguments
    from fedml_tpu_torch.cross_device.driver import beehive_registry
    from fedml_tpu_torch.ops.synth_features import SYNTH_KERNEL

    args = load_yaml_arguments(str(BEEHIVE_CONFIG))
    schedule = beehive_schedule(args)
    registry_bytes = beehive_registry(args).nbytes()
    reset_launches()
    with plain_synth_calls() as plain:
        masked = beehive_world("masked", schedule, True)
        unmasked = beehive_world("unmasked", schedule, False)
        traced = []
        for attempt in range(CD_TRACE_ATTEMPTS):
            traced.append(beehive_world(f"profiled {attempt}", schedule, True, rounds=1,
                                        profiled=True))
            if traced[-1]["k2_traced_launches"] == traced[-1]["groups_trained"]:
                break
            log(f"cross device: trace {attempt} holds {traced[-1]['k2_traced_launches']} K2 "
                f"launches for {traced[-1]['groups_trained']} groups: it dropped events")
    launches = launch_counts()
    profiled = traced[-1]
    diff = float(np.max(np.abs(masked["final_flat"] - unmasked["final_flat"])))
    if diff != 0.0 or masked["final_flat"].tobytes() != unmasked["final_flat"].tobytes():
        fail(f"cross device: masked and unmasked worlds differ (max abs diff {diff})")
    if not any(r["recovered"] > 0 for r in masked["round_records"]):
        fail("cross device: the masked world recovered no vanished device's mask")
    groups = sum(w["groups_trained"] for w in [masked, unmasked] + traced)
    if SYNTH_KERNEL.launches != groups:
        fail(f"cross device: K2 launched {SYNTH_KERNEL.launches} times for {groups} "
             "(tier, bucket) groups")
    if profiled["k2_traced_launches"] != profiled["groups_trained"]:
        fail(f"cross device: {len(traced)} profiled worlds' traces each missed K2 launches "
             f"(the last holds {profiled['k2_traced_launches']} for "
             f"{profiled['groups_trained']} groups)")
    if any(plain.values()):
        fail(f"cross device: K2's plain version ran: {plain}")
    log(f"cross device: masked == unmasked bitwise (max abs diff {diff}); K2 "
        f"{SYNTH_KERNEL.launches} launches = {groups} groups; registry "
        f"{registry_bytes} B; plain K2 calls {plain}")
    for w in [masked, unmasked] + traced:
        del w["final_flat"]
    return {"masked": masked, "unmasked": unmasked, "profiled": profiled,
            "trace_attempts": len(traced),
            "masked_vs_unmasked_max_abs_diff": diff, "registry_bytes": registry_bytes,
            "kernel_launches": launches}


def cd_legacy() -> dict:
    """The legacy part: ``run_edge_server``'s ``ServerEdge`` (built as it
    builds it) and 10 ``EdgeClientSim`` threads over MQTT."""
    import tempfile
    import threading

    import fedml_tpu_torch
    from fedml_tpu_torch import data, models
    from fedml_tpu_torch.arguments import load_yaml_arguments
    from fedml_tpu_torch.core.comm.payload_store import FilePayloadStore
    from fedml_tpu_torch.core.local_trainer import make_local_train_fn
    from fedml_tpu_torch.core.optimizers import create_client_optimizer
    from fedml_tpu_torch.core.types import Batches
    from fedml_tpu_torch.cross_device import EdgeClientSim, ServerEdge, params_to_model_bytes

    a = load_yaml_arguments(str(LEGACY_CONFIG))
    a.run_id = "cd-legacy"
    a.comm_round = LEGACY_ROUNDS
    a.payload_store_dir = tempfile.mkdtemp(prefix="cd_store_")
    a._validate()
    dev = torch.device(DEVICE)
    fedml_tpu_torch.init(a, dev)
    ds = data.load(a, device=dev)
    store = FilePayloadStore(a.payload_store_dir)
    reset_launches()
    server = ServerEdge(a, DEVICE, ds, models.create(a, ds.class_num, device=dev), store=store)
    n = int(a.client_num_per_round)
    clients = []
    for rank in range(1, n + 1):
        model = models.create(a, ds.class_num, device=dev)  # a module a thread
        trainer = make_local_train_fn(model.apply, model.loss_fn, create_client_optimizer(a),
                                      epochs=int(a.epochs))
        local = Batches(x=ds.packed_train.x[rank - 1], y=ds.packed_train.y[rank - 1],
                        mask=ds.packed_train.mask[rank - 1])
        clients.append(EdgeClientSim(a, trainer, local, store, rank=rank, size=n + 1))
    threads = [threading.Thread(target=server.run, name="edge-server", daemon=True)]
    threads += [threading.Thread(target=c.run, name=f"edge-client-{c.rank}", daemon=True)
                for c in clients]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(CD_JOIN_S)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        fail(f"cross device legacy: threads still running after {CD_JOIN_S} s")
    launches = launch_counts()
    rounds, freq = int(a.comm_round), int(a.frequency_of_the_test)
    want = [r for r in range(rounds) if r % freq == 0 or r == rounds - 1]
    hist = server.aggregator.history
    if [h["round"] for h in hist] != want:
        fail(f"cross device legacy: evaluated rounds {[h['round'] for h in hist]}, want {want}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        fail(f"cross device legacy: the test loss did not fall: {hist}")
    if server.manager.finish_acks != {r: True for r in range(1, n + 1)}:
        fail(f"cross device legacy: FINISH acks {server.manager.finish_acks}")
    file_bytes = len(params_to_model_bytes(server.aggregator.global_params))
    log(f"cross device legacy: {rounds} rounds of {n} edge clients over MQTT in {wall:.3f} s "
        f"(host clock), {rounds / wall:.4f} rounds/s; a model file {file_bytes} B; history "
        f"{hist}; every client acknowledged FINISH")
    return {"rounds": rounds, "clients": n, "wall_s": wall, "rounds_per_s": rounds / wall,
            "model_file_bytes": file_bytes, "history": hist, "kernel_launches": launches}


def cd_centralized() -> dict:
    """The centralized part: ``CentralizedTrainer`` on the bf16 flash
    transformer config, one epoch of the coalesced training split."""
    import fedml_tpu_torch
    from fedml_tpu_torch import data, models
    from fedml_tpu_torch.arguments import load_yaml_arguments
    from fedml_tpu_torch.centralized import CentralizedTrainer
    from fedml_tpu_torch.core.local_trainer import eval_batches_per_pass
    from fedml_tpu_torch.ops.flash_attention import BWD_KERNEL, FWD_KERNEL

    a = load_yaml_arguments(str(TRANSFORMER_CONFIG))
    a.epochs = 1
    a._validate()
    dev = torch.device(DEVICE)
    fedml_tpu_torch.init(a, dev)
    ds = data.load(a, device=dev)
    model = models.create(a, ds.class_num, device=dev)
    trainer = CentralizedTrainer(a, DEVICE, ds, model)
    train, test = ds.train_data_global, ds.test_data_global

    def passes(b):
        return -(-(b.mask.numel() // b.batch_size) // eval_batches_per_pass(b))

    steps, layers = int(train.mask.shape[0]), int(a.num_layers)
    fwd_want = layers * (steps + 2 * passes(train) + passes(test))
    bwd_want = layers * steps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    inner = trainer._train_fn

    def timed(*args, **kw):
        start.record()
        out = inner(*args, **kw)
        end.record()
        return out

    trainer._train_fn = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with plain_flash_calls() as plain:
        before = model.metrics_from_sums(trainer._eval(trainer.params, train))
        final = trainer.train()
        end.synchronize()
    launches = launch_counts()
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() / 2**20
    tokens = steps * train.batch_size * int(a.seq_len)
    if launches[FWD_KERNEL.name] != fwd_want or launches[BWD_KERNEL.name] != bwd_want:
        fail(f"centralized: flash launches forward {launches[FWD_KERNEL.name]}, backward "
             f"{launches[BWD_KERNEL.name]}; the reckoning {fwd_want}, {bwd_want}")
    if any(plain.values()):
        fail(f"centralized: the flash plain versions ran: {plain}")
    if not final["train_loss"] < before["loss"]:
        fail(f"centralized: the train loss did not fall ({before['loss']} -> "
             f"{final['train_loss']})")
    log(f"centralized: {steps} steps of [{train.batch_size}, {a.seq_len}] in {ms:.1f} ms on "
        f"the card's clock, {ms / steps:.3f} ms a step, {tokens / (ms / 1e3):.0f} tokens/s; "
        f"peak {peak:.1f} MiB; train loss {before['loss']:.4f} -> {final['train_loss']:.4f}, "
        f"test loss {final['test_loss']:.4f}; flash {launches[FWD_KERNEL.name]} forward = "
        f"{layers} x ({steps} + 2 x {passes(train)} + {passes(test)}), "
        f"{launches[BWD_KERNEL.name]} backward = {layers} x {steps}; plain flash calls {plain}")
    return {"steps": steps, "train_ms": ms, "step_ms": ms / steps,
            "tokens_per_s": tokens / (ms / 1e3), "peak_mib": peak,
            "train_loss_before": before["loss"], "record": final,
            "flash_forward_wanted": fwd_want, "flash_backward_wanted": bwd_want,
            "kernel_launches": launches}


def run_cross_device():
    """The fifteenth slice's phase: the Beehive worlds, the legacy
    plane and the centralized trainer, each path's launches counted from
    0 just before it."""
    out = {"beehive": cd_beehive(), "legacy": cd_legacy(), "centralized": cd_centralized()}
    torch.cuda.empty_cache()
    return out

# -- the sixteenth slice: the exporters, the checker, elastic preemption ----
ELASTIC_PREEMPT_AT = 1
# the mesh drill runs 3 of the FEMNIST config's 4 rounds: preempted after
# round 1, resumed for round 2
ELASTIC_MESH_ROUNDS = 3
ELASTIC_STALL_S = 120.0  # the healthy run's watchdog timeout: no bundle may land
ELASTIC_LIMB_UPLOADS = 4
ELASTIC_ARTIFACTS = ("trace.json", "metrics.prom", "telemetry.jsonl")
PREEMPT_INVARIANTS = ("preempt_paired_with_checkpoint", "preempt_resume_continuity")


def cli_json(argv) -> dict:
    """``python -m fedml_tpu_torch.cli`` in this process: fails unless it
    exits 0; its JSON line."""
    import contextlib
    import io

    from fedml_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    if rc != 0:
        fail(f"cli {argv}: exit {rc}: {buf.getvalue()}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def artifact_bytes(telemetry_dir: str) -> dict:
    return {name: os.path.getsize(os.path.join(telemetry_dir, name))
            for name in sorted(os.listdir(telemetry_dir))
            if name.endswith((".json", ".prom", ".jsonl"))}


def wal_kinds(checkpoint_dir: str) -> list:
    from fedml_tpu_torch.core.checkpoint import RoundWAL

    return [r.get("kind") for r in RoundWAL(checkpoint_dir).records()]


def first_round_clock(api, t0: float) -> list:
    """Seconds from ``t0`` to the end, on the card, of the first round
    ``api`` runs (its first round function call waited for): the resume's
    recovery time. Measurement only."""
    got, real = [], api._round_fn

    def round_fn(*a, **kw):
        out = real(*a, **kw)
        if not got:
            torch.cuda.synchronize()
            got.append(time.perf_counter() - t0)
        return out

    api._round_fn = round_fn
    return got


def elastic_transformer_drill() -> dict:
    """The transformer preempt drill at the resume check's depth: the bf16
    flash transformer configuration, depth 4, ``checkpoint_freq`` 2,
    preempted at round 1 (a cadence round: the forced save is skipped);
    a world built anew from the configuration and the checkpoint
    directory resumes to round RESUME_ROUNDS. Gates: ``Preempted`` with
    round and step 1, the WAL ``["preempt"]`` then ``["preempt",
    "resume"]``, the final params bitwise the resume check's straight
    run, flash launches as the steps reckon and no plain version, the
    checker ok with both preempt invariants checked."""
    import tempfile

    from fedml_tpu_torch.ops.flash_attention import BWD_KERNEL, FWD_KERNEL
    from fedml_tpu_torch.parallel.elastic import Preempted, SimulatedPreemption, recovery_clock

    straight = RESUME_STRAIGHT["transformer"]
    reset_launches()
    with tempfile.TemporaryDirectory(prefix="elastic_tf_") as ck, deterministic(), \
            plain_flash_calls() as plain:
        knobs = {"checkpoint_dir": ck, "checkpoint_freq": RESUME_FREQ}
        sim = _sim(TRANSFORMER_CONFIG, 4, RESUME_ROUNDS, RESUME_FREQ, **knobs)
        api = sim.fl_trainer
        L, steps = int(api.args.num_layers), api.dataset.packed_train.num_batches * api.epochs
        passes = eval_passes(api.dataset)
        api._preempt_signal = SimulatedPreemption(ELASTIC_PREEMPT_AT)
        try:
            sim.run()
            fail("elastic transformer: the run was not preempted")
        except Preempted as e:
            stopped = (e.round_idx, e.ckpt_step)
        kinds_after_preempt = wal_kinds(ck)
        del sim, api
        torch.cuda.empty_cache()
        t0 = recovery_clock()
        sim = _sim(TRANSFORMER_CONFIG, 4, RESUME_ROUNDS, RESUME_FREQ, **knobs)
        recovery = first_round_clock(sim.fl_trainer, t0)
        sim.run()
        params = {k: v.detach().clone() for k, v in sim.fl_trainer.global_params.items()}
        kinds = wal_kinds(ck)
        report = checked_run("elastic transformer", None, ck, PREEMPT_INVARIANTS)
        del sim
    launches = launch_counts()
    rounds = RESUME_ROUNDS  # rounds 0-1 before the preemption, the rest after
    evals = len([r for r in range(rounds) if r % RESUME_FREQ == 0 or r == rounds - 1])
    want = {**no_launches(), FWD_KERNEL.name: L * (rounds * steps + evals * passes),
            BWD_KERNEL.name: L * rounds * steps}
    unequal = [k for k in straight if not torch.equal(params[k], straight[k])]
    log(f"elastic transformer on {card_line()}: preempted at {stopped} (round, step), WAL "
        f"{kinds_after_preempt} then {kinds}; recovery {recovery[0]:.3f} s from the restart "
        f"world's build to its first round done on the card (host clock); params differing "
        f"bitwise from the straight run {len(unequal)} of {len(straight)}; flash launches "
        f"{launches} (reckoned {want}: {L} layers x {rounds} rounds x {steps} steps + "
        f"{evals} evaluations x {passes} passes); plain calls {plain}")
    if stopped != (ELASTIC_PREEMPT_AT, ELASTIC_PREEMPT_AT):
        fail(f"elastic transformer: preempted at {stopped}")
    if kinds_after_preempt != ["preempt"] or kinds != ["preempt", "resume"]:
        fail(f"elastic transformer: WAL kinds {kinds_after_preempt} then {kinds}")
    if unequal:
        fail(f"elastic transformer: the resumed run differs from the straight one in {unequal}")
    if launches != want or any(plain.values()):
        fail(f"elastic transformer: flash launches {launches}, reckoned {want}; plain {plain}")
    return {"card": card_line(), "preempted": list(stopped), "wal": kinds,
            "recovery_s": recovery[0], "bitwise_equal": True, "checked": report["checked"],
            "kernel_launches": launches}


def elastic_mesh_args(**knobs):
    from fedml_tpu_torch.arguments import load_yaml_arguments

    args = load_yaml_arguments(str(FEDAVG_CONFIG))
    args.comm_round, args.mesh_shape, args.log_metrics = (
        ELASTIC_MESH_ROUNDS, dict(MESH_SHAPE), False)
    for k, v in knobs.items():
        setattr(args, k, v)
    args._validate()
    return args


def elastic_mesh_run(args, preempt_at=None, t0=None) -> dict:
    """``run_simulation(backend="MESH")`` on ``args`` in a NCCL world of
    one rank built for it; the params whole, whether it was preempted,
    the recovery clock (with ``t0``) and the /metrics body a scrape got
    after its first evaluated round (with ``metrics_port``)."""
    import urllib.request

    import fedml_tpu_torch
    from fedml_tpu_torch.core import sys_stats
    from fedml_tpu_torch.core.telemetry import Telemetry
    from fedml_tpu_torch.core.tracking import MetricsReporter
    from fedml_tpu_torch.parallel.elastic import Preempted, SimulatedPreemption
    from fedml_tpu_torch.simulation import simulator

    out, real_init = {"preempted": None, "scrape": None}, simulator.SimulatorMesh.__init__
    port = int(getattr(args, "metrics_port", 0) or 0)

    def scrape(stats):
        if port and out["scrape"] is None:
            url = f"http://127.0.0.1:{port}/metrics"
            # straight to the loopback server, whatever proxy the
            # environment names
            direct = urllib.request.build_opener(urllib.request.ProxyHandler({}))
            with direct.open(url, timeout=10) as resp:
                out["scrape"] = resp.read().decode()

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        api = out["api"] = self.fl_trainer
        if preempt_at is not None:
            api._preempt_signal = SimulatedPreemption(preempt_at)
        if t0 is not None:
            out["recovery"] = first_round_clock(api, t0)
        api.metrics_reporter.add_sink(
            lambda rec: scrape(rec) if rec.get("kind") == "server_train" else None)

    Telemetry.reset()
    sampler = None
    if port:  # the card's memory streamed into the sys_* gauges while the run lasts
        sampler = sys_stats.SysStats(MetricsReporter(None, keep_history=False), 0.25,
                                     telemetry=Telemetry.get_instance(args),
                                     device=torch.cuda.current_device()).start()
    simulator.SimulatorMesh.__init__ = init
    try:
        with world_of_one():
            try:
                fedml_tpu_torch.run_simulation("MESH", device=DEVICE, args=args)
            except Preempted as e:
                out["preempted"] = (e.round_idx, e.ckpt_step)
            api = out.pop("api")
            out["params"] = {k: v.detach().clone() for k, v in api.full_params().items()}
            out["mesh_shape"] = dict(api.mesh.shape)
    finally:
        simulator.SimulatorMesh.__init__ = real_init
        if sampler is not None:
            sampler.stop()
    return out


def elastic_limb_travel(template) -> dict:
    """Limb travel at the CNN's width: four uploads near ``template``
    (its 8 leaves, 428,350 params), folded 0-1, exported,
    ``reshape_limb_state`` onto the world's ``{data: 1, fsdp: 1}`` mesh,
    ``fold_limbs``, then folded 2-3 there; raw (K1 a fold) and
    int8-encoded deltas against ``template`` (K3 then K1). Gates: each
    bitwise the unsplit fold of all four; K1/K3 launches as reckoned; no
    plain fold or term."""
    from fedml_tpu_torch.core.aggregation import StreamingAccumulator
    from fedml_tpu_torch.core.compression import Int8Codec
    from fedml_tpu_torch.ops.exact_fold import FOLD_KERNEL
    from fedml_tpu_torch.ops.robust_term import TERM_KERNEL
    from fedml_tpu_torch.parallel.elastic import reshape_limb_state, surviving_mesh

    gen = torch.Generator(device=DEVICE).manual_seed(20)
    ups = [{k: v + 1e-2 * torch.randn(v.shape, generator=gen, device=DEVICE)
            for k, v in template.items()} for _ in range(ELASTIC_LIMB_UPLOADS)]
    ws = [3.0, 1.0, 5.0, 2.0]
    codec = Int8Codec()
    enc = [codec.encode({k: u[k] - template[k] for k in u}) for u in ups]
    out = {}
    with world_of_one(), plain_fold_calls() as plain:
        mesh = surviving_mesh(mesh_shape=dict(MESH_SHAPE), device_type=DEVICE)
        for mode in ("raw", "int8"):
            def fold(acc, i, _mode=mode):
                if _mode == "raw":
                    acc.fold(ups[i], ws[i])
                else:
                    acc.fold_encoded(codec, enc[i], template, ws[i])

            before = launch_counts()
            ref, old = StreamingAccumulator(template), StreamingAccumulator(template)
            for i in range(4):
                fold(ref, i)
            for i in range(2):
                fold(old, i)
            state = reshape_limb_state(old.export_state(), mesh)
            new = StreamingAccumulator(template)
            new.fold_limbs(state["limbs"], state["total_w"], count=state["count"])
            for i in (2, 3):
                fold(new, i)
            a, b = ref.finalize(), new.finalize()
            launches = _delta(launch_counts(), before)
            want = {**no_launches(), FOLD_KERNEL.name: 4 + 2 + 1 + 2,
                    TERM_KERNEL.name: 0 if mode == "raw" else 4 + 2 + 2}
            unequal = [k for k in a if not bits_equal(a[k], b[k])]
            log(f"elastic limb travel ({mode}, {sum(v.numel() for v in template.values())} "
                f"params): {len(unequal)} leaves differ bitwise from the unsplit fold; count "
                f"{new.count}, total_w {new.total_w}; launches {launches} (reckoned {want})")
            if unequal or new.count != 4 or new.total_w != ref.total_w:
                fail(f"elastic limb travel ({mode}): differs from the unsplit fold: {unequal}")
            if launches != want:
                fail(f"elastic limb travel ({mode}): launches {launches}, reckoned {want}")
            out[mode] = {"bitwise_equal": True, "launches": launches}
    if any(plain.values()):
        fail(f"elastic limb travel: a plain fold or term ran: {plain}")
    return out


def elastic_mesh_drill() -> dict:
    """The mesh drill and the exporters on the card: the FEMNIST CNN on
    SimulatorMesh {data: 1, fsdp: 1} (a NCCL world of one), ELASTIC_MESH_ROUNDS
    rounds, under deterministic algorithms. The straight run exports its
    artifacts (``telemetry_dir``), serves /metrics on a free loopback port
    (scraped once after its first evaluated round) and arms the stall
    watchdog; a run preempted at round 1, then a world built anew resumes
    it at {1, 1}. Then limb travel at the CNN's width. Gates: resumed ==
    straight bitwise; K1 ``weighted_mean`` a leaf a round trained; the
    scrape carries the run's counters and the card's memory gauges; the
    three artifacts written and no stall bundle; ``cli trace`` and ``cli
    check`` exit 0; the checker ok with both preempt invariants."""
    import tempfile

    from fedml_tpu_torch.core.telemetry import Telemetry
    from fedml_tpu_torch.ops.exact_fold import MEAN_KERNEL
    from fedml_tpu_torch.parallel.elastic import recovery_clock

    reset_launches()
    td = tempfile.mkdtemp(prefix="elastic_td_")
    ck = tempfile.mkdtemp(prefix="elastic_ck_")
    port = free_port_block(1)
    with deterministic(), timed_calls(Telemetry, "export_run_artifacts") as exports:
        straight = elastic_mesh_run(elastic_mesh_args(
            telemetry_dir=td, metrics_port=port, stall_timeout_s=ELASTIC_STALL_S))
        stopped = elastic_mesh_run(elastic_mesh_args(checkpoint_dir=ck),
                                   preempt_at=ELASTIC_PREEMPT_AT)
        kinds_after_preempt = wal_kinds(ck)
        t0 = recovery_clock()
        resumed = elastic_mesh_run(elastic_mesh_args(checkpoint_dir=ck), t0=t0)
    leaves = len(straight["params"])
    launches = launch_counts()
    want = {**no_launches(),
            MEAN_KERNEL.name: leaves * (ELASTIC_MESH_ROUNDS + (ELASTIC_PREEMPT_AT + 1)
                                        + (ELASTIC_MESH_ROUNDS - ELASTIC_PREEMPT_AT - 1))}
    unequal = [k for k in straight["params"]
               if not bits_equal(straight["params"][k], resumed["params"][k])]
    kinds = wal_kinds(ck)
    report = checked_run("elastic mesh", None, ck, PREEMPT_INVARIANTS)
    files = artifact_bytes(td)
    bundles = [n for n in os.listdir(td) if n.startswith("stall_bundle")]
    scrape = straight["scrape"] or ""
    trace = cli_json(["trace", "--telemetry-dir", td])
    check = cli_json(["check", "--telemetry-dir", td])
    card = card_line()
    log(f"elastic mesh on {card}: {ELASTIC_MESH_ROUNDS} rounds at {straight['mesh_shape']}; "
        f"preempted at {stopped['preempted']}, WAL {kinds_after_preempt} then {kinds}; "
        f"recovery {resumed['recovery'][0]:.3f} s (restart world's build to its first round "
        f"done on the card, host clock); params differing bitwise from the straight run "
        f"{len(unequal)} of {leaves}; K1 weighted_mean launches {launches[MEAN_KERNEL.name]} "
        f"(reckoned {want[MEAN_KERNEL.name]}: {leaves} leaves a round trained)")
    log(f"elastic exporters on {card}: export {['%.4f' % t for t in exports['export_run_artifacts']]}"
        f" s; artifacts {files} B; stall bundles {bundles}; /metrics scrape {len(scrape)} B, "
        f"sys_ lines {sum(1 for l in scrape.splitlines() if l.startswith('sys_device'))} "
        f"device; cli trace {trace}; cli check ok={check['ok']}")
    if stopped["preempted"] != (ELASTIC_PREEMPT_AT, ELASTIC_PREEMPT_AT):
        fail(f"elastic mesh: preempted at {stopped['preempted']}")
    if kinds_after_preempt != ["preempt"] or kinds != ["preempt", "resume"]:
        fail(f"elastic mesh: WAL kinds {kinds_after_preempt} then {kinds}")
    if unequal:
        fail(f"elastic mesh: the resumed run differs from the straight one in {unequal}")
    if launches != want:
        fail(f"elastic mesh: launches {launches}, reckoned {want}")
    if not set(ELASTIC_ARTIFACTS) <= set(files) or bundles:
        fail(f"elastic exporters: artifacts {files}, stall bundles {bundles}")
    if ("pipeline_rounds_dispatched_total{" not in scrape
            or "sys_device" not in scrape or "_bytes_limit" not in scrape):
        fail(f"elastic exporters: the /metrics scrape lacks the run's counters or the card's "
             f"memory gauges: {scrape[:2000]!r}")
    if not trace["events"] or not check["ok"]:
        fail(f"elastic exporters: cli trace {trace}, cli check {check}")
    limbs = elastic_limb_travel({k: v.to(DEVICE) for k, v in straight["params"].items()})
    launches = launch_counts()
    return {"card": card, "rounds": ELASTIC_MESH_ROUNDS, "preempted": list(stopped["preempted"]),
            "telemetry_dir": td,
            "wal": kinds, "recovery_s": resumed["recovery"][0], "bitwise_equal": True,
            "export_s": exports["export_run_artifacts"], "artifact_bytes": files,
            "scrape_bytes": len(scrape), "cli_trace": trace, "checked": report["checked"],
            "limb_travel": limbs, "kernel_launches": launches}


def run_elastic():
    """The sixteenth slice's phase: the transformer preempt drill, the
    mesh drill with the exporters, and limb travel. Each part is a path
    of its own in the kernels line (its counts reset just before it)."""
    return {"transformer": elastic_transformer_drill(), "mesh": elastic_mesh_drill()}


# -- the eighteenth slice: audit and perf ---------------------------------
AUDIT_CHILD_FLAG = "--audit-child"
AUDIT_CHILD_TIMEOUT_S = 120
AUDIT_EXECUTABLES = 9  # the JAX registry's names
AUDIT_CASES = 16  # and its census keys
PERF_MIN_COVERAGE = 0.9  # the JAX plane's default gate
LEDGER_RECON_TOL = 0.05  # a round's ledger accounts for its wall within 5%
AUDIT_PERF_BUDGET_S = 30.0  # the phase's budget (reported when exceeded)


def audit_child(report: str) -> int:
    """``cli audit --ci --json`` in a process started with no card visible
    (its fake tensors sit on ``meta`` in any case); then one JSON line: its
    exit code, whether CUDA was initialised, the hand kernels' launch
    counts."""
    from fedml_tpu_torch.cli import main as cli_main
    from fedml_tpu_torch.ops.exact_fold import FOLD_KERNEL, MEAN_KERNEL
    from fedml_tpu_torch.ops.robust_term import TERM_KERNEL

    rc = cli_main(["audit", "--ci", "--json", "--report", report])
    print(json.dumps({
        "rc": rc, "cuda_initialized": torch.cuda.is_initialized(),
        "launches": {k.name: k.launches for k in (FOLD_KERNEL, MEAN_KERNEL, TERM_KERNEL)},
    }), flush=True)
    return rc


def run_audit_child(report: str) -> dict:
    """The audit child: its gate line and the audit's JSON line."""
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), AUDIT_CHILD_FLAG, report],
                         cwd=str(REPO), env=env, capture_output=True, text=True,
                         timeout=AUDIT_CHILD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    try:
        audit, gate = json.loads(lines[-2]), json.loads(lines[-1])
    except (IndexError, ValueError):
        audit = gate = None
    if out.returncode != 0 or gate is None:
        fail(f"cli audit child: exit {out.returncode}, stdout {out.stdout[-800:]!r}, "
             f"stderr {out.stderr[-1500:]!r}")
    return {"audit": audit, "gate": gate, "wall_s": wall}


def perf_report(argv) -> dict:
    """``cli perf`` in this process (exit 0 or the phase fails); its
    report file."""
    out = cli_json(["perf", *argv, "--quiet"])
    with open(out["report"]) as fh:
        return json.load(fh)


def run_audit_and_perf(elastic_mesh: dict, cross_silo: dict) -> dict:
    """The eighteenth slice's phase; it trains nothing. ``cli audit`` in a
    child process with no card visible (16 cases of 9 executables, CUDA
    never initialised there, no kernel launched); ``cli perf`` on the
    elastic phase's exporting mesh run (the round series
    ``simulation.round_fn_mesh`` joined, coverage at least 0.9, the card's
    bf16 peak from the port's table, the seconds' clock stated), on the
    cross-silo TRPC World A run's trace (every ledgered round within 5% of
    its wall) and ``--ratchet`` over the repo's BENCH records (exit 0, the
    3 groups of the JAX plane, BENCH_r01.json skipped)."""
    import glob
    import tempfile

    t0 = time.perf_counter()
    before = launch_counts()
    work = tempfile.mkdtemp(prefix="audit_perf_")
    report = os.path.join(work, "audit_report_torch.json")
    child = run_audit_child(report)
    audit, gate = child["audit"], child["gate"]
    with open(report) as fh:
        traced = json.load(fh)
    names = {e["executable"] for e in traced["executables"]}
    kind = torch.cuda.get_device_name(0)
    mesh = perf_report(["--telemetry-dir", elastic_mesh["telemetry_dir"], "--audit-report",
                        report, "--device-kind", kind, "--out",
                        os.path.join(work, "perf_mesh.json")])
    roof = mesh["roofline"]
    rows = {r["executable"]: r for r in roof["rows"]}
    silo = perf_report(["--telemetry-dir", cross_silo["trpc_stream_artifacts"]["telemetry_dir"],
                        "--audit-report", report, "--device-kind", kind, "--out",
                        os.path.join(work, "perf_cross_silo.json")])
    recon = [r["recon_frac"] for r in silo["ledger"]["rounds"]]
    ratchet = cli_json(["perf", "--ratchet", *sorted(glob.glob(str(REPO / "BENCH_*.json"))),
                        "--quiet"])
    skipped = [os.path.basename(s.split(":")[0]) for s in ratchet["skipped"]]
    moved = _delta(launch_counts(), before)
    wall = time.perf_counter() - t0
    card = card_line()
    log(f"audit on {card}: child exit {gate['rc']}, {audit['executables']} cases of "
        f"{len(names)} executables, findings {audit['total']}, CUDA initialised in the child "
        f"{gate['cuda_initialized']}, the child's launches {gate['launches']}, "
        f"{child['wall_s']:.2f} s (torch import and 16 fake-tensor traces)")
    log(f"perf on {card}: mesh run rows "
        f"{[(r['executable'], r['bucket'], r['calls'], r['device_seconds']) for r in roof['rows']]}"
        f" ({roof['seconds_clock']}), coverage {roof['coverage']}, peak "
        f"{roof['peak_bf16_flops']}; cross silo ledger recon {recon}, rows "
        f"{[(r['executable'], r['calls']) for r in silo['roofline']['rows']]}; ratchet "
        f"{[(g['phase'], g['device_kind'], g['smoke'], g['verdict']) for g in ratchet['groups']]}"
        f", skipped {skipped}; phase {wall:.2f} s")
    if gate["rc"] != 0 or not audit["ok"] or audit["executables"] != AUDIT_CASES \
            or len(names) != AUDIT_EXECUTABLES:
        fail(f"audit: exit {gate['rc']}, {audit}")
    if gate["cuda_initialized"] or any(gate["launches"].values()) or any(moved.values()):
        fail(f"audit: CUDA initialised {gate['cuda_initialized']}, the child's launches "
             f"{gate['launches']}, this process's {moved}")
    mesh_row = rows.get("simulation.round_fn_mesh")
    if not mesh_row or not mesh_row["joined"] or (roof["coverage"] or 0) < PERF_MIN_COVERAGE \
            or roof["peak_bf16_flops"] != peak_bf16_flops(H100_KIND) \
            or roof.get("seconds_clock") != "host wall clock around the call":
        fail(f"perf on the mesh run: {roof}")
    if not recon or any(r is None or abs(r - 1.0) > LEDGER_RECON_TOL for r in recon):
        fail(f"perf on the cross silo run: ledger recon {recon}")
    if not ratchet["ok"] or len(ratchet["groups"]) != 3 or ratchet["regressions"] \
            or skipped != ["BENCH_r01.json"]:
        fail(f"perf --ratchet: {ratchet}")
    if wall > AUDIT_PERF_BUDGET_S:
        # a budget, not a correctness gate: the child is host-bound (torch's
        # import and the fake mode's first use), and host time varies by
        # machine; the script's own deadline bounds the whole run
        log(f"audit and perf: {wall:.1f} s, over its {AUDIT_PERF_BUDGET_S} s budget")
    return {"audit": {"cases": audit["executables"], "executables": len(names),
                      "findings": audit["total"], "child_wall_s": child["wall_s"],
                      "cuda_initialized": gate["cuda_initialized"],
                      "fake_device": traced["fake_device"]},
            "perf_mesh": {"rows": roof["rows"], "coverage": roof["coverage"],
                          "seconds_clock": roof["seconds_clock"]},
            "perf_cross_silo": {"recon_frac": recon,
                                "coverage": silo["roofline"]["coverage"]},
            "ratchet": {"groups": len(ratchet["groups"]), "skipped": skipped},
            "wall_s": wall}


# -- the nineteenth slice: examples -------------------------------------------

EXAMPLES = ("simulation_sp/one_line", "simulation_sp/custom", "cross_device/one_line")
EXAMPLE_TIMEOUT_S = 240
EXAMPLES_BUDGET_S = 40.0  # the phase's budget (reported when exceeded)
# the JAX package's shipped simulation default (fedml_tpu/config/
# simulation_sp.yaml), but for the device
DEFAULT_TABLE = {"training_type": "simulation", "dataset": "mnist",
                 "client_num_in_total": 1000, "comm_round": 200, "batch_size": 10,
                 "weight_decay": 0.001, "learning_rate": 0.03, "device_type": "cuda"}
DEFAULT_CHILD = (
    "import json, fedml_tpu_torch\n"
    "a = fedml_tpu_torch.init()\n"
    f"print(json.dumps({{k: getattr(a, k) for k in {sorted(DEFAULT_TABLE)!r}}}))\n"
)


def run_examples():
    """The nineteenth slice's phase: three examples as a user runs them
    (``python main.py --cf fedml_config.yaml`` in a copy of the example's
    directory, its YAML unchanged, so on the card) and ``init()`` with no
    ``--cf``, four child processes side by side."""
    import ast
    import shutil
    import tempfile

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="examples_")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    children = {}
    for name in EXAMPLES:
        d = os.path.join(work, name.replace("/", "_"))
        shutil.copytree(REPO / "fedml_tpu_torch" / "examples" / name, d)
        children[name] = subprocess.Popen(
            [sys.executable, "main.py", "--cf", "fedml_config.yaml"], cwd=d, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    children["default config"] = subprocess.Popen(
        [sys.executable, "-c", DEFAULT_CHILD], cwd=work, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    outs, walls = {}, {}
    for name, proc in children.items():
        try:
            out, err = proc.communicate(timeout=max(1.0, EXAMPLE_TIMEOUT_S
                                                    - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for p in children.values():
                p.kill()
            fail(f"example {name}: no end within {EXAMPLE_TIMEOUT_S} s")
        walls[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"example {name}: exit {proc.returncode}, stdout {out[-800:]!r}, "
                 f"stderr {err[-2000:]!r}")
        outs[name] = out
    finals = {}
    for name in EXAMPLES:
        lines = [ln[len("FINAL:"):].strip() for ln in outs[name].splitlines()
                 if ln.startswith("FINAL:")]
        if len(lines) != 1:
            fail(f"example {name}: {len(lines)} FINAL lines in {outs[name][-800:]!r}")
        final = ast.literal_eval(lines[0])
        losses = {k: v for k, v in final.items() if "loss" in k}
        want_round = 1 if name.startswith("cross_device") else 4
        if not losses or not all(np.isfinite(v) for v in losses.values()) \
                or final.get("round") != want_round:
            fail(f"example {name}: FINAL {final}")
        finals[name] = final
    table = json.loads(outs["default config"].strip().splitlines()[-1])
    if table != DEFAULT_TABLE:
        fail(f"init() with no --cf resolved {table}, not {DEFAULT_TABLE}")
    wall = time.perf_counter() - t0
    card = card_line()
    log(f"examples on {card}: FINAL {json.dumps(finals)}; init() with no --cf {table}; "
        f"each child collected {json.dumps({k: round(v, 2) for k, v in walls.items()})} s "
        f"from the phase's start; phase {wall:.2f} s")
    if wall > EXAMPLES_BUDGET_S:
        # a budget, not a correctness gate: each child spends most of its
        # time importing torch and reaching the card
        log(f"examples: {wall:.1f} s, over its {EXAMPLES_BUDGET_S} s budget")
    return {"finals": finals, "default_table": table, "child_collected_s": walls, "wall_s": wall}


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

    start = time.perf_counter()
    # past the deadline every thread's stack goes to stderr and the script
    # exits 1, so that a run too slow for its caller's limit says where it was
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    walls = {}

    def phase(name, fn, *a):
        print(f"chip_smoke: phase {name} starts {time.perf_counter() - start:.1f} s in",
              file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = time.perf_counter() - t0
        log(f"phase {name}: {walls[name]:.1f} s wall")
        return out

    phase("build", build_kernels)
    kernels = [phase("kernels: flash forward", check_flash_kernel),
               phase("kernels: flash backward", check_flash_backward),
               *phase("kernels: flash rows", check_flash_rows),
               phase("kernels: exact fold", check_exact_fold),
               phase("kernels: synth features", check_synth_features),
               phase("kernels: robust term", check_robust_term)]
    long_sequence = phase("kernels: flash long sequence", check_long_sequence)
    for entry in kernels[:2]:  # the forward's and the backward's readings past tile 65,535
        entry["long_sequence"] = long_sequence
    slice_numbers = phase("serving", run_slice, kernels)
    log(f"slice numbers on {card}: {json.dumps(slice_numbers)}")
    serving_comm_numbers = phase("serving comm", run_serving_comm)
    log(f"serving comm numbers on {card}: {json.dumps(serving_comm_numbers, default=str)}")
    native_numbers = phase("native and compile cache", run_native_and_cache)
    log(f"native and compile cache numbers on {card}: {json.dumps(native_numbers, default=str)}")
    fedavg_numbers = phase("fedavg", run_fedavg)
    log(f"fedavg numbers on {card}: {json.dumps(fedavg_numbers)}")
    dense_numbers = phase("dense", run_dense)
    log(f"dense numbers on {card}: {json.dumps(dense_numbers)}")
    transformer_numbers = phase("transformer", run_transformer)
    log(f"transformer numbers on {card}: {json.dumps(transformer_numbers)}")
    transformer_f32_numbers = phase("transformer f32", run_transformer_f32,
                                    transformer_numbers["pipeline_check"]["eval_passes"])
    log(f"transformer f32 numbers on {card}: {json.dumps(transformer_f32_numbers)}")
    rnn_numbers = phase("rnn", run_rnn)
    log(f"rnn numbers on {card}: {json.dumps(rnn_numbers)}")
    so_numbers = phase("rnn stackoverflow", run_rnn_stackoverflow)
    log(f"rnn stackoverflow numbers on {card}: {json.dumps(so_numbers)}")
    seam_numbers = phase("seam", run_seam)
    log(f"seam numbers on {card}: {json.dumps(seam_numbers)}")
    resume_numbers = phase("resume", run_resume)
    log(f"resume numbers on {card}: {json.dumps(resume_numbers)}")
    remat_numbers = phase("remat", run_remat, transformer_numbers["pipeline_check"]["eval_passes"])
    log(f"remat numbers on {card}: {json.dumps(remat_numbers)}")
    planet_numbers = phase("planet", run_planet)
    log(f"planet numbers on {card}: {json.dumps(planet_numbers)}")
    tag_numbers = phase("tag prediction", run_tag_prediction)
    log(f"tag prediction numbers on {card}: {json.dumps(tag_numbers)}")
    leaf_numbers = phase("real files", run_real_files)
    log(f"real files numbers on {card}: {json.dumps(leaf_numbers)}")
    fedprox_numbers = phase("fedprox synthetic", run_fedprox_synthetic)
    log(f"fedprox synthetic numbers on {card}: {json.dumps(fedprox_numbers)}")
    poisoned_numbers = phase("poisoned worlds", run_poisoned_worlds)
    log(f"poisoned worlds numbers on {card}: {json.dumps(poisoned_numbers)}")
    defenses_numbers = phase("defenses", run_defenses)
    log(f"defenses numbers on {card}: {json.dumps(defenses_numbers)}")
    folds_numbers = phase("robust folds", run_robust_folds)
    log(f"robust folds numbers on {card}: {json.dumps(folds_numbers)}")
    other_numbers = phase("other algorithms", run_other_algorithms)
    log(f"other algorithms numbers on {card}: {json.dumps(other_numbers)}")
    dist_numbers = phase("distributed", run_distributed_phase)
    log(f"distributed numbers on {card}: {json.dumps(dist_numbers, default=str)}")
    mesh_numbers = phase("mesh", run_mesh_phase)
    log(f"mesh numbers on {card}: {json.dumps(mesh_numbers, default=str)}")
    cross_silo_numbers = phase("cross silo", run_cross_silo)
    log(f"cross silo numbers on {card}: {json.dumps(cross_silo_numbers, default=str)}")
    cross_device_numbers = phase("cross device", run_cross_device)
    log(f"cross device numbers on {card}: {json.dumps(cross_device_numbers, default=str)}")
    elastic_numbers = phase("elastic", run_elastic)
    log(f"elastic numbers on {card}: {json.dumps(elastic_numbers, default=str)}")
    audit_numbers = phase("audit and perf", run_audit_and_perf, elastic_numbers["mesh"],
                          cross_silo_numbers)
    log(f"audit and perf numbers on {card}: {json.dumps(audit_numbers, default=str)}")
    examples_numbers = phase("examples", run_examples)
    log(f"examples numbers on {card}: {json.dumps(examples_numbers, default=str)}")
    log(f"phase wall times (s): {json.dumps(walls)}")
    paths = {
        "serving": slice_numbers, "serving_comm": serving_comm_numbers,
        "native_and_cache": native_numbers,
        "fedavg_headline": fedavg_numbers,
        "fedavg_dense": dense_numbers, "fedavg_transformer": transformer_numbers,
        "fedavg_transformer_f32": transformer_f32_numbers, "fedavg_rnn": rnn_numbers,
        "fedavg_rnn_stackoverflow": so_numbers, "seam": seam_numbers,
        "resume": resume_numbers, "fedavg_transformer_remat": remat_numbers,
        "fedavg_planet": planet_numbers, "fedavg_tag_prediction": tag_numbers,
        "fedavg_real_files": leaf_numbers, "fedprox_synthetic": fedprox_numbers,
        "fedavg_poisoned_worlds": poisoned_numbers, "defenses": defenses_numbers,
        "robust_folds": folds_numbers,
        **{f"other_{tag}": numbers for tag, numbers in other_numbers.items()},
        **{f"distributed_{tag}": numbers for tag, numbers in dist_numbers.items()
           if isinstance(numbers, dict) and "kernel_launches" in numbers},
        **{f"mesh_{tag}": numbers for tag, numbers in mesh_numbers.items()},
        "cross_silo": cross_silo_numbers,
        **{f"cross_device_{tag}": numbers for tag, numbers in cross_device_numbers.items()},
        **{f"elastic_{tag}": numbers for tag, numbers in elastic_numbers.items()},
    }
    for entry in kernels:  # each path's own count, reset just before it
        entry["launches_by_path"] = {
            path: numbers["kernel_launches"][entry["name"]] for path, numbers in paths.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
    faulthandler.cancel_dump_traceback_later()
    log(f"chip_smoke: {time.perf_counter() - start:.1f} s from the start of main to the end")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [CACHE_CHILD_FLAG]:
        sys.exit(compile_cache_child(*sys.argv[2:4]))
    if sys.argv[1:2] == [AUDIT_CHILD_FLAG]:
        sys.exit(audit_child(sys.argv[2]))
    sys.exit(main())
