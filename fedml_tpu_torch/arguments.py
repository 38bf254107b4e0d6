"""Configuration: YAML -> flat ``Arguments`` (port of ``fedml_tpu/arguments.py``).

The subset the ported slices read: the YAML load and section
flattening, the defaults for the seed, the dataset and its
partitioning, the model geometry, the FedAvg training knobs, the
serving and fleet knobs, the comm layer's knobs, the cross-silo knobs
(aggregation mode, quorum, deadline, elastic membership, async
staleness, the silo's process group, the edge plane), the chaos
plane's, the telemetry exporters' (watchdog, ``/metrics`` server,
trace ring, devtime ring), elastic preemption's and the compile
cache's, and their validation. Every key of the JAX package's
``_DEFAULTS`` has an entry here with the JAX default, except that
``device_type`` defaults to ``"cuda"``. A YAML written for the JAX
package loads here unchanged; knobs without a default still land on
the object as the YAML sets them.

The command line and the entry points read it as the JAX package does:
``load_arguments(training_type, comm_backend)`` parses ``--cf``,
``--rank``, ``--local_rank``, ``--role`` and ``--run_id``; without
``--cf`` it reads the shipped default config of ``training_type``
(``config/simulation_sp.yaml``, ``cross_silo.yaml``,
``cross_device.yaml``: the JAX package's files but for ``device_type:
cuda`` in the first), and ``Arguments`` puts the pinned
``training_type`` and ``comm_backend`` over what the YAML says.
``load_yaml_arguments(path)`` reads one YAML file alone.

Validation imports nothing of JAX, and of the port only
``parallel/elastic.py``'s signal parser: the dtype knob is checked here
against its own table.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Any, Dict, Optional

import yaml

from . import constants

# Defaults applied when neither the YAML nor the caller provides a value.
_DEFAULTS: Dict[str, Any] = {
    "scenario": constants.FEDML_CROSS_SILO_SCENARIO_HORIZONTAL,
    "random_seed": 0,
    # data
    "dataset": "synthetic",
    # real files under <data_cache_dir>/<dataset>/ take precedence over
    # the synthetic stand-ins (data/loader.py)
    "data_cache_dir": "./data_cache",
    # fetch the dataset's archives into data_cache_dir when no local copy
    # exists (offline grace: a failed fetch falls back to the stand-in);
    # off by default so offline runs never stall
    "download": False,
    "partition_method": constants.PARTITION_HETERO,
    "partition_alpha": 0.5,
    # padded-packing long-tail policy: the shared num_batches is clamped
    # to waste_cap x the median client's; float("inf") disables
    "packing_waste_cap": 4.0,
    "image_size": 64,  # H=W of the resized-image stand-ins
    "synthetic_sigma": 1.0,  # synthetic feature noise scale
    "output_dim": 10,  # class/label count for the synthetic-style loaders
    "synthetic_feature_dim": 2000,  # tag-prediction stand-in feature width
    "synthetic_alpha": 1.0,  # fedprox-synthetic u_k spread
    "synthetic_beta": 1.0,  # fedprox-synthetic v_k spread
    # seq_len, synthetic_train_size and synthetic_test_size keep the JAX
    # package's per-site fallbacks, so they have no entry here: a stand-in's
    # size is min(the dataset's, 20000) for training and min(the dataset's,
    # 4000) for testing (data/loader.py), a next-token stand-in's length is
    # seq_len or else the dataset's own (shakespeare 80), and the
    # transformer reads seq_len or else 64 (models/__init__.py)
    # training
    "federated_optimizer": constants.FED_OPTIMIZER_FEDAVG,
    "client_num_in_total": 10,
    "client_num_per_round": 10,
    "comm_round": 10,
    "epochs": 1,
    "batch_size": 32,
    "client_optimizer": "sgd",
    "learning_rate": 0.03,
    "momentum": 0.0,
    "weight_decay": 0.0,
    # FedOpt's server optimizer: sgd | adam | adagrad | yogi
    "server_optimizer": "sgd",
    "server_lr": 1.0,
    "server_momentum": 0.0,
    "server_beta1": 0.9,  # FedOpt adam/yogi first-moment decay
    "server_beta2": 0.999,  # FedOpt adam/yogi second-moment decay
    "fedprox_mu": 0.0,
    # "vectorized" (vmap the cohort) or "sequential" (a loop per client)
    "sim_mode": "vectorized",
    "shuffle": True,  # reshuffle each client's examples every local epoch
    "frequency_of_the_test": 5,
    # learning-rate schedule: "constant" or "cosine", step-indexed
    # (lr_total_steps) or round-indexed (lr_total_rounds, FL)
    "lr_schedule": "constant",
    "lr_total_steps": 0,
    "warmup_steps": 0,
    "lr_total_rounds": 0,
    "warmup_rounds": 0,
    # "highest" keeps f32 products in f32 (TF32 off for cuBLAS and
    # cuDNN); "high"/"default" allow TF32, which changes results
    "matmul_precision": "highest",
    # round pipeline (vectorized mode): rounds in flight (1 = the
    # synchronous loop's behaviour; K>1 defers metric fetches so the hot
    # loop waits for nothing between flushes)
    "pipeline_depth": 1,
    # cohort bucket policy: "pow2" pads the sampled cohort up to the
    # next power of two (zero-weight, fully masked padding), "exact"
    # keeps its size
    "pipeline_bucket": "pow2",
    # checkpoint/resume (core/checkpoint.py): directory of the round
    # checkpoints, None disables them; a run whose directory holds one
    # resumes after its latest step
    "checkpoint_dir": None,
    # save every N completed rounds (and after the last); None = every 10
    "checkpoint_freq": None,
    # the kernels' build cache (core/compile_cache.py): the CUDA
    # libraries are built into and reused from this directory, and
    # hits/misses are counted in compile_cache_hits_total/_misses_total.
    # One directory per process. None = ops/build/ inside the package
    "compile_cache_dir": None,
    # metrics and profiling
    "log_metrics": True,  # mirror round metrics into the log
    "metrics_jsonl_path": None,  # also append them as JSON lines here
    # run artifacts land here: trace.json (the flight record),
    # metrics.prom (Prometheus text), telemetry.jsonl (registry
    # snapshots), stall debug bundles and profile captures. None = keep
    # everything in-process
    "telemetry_dir": None,
    # stall watchdog: when no progress heartbeat (pipeline round, comm
    # send/receive, cross-silo round) advances for this many seconds,
    # dump a debug bundle to telemetry_dir. 0 disables
    "stall_timeout_s": 0.0,
    # flight-recorder ring capacity (events); overflow evicts the oldest,
    # counted in telemetry_trace_dropped_total and the trace's meta
    "trace_ring_size": 65536,
    # devtime wall-clock ring capacity (core/devtime.py): per-call
    # {executable, bucket, seconds} entries
    "devtime_ring_size": 4096,
    # serve Telemetry.prometheus_text() at
    # http://<metrics_host>:<metrics_port>/metrics for the run's
    # lifetime; 0 = off. Loopback unless metrics_host says otherwise
    "metrics_port": 0,
    "metrics_host": "127.0.0.1",
    # a torch.profiler trace of the whole run lands here (None = off)
    "profile_dir": None,
    "profile_rounds": None,  # rounds to capture with torch.profiler
    # model
    "model": "lr",
    "hidden_dim": 64,  # MLP hidden width
    # compute dtype of the hot loop ("float32" = no casting)
    "dtype": "float32",
    "vocab_size": 0,  # LM vocabulary (0 = the model family's default)
    "num_layers": 2,  # transformer depth
    "num_heads": 4,  # attention heads
    "embed_dim": 128,  # transformer model width
    "max_len": 512,  # positional-embedding capacity
    "attention_impl": "full",  # "full" | "flash"
    # rematerialize each transformer block: its activations are dropped
    # after the forward and recomputed in the backward (less memory, one
    # more forward per block; gradients bitwise the same)
    "remat": False,
    "training_type": constants.FEDML_TRAINING_PLATFORM_SIMULATION,
    # the comm backend of a cross-silo world (LOCAL, TRPC, GRPC, MQTT,
    # MQTT_S3); the simulation default maps to LOCAL there
    "backend": constants.FEDML_SIMULATION_TYPE_SP,
    # the distributed platform (distributed.py): mesh axes -> sizes, from
    # {dp, tp, ep} (sharded) or {sp} / {dp, sp} (sequence); None = one dp
    # axis over every rank
    "mesh_shape": None,
    # sequence parallelism: "ring" or "ulysses"; the ring's K/V chunk per
    # fold (0 = the whole shard per hop)
    "sp_strategy": "ring",
    "sp_ring_block": 0,
    "pp_microbatches": 0,  # the pipeline mode's microbatches: 0 = auto (2 x stages)
    # weight of the Switch MoE load-balancing aux loss in the distributed
    # trainer's objective (0 disables)
    "moe_aux_weight": 0.01,
    # the distributed trainer's gradient accumulation: each batch in N
    # chunks before one update, exact (count-weighted) vs unchunked
    "grad_accum_steps": 1,
    "moe_every": 2,  # every Nth transformer block is a Switch MoE layer
    "num_experts": 8,  # Switch MoE expert count
    "capacity_factor": 1.25,  # MoE per-expert token capacity slack
    # planet-scale population plane (scale/): a registry of N clients as
    # columnar state, cohorts sampled and materialized on demand
    # (0 = the eager federation)
    "client_registry_size": 0,
    # clients a registry round samples (0 = client_num_per_round)
    "cohort_size": 0,
    # edge aggregators of the two-tier fold tree (0 or 1 = flat): the
    # registry simulator's and the cross-silo streaming server's
    "edge_num": 0,
    # where the cross-silo edge tier runs: "inproc" (the in-process tree
    # inside the server) or "ranks" (edge aggregators as real ranks over
    # the comm layer, cross_silo/hierarchical: each edge folds its
    # clients' uploads and ships one limb-set a round to the root)
    "edge_plane": "inproc",
    # gRPC port stride between per-edge client fabrics (each binds
    # grpc_port_base + edge_rank * stride + rank); must exceed the client
    # count. LOCAL fabrics are name-strided and ignore it
    "hier_port_stride": 64,
    # keep the registry's columns in <dir>/<name>.npy memmaps (None =
    # host RAM)
    "registry_dir": None,
    # fold the per-edge terms into one flat accumulator instead of the
    # tree: the A/B baseline the tree's bit-identity is held against
    "edge_flat_fold": False,
    # robustness (the reference's fedavg_robust configuration):
    # defense_type "norm_diff_clipping" | "weak_dp" | "median" | None.
    # Clipping and weak DP are per-upload (clip in the term, noise on
    # the aggregate, drawn from a generator seeded by the run seed and
    # the round); median needs the whole cohort. Unknown strings raise
    "defense_type": None,
    # norm-diff clip radius: each upload's delta against the broadcast
    # global is scaled to at most this L2 norm
    "norm_bound": 5.0,
    # weak-DP Gaussian noise stddev added to the aggregate
    "stddev": 0.158,
    # on-arrival anomaly screen (core/defense.py AnomalyScreen): a rank
    # whose reputation crosses this threshold is quarantined; 0 disables
    "defense_anomaly_threshold": 0.0,
    # quarantine probation length, in round closes or publishes
    "defense_quarantine_rounds": 3,
    # poisoned worlds (data/poison.py): the attack of the attacker
    # clients, "label_flip" | "targeted_flip" | "backdoor_pattern" |
    # "edge_case", or a list paired 1:1 with poisoned_client_idxs; None
    # disables
    "poison_type": None,
    # explicit attacker client indexes (wins over the fraction)
    "poisoned_client_idxs": None,
    # else this fraction of clients is drawn as attackers (seeded)
    "poisoned_client_fraction": 0.0,
    # the label the attacks steer toward
    "target_label": 0,
    # fraction of each attacker's samples that are poisoned
    "poison_sample_fraction": 1.0,
    # uplink compression of the streaming fold's uploads (core/
    # compression.py): "none" | "int8" | "topk"
    "compression": "none",
    "compression_topk_ratio": 0.01,
    # S-FedAvg (simulation/defenses.py)
    "sfedavg_alpha": 0.5,  # reputation weight (goodness)
    "sfedavg_beta": 0.5,  # reputation weight (history)
    "sampling_filter": "exp",  # score -> probability filter
    "score_method": "acc",  # client scoring signal
    "sv_tol": 0.005,  # Shapley truncation tolerance
    # Shapley permutation cap; None = client_num_per_round ** 2
    "sv_max_perms": None,
    "valid_batches": 4,  # validation batches for defense scoring
    # HS-FedAvg
    "hs_L": 0.0,  # FFT band ratio (0 = the DC term only)
    "hs_momentum": 0.1,  # running-amplitude momentum
    # the other simulation algorithms and their models, at the JAX
    # package's defaults
    "seg_width": 32,  # DeepLabLite width (FedSeg)
    "nas_width": 16,  # FedNAS stem channels
    "nas_cells": 2,  # FedNAS cells per client model
    "nas_steps": 2,  # FedNAS nodes per cell
    "arch_learning_rate": 0.0003,  # FedNAS architecture-weight LR
    "gan_latent_dim": 64,  # FedGAN generator latent size
    "gan_lr_g": 0.0002,  # FedGAN generator LR
    "gan_lr_d": 0.0002,  # FedGAN discriminator LR
    "splitnn_stages": (1, 1, 1),  # SplitNN server-side stage depths
    "vfl_parties": 2,  # vertical-FL feature-holding parties
    "vfl_rep_dim": 32,  # vertical-FL per-party representation width
    "gkt_server_stages": (2, 2, 2),  # FedGKT server tower depths
    "gkt_alpha": 1.0,  # FedGKT distillation loss weight
    "gkt_temperature": 3.0,  # FedGKT softmax temperature
    "gkt_server_epochs": 1,  # FedGKT server epochs per round
    "group_num": 2,  # hierarchical-FL group count
    "group_method": "random",  # hierarchical-FL grouping rule
    "group_comm_round": 1,  # hierarchical-FL intra-group rounds
    "topology_neighbor_num": 2,  # decentralized ring/random neighbors
    "topology_beta": 0.0,  # DSGD Watts-Strogatz rewiring probability
    "ta_groups": 4,  # TurboAggregate circular groups
    "ta_quant_scale": 65536.0,  # TurboAggregate additive-share scale
    # serving plane (fedml_tpu_torch/serving):
    # bounded request queue; a full queue sheds new requests
    # (serving_shed_total{reason=queue_full}) instead of growing
    "serve_queue_size": 256,
    # micro-batch cap: the batcher drains up to this many queued
    # requests into one forward pass (pow2-bucketed below the cap)
    "serve_max_batch": 64,
    # linger time while assembling a micro-batch once the first
    # request is in hand — the latency/occupancy tradeoff knob
    "serve_batch_wait_ms": 2.0,
    # default per-request deadline; requests still queued past it are
    # shed (serving_shed_total{reason=deadline}). 0 disables
    "serve_deadline_ms": 100.0,
    # serving batch-shape bucket policy: "pow2" or "exact"
    "serve_bucket": "pow2",
    # checkpoint publish/watch poll interval for weight hot-swaps
    "serve_watch_interval_s": 1.0,
    # serving fleet: number of endpoints behind the fleet frontend
    # (1 = the classic single-endpoint plane, no fleet layer)
    "serve_fleet_size": 1,
    # serve on a named (data, fsdp) mesh of the process group:
    # {"data": D, "fsdp": F} makes every endpoint a MeshModelEndpoint
    # (params at rest in their fsdp shards, batches split along data).
    # None = serve on one device
    "serve_mesh": None,
    # fleet routing policy: "least_loaded" (argmin queue depth per
    # request) or "static" (the boustrophedon deal cycled —
    # core/scheduler.assign_by_load)
    "serve_route_policy": "least_loaded",
    # fleet SLO shed signal: when the p99 of serving_request_latency_s
    # exceeds this, new requests shed at the fleet door
    # (serving_fleet_shed_total{reason=slo}). 0 disables
    "serve_route_slo_ms": 0.0,
    # on an immediately-shed submission (queue full / stopped engine)
    # retry this many more candidates before giving up
    "serve_route_failover": 1,
    # comm layer (core/comm, core/managers.py)
    "run_id": "0",
    "grpc_ipconfig_path": None,  # gRPC fabric rank->ip CSV
    "grpc_port_base": 8890,  # gRPC first port (rank k = base+k)
    # per-attempt deadline of one gRPC unary send; the transport retries
    # transient RPC errors a small fixed number of times, then raises a
    # typed CommSendError
    "grpc_send_timeout_s": 300.0,
    "trpc_ipconfig_path": None,  # TRPC fabric rank->ip CSV
    "trpc_port_base": None,  # TRPC first port (rank k = base+k)
    "broker_host": "127.0.0.1",  # MQTT broker bind address
    "broker_port": 0,  # MQTT broker port (0 = per-run local broker)
    "payload_store_dir": None,  # MQTT_S3's payload store directory
    # fault injection (core/comm/faults.py): a mapping of {drop_prob,
    # duplicate_prob, delay_s, delay_prob, seed, msg_types, max_faults};
    # None disables
    "fault_injection": None,
    # reliable delivery (core/comm/reliable.py): ack/retransmit channel
    # with receive-side dedup. Enable on ALL processes of a world together
    "reliable_comm": False,
    # reliable channel: retransmits before a send is given up
    "comm_retry_max": 5,
    # first-retry backoff; doubles per attempt with up to +50% jitter
    "comm_retry_base_s": 0.2,
    # client liveness beats (core/comm/heartbeat.py); 0 disables
    "heartbeat_interval_s": 0.0,
    # failure detector: a client silent this long is dead; 0 disables
    "heartbeat_timeout_s": 0.0,
    # flight-recorder telemetry: False disables every instrument
    "telemetry": True,
    # tracking (the JAX package's experiment-tracking switch)
    "enable_tracking": False,
    # device: the device kind this configuration targets ("cuda" here,
    # where the JAX package says "tpu"), and the reference's GPU knobs
    "using_gpu": True,
    "device_type": "cuda",
    "gpu_mapping_file": None,
    # -- cross-silo (cross_silo/) --------------------------------------
    # real edge-device ids of ranks 1..N (a JSON string or list); None =
    # the ranks themselves
    "client_id_list": None,
    # server aggregation: "stream" folds each upload the moment it lands
    # (bitwise the same result as "buffered"; falls back to buffered
    # LOUDLY for the median or a custom ServerAggregator); "buffered"
    # keeps the uploads until the round closes; "async" is FedBuff-style:
    # no round barrier, staleness-weighted folds, a publish every
    # async_publish_every folds
    "agg_mode": "stream",
    # quorum close: once this fraction of the round's live cohort has
    # folded, arm a round_grace_s timer; when it fires the round closes
    # over the partial cohort. 0 disables
    "round_quorum_frac": 0.0,
    "round_grace_s": 0.0,  # how long past quorum the server waits
    # async: an upload s publishes stale folds with weight
    # sample_num * staleness_decay^s; staler than staleness_max is dropped
    "staleness_decay": 0.5,
    "staleness_max": 10,
    "async_publish_every": 4,  # async publish cadence, in folds
    # deadline cohort: aggregate whoever reported within this many
    # seconds of the broadcast. 0 = wait for everyone
    "aggregation_deadline_s": 0.0,
    # a deadline with ZERO uploads rebroadcasts at most this many times
    "aggregation_deadline_max_extensions": 3,
    # elastic membership: start once client_num_per_round clients are
    # online, accept joins, survive OFFLINE leaves
    "elastic_membership": False,
    # highest rank an unknown ONLINE may register as (elastic)
    "max_clients": 4096,
    # round SLO: a round longer than this counts slo_violations_total
    "round_deadline_s": 0.0,
    # hierarchical silos: the silo's processes (one torch.distributed
    # rank each, gloo on the CPU, NCCL on the card), this process's rank
    # among them, and the TCP rendezvous of their process group
    # ("host:port", hosted by process 0)
    "n_proc_in_silo": 1,
    "proc_rank_in_silo": 0,
    "distributed_coordinator": None,
    # the silo's control fabric (the round broadcast master -> slaves):
    # "LOCAL" (threads of one process) or "GRPC"
    "silo_backend": "LOCAL",
    "silo_grpc_port_base": 9890,  # the silo fabric's first gRPC port
    "silo_grpc_ipconfig_path": None,  # the silo fabric's rank->ip CSV
    # cards of a silo process group: rank p of silo s uses card
    # (s - 1) * silo_device_count + p; 0 = the card the caller names
    "silo_device_count": 0,
    # -- the cross-device planes (cross_device/) -------------------------
    # the legacy model-file server's fabric (cross_device/server.py)
    "cross_device_backend": constants.COMM_BACKEND_MQTT,
    # the Beehive check-in plane (cross_device/gateway.py, device.py):
    # devices sampled a round (0 = cohort_size, then client_num_per_round)
    "crossdevice_cohort": 0,
    "crossdevice_fold_target_frac": 0.6,  # share of the roster whose folds close a round
    "crossdevice_report_window_s": 30.0,  # the report window after the offer
    "crossdevice_secure_agg": True,  # pairwise-masked uploads (they cancel in the fold)
    "crossdevice_quant_scale": 65536.0,  # field quantization scale of the deltas
    "crossdevice_mask_threshold": 2,  # Shamir threshold of the dropout recovery
    "crossdevice_duty_hours": 14,  # hours a day a device is reachable
    "crossdevice_verify_pubkey": True,  # check each recovered secret against its key
    # -- the chaos plane (core/chaos.py) -------------------------------
    # ordered one-shot fault steps {at: {event, occurrence, round?, rank?,
    # msg_type?, name?}, fault: kind-or-mapping}; None disables
    "chaos_schedule": None,
    "chaos_seed": 0,  # seeds latency jitter; same pair -> same faults
    # IO-only fault steps (wal_create / wal_append / ckpt_publish)
    "io_faults": None,
    # -- elastic preemption (parallel/elastic.py) ----------------------
    # None/"none" disables; "round:K" a scripted drill at round K;
    # "file:PATH" fires when PATH exists; "metadata" polls the GCE
    # metadata maintenance-event endpoint; "chaos" rides a scheduled
    # preempt/device.loss fault on the elastic.check event. Requires
    # checkpoint_dir
    "preempt_signal": None,
    # the resume floor: refuse to resume on fewer surviving devices
    "elastic_min_devices": 1,
}

_SECTIONS = (
    "common_args",
    "data_args",
    "model_args",
    "train_args",
    "validation_args",
    "device_args",
    "comm_args",
    "tracking_args",
    "defense_args",
    "attack_args",
)

_DTYPES = ("bfloat16", "float32")
# matmul_precision values (the JAX names) and whether each allows TF32
MATMUL_PRECISIONS = {
    "highest": False, "float32": False,
    "high": True, "default": True, "tensorfloat32": True, "bfloat16": True,
}


class Arguments:
    """Flat attribute bag over a sectioned YAML config: the command line's
    flags first, the YAML over them, the defaults under both; then the
    entry point's ``training_type`` and ``comm_backend``, when it pins
    them, over everything."""

    def __init__(
        self,
        cmd_args: Optional[argparse.Namespace] = None,
        training_type: Optional[str] = None,
        comm_backend: Optional[str] = None,
    ) -> None:
        self._raw: Dict[str, Any] = {}
        if cmd_args is not None:
            for k, v in vars(cmd_args).items():
                setattr(self, k, v)
        config_path = getattr(self, "yaml_config_file", None) or None
        if config_path:
            self.load_yaml_config(config_path)
        for key, val in _DEFAULTS.items():
            if not hasattr(self, key):
                setattr(self, key, val)
        if training_type is not None:
            self.training_type = training_type
        if comm_backend is not None:
            self.backend = comm_backend
        self._validate()

    # -- YAML ----------------------------------------------------------
    def load_yaml_config(self, path: str) -> None:
        with open(path, "r") as f:
            cfg = yaml.safe_load(f) or {}
        self._raw = cfg
        self.set_attr_from_config(cfg)

    def set_attr_from_config(self, configuration: Dict[str, Any]) -> None:
        """Flatten sections: every key of a ``*_args`` section becomes
        an attribute; a top-level scalar stays as it is."""
        for section, content in configuration.items():
            if isinstance(content, dict) and (
                section in _SECTIONS or section.endswith("_args")
            ):
                for key, val in content.items():
                    setattr(self, key, val)
            else:
                setattr(self, section, content)

    # -- validation ----------------------------------------------------
    def _validate(self) -> None:
        dtype = str(getattr(self, "dtype", "float32") or "float32")
        if dtype not in _DTYPES:
            raise ValueError(
                f"dtype {dtype!r}: pick one of {sorted(_DTYPES)} (float16 is "
                "unsupported — no loss scaling)"
            )
        for int_key in (
            "random_seed", "serve_queue_size", "serve_max_batch",
            "client_num_in_total", "client_num_per_round", "comm_round",
            "epochs", "batch_size", "pipeline_depth", "serve_fleet_size",
            "serve_route_failover", "comm_retry_max",
        ):
            setattr(self, int_key, int(getattr(self, int_key)))
        for float_key in (
            "learning_rate", "server_lr", "partition_alpha", "fedprox_mu",
            "serve_batch_wait_ms", "serve_deadline_ms", "serve_watch_interval_s",
            "serve_route_slo_ms", "comm_retry_base_s", "grpc_send_timeout_s",
            "heartbeat_interval_s", "heartbeat_timeout_s",
        ):
            setattr(self, float_key, float(getattr(self, float_key)))
        for size_key in ("seq_len", "synthetic_train_size", "synthetic_test_size"):
            if getattr(self, size_key, None) is not None:
                setattr(self, size_key, int(getattr(self, size_key)))
        if self.client_num_per_round > self.client_num_in_total:
            self.client_num_per_round = self.client_num_in_total
        if self.pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth={self.pipeline_depth}: must be >= 1 "
                "(1 = synchronous round loop)"
            )
        if self.pipeline_bucket not in ("pow2", "exact"):
            raise ValueError(
                f"pipeline_bucket {self.pipeline_bucket!r}: pick 'pow2' or 'exact'"
            )
        if self.sim_mode not in ("vectorized", "sequential"):
            raise ValueError(
                f"sim_mode {self.sim_mode!r}: pick 'vectorized' or 'sequential'"
            )
        if str(self.matmul_precision) not in MATMUL_PRECISIONS:
            raise ValueError(
                f"matmul_precision {self.matmul_precision!r}: pick one of "
                f"{sorted(MATMUL_PRECISIONS)}"
            )
        if self.serve_queue_size < 1 or self.serve_max_batch < 1:
            raise ValueError(
                f"serve_queue_size={self.serve_queue_size} / "
                f"serve_max_batch={self.serve_max_batch}: both must be >= 1"
            )
        for nonneg_key in (
            "serve_batch_wait_ms", "serve_deadline_ms", "serve_watch_interval_s",
            "serve_route_slo_ms", "serve_route_failover",
        ):
            if getattr(self, nonneg_key) < 0:
                raise ValueError(
                    f"{nonneg_key}={getattr(self, nonneg_key)}: must be >= 0"
                )
        if self.serve_bucket not in ("pow2", "exact"):
            raise ValueError(
                f"serve_bucket {self.serve_bucket!r}: pick 'pow2' or 'exact'"
            )
        self._validate_fleet()
        self._validate_comm()
        self._validate_cross_silo()
        self._validate_population()
        self._validate_robustness()
        self._validate_cross_device()
        self._validate_telemetry()
        self._validate_elastic()

    def _validate_telemetry(self) -> None:
        """The exporters' knobs, with the JAX package's words."""
        self.stall_timeout_s = float(self.stall_timeout_s)
        if self.stall_timeout_s < 0:
            raise ValueError(
                f"stall_timeout_s={self.stall_timeout_s}: must be >= 0 "
                "(0 disables the stall watchdog)"
            )
        raw = getattr(self, "compile_cache_dir", None)
        if raw is not None and not isinstance(raw, (str, os.PathLike)):
            # the null-naming rule: a YAML `compile_cache_dir: 3` must
            # name the knob
            raise ValueError(
                f"compile_cache_dir={raw!r}: must be a directory path "
                "(or null to disable the persistent compilation cache)"
            )
        for int_key in ("trace_ring_size", "devtime_ring_size", "metrics_port"):
            setattr(self, int_key, int(getattr(self, int_key)))
        if self.trace_ring_size < 1:
            raise ValueError(
                f"trace_ring_size={self.trace_ring_size}: must be >= 1"
            )
        if self.devtime_ring_size < 1:
            raise ValueError(
                f"devtime_ring_size={self.devtime_ring_size}: must be >= 1"
            )
        if not 0 <= self.metrics_port <= 65535:
            raise ValueError(
                f"metrics_port={self.metrics_port}: must be a port number "
                "(0 disables the /metrics server)"
            )

    def _validate_elastic(self) -> None:
        """The elastic preemption knobs, with the JAX package's words."""
        from .parallel.elastic import make_signal

        # parse-validate (the factory raises the naming ValueError); the
        # signal itself is rebuilt at train() time, not stored here
        signal = make_signal(getattr(self, "preempt_signal", None))
        if signal is not None and not getattr(self, "checkpoint_dir", None):
            raise ValueError(
                f"preempt_signal={self.preempt_signal!r} needs "
                "checkpoint_dir: a preemption notice forces a durable "
                "checkpoint — with nowhere to land it the drained round "
                "would be lost"
            )
        raw = getattr(self, "elastic_min_devices", 1)
        try:
            self.elastic_min_devices = int(raw if raw is not None else 1)
        except (TypeError, ValueError):
            raise ValueError(
                f"elastic_min_devices={raw!r}: must be an integer >= 1"
            ) from None
        if self.elastic_min_devices < 1:
            raise ValueError(
                f"elastic_min_devices={self.elastic_min_devices}: must be "
                ">= 1 (the resume floor — below it the run refuses to "
                "continue)"
            )

    def _validate_fleet(self) -> None:
        """The fleet knobs, with the JAX package's words."""
        if self.serve_fleet_size < 1:
            raise ValueError(
                f"serve_fleet_size={self.serve_fleet_size}: must be >= 1 "
                "(1 = single endpoint, no fleet layer)"
            )
        if self.serve_route_policy not in ("least_loaded", "static"):
            raise ValueError(
                f"serve_route_policy {self.serve_route_policy!r}: pick "
                "'least_loaded' or 'static'"
            )
        serve_mesh = self.serve_mesh
        if serve_mesh is not None:
            if not isinstance(serve_mesh, dict) or not set(
                serve_mesh
            ) <= {"data", "fsdp"}:
                raise ValueError(
                    f"serve_mesh={serve_mesh!r}: expected a dict with "
                    "'data'/'fsdp' axis sizes (e.g. {'data': 2, 'fsdp': 2})"
                )
            self.serve_mesh = {k: int(v) for k, v in serve_mesh.items()}

    def _validate_comm(self) -> None:
        """The comm layer's knobs, with the JAX package's words."""
        if self.comm_retry_max < 0:
            raise ValueError(
                f"comm_retry_max={self.comm_retry_max}: must be >= 0 "
                "(0 = no retransmits/retries)"
            )
        for nonneg_key in (
            "comm_retry_base_s", "heartbeat_interval_s", "heartbeat_timeout_s",
        ):
            if getattr(self, nonneg_key) < 0:
                raise ValueError(
                    f"{nonneg_key}={getattr(self, nonneg_key)}: must be >= 0"
                )
        if self.grpc_send_timeout_s <= 0:
            raise ValueError(
                f"grpc_send_timeout_s={self.grpc_send_timeout_s}: must be > 0"
            )

    def _validate_cross_silo(self) -> None:
        """The cross-silo and chaos knobs, with the JAX package's words."""
        if (
            self.training_type == constants.FEDML_TRAINING_PLATFORM_CROSS_SILO
            and self.backend
            in (constants.COMM_BACKEND_SP, constants.FEDML_SIMULATION_TYPE_SP)
        ):
            # the simulation default backend makes no sense cross-silo;
            # LOCAL runs single-host worlds, GRPC/TRPC the networked path
            self.backend = constants.COMM_BACKEND_LOCAL
        if self.agg_mode not in ("stream", "buffered", "async"):
            raise ValueError(
                f"agg_mode {self.agg_mode!r}: pick 'stream' (aggregate-on-"
                "arrival), 'buffered' (reference shape) or 'async' (FedBuff)"
            )
        for float_key in ("round_quorum_frac", "round_grace_s", "staleness_decay",
                          "aggregation_deadline_s", "round_deadline_s"):
            setattr(self, float_key, float(getattr(self, float_key) or 0.0))
        if not 0.0 <= self.round_quorum_frac <= 1.0:
            raise ValueError(
                f"round_quorum_frac={self.round_quorum_frac}: must be in "
                "[0, 1] (0 disables the quorum close)"
            )
        if self.round_grace_s < 0:
            raise ValueError(
                f"round_grace_s={self.round_grace_s}: must be >= 0"
            )
        if not 0.0 < self.staleness_decay <= 1.0:
            raise ValueError(
                f"staleness_decay={self.staleness_decay}: must be in (0, 1] "
                "(1 = no staleness discount)"
            )
        for int_key in ("staleness_max", "async_publish_every",
                        "n_proc_in_silo", "proc_rank_in_silo", "silo_device_count"):
            setattr(self, int_key, int(getattr(self, int_key) or 0))
        if self.staleness_max < 0:
            raise ValueError(
                f"staleness_max={self.staleness_max}: must be >= 0 "
                "(0 = only fresh updates fold)"
            )
        if self.async_publish_every < 1:
            raise ValueError(
                f"async_publish_every={self.async_publish_every}: must be >= 1"
            )
        if self.agg_mode == "async" and self.aggregation_deadline_s > 0:
            raise ValueError(
                "agg_mode=async has no round barrier; "
                "aggregation_deadline_s does not apply — unset one of them"
            )
        if self.round_deadline_s < 0:
            raise ValueError(
                f"round_deadline_s={self.round_deadline_s}: must be >= 0 "
                "(0 disables the round SLO)"
            )
        raw = self.max_clients
        try:
            # a YAML `max_clients: null` must name the knob, never coerce
            self.max_clients = int(raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"max_clients={raw!r}: must be an integer"
            ) from None
        if self.max_clients < 1:
            raise ValueError(
                f"max_clients={self.max_clients}: must be >= 1"
            )
        if self.n_proc_in_silo < 1:
            raise ValueError(f"n_proc_in_silo={self.n_proc_in_silo}: must be >= 1")
        if not 0 <= self.proc_rank_in_silo < self.n_proc_in_silo:
            raise ValueError(
                f"proc_rank_in_silo={self.proc_rank_in_silo}: must be in "
                f"[0, n_proc_in_silo={self.n_proc_in_silo})"
            )
        if str(self.silo_backend or "LOCAL").upper() not in ("LOCAL", "GRPC"):
            raise ValueError(f"unsupported silo_backend {self.silo_backend!r}")
        # -- chaos plane knobs -------------------------------------------
        from .core.chaos import validate_schedule

        validate_schedule(getattr(self, "chaos_schedule", None), "chaos_schedule")
        io_steps = validate_schedule(getattr(self, "io_faults", None), "io_faults")
        bad_io = [
            s for s in io_steps
            if s["at"]["event"] not in ("wal_create", "wal_append", "ckpt_publish")
        ]
        if bad_io:
            raise ValueError(
                f"io_faults only takes IO events (wal_create / wal_append / "
                f"ckpt_publish); got {sorted(s['at']['event'] for s in bad_io)}"
                " — use chaos_schedule for comm/barrier steps"
            )
        raw = getattr(self, "chaos_seed", 0)
        try:
            self.chaos_seed = int(raw or 0)
        except (TypeError, ValueError):
            raise ValueError(
                f"chaos_seed={raw!r}: must be an integer"
            ) from None

    def _validate_population(self) -> None:
        """The planet-scale knobs, as the JAX package validates them."""
        for int_key in ("client_registry_size", "cohort_size", "edge_num"):
            raw = getattr(self, int_key)
            try:
                setattr(self, int_key, int(raw or 0))
            except (TypeError, ValueError):
                raise ValueError(
                    f"{int_key}={raw!r}: must be an integer"
                ) from None
            if getattr(self, int_key) < 0:
                raise ValueError(
                    f"{int_key}={getattr(self, int_key)}: must be >= 0 "
                    "(0 disables)"
                )
        t = getattr(self, "training_type", constants.FEDML_TRAINING_PLATFORM_SIMULATION)
        if self.client_registry_size > 0:
            if t != constants.FEDML_TRAINING_PLATFORM_SIMULATION:
                raise ValueError(
                    "client_registry_size applies to training_type="
                    "simulation only (the cross-silo edge tier is the "
                    f"edge_num knob); got training_type={t!r}"
                )
            cohort = self.cohort_size or self.client_num_per_round
            if cohort > self.client_registry_size:
                raise ValueError(
                    f"cohort_size={cohort} exceeds "
                    f"client_registry_size={self.client_registry_size}"
                )
            if self.edge_num > cohort:
                raise ValueError(
                    f"edge_num={self.edge_num} exceeds the cohort size "
                    f"{cohort}: an edge tier wider than its cohort is a "
                    "misconfiguration, not a topology"
                )
        plane = str(getattr(self, "edge_plane", "inproc") or "inproc")
        if plane not in ("inproc", "ranks"):
            raise ValueError(
                f"edge_plane={plane!r}: pick 'inproc' (the in-process "
                "tree) or 'ranks' (edge aggregators as real ranks)"
            )
        self.edge_plane = plane
        raw_stride = getattr(self, "hier_port_stride", 64)
        try:
            self.hier_port_stride = int(
                64 if raw_stride is None else raw_stride
            )
        except (TypeError, ValueError):
            raise ValueError(
                f"hier_port_stride={raw_stride!r}: must be an integer"
            ) from None
        if self.hier_port_stride < 1:
            raise ValueError(
                f"hier_port_stride={self.hier_port_stride}: must be >= 1"
            )
        if plane == "ranks":
            if t != constants.FEDML_TRAINING_PLATFORM_CROSS_SILO:
                raise ValueError(
                    "edge_plane=ranks needs training_type=cross_silo "
                    f"(real edge processes over the comm seam); got {t!r}"
                )
            if getattr(self, "agg_mode", "stream") != "stream":
                raise ValueError(
                    "edge_plane=ranks requires agg_mode=stream: the edge "
                    "tier IS the streaming fold (one merged limb-set per "
                    "round crosses the root link); buffered has no "
                    "limb-set to ship and async hierarchy is ROADMAP work"
                )
            if self.edge_num < 1:
                raise ValueError(
                    f"edge_plane=ranks needs edge_num >= 1; got "
                    f"{self.edge_num}"
                )
            if self.edge_num > int(self.client_num_per_round):
                raise ValueError(
                    f"edge_num={self.edge_num} exceeds "
                    f"client_num_per_round={self.client_num_per_round}: an "
                    "edge tier wider than its clients is a "
                    "misconfiguration, not a topology"
                )
            if getattr(self, "defense_type", None) == constants.DEFENSE_MEDIAN:
                raise ValueError(
                    "edge_plane=ranks cannot run defense_type=median: a "
                    "full-cohort reduction needs every upload in one "
                    "place, which is exactly what the edge tier removes"
                )
            if bool(getattr(self, "elastic_membership", False)):
                raise ValueError(
                    "edge_plane=ranks does not support elastic_membership "
                    "yet: the client->edge partition is planned per run "
                    "(joins would need repartitioning)"
                )
            if float(getattr(self, "aggregation_deadline_s", 0) or 0) > 0:
                raise ValueError(
                    "edge_plane=ranks closes rounds per edge and uses the "
                    "quorum close at the root (round_quorum_frac/"
                    "round_grace_s); aggregation_deadline_s does not apply"
                )


    def _validate_robustness(self) -> None:
        """The defense and attack knobs, as the JAX package validates
        them, with its errors word for word."""
        defense = getattr(self, "defense_type", None) or None
        if defense is not None and defense not in constants.DEFENSE_TYPES:
            # a typo'd defense_type must not fall through to an
            # undefended plain mean
            raise ValueError(
                f"unknown defense_type {defense!r}; pick one of "
                f"{constants.DEFENSE_TYPES} (or null to disable)"
            )
        for float_key in (
            "norm_bound", "stddev", "defense_anomaly_threshold",
            "poisoned_client_fraction", "poison_sample_fraction",
        ):
            raw = getattr(self, float_key)
            try:
                setattr(self, float_key, float(raw))
            except (TypeError, ValueError):
                raise ValueError(
                    f"{float_key}={raw!r}: must be a number"
                ) from None
        if self.norm_bound <= 0:
            raise ValueError(
                f"norm_bound={self.norm_bound}: must be > 0 (the clip "
                "radius around the global model)"
            )
        if self.stddev < 0:
            raise ValueError(f"stddev={self.stddev}: must be >= 0")
        if self.defense_anomaly_threshold < 0:
            raise ValueError(
                f"defense_anomaly_threshold={self.defense_anomaly_threshold}: "
                "must be >= 0 (0 disables the anomaly screen)"
            )
        raw = self.defense_quarantine_rounds
        try:
            self.defense_quarantine_rounds = int(raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"defense_quarantine_rounds={raw!r}: must be an integer"
            ) from None
        if self.defense_quarantine_rounds < 1:
            raise ValueError(
                f"defense_quarantine_rounds={self.defense_quarantine_rounds}: "
                "must be >= 1"
            )
        ptypes = getattr(self, "poison_type", None) or None
        if ptypes is not None:
            as_list = list(ptypes) if isinstance(ptypes, (list, tuple)) else [ptypes]
            bad = [t for t in as_list if t not in constants.POISON_TYPES]
            if bad:
                raise ValueError(
                    f"unknown poison_type {bad}; pick from "
                    f"{constants.POISON_TYPES}"
                )
            if isinstance(ptypes, (list, tuple)) and not (
                getattr(self, "poisoned_client_idxs", None)
            ):
                raise ValueError(
                    "poison_type as a list pairs 1:1 with "
                    "poisoned_client_idxs; set the idxs explicitly "
                    "(poisoned_client_fraction draws an arbitrary "
                    "attacker set)"
                )
        if not 0.0 <= self.poisoned_client_fraction <= 1.0:
            raise ValueError(
                f"poisoned_client_fraction={self.poisoned_client_fraction}: "
                "must be in [0, 1]"
            )
        if not 0.0 < self.poison_sample_fraction <= 1.0:
            raise ValueError(
                f"poison_sample_fraction={self.poison_sample_fraction}: "
                "must be in (0, 1]"
            )
        self.target_label = int(getattr(self, "target_label", 0) or 0)


    def _validate_cross_device(self) -> None:
        """The Beehive knobs, as the JAX package validates them, word for
        word."""
        for int_key in ("crossdevice_cohort", "crossdevice_mask_threshold",
                        "crossdevice_duty_hours"):
            raw = getattr(self, int_key)
            try:
                setattr(self, int_key, int(raw or 0))
            except (TypeError, ValueError):
                raise ValueError(f"{int_key}={raw!r}: must be an integer") from None
        if self.crossdevice_cohort < 0:
            raise ValueError(
                f"crossdevice_cohort={self.crossdevice_cohort}: must be "
                ">= 0 (0 = client_num_per_round)"
            )
        if self.crossdevice_mask_threshold < 1:
            raise ValueError(
                f"crossdevice_mask_threshold="
                f"{self.crossdevice_mask_threshold}: must be >= 1 "
                "(shares needed to reconstruct a vanished device's mask)"
            )
        if not 1 <= self.crossdevice_duty_hours <= 24:
            raise ValueError(
                f"crossdevice_duty_hours={self.crossdevice_duty_hours}: "
                "must be in [1, 24] (hours per day a device is reachable)"
            )
        for float_key in ("crossdevice_fold_target_frac", "crossdevice_report_window_s",
                          "crossdevice_quant_scale"):
            raw = getattr(self, float_key)
            try:
                setattr(self, float_key, float(raw))
            except (TypeError, ValueError):
                raise ValueError(f"{float_key}={raw!r}: must be a number") from None
        if not 0.0 < self.crossdevice_fold_target_frac <= 1.0:
            raise ValueError(
                f"crossdevice_fold_target_frac="
                f"{self.crossdevice_fold_target_frac}: must be in (0, 1] "
                "(fraction of the offered cohort whose folds close a round)"
            )
        if self.crossdevice_report_window_s <= 0:
            raise ValueError(
                f"crossdevice_report_window_s="
                f"{self.crossdevice_report_window_s}: must be > 0"
            )
        if self.crossdevice_quant_scale <= 0:
            raise ValueError(
                f"crossdevice_quant_scale={self.crossdevice_quant_scale}: "
                "must be > 0"
            )
        self.crossdevice_secure_agg = bool(self.crossdevice_secure_agg)
        self.crossdevice_verify_pubkey = bool(self.crossdevice_verify_pubkey)

    # -- niceties ------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items() if not k.startswith("_")}


def load_yaml_arguments(path: str) -> Arguments:
    """``Arguments`` from one YAML file alone (what ``--cf <yaml>`` does,
    without the rest of the command line)."""
    return Arguments(argparse.Namespace(yaml_config_file=path))


def add_args(parser: Optional[argparse.ArgumentParser] = None) -> argparse.Namespace:
    """The reference's command line: ``--cf <yaml>``, ``--rank``,
    ``--local_rank``, ``--role`` and ``--run_id``; other flags are left to
    the caller."""
    parser = parser or argparse.ArgumentParser(description="fedml_tpu_torch")
    parser.add_argument("--yaml_config_file", "--cf", type=str, default="",
                        help="yaml configuration file")
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument("--role", type=str, default="client")
    parser.add_argument("--run_id", type=str, default="0")
    args, _ = parser.parse_known_args()
    return args


def _default_config_path(training_type: str) -> Optional[str]:
    """The shipped default config of a training type (``config/``), or
    None for a type that has none."""
    name = {
        constants.FEDML_TRAINING_PLATFORM_SIMULATION: "simulation_sp.yaml",
        constants.FEDML_TRAINING_PLATFORM_CROSS_SILO: "cross_silo.yaml",
        constants.FEDML_TRAINING_PLATFORM_CROSS_DEVICE: "cross_device.yaml",
    }.get(training_type)
    if name is None:
        return None
    p = Path(__file__).parent / "config" / name
    return str(p) if p.exists() else None


def load_arguments(training_type: Optional[str] = None,
                   comm_backend: Optional[str] = None) -> Arguments:
    """The command line's ``Arguments``: ``--cf <yaml>``, or without it the
    shipped default config of ``training_type`` (the simulation's when
    None), with ``training_type`` and ``comm_backend`` pinned over it when
    given."""
    cmd_args = add_args()
    if not cmd_args.yaml_config_file:
        default = _default_config_path(training_type or _DEFAULTS["training_type"])
        if default is not None:
            cmd_args.yaml_config_file = default
    return Arguments(cmd_args, training_type, comm_backend)
