"""The round pipeline: K federation rounds in flight (port of
``fedml_tpu/core/round_pipeline.py``).

PyTorch already queues a round's kernels on the card and returns, so a
round loop keeps the card busy as long as it never waits for a value.
The synchronous loop waited every evaluated round (it fetched the
round's metrics there); this executor takes every wait out of the hot
loop:

- **Horizon precompute.** Client sampling is host-deterministic by
  ``round_idx`` and the round-LR multiplier is host math, so the cohort
  indices, their validity masks and the multipliers of the whole
  horizon are computed before the first round and the indices and masks
  reach the device in one copy (a copy per round would wait for the
  card). Each round's shuffle uniforms are drawn as it is dispatched,
  from the API's device ``torch.Generator`` and in round order, so the
  draws are the same at every depth.
- **K rounds in flight.** Rounds are dispatched back to back, the
  global params and server state chained on the device. Each round
  records a CUDA event after its last kernel; before the next dispatch
  the loop waits on the event of round r-K+1, so at most K rounds are
  queued. An event wait blocks the host until the card gets there; it
  copies nothing.
- **Deferred metrics.** An evaluated round dispatches its evaluation
  and pushes the metric tensors into a ``DeferredMetrics`` ring
  (``core/tracking.py``); records at least K-1 rounds old are fetched,
  all in one copy, at every evaluated round, and the rest at the end.
  Between flushes the hot loop copies nothing to the host.
- **Pow2 cohort buckets.** A cohort is padded up to a power-of-two
  bucket (``pipeline_bucket: pow2``; ``exact`` keeps its size): the
  padded slots repeat a real client index with an all-zero batch mask
  and zero aggregation weight, so they train on nothing and weigh
  nothing. This keeps one shape per bucket, as the JAX package's jit
  cache needs; eager PyTorch has no compile cache, so here the padding
  only costs the padded slots' compute. Every aggregation ported so far
  (FedAvg, FedProx, FedOpt, FedNova) weighs by ``valid``; the JAX
  package's fallback to exact cohorts for weight-unaware reductions
  (the coordinate median) comes with the robust-aggregation planes.

``pipeline_depth: 1`` (the default) is the synchronous loop: every
round waits for its own event and every record is flushed at its own
evaluation, with the same history records.

**Checkpoints** (``checkpoint_dir``). The API's checkpointer saves at
every round r with ``(r + 1) % checkpoint_freq == 0`` and at the last
round, right after r is dispatched and after the deferred records up to
r are flushed; the save's device-to-host copy is its own wait for the
card. A restored run starts at ``start_round`` and precomputes the
horizon from there. The generator is drawn in dispatch order, so its
state right after round r is dispatched is the one round r + 1 draws
from, and the resumed run is bitwise the run that never stopped.
Without ``checkpoint_dir`` nothing here changes: the hot loop fetches
only at its flushes.

**Preemption** (``parallel/elastic.py``). After the cadence save the
loop polls the API's preemption signal (rank 0's answer on a mesh of
several ranks); on notice it drains the window (every queued round's
event waited on, every deferred record flushed), then ``preempt_now``
makes the round durable and raises ``Preempted``.

**Telemetry.** Each dispatch bumps ``pipeline_rounds_dispatched_total``,
marks the ``pipeline.round`` heartbeat (the stall watchdog's progress
signal) and records a ``pipeline.dispatch`` instant; each flush a
``pipeline.flush`` (``pipeline.drain`` at the end) instant; the run's
depth, bucket and host syncs a round land in gauges. All host-side.

A round's ``train_time_s`` is its training time on the card, read from
CUDA events before and after its dispatch when the record is flushed
(on the CPU, where every op runs before it returns, the host clock
around the dispatch). At the end of the run the stats also carry every
round's ``[start, end]`` on that clock (``round_spans_s``, from round
0's start) and the real examples its cohort holds (``round_samples``,
from the host's sample counts), so a caller can time any run of
consecutive rounds as a whole; the stats are reported as one
``kind: "pipeline"`` metrics record.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import devtime
from .bucketing import bucket_cohort, pad_cohort_idx
from .tracking import DeferredMetrics

__all__ = ["RoundPipeline", "bucket_cohort", "pad_cohort_idx"]


def _mark(cuda: bool):
    """A point on the round clock: a recorded CUDA event, or the host
    clock on the CPU."""
    if not cuda:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _seconds(a, b) -> float:
    """Seconds from mark ``a`` to mark ``b`` (both complete)."""
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b) / 1e3


class RoundPipeline:
    """Drives a FedAvg-family API's vectorized round loop with K rounds
    in flight. Built per ``train()`` call; ``run`` leaves ``stats`` (and
    ``api.pipeline_stats``): depth, bucket, rounds, flushes, host syncs
    and ``host_syncs_per_round``."""

    def __init__(self, api) -> None:
        self.api = api
        self.depth = max(1, int(getattr(api.args, "pipeline_depth", 1)))
        self.bucket_policy = str(getattr(api.args, "pipeline_bucket", "pow2"))
        self.deferred = DeferredMetrics()
        self.checkpoints = 0  # saves made (each a host sync of its own)
        self.stats: Dict[str, Any] = {}

    def _precompute(self, rounds: range, bucket: int):
        """For the ``rounds`` to run: cohort indices and validity
        ``[R, bucket]`` on the device (one copy each), the real cohort
        sizes, the real examples each cohort holds (host counts) and the
        LR multipliers."""
        api = self.api
        per_round = int(api.args.client_num_per_round)
        plans = [
            pad_cohort_idx(api._client_sampling(r, api.dataset.client_num, per_round), bucket)
            for r in rounds
        ]
        sizes = [int(valid.sum()) for _, valid in plans]
        counts = np.asarray(api.dataset.packed_num_samples)
        samples = [int(counts[p[:n]].sum()) for (p, _), n in zip(plans, sizes)]
        idx = torch.as_tensor(np.stack([p for p, _ in plans]), dtype=torch.int64,
                              device=api.device)
        valid = torch.as_tensor(np.stack([v for _, v in plans]), device=api.device)
        lr_plan = [api._lr_mult(r) for r in rounds]
        return idx, valid, sizes, samples, lr_plan

    def run(self, packed, nsamples, comm_rounds: int, freq: int, profiler, ckpt=None,
            start_round: int = 0) -> Dict[str, float]:
        """Rounds ``start_round`` to ``comm_rounds - 1``; with ``ckpt``
        (the API's checkpointer) the state is saved every
        ``api._ckpt_freq`` rounds and after the last."""
        api = self.api
        cuda = api.device.type == "cuda"
        # a bucket must tile the mesh's cohort axis, so every lane trains
        # an equal share
        from ..parallel.layout import cohort_axis_size

        bucket = bucket_cohort(int(api.args.client_num_per_round), self.bucket_policy,
                               max_size=int(api.dataset.client_num),
                               shard_multiple=cohort_axis_size(getattr(api, "mesh", None)))
        final_stats: Dict[str, float] = {}
        rounds = range(start_round, comm_rounds)
        if len(rounds) == 0:
            self._finish(bucket, 0)
            return final_stats
        idx_plan, valid_plan, sizes, samples, lr_plan = self._precompute(rounds, bucket)

        # telemetry: host-side counter bumps and ring appends only, so the
        # hot loop gains no device fetch with telemetry on
        tel = getattr(api, "telemetry", None)
        tel = tel if tel is not None and tel.enabled else None
        rec = tel.recorder if tel is not None else None
        if tel is not None:
            tel.attach_deferred(self.deferred)

        inflight: deque = deque()
        # per round: (start, end) CUDA events, or host clock readings on
        # the CPU
        spans: List[Tuple[Any, Any]] = []
        # round wall durations, dispatch to next dispatch: a record may
        # be flushed K-1 rounds after its round, and "now - t0" there
        # would charge the round for the pipeline's lag
        t_dispatch: Dict[int, float] = {}
        durations: Dict[int, float] = {}
        prev_round: Optional[int] = None

        def flush(upto: Optional[int]) -> None:
            nonlocal final_stats
            flushed = self.deferred.flush(upto)
            if rec is not None and flushed:
                rec.instant("pipeline.flush" if upto is not None else "pipeline.drain",
                            cat="pipeline", records=len(flushed), upto=upto)
            for r, host in flushed:
                t0r = t_dispatch.pop(r)
                dt = durations.pop(r, None)
                if dt is None:
                    # only the round just dispatched (K=1 flushes in the
                    # same iteration): round start to now
                    dt = time.perf_counter() - t0r
                stats = api._stats_from_host(r, host, dt, _seconds(*spans[r - start_round]))
                api.history.append(stats)
                final_stats = stats
                api.metrics_reporter.report_server_training_metric(stats)

        def drain() -> None:
            """Every queued round's event waited on, every record flushed."""
            while inflight:
                inflight.popleft().synchronize()
            flush(None)

        for i, round_idx in enumerate(rounds):
            profiler.tick(round_idx)
            t0 = time.perf_counter()
            if prev_round is not None and prev_round in t_dispatch:
                durations[prev_round] = t0 - t_dispatch[prev_round]
            prev_round = None
            rng = api._shuffle_uniforms(sizes[i], bucket)
            api._round_idx = round_idx
            start = _mark(cuda)
            with devtime.measure(api._round_exec_name(), bucket=f"b{bucket}"):
                api.global_params, api.server_state, summed = api._round_fn(
                    api.global_params, api.server_state, packed, nsamples,
                    idx_plan[i], rng, lr_plan[i], valid=valid_plan[i],
                )
            end = _mark(cuda)
            spans.append((start, end))
            if cuda:
                # back-pressure: after the wait at most K-1 rounds are
                # unconfirmed, so the next dispatch makes K (depth 1:
                # wait on the round just dispatched)
                inflight.append(end)
                while len(inflight) >= self.depth:
                    inflight.popleft().synchronize()
            if tel is not None:
                tel.inc("pipeline_rounds_dispatched_total")
                tel.heartbeat("pipeline.round", round_idx)
                rec.instant("pipeline.dispatch", cat="pipeline", round=round_idx)

            if round_idx % freq == 0 or round_idx == comm_rounds - 1:
                sums = api._eval_sums()
                t_dispatch[round_idx] = t0
                prev_round = round_idx
                self.deferred.push(round_idx, {"summed": summed, **sums})
                # only records at least K-1 rounds old: the fetch never
                # waits on a round in flight (K=1: this round's record)
                flush(round_idx - (self.depth - 1))

            saved = False
            if ckpt is not None and ((round_idx + 1) % api._ckpt_freq == 0
                                     or round_idx == comm_rounds - 1):
                # the records up to this round out first, then the save
                # copies the state to the host (a wait for the card)
                flush(None)
                api._save_checkpoint(ckpt, round_idx)
                self.checkpoints += 1
                saved = True
            # on a preemption notice the depth-K window drains before the
            # forced snapshot: every queued round's event waited on, the
            # deferred records out, so the checkpoint holds exactly the
            # rounds the WAL says it does
            api._maybe_preempt(ckpt, round_idx, saved=saved, drain=drain)

        flush(None)  # drain
        if cuda:
            spans[-1][1].synchronize()  # the drain's fetch has waited already
        origin = spans[0][0]
        self._finish(bucket, len(rounds), {
            "num_batches": packed.num_batches,
            "round_samples": samples,
            "round_spans_s": [[_seconds(origin, a), _seconds(origin, b)] for a, b in spans],
        })
        api.metrics_reporter.report({"kind": "pipeline", **self.stats})
        return final_stats

    def _finish(self, bucket: int, rounds: int, timings=None) -> None:
        self.stats = {
            "depth": self.depth,
            "bucket": bucket,
            "bucket_policy": self.bucket_policy,
            "rounds": rounds,
            "flushes": self.deferred.flushes,
            "host_syncs": self.deferred.host_syncs,
            "host_syncs_per_round": round(self.deferred.host_syncs / max(1, rounds), 4),
            "checkpoints": self.checkpoints,
            **(timings or {}),
        }
        self.api.pipeline_stats = self.stats
        tel = getattr(self.api, "telemetry", None)
        if tel is not None and tel.enabled:
            tel.set_gauge("pipeline_depth", self.depth)
            tel.set_gauge("pipeline_bucket", bucket)
            tel.set_gauge("pipeline_host_syncs_per_round", self.stats["host_syncs_per_round"])
        logging.debug("round pipeline: %s", self.stats)
