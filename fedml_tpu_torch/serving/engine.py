"""The serving engine: request queue -> micro-batches -> forward on the card.

Port of ``fedml_tpu/serving/engine.py``. ``ServingEngine`` is the
in-process serving plane for the federated global model: a bounded
request queue (``admission.py``), a continuous micro-batcher
(``batcher.py``) and a versioned, hot-swappable endpoint
(``endpoint.py``) driven by one worker thread. Frontends
(``frontends.py``), the fleet (``fleet.py``) and the checkpoint watcher
(``core/checkpoint.py``) publish into it.

Telemetry (all host-side, the core/telemetry.py hot-loop contract):

- ``serving_request_latency_s`` — submit-to-complete histogram with
  explicit buckets (Prometheus ``_bucket``/``_sum``/``_count``);
- ``serving_batch_occupancy_frac`` — real rows / bucket rows per batch (how
  much of each batch shape is doing useful work);
- ``serving_queue_depth`` gauge, ``serving_requests_total`` /
  ``serving_batches_total{bucket}`` / ``serving_shed_total{reason}``
  counters, ``serving_swaps_total`` + ``serving_model_version`` from
  the endpoint;
- ``serve.batch`` B/E spans + shed/swap instants on the flight-recorder
  timeline.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, List, Optional

import numpy as np

from ..core.devtime import measure as _devtime
from .admission import AdmissionController, ServingShedError
from .batcher import STOP, MicroBatcher
from .endpoint import ModelEndpoint

__all__ = ["ServingEngine", "InferenceRequest", "LATENCY_BUCKETS_S"]

# request-latency histogram bounds (seconds): sub-ms in-process hits
# through multi-second degraded tails
LATENCY_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0,
)

# batch-occupancy histogram bounds (real rows / bucket rows)
OCCUPANCY_BUCKETS = (0.25, 0.5, 0.75, 1.0)


class InferenceRequest:
    """One queued example: input row, absolute deadline, result future."""

    __slots__ = ("x", "t_submit", "deadline", "future")

    def __init__(
        self, x: np.ndarray, t_submit: float, deadline: Optional[float]
    ) -> None:
        self.x = x
        self.t_submit = t_submit
        self.deadline = deadline
        self.future: Future = Future()

    def complete(self, row: np.ndarray) -> None:
        if not self.future.done():
            self.future.set_result(row)

    def fail(self, exc: BaseException) -> None:
        if not self.future.done():
            self.future.set_exception(exc)


class ServingEngine:
    """Continuous micro-batching engine over one ``ModelEndpoint``.

    Knobs (``args``, all ``serve_*`` — defaults in ``arguments.py``):
    ``serve_queue_size``, ``serve_max_batch``, ``serve_batch_wait_ms``,
    ``serve_deadline_ms`` (0 disables the default deadline),
    ``serve_bucket``.
    """

    def __init__(self, endpoint: ModelEndpoint, args: Any = None) -> None:
        self.endpoint = endpoint
        self.args = args
        g = lambda k, d: getattr(args, k, d) if args is not None else d  # noqa: E731
        self.queue_size = int(g("serve_queue_size", 256))
        self.max_batch = int(g("serve_max_batch", 64))
        self.batch_wait_s = float(g("serve_batch_wait_ms", 2.0)) / 1e3
        deadline_ms = float(g("serve_deadline_ms", 100.0))
        self.default_deadline_s = deadline_ms / 1e3 if deadline_ms > 0 else None
        self.bucket_policy = str(g("serve_bucket", "pow2"))

        from ..core.compile_cache import maybe_enable_compile_cache
        from ..core.telemetry import Telemetry

        # the kernels' build cache (args.compile_cache_dir): a serving
        # restart reuses its kernels' libraries from disk
        maybe_enable_compile_cache(args)
        self.telemetry = Telemetry.get_instance(args)
        self.admission = AdmissionController(self.queue_size, self.telemetry)
        self.batcher = MicroBatcher(
            self.admission.queue, self.max_batch, self.batch_wait_s,
            self.bucket_policy,
            shard_multiple=int(getattr(endpoint, "shard_multiple", 1)),
        )
        self._stop_evt = threading.Event()
        self._paused = threading.Event()
        # pause handshake: generation-counted so an acknowledgement can
        # only ever satisfy the pause() that requested it — a flag left
        # set by an earlier pause can't leak through a resume/pause pair
        self._park_cond = threading.Condition()
        self._pause_gen = 0
        self._parked_gen = -1
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "ServingEngine":
        if self._thread is None or not self._thread.is_alive():
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="serving-engine"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        self._paused.clear()
        with self._park_cond:
            self._park_cond.notify_all()  # release a pause() in flight
        try:
            # wake a blocked gather; non-blocking — on a FULL queue the
            # worker is already exiting via _stop_evt, and a blocking
            # put here would deadlock stop() at exactly the overload
            # moment an operator is most likely shutting down
            self.admission.queue.put_nowait(STOP)
        except queue.Full:  # lint: except-ok — full queue means the
            pass  # worker is already exiting via _stop_evt (see above)
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._drain_stopped()

    def _drain_stopped(self) -> None:
        """Fail everything still queued after the worker exited: an
        abandoned future would hang any caller blocked on result()
        forever; a counted shed unblocks it (and a frontend turns it
        into a retryable response)."""
        while True:
            try:
                req = self.admission.queue.get_nowait()
            except queue.Empty:
                return
            if req is not STOP:
                self.admission.shed(
                    req, "stopped", ServingShedError("serving engine stopped")
                )

    def alive(self) -> bool:
        """Is the worker thread serving? False before ``start``, after
        ``stop`` and after a worker crash — the fleet's routing excludes
        dead engines on exactly this."""
        return (
            self._thread is not None
            and self._thread.is_alive()
            and not self._stop_evt.is_set()
        )

    def depth(self) -> int:
        """Queued (not yet drained) requests — the fleet's load signal."""
        return self.admission.depth()

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def pause(self) -> None:
        """Hold the worker between batches; queued requests accumulate.
        Deterministic-batching seam for tests/bench (a paused engine
        turns N submits into exactly one N-row micro-batch on resume)
        and a drain gate for operational hold-the-world moments.

        Blocks (briefly) until the worker acknowledges THIS pause — a
        gather already blocked on the queue must wind down first, or a
        submit racing the pause could be drained into a stray batch."""
        self._paused.set()
        if self._thread is not None and self._thread.is_alive():
            with self._park_cond:
                self._pause_gen += 1
                target = self._pause_gen
                self._park_cond.notify_all()  # a parked worker must re-ack
                acked = self._park_cond.wait_for(
                    lambda: self._parked_gen >= target
                    or self._stop_evt.is_set(),
                    timeout=5.0,
                )
            if not acked:
                # proceeding unacknowledged re-opens the stray-batch
                # race this handshake exists to close — make it loud
                logging.warning(
                    "serving pause(): worker did not park within 5s "
                    "(long-running batch?); batching may be "
                    "nondeterministic until it does"
                )

    def resume(self) -> None:
        self._paused.clear()
        with self._park_cond:
            self._park_cond.notify_all()  # wake the parked worker now

    # -- submit side ---------------------------------------------------
    def submit(
        self,
        x,
        deadline_s: Optional[float] = None,
        deadline_ts: Optional[float] = None,
    ) -> Future:
        """Queue one example; returns a Future resolving to the model's
        output row (or raising a ``ServingShedError``). ``deadline_s``
        is relative to now; ``deadline_ts`` is an absolute
        ``time.monotonic`` stamp (frontends pass the client's through
        so network delay eats into the budget)."""
        x = np.asarray(x)
        model = self.endpoint.model
        expected = tuple(model.example_shape)
        if expected and tuple(x.shape) != expected:
            raise ValueError(
                f"request shape {tuple(x.shape)} != model example shape "
                f"{expected} (serving batches along a new leading axis)"
            )
        bound = model.input_bound
        if bound is not None and x.size and (x.min() < 0 or x.max() >= bound):
            raise ValueError(
                f"request ids span [{x.min()}, {x.max()}]; the model takes "
                f"ids in [0, {bound})"
            )
        now = time.monotonic()
        if deadline_ts is not None:
            deadline = float(deadline_ts)
        elif deadline_s is not None:
            deadline = now + float(deadline_s) if deadline_s > 0 else None
        else:
            deadline = (
                now + self.default_deadline_s
                if self.default_deadline_s is not None
                else None
            )
        req = InferenceRequest(x, now, deadline)
        tel = self.telemetry
        if tel.enabled:
            tel.inc("serving_requests_total")
            tel.heartbeat("serving.submit")
        if self._stop_evt.is_set():
            # no worker will ever drain this — fail it now, typed
            self.admission.shed(
                req, "stopped", ServingShedError("serving engine stopped")
            )
            return req.future
        self.admission.offer(req)  # on shed the future is already failed
        if self._stop_evt.is_set():
            # stop() may have drained between the check above and the
            # offer — re-drain so this request cannot slip through
            # un-serviced (its future must resolve, typed)
            self._drain_stopped()
        if tel.enabled:
            tel.set_gauge("serving_queue_depth", self.admission.depth())
        return req.future

    def submit_many(self, xs, **kw) -> List[Future]:
        return [self.submit(x, **kw) for x in xs]

    # -- hot swap passthrough -----------------------------------------
    def hot_swap(self, params, version: Optional[int] = None) -> int:
        return self.endpoint.swap(params, version)

    # -- worker --------------------------------------------------------
    def _loop(self) -> None:
        tel = self.telemetry
        rec = tel.recorder
        while not self._stop_evt.is_set():
            if self._paused.is_set():
                with self._park_cond:
                    # ack the current pause generation, then BLOCK on
                    # the condition (no 1 kHz poll loop, and resume()
                    # wakes the worker in microseconds instead of
                    # charging every post-resume burst up to 1 ms)
                    self._parked_gen = self._pause_gen
                    self._park_cond.notify_all()
                    self._park_cond.wait_for(
                        lambda: not self._paused.is_set()
                        or self._stop_evt.is_set()
                        or self._parked_gen != self._pause_gen,
                        timeout=0.5,
                    )
                continue
            batch = self.batcher.gather()
            if not batch:
                continue
            live = self.admission.admit_batch(batch)
            if tel.enabled:
                tel.set_gauge("serving_queue_depth", self.admission.depth())
            if not live:
                continue
            try:
                self._process(live, tel, rec)
            except Exception as e:  # noqa: BLE001 — engine must survive a bad batch
                logging.exception("serving batch failed")
                if tel.enabled:
                    tel.inc("serving_batch_errors_total")
                for req in live:
                    req.fail(e)

    def _process(self, live: List[InferenceRequest], tel, rec) -> None:
        padded, _valid, bucket, n = self.batcher.pad(live)
        if tel.enabled:
            rec.begin("serve.batch", cat="serving", bucket=bucket, n=n)
        try:
            # launch + the single fetch inside one measure: the fetch
            # waits for the card, so this is device+transfer time
            with _devtime("serving.forward", bucket=f"b{bucket}"):
                y = self.endpoint.infer(padded)
                host = y.cpu().numpy()  # the one fetch per micro-batch
        finally:
            if tel.enabled:
                rec.end("serve.batch", cat="serving")
        now = time.monotonic()
        for i, req in enumerate(live):
            req.complete(host[i])  # padded rows are masked off by slice
            if tel.enabled:
                tel.observe(
                    "serving_request_latency_s", now - req.t_submit,
                    buckets=LATENCY_BUCKETS_S, bucket=bucket,
                )
        if tel.enabled:
            tel.inc("serving_batches_total", bucket=bucket)
            tel.observe(
                "serving_batch_occupancy_frac", n / max(bucket, 1),
                buckets=OCCUPANCY_BUCKETS,
            )
            tel.heartbeat("serving.batch", bucket)
