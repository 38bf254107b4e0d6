"""Serving fleet: N endpoints behind one load-aware frontend (port of
``fedml_tpu/serving/fleet.py``).

The heavy-traffic half of the north star: federation rounds keep
publishing weights while a fleet of endpoints absorbs the request
stream. One ``ServingFleet`` owns N ``ServingEngine``s (plain or
mesh-sharded endpoints) and routes each request to a live engine:

- **least_loaded** (default): argmin queue depth over the live
  engines — the serving analog of LPT greedy, re-evaluated per
  request so a paused/slow endpoint sheds load to its peers;
- **static**: the boustrophedon deal (``core/scheduler.assign_by_load``
  — the same assignment the edge tree uses for clients) cycled over
  the fleet; ``submit_burst`` deals a whole burst by per-request load
  in one call.

Routing composes with the existing shed machinery instead of
replacing it: a queue-full engine fails the request's future, the
fleet sees the typed shed and **fails over** to the next candidate
(``serve_route_failover`` attempts, counted). Dead engines (stopped,
crashed worker) are excluded up front; with no live engine the request
sheds typed and counted, never hangs. SLO-driven admission sits on
top: when the p99 of the ``serving_request_latency_s`` histograms
crosses ``serve_route_slo_ms`` the fleet sheds at the door — the
scale/shed signal an autoscaler would act on, counted per reason.

``FleetFrontend`` is ``ServingFrontend`` with the fleet in the engine
seat — the identical comm-seam adapter, so FaultInjector /
ReliableChannel compose in either wrap order, unchanged.

Publish path: ``publish_state`` fans a ``CheckpointWatcher`` state out
to every endpoint (version-gated, latest-wins), and ``restore_target``
grows the mesh endpoint's target from the first publish so every later
restore loads the params straight onto the endpoint's device — wire it
as ``CheckpointWatcher(..., restore_target=fleet.restore_target)``.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core.scheduler import assign_by_load
from .admission import ServingShedError
from .engine import ServingEngine
from .frontends import ServingFrontend

__all__ = ["ServingFleet", "FleetFrontend", "SloController", "FleetSloError"]

Params = Any


class FleetSloError(ServingShedError):
    """Shed at the fleet door: serving p99 is over the SLO."""


class SloController:
    """p99-over-SLO shed signal from the telemetry histograms.

    Estimates p99 from the cumulative ``le_counts`` of every
    ``serving_request_latency_s`` series in the telemetry snapshot (the
    fleet's engines all observe into the same process-wide registry).
    The estimate is the smallest histogram bound covering 99% of
    observations — conservative (an upper bound), cheap (no per-request
    state), and exactly what a dashboard's ``histogram_quantile``
    would show. Below ``min_count`` observations it abstains: a cold
    fleet must not shed on noise."""

    def __init__(
        self,
        slo_ms: float = 0.0,
        min_count: int = 20,
        series: str = "serving_request_latency_s",
        telemetry=None,
    ) -> None:
        self.slo_ms = float(slo_ms)
        self.min_count = int(min_count)
        self.series = str(series)
        self._telemetry = telemetry

    @property
    def telemetry(self):
        if self._telemetry is None:
            from ..core.telemetry import Telemetry

            self._telemetry = Telemetry.get_instance()
        return self._telemetry

    def p99_ms(self) -> Optional[float]:
        """Estimated p99 latency in ms, or None while under
        ``min_count`` total observations (or telemetry is off)."""
        snap = self.telemetry.snapshot()
        total = 0
        merged: Dict[Tuple[float, ...], List[int]] = {}
        for key, h in snap.get("histograms", {}).items():
            if not key.startswith(self.series):
                continue
            bounds = tuple(h.get("le", ()))
            if not bounds:
                continue
            acc = merged.setdefault(bounds, [0] * len(bounds))
            for i, c in enumerate(h.get("le_counts", ())):
                acc[i] += int(c)
            total += int(h.get("count", 0))
        if total < self.min_count or not merged:
            return None
        # merge across bound-sets by taking the worst (largest) p99
        worst = 0.0
        target = 0.99 * total
        for bounds, counts in merged.items():
            for b, c in zip(bounds, counts):
                if c >= target:
                    worst = max(worst, float(b) * 1e3)
                    break
            else:
                worst = max(worst, float(bounds[-1]) * 1e3)
        return worst

    def should_shed(self) -> bool:
        if self.slo_ms <= 0:
            return False
        p99 = self.p99_ms()
        return p99 is not None and p99 > self.slo_ms


class ServingFleet:
    """N serving engines behind one ``submit`` — drop-in for a
    ``ServingEngine`` wherever only ``submit``/``hot_swap`` are used
    (the frontend seam)."""

    def __init__(self, engines: Sequence[ServingEngine], args: Any = None) -> None:
        self.engines: List[ServingEngine] = list(engines)
        if not self.engines:
            raise ValueError("a serving fleet needs at least one engine")
        g = lambda k, d: getattr(args, k, d) if args is not None else d  # noqa: E731
        self.route_policy = str(g("serve_route_policy", "least_loaded"))
        if self.route_policy not in ("least_loaded", "static"):
            raise ValueError(
                f"serve_route_policy {self.route_policy!r}: pick "
                "'least_loaded' or 'static'"
            )
        self.route_failover = max(0, int(g("serve_route_failover", 1)))
        self.slo = SloController(slo_ms=float(g("serve_route_slo_ms", 0.0)))
        self._lock = threading.Lock()
        self._rr = 0
        # routed-request tally per endpoint — the load-skew evidence
        # the bench gate asserts on (<= 2x between live endpoints)
        self.routed: List[int] = [0] * len(self.engines)
        # the static deal: equal unit loads through the boustrophedon
        # assignment, flattened to a cycle over the endpoints
        deal = assign_by_load([1] * len(self.engines), len(self.engines))
        self._static_cycle = [deal[i] for i in range(len(self.engines))]
        self._restore_target: Optional[Dict[str, Any]] = None
        from ..core.telemetry import Telemetry

        self.telemetry = Telemetry.get_instance(args)
        if self.telemetry.enabled:
            self.telemetry.set_gauge("serving_fleet_size", len(self.engines))

    @classmethod
    def build(
        cls,
        model,
        params: Params,
        args: Any = None,
        fleet_size: Optional[int] = None,
        mesh=None,
    ) -> "ServingFleet":
        """Construct ``fleet_size`` endpoints (mesh-sharded when a fed
        mesh is given) + engines. Endpoints share the mesh but own
        their params snapshot — a swap on one can never tear another.
        Every rank of the mesh's world builds the same fleet; the ranks
        other than 0 then serve their endpoints' collectives
        (``MeshModelEndpoint.follow``)."""
        from .endpoint import ModelEndpoint
        from .mesh_endpoint import MeshModelEndpoint

        n = int(
            fleet_size
            if fleet_size is not None
            else getattr(args, "serve_fleet_size", 1)
        )
        engines = []
        for i in range(max(1, n)):
            # the engines run their forwards in threads of their own, and
            # ``FedModel.apply`` loads the params into its module for the
            # call: each endpoint gets a module of its own
            own = model if i == 0 else dataclasses.replace(
                model, module=copy.deepcopy(model.module))
            ep = (
                MeshModelEndpoint(own, params, mesh)
                if mesh is not None
                else ModelEndpoint(own, params)
            )
            engines.append(ServingEngine(ep, args))
        return cls(engines, args)

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "ServingFleet":
        for e in self.engines:
            e.start()
        return self

    def stop(self) -> None:
        for e in self.engines:
            e.stop()

    def __enter__(self) -> "ServingFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- mesh followers ------------------------------------------------
    def follow(self) -> None:
        """Ranks other than 0 of a mesh fleet: serve rank 0's collectives
        for every endpoint (``MeshModelEndpoint.follow``) until rank 0
        calls :meth:`release`. A no-op for a fleet of plain endpoints."""
        ep = self.engines[0].endpoint
        if hasattr(ep, "follow"):
            ep.follow()

    def release(self) -> None:
        """Rank 0 of a mesh fleet: end the followers' loops. A no-op for
        a fleet of plain endpoints."""
        ep = self.engines[0].endpoint
        if hasattr(ep, "release"):
            ep.release()

    # -- introspection -------------------------------------------------
    def live_indices(self) -> List[int]:
        return [i for i, e in enumerate(self.engines) if e.alive()]

    def depths(self) -> List[int]:
        return [e.depth() for e in self.engines]

    def load_skew(self) -> float:
        """max/min routed requests over live endpoints (1.0 = perfectly
        even; inf when an endpoint got nothing)."""
        live = self.live_indices() or range(len(self.engines))
        counts = [self.routed[i] for i in live]
        lo, hi = min(counts), max(counts)
        return float("inf") if lo == 0 and hi > 0 else (hi / lo if lo else 1.0)

    # -- routing -------------------------------------------------------
    def _route_order(self) -> List[int]:
        """Candidate endpoints, best first, dead engines excluded."""
        live = self.live_indices()
        if not live:
            return []
        if self.route_policy == "static":
            with self._lock:
                k = self._rr
                self._rr += 1
            first = self._static_cycle[k % len(self._static_cycle)]
            # failover candidates: the rest by load
            rest = sorted(
                (i for i in live if i != first),
                key=lambda i: self.engines[i].depth(),
            )
            return ([first] if first in live else []) + rest
        # least_loaded: argmin depth, round-robin tiebreak so equal
        # depths (the common idle case) still spread evenly
        with self._lock:
            k = self._rr
            self._rr += 1
        return sorted(
            live,
            key=lambda i: (self.engines[i].depth(), (i - k) % len(self.engines)),
        )

    def _shed(self, reason: str, exc: ServingShedError) -> Future:
        fut: Future = Future()
        if self.telemetry.enabled:
            self.telemetry.inc("serving_fleet_shed_total", reason=reason)
        fut.set_exception(exc)
        return fut

    def submit(
        self,
        x,
        deadline_s: Optional[float] = None,
        deadline_ts: Optional[float] = None,
    ) -> Future:
        """Route one request; returns the chosen engine's Future. On an
        immediately-shed submission (queue full, engine stopped) fails
        over to the next candidate up to ``serve_route_failover``
        times; with no live endpoint sheds typed and counted."""
        tel = self.telemetry
        if self.slo.should_shed():
            return self._shed(
                "slo",
                FleetSloError(
                    f"fleet p99 over SLO ({self.slo.slo_ms} ms); shed at the door"
                ),
            )
        order = self._route_order()
        if not order:
            return self._shed(
                "no_endpoint", ServingShedError("no live serving endpoint")
            )
        fut: Optional[Future] = None
        for attempt, i in enumerate(order[: self.route_failover + 1]):
            if attempt and tel.enabled:
                tel.inc("serving_fleet_failover_total")
            fut = self.engines[i].submit(
                x, deadline_s=deadline_s, deadline_ts=deadline_ts
            )
            if tel.enabled:
                tel.inc("serving_fleet_requests_total", endpoint=i)
                tel.set_gauge(
                    "serving_fleet_depth", self.engines[i].depth(), endpoint=i
                )
            with self._lock:
                self.routed[i] += 1
            # an immediate typed failure (queue full / stopped race) is
            # the failover trigger; anything pending is routed
            if not (
                fut.done() and isinstance(fut.exception(), ServingShedError)
            ):
                return fut
        return fut  # every candidate shed — the last typed future

    def submit_burst(
        self, xs: Sequence, loads: Optional[Sequence[float]] = None, **kw
    ) -> List[Future]:
        """Deal a whole burst across the live endpoints by per-request
        load (``core/scheduler.assign_by_load`` — near-equal total load
        per endpoint, the static-routing face of the fleet)."""
        live = self.live_indices()
        if not live:
            return [
                self._shed(
                    "no_endpoint", ServingShedError("no live serving endpoint")
                )
                for _ in xs
            ]
        plan = assign_by_load(
            list(loads) if loads is not None else [1] * len(xs), len(live)
        )
        tel = self.telemetry
        out: List[Future] = []
        for j, x in enumerate(xs):
            i = live[plan[j]]
            fut = self.engines[i].submit(x, **kw)
            if tel.enabled:
                tel.inc("serving_fleet_requests_total", endpoint=i)
            with self._lock:
                self.routed[i] += 1
            out.append(fut)
        return out

    # -- publish / swap ------------------------------------------------
    def hot_swap(self, params: Params, version: Optional[int] = None) -> int:
        """Swap every endpoint (version-gated per endpoint); returns
        the fleet's resulting version (they agree by construction)."""
        v = 0
        for e in self.engines:
            v = e.hot_swap(params, version)
        if self.telemetry.enabled:
            self.telemetry.inc("serving_fleet_swaps_total")
        return v

    def publish_state(self, state: Dict[str, Any], step: int) -> int:
        """``CheckpointWatcher`` callback target: fan a published
        checkpoint state out to every endpoint and refresh the restore
        target from it. Refreshing EVERY publish (not learn-once) is the
        elastic contract: after ``remesh``, the first publish the watcher
        delivers (raw, after its relearn fallback —
        ``serving_restore_target_relearned_total``) rebuilds the target
        for the new layout."""
        v = 0
        for e in self.engines:
            v = e.endpoint.swap_from_checkpoint_state(state, version=step)
        ep = self.engines[0].endpoint
        build = getattr(ep, "restore_target", None)
        if build is not None:
            self._restore_target = build(state)
        if self.telemetry.enabled:
            self.telemetry.inc("serving_fleet_swaps_total")
        return v

    def restore_target(self) -> Optional[Dict[str, Any]]:
        """For ``CheckpointWatcher(restore_target=...)``: None until the
        first (host-side) publish taught us the state tree, then the mesh
        endpoint's target — every later restore loads each param straight
        onto the endpoint's device."""
        return self._restore_target

    # -- elastic re-mesh ----------------------------------------------
    def remesh(self, devices=None, mesh_shape=None) -> int:
        """Re-mesh every mesh endpoint (``mesh_shape``, over the
        surviving ranks ``devices`` when given, the elastic shrink), one
        engine at a time so the rest of the fleet keeps serving:
        each engine is stopped (its queued requests shed TYPED and
        counted — ``serving_shed_total{reason=stopped}`` — and routing
        excludes the dead engine, so the stream flows around it),
        its endpoint rebuilt over the new mesh, then restarted. The
        stale sharded restore target is dropped so the watcher's
        relearn path + the next publish re-derive it on the new
        layout. Returns the number of endpoints re-meshed."""
        n = 0
        for e in self.engines:
            ep = e.endpoint
            if not hasattr(ep, "remesh"):
                continue  # a plain single-device endpoint has no mesh
            was_alive = e.alive()
            if was_alive:
                e.stop()
            ep.remesh(devices=devices, mesh_shape=mesh_shape)
            # the micro-batcher lifts buckets to the endpoint's lane
            # count — a reshape changes it, so rebind it too
            e.batcher.shard_multiple = int(getattr(ep, "shard_multiple", 1))
            if was_alive:
                e.start()
            n += 1
        if n:
            self._restore_target = None
        return n


class FleetFrontend(ServingFrontend):
    """``ServingFrontend`` with the fleet in the engine seat: the same
    wire protocol and the same comm wrap-order composition
    (FaultInjector / ReliableChannel either side), routing included."""

    def __init__(self, fleet: ServingFleet, com, args, rank: int = 0) -> None:
        super().__init__(fleet, com, args, rank=rank)
        self.fleet = fleet
