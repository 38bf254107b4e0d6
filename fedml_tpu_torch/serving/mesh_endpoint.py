"""Mesh-sharded serving endpoint: serve exactly where we train (port of
``fedml_tpu/serving/mesh_endpoint.py``).

The served params rest fsdp-sharded under the canonical ``SpecLayout``
table (``parallel/layout.py``): each rank of the named (data, fsdp) mesh
holds its ``1/fsdp`` share of every sharded leaf, so a model bigger than
one card's memory is servable.

The JAX endpoint drives every device from one process. In the port each
rank is a process, so one rank leads and the others follow:

- rank 0 runs the engine and the frontend. ``infer`` broadcasts the
  bucket's shape and rows over the world group; every rank gathers the
  params whole over ``fsdp`` (the FSDP at-use gather), runs the rows of
  its ``data`` lane, and all-gathers the lanes back. Per-example compute
  is never tensor-split, so a response is the same on every mesh shape
  up to the arithmetic of a lane's batch size;
- the other ranks run :meth:`MeshModelEndpoint.follow`, which serves
  these broadcasts until rank 0 calls :meth:`MeshModelEndpoint.release`;
- swaps and ``remesh`` go down the same ordered channel (one per world,
  shared by every endpoint of a fleet and serialized by one lock on rank
  0), so every rank changes version between the same two batches.

Version-gated swaps: publishes carry the round step as the version; a
stale explicit version (<= the last published one) is dropped and
counted (``serving_swaps_rejected_total``), so out-of-order deliveries
can never roll the endpoint backward. ``restore_target`` hands
``CheckpointWatcher`` a target that loads the published params straight
onto the endpoint's device.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..parallel.layout import (
    AXIS_COHORT,
    build_fed_mesh,
    cohort_axis_size,
    gather_tree,
    is_fed_mesh,
    shard_tree,
    tree_specs,
)
from ..analysis.compiled import auditable, pow2_budget
from .endpoint import ModelEndpoint, build_forward

__all__ = ["MeshModelEndpoint", "build_mesh_forward"]

Params = Dict[str, torch.Tensor]


@auditable(
    "serving.forward_mesh",
    census_budget=lambda ctx: pow2_budget(ctx.serve_buckets),
)
def _audit_mesh_forward_cases(ctx):
    """`cli audit` provider: the mesh-served forward the endpoint runs,
    traced across the serve-bucket census on the fed ``{data: 1, fsdp:
    1}`` mesh of the audit's world of one rank, the params at their
    at-rest shards. The hot rule proves a request never makes the card
    wait on the host."""
    from ..analysis.compiled import LoweringCase

    mesh = ctx.mesh()
    full = ctx.abstract_params()
    specs = tree_specs(full, mesh)
    with ctx.fake_mode():
        params = shard_tree(full, mesh, specs)
    fn = build_forward(build_mesh_forward(ctx.model().apply, mesh, specs))
    return [
        LoweringCase(key=f"b{b}", fn=fn, args=(params, ctx.sds((b, ctx.feature_dim))))
        for b in ctx.serve_buckets
    ]


def build_mesh_forward(apply_fn, mesh, specs):
    """The mesh-served forward on one rank: the params gathered whole over
    ``fsdp``, this rank's ``data`` lane of the batch through ``apply_fn``,
    the lanes all-gathered back in order. Every rank of the mesh calls it
    on the same batch."""
    import torch.distributed as dist

    def fwd(local: Params, x: torch.Tensor) -> torch.Tensor:
        full = gather_tree(local, mesh, specs)
        lo, hi = mesh.lanes(int(x.shape[0]))
        y = apply_fn(full, x[lo:hi]).contiguous()
        n = cohort_axis_size(mesh)
        if n == 1:
            return y
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y, group=mesh.groups[AXIS_COHORT])
        return torch.cat(parts, 0)

    return fwd


class _Channel:
    """The world's ordered serving channel: rank 0 issues (endpoint id,
    op, payload) commands under one lock; every other rank replays them
    in :meth:`follow`."""

    def __init__(self, device: torch.device) -> None:
        import torch.distributed as dist

        self.dist = dist
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.device = device
        self.lock = threading.Lock()
        self.endpoints: List["MeshModelEndpoint"] = []
        self.released = False

    def register(self, ep: "MeshModelEndpoint") -> int:
        self.endpoints.append(ep)
        return len(self.endpoints) - 1

    def send(self, header: tuple, tensors: List[torch.Tensor] = ()) -> None:
        """Rank 0: one command to every follower (called under ``lock``)."""
        if self.world == 1:
            return
        self.dist.broadcast_object_list([header], src=0)
        for t in tensors:
            self.dist.broadcast(t, src=0)

    def recv_tensor(self, shape, dtype: str) -> torch.Tensor:
        t = torch.empty(tuple(shape), dtype=getattr(torch, dtype), device=self.device)
        self.dist.broadcast(t, src=0)
        return t

    def release(self) -> None:
        """Rank 0: end every follower's loop."""
        with self.lock:
            if not self.released:
                self.released = True
                self.send(("stop",))

    def follow(self) -> None:
        """Ranks other than 0: serve rank 0's commands until released."""
        while True:
            box = [None]
            self.dist.broadcast_object_list(box, src=0)
            op, *rest = box[0]
            if op == "stop":
                return
            self.endpoints[rest[0]]._replay(op, *rest[1:])


def _channel_for(mesh, device: torch.device) -> _Channel:
    ch = getattr(mesh, "_serve_channel", None)
    if ch is None:
        ch = _Channel(device)
        mesh._serve_channel = ch
    return ch


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class MeshModelEndpoint(ModelEndpoint):
    """A ``ModelEndpoint`` whose params rest sharded on a named (data,
    fsdp) mesh over the process group; every rank of the world builds it
    with the same params, rank 0 serves and the rest :meth:`follow`."""

    def __init__(self, model, params: Params, mesh, version: int = 0) -> None:
        if not is_fed_mesh(mesh):
            raise ValueError(
                f"MeshModelEndpoint needs a named (data, fsdp) mesh, got "
                f"axes {getattr(mesh, 'axis_names', None)!r} — build one "
                "with parallel.layout.build_fed_mesh"
            )
        self.mesh = mesh
        # serve buckets must tile the data axis so every lane takes an
        # equal share; the engine's micro-batcher reads this and lifts
        # every bucket to a multiple
        self.shard_multiple = cohort_axis_size(mesh)
        self._last_published: Optional[int] = None
        self._specs = tree_specs(params, mesh)
        self._fwd = build_forward(build_mesh_forward(model.apply, mesh, self._specs))
        super().__init__(model, params, version=version)
        self._channel = _channel_for(mesh, self.device)
        self._eid = self._channel.register(self)

    # -- placement -----------------------------------------------------
    def _place(self, params: Params) -> Params:
        """SpecLayout at-rest placement: this rank's fsdp shard of what
        tiles, the rest whole, on the endpoint's device."""
        on_device = {k: torch.as_tensor(v).detach().to(self.device, copy=True)
                     for k, v in params.items()}
        return shard_tree(on_device, self.mesh, self._specs)

    # -- inference -----------------------------------------------------
    def infer(self, x: np.ndarray) -> torch.Tensor:
        """Rank 0: the bucket's rows through the mesh forward on every
        rank; the whole batch's answers on rank 0."""
        m = self.shard_multiple
        if m > 1 and int(x.shape[0]) % m != 0:
            raise ValueError(
                f"mesh serving batch of {int(x.shape[0])} does not tile "
                f"the data axis ({m} lanes) — bucket micro-batches with "
                f"shard_multiple={m} (the engine does this automatically)"
            )
        xt = torch.as_tensor(x).to(self.device)
        ch = self._channel
        with ch.lock:
            ch.send(("infer", self._eid, tuple(xt.shape), _dtype_name(xt.dtype)), [xt])
            return self._forward(xt)

    def _forward(self, xt: torch.Tensor) -> torch.Tensor:
        return self._fwd(self.params(), xt)

    # -- hot swap ------------------------------------------------------
    def swap(self, new_params: Params, version: Optional[int] = None) -> int:
        """Version-gated sharded swap (rank 0). A stale explicit
        ``version`` (<= the last explicitly published one) is dropped —
        counted, never applied. The key/shape/dtype/device check is the
        plain endpoint's; the accepted params go to every rank, which
        keeps its own shard."""
        if (
            version is not None
            and self._last_published is not None
            and int(version) <= self._last_published
        ):
            from ..core.telemetry import Telemetry

            tel = Telemetry.get_instance()
            if tel.enabled:
                tel.inc("serving_swaps_rejected_total", reason="stale_version")
            return self.version
        full = {k: torch.as_tensor(new_params[k]).detach().to(self.device)
                for k in sorted(new_params)}
        placed = self._placed_checked(full)  # a mismatch raises before any broadcast
        ch = self._channel
        with ch.lock:
            ch.send(("swap", self._eid, version,
                     [(k, tuple(v.shape), _dtype_name(v.dtype)) for k, v in full.items()]),
                    [v.contiguous() for v in full.values()])
            return self._install(placed, version)

    def _install(self, placed: Params, version: Optional[int]) -> int:
        v = super()._install(placed, version)
        if version is not None:
            self._last_published = int(version)
        return v

    # -- elastic re-mesh -----------------------------------------------
    def remesh(self, devices=None, mesh_shape=None) -> None:
        """Rebuild this endpoint over a new (data, fsdp) ``mesh_shape``
        (rank 0; the followers replay it): the params gathered whole on the
        old mesh and re-sharded onto the new one. ``devices`` (the elastic
        shrink onto survivors) lays the new mesh over those ranks of the
        world, a subset of the old mesh's that keeps rank 0 (it serves);
        the ranks left out stay in the world's channel and serve nothing.
        The response identity across mesh shapes is what makes this safe.

        Caller contract: quiesce the engine first (the fleet's ``remesh``
        does). Counted ``serving_remesh_total``."""
        shape = dict(mesh_shape or {})
        ranks = None if devices is None else [int(d) for d in devices]
        if ranks is not None and (0 not in ranks or not set(ranks) <= set(self.mesh.ranks)):
            raise ValueError(
                f"remesh(devices={ranks}): the surviving ranks must be a subset of "
                f"the mesh's {self.mesh.ranks} and keep rank 0, which serves"
            )
        ch = self._channel
        with ch.lock:
            ch.send(("remesh", self._eid, shape, ranks))
            self._apply_remesh(shape, ranks)

    def _apply_remesh(self, shape: Dict[str, int], ranks=None) -> None:
        import torch.distributed as dist

        full = gather_tree(self.params(), self.mesh, self._specs) if self.mesh.member else None
        new_mesh = build_fed_mesh(shape, dist.get_world_size(), self.device.type, ranks=ranks)
        new_mesh._serve_channel = self._channel
        if not new_mesh.member:  # left out of the shrink: nothing to serve
            with self._lock:
                self.mesh, self._params = new_mesh, {}
            return
        specs = tree_specs(full, new_mesh)
        placed = shard_tree(full, new_mesh, specs)
        with self._lock:
            self.mesh = new_mesh
            self._specs = specs
            self.shard_multiple = cohort_axis_size(new_mesh)
            self._params = placed
            self._fwd = build_forward(build_mesh_forward(self.model.apply, new_mesh, specs))
        from ..core.telemetry import Telemetry

        tel = Telemetry.get_instance()
        if tel.enabled:
            tel.inc("serving_remesh_total")
            tel.recorder.instant(
                "serve.remesh", cat="serving",
                devices=int(np.prod(list(new_mesh.shape.values()))),
            )

    # -- followers -----------------------------------------------------
    def follow(self) -> None:
        """Ranks other than 0: serve rank 0's infer/swap/remesh commands
        for every endpoint of this world until rank 0 calls
        :meth:`release`."""
        self._channel.follow()

    def release(self) -> None:
        """Rank 0: end the followers' loops (once per world)."""
        self._channel.release()

    def _replay(self, op: str, *rest) -> None:
        ch = self._channel
        if op == "infer":
            shape, dtype = rest
            x = ch.recv_tensor(shape, dtype)
            if self.mesh.member:
                self._forward(x)
        elif op == "swap":
            version, table = rest
            full = {k: ch.recv_tensor(shape, dtype) for k, shape, dtype in table}
            if self.mesh.member:
                self._install(self._placed_checked(full), version)
        elif op == "remesh":
            self._apply_remesh(*rest)
        else:
            raise ValueError(f"unknown serving channel op {op!r}")

    # -- device-direct publish -----------------------------------------
    def restore_target(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The ``CheckpointWatcher`` restore target for one published
        state tree: each params leaf a one-element tensor expanded to the
        leaf's shape, in its dtype, on the endpoint's device, so the
        restore checks it and loads it straight onto the card; the other
        leaves restore on the host as before."""
        target = dict(state)
        target["params"] = {
            k: torch.empty(1, dtype=v.dtype, device=self.device).expand(tuple(v.shape))
            for k, v in state["params"].items()
        }
        return target
