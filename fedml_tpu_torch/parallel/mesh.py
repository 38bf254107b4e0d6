"""Device meshes over ``torch.distributed``: the distributed trainer's,
and the simulator's with the federation's placement on it.

The port of ``fedml_tpu/parallel/mesh.py``'s ``build_mesh`` and of
``fedml_tpu/distributed.py``'s ``_resolve_mesh``: ``mesh_shape`` (axis
-> size, in the YAML's order) becomes a ``DeviceMesh`` over the process
group, one rank a device, ranks laid out row-major as JAX lays devices
out (the last axis fastest). Each axis's process group is
``mesh.get_group(axis)``. The default is one ``dp`` axis over the whole
world. The refusals are the JAX package's, word for word: an unknown
axis, ``sp`` or ``pp`` with any axis but ``dp``, more ranks than the
world has. The port runs one process a rank, every rank in the mesh, so
a mesh must span the world (JAX's multi-controller rule).

The simulator's mesh (port of ``fedml_tpu/parallel/mesh.py``'s
federation half) is a :class:`SimMesh`: the legacy ``{clients[, data]}``
vocabulary (``build_sim_mesh``) or the fed ``{data, fsdp}`` one
(``parallel/layout.build_fed_mesh``, which also lays an explicit smaller
shape over a prefix of the world's ranks). The packed federation's client
axis is padded with zero-sample dummies to a multiple of the cohort axis
(``pad_federation``) and each cohort rank keeps its contiguous share
(``shard_federation``); each cohort rank takes its lane of a round's
cohort (``SimMesh.lanes``) from the lane's owners
(``SimMesh.gather_lane``) and trains it, and the trained params are
gathered back in client order (``SimMesh.gather_stacked``), so that the
aggregation sees the cohort's params as the one-rank run sees them.

The reference's ``federation_spec`` and ``pad_cohort_to_mesh`` have no
counterpart: the federation is placed by cohort lanes alone (a legacy
``data`` axis splits each batch's examples at use, after the shuffle,
in the local trainer), and a cohort must tile the cohort axis
(``SimulatorMesh``'s refusal; ``bucket_cohort``'s ``shard_multiple``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.types import Batches
from .collectives import all_gather_list, all_reduce_

SHARDED_AXES = {"dp", "tp", "ep"}
ALL_AXES = SHARDED_AXES | {"sp", "pp"}


def resolve_mesh_shape(shape: Optional[dict], world_size: int) -> Dict[str, int]:
    """``mesh_shape`` checked against a world of ``world_size`` ranks, as
    ``{axis: size}`` in its given order."""
    if not shape:
        shape = {"dp": world_size}
    shape = {str(k): int(v) for k, v in dict(shape).items()}
    unknown = set(shape) - ALL_AXES
    if unknown:
        raise ValueError(
            f"mesh_shape axes {sorted(unknown)} unknown; pick from {sorted(ALL_AXES)}"
        )
    for special in ("sp", "pp"):
        if special in shape and not set(shape) <= {special, "dp"}:
            raise ValueError(
                f"mesh axis {special!r} composes only with 'dp' (its "
                f"shard_map program pins the other axes); got {shape}"
            )
    n = math.prod(shape.values())
    if n > world_size:
        raise ValueError(f"mesh_shape {shape} needs {n} devices, have {world_size}")
    if n != world_size:
        raise ValueError(
            f"multi-controller run ({world_size} processes): "
            f"mesh_shape {shape} must span all {world_size} global "
            f"devices, not {n}"
        )
    return shape


def build_mesh(shape: Dict[str, int], device_type: str):
    """A ``DeviceMesh`` of ``shape`` over the initialised default process
    group, its dims named by the axes."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape.values()),
                            mesh_dim_names=tuple(shape.keys()))


def train_lane(local_train, params: Dict[str, torch.Tensor], lane: Batches, rng, lr_mult):
    """``local_train`` on a mesh rank's lane of a cohort; a lane with no
    clients (a cohort smaller than the cohort axis) trains nothing and
    returns empty stacks."""
    if lane.mask.shape[0] == 0:
        empty = torch.zeros(0, dtype=torch.float32, device=lane.mask.device)
        return ({k: v.new_zeros((0,) + tuple(v.shape)) for k, v in params.items()},
                {k: empty for k in ("loss_sum", "correct", "count")})
    return local_train(params, lane, rng, lr_mult)


class SimMesh:
    """The simulator's mesh over the process group: ``shape`` (axis ->
    size, in order; ranks row-major, the last axis fastest), this rank's
    coordinate on each axis (``coords``) and each axis's process group
    (``groups``). ``axis_names`` and ``shape`` read as a JAX mesh's do.
    ``ranks`` (default: the world) lays it over those ranks of the world
    only; ``member`` says whether this rank is one of them, and ``group``
    is the members' process group (None: the world's)."""

    def __init__(self, shape: Dict[str, int], device_type: str,
                 ranks: Optional[Sequence[int]] = None) -> None:
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.device_type = device_type
        world = dist.get_world_size()
        if ranks is None or list(ranks) == list(range(world)):
            # the whole world: the mesh's own groups
            self.ranks = list(range(world))
            mesh = build_mesh(self.shape, device_type)
            self.groups = {a: mesh.get_group(a) for a in self.shape}
            self.group = None
        else:
            # a subset of the world's ranks (the elastic shrink onto
            # survivors, a prefix sub-mesh): every rank of the world takes
            # part in making the groups, and only the members hold a
            # coordinate
            self.ranks = [int(r) for r in ranks]
            self.groups = _subset_groups(self.shape, self.ranks)
            self.group = dist.new_group(self.ranks)
        self.member = dist.get_rank() in self.ranks
        self.coords = ({a: dist.get_rank(self.groups[a]) for a in self.shape}
                       if self.member else {})
        from .layout import cohort_axis_size, is_fed_mesh

        self.cohort_axis = "data" if is_fed_mesh(self) else "clients"
        self.lanes_count = cohort_axis_size(self)
        self.lane = self.coords.get(self.cohort_axis, 0)
        self._slots: Dict[tuple, torch.Tensor] = {}

    def lanes(self, count: int) -> Tuple[int, int]:
        """This rank's lane ``[lo, hi)`` of ``count`` cohort slots: an even
        split over the cohort axis."""
        return self._span(self.lane, count)

    def _group(self):
        return self.groups.get(self.cohort_axis)

    def gather_lane(self, shard: Batches, idx: torch.Tensor, per: int) -> Batches:
        """This rank's lane (``lanes(C)``) of the cohort ``idx`` [C] of the
        federation whose client i lives on cohort rank ``i // per``
        (``shard`` is this rank's ``per`` clients), in one equal-split
        ``all_to_all`` a leaf: every rank sends each lane the rows of it
        that it owns (zeros elsewhere, the split a lane's width), and
        each lane takes each row from its owner. A rank receives
        ``lanes_count`` x the lane's width rows, the cohort's size,
        never the whole cohort from every rank."""
        if self.lanes_count == 1:
            return Batches(x=shard.x.index_select(0, idx), y=shard.y.index_select(0, idx),
                           mask=shard.mask.index_select(0, idx))
        n, C = self.lanes_count, idx.numel()
        width = -(-C // n)
        slot = self._send_slots(C, idx.device)
        client = idx.index_select(0, slot.clamp_min(0))
        owner = torch.div(client, per, rounding_mode="floor")
        mine = (owner == self.lane) & (slot >= 0)
        local_idx = torch.where(mine, client - self.lane * per, torch.zeros_like(client))
        lo, hi = self.lanes(C)
        rows = torch.arange(hi - lo, device=idx.device)
        src = owner.view(n, width)[self.lane, :hi - lo]

        def exchange(leaf: torch.Tensor) -> torch.Tensor:
            send = leaf.index_select(0, local_idx)
            keep = mine.reshape((-1,) + (1,) * (send.dim() - 1))
            send = torch.where(keep, send, torch.zeros_like(send)).contiguous()
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send, group=self._group())
            return recv.view((n, width) + tuple(leaf.shape[1:]))[src, rows]

        return Batches(x=exchange(shard.x), y=exchange(shard.y), mask=exchange(shard.mask))

    def _send_slots(self, count: int, device) -> torch.Tensor:
        """Send position (d, j) of a ``count``-slot cohort: the j-th slot
        of lane d, or -1 past its end; made once a size (a host copy)."""
        key = (count, str(device))
        if key not in self._slots:
            width = -(-count // self.lanes_count)
            spans = (self._span(d, count) for d in range(self.lanes_count))
            self._slots[key] = torch.tensor(
                [lo + j if lo + j < hi else -1 for lo, hi in spans for j in range(width)],
                dtype=torch.int64, device=device)
        return self._slots[key]

    def _span(self, d: int, count: int) -> Tuple[int, int]:
        n = self.lanes_count
        return d * count // n, (d + 1) * count // n

    def gather_stacked(self, local: Dict[str, torch.Tensor], count: int
                       ) -> Dict[str, torch.Tensor]:
        """Every lane's rows of a stacked tree, in slot order: [count, ...]."""
        if self.lanes_count == 1:
            return local
        n = self.lanes_count
        width = -(-count // n)
        spans = [self._span(d, count) for d in range(n)]

        def gather(leaf: torch.Tensor) -> torch.Tensor:
            pad = width - leaf.shape[0]
            if pad:
                leaf = torch.cat([leaf, leaf.new_zeros((pad,) + tuple(leaf.shape[1:]))])
            parts = all_gather_list(leaf, self._group())
            return torch.cat([p[:hi - lo] for p, (lo, hi) in zip(parts, spans)])

        return {k: gather(v) for k, v in local.items()}

    def lane_total(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the cohort axis."""
        if self.lanes_count == 1:
            return t
        return all_reduce_(t.clone(), self._group())

    def sum_lanes(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Scalars summed over the cohort axis (one all-reduce)."""
        if self.lanes_count == 1:
            return tree
        keys = list(tree)
        flat = all_reduce_(torch.stack([tree[k].to(torch.float32) for k in keys]),
                           self._group())
        return dict(zip(keys, flat.unbind(0)))


def _subset_groups(shape: Dict[str, int], ranks: Sequence[int]) -> dict:
    """Each axis's process group of the member ranks ``ranks`` laid out
    row-major over ``shape`` (the last axis fastest), made on every rank
    of the world in one order (``new_group`` is collective over the
    default group); a rank keeps the group of each axis it belongs to."""
    sizes = list(shape.values())
    me = dist.get_rank()
    grid = torch.tensor(list(ranks)).view(sizes)
    groups = {}
    for d, axis in enumerate(shape):
        moved = grid.movedim(d, -1).reshape(-1, sizes[d])
        for row in moved.tolist():
            g = dist.new_group(row)
            if me in row:
                groups[axis] = g
    return groups


def build_sim_mesh(mesh_shape: Optional[dict], world_size: int, device_type: str) -> SimMesh:
    """The legacy simulator mesh, ``{"clients": ...[, "data": ...]}``
    (default: every rank on ``clients``), spanning the world."""
    if not mesh_shape:
        mesh_shape = {"clients": world_size}
    shape = {str(k): int(v) for k, v in dict(mesh_shape).items()}
    if math.prod(shape.values()) != world_size:
        raise ValueError(f"mesh shape {mesh_shape} != {world_size} devices")
    return SimMesh(shape, device_type)


def pad_federation(packed: Batches, num_samples, multiple: int) -> Tuple[Batches, torch.Tensor]:
    """The client axis padded up to a multiple with zero-sample dummy
    clients (all-zero mask): never sampled (sampling draws indices below
    the real client count) and adding nothing to masked metrics."""
    ns = torch.as_tensor(num_samples, dtype=torch.float32)
    c = packed.mask.shape[0]
    pad = (-c) % multiple
    if pad == 0:
        return packed, ns

    def padleaf(a: torch.Tensor) -> torch.Tensor:
        return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])

    return (Batches(x=padleaf(packed.x), y=padleaf(packed.y), mask=padleaf(packed.mask)),
            torch.cat([ns, ns.new_zeros(pad)]))


def shard_federation(packed: Batches, num_samples, mesh) -> Tuple[Batches, torch.Tensor]:
    """This cohort rank's contiguous share of the (padded) federation's
    clients; the sample counts stay whole on every rank."""
    n = mesh.lanes_count
    per = packed.mask.shape[0] // n
    lo, hi = mesh.lane * per, (mesh.lane + 1) * per
    return (Batches(x=packed.x[lo:hi], y=packed.y[lo:hi], mask=packed.mask[lo:hi]),
            torch.as_tensor(num_samples, dtype=torch.float32))

