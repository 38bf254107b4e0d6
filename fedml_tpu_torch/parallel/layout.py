"""The ``(data, fsdp)`` federation mesh and its parameter layout (port of
``fedml_tpu/parallel/layout.py``).

- ``data``: the cohort axis. Each data rank trains its slice of the
  sampled cohort and keeps its share of the packed federation.
- ``fsdp``: the parameter axis. The global params rest sharded along it
  (each rank holds ``1/fsdp`` of every sharded leaf) and are gathered
  whole at use, ZeRO-3 style, so that a client's training is never
  tensor-split and stays bitwise the one-rank run's.

A leaf's class is a pure function of its name and rank
(:func:`classify_param`): ``dense_kernel``, ``conv_kernel``,
``embedding``, ``vector``, ``scalar``; an unknown leaf fails loudly, with
the JAX package's words. :class:`SpecLayout` names, per class, the axis
the reference shards, read in the port's tensor layout: a ``Linear``
weight is ``[out, in]`` and the reference shards its input rows
(``[in, out]`` axis 0), so the port's dim 1; a ``Conv2d`` weight is
``[out, in, kh, kw]`` and the reference shards the output channels (HWIO
axis 3), so dim 0 (a ``ConvTranspose`` weight ``[in, out, kh, kw]``: dim
1); an embedding its vocabulary rows, dim 0. A leaf the fsdp axis does
not divide there is replicated.

At rest a rank's leaf is its ``local_shard`` (``parallel/tensor.py``);
:func:`gather_tree` all-gathers it whole over the fsdp group.

The mesh (``parallel/mesh.SimMesh``) runs one process a rank over the
process group, so it spans the world (or, for the elastic shrink onto
survivors, the ranks it is given); the refusals of
:func:`build_fed_mesh` are the reference's, word for word, and a shape
smaller than those ranks (which the reference serves from a prefix of
its devices) is refused too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .tensor import Shard, gather_full, local_shard

Params = Dict[str, torch.Tensor]
Specs = Dict[str, Optional[Shard]]

AXIS_COHORT = "data"
AXIS_PARAM = "fsdp"

PARAM_CLASSES = (
    "dense_kernel",  # rank >= 2 weight of a Linear
    "conv_kernel",   # rank-4 weight of a (transposed) convolution
    "embedding",     # an Embed_<k> module's table (vocab x width)
    "vector",        # rank-1 bias / norm scale
    "scalar",        # rank-0 (optimizer counts)
)

__all__ = ["AXIS_COHORT", "AXIS_PARAM", "PARAM_CLASSES", "SpecLayout", "build_fed_mesh",
           "classify_param", "cohort_axis_size", "fed_mesh_shape", "gather_tree",
           "is_fed_mesh", "param_spec", "shard_tree", "tree_specs"]


def classify_param(name: str, ndim: int) -> str:
    """A leaf (its slash-joined key, or the leaf name alone, and its rank)
    -> its parameter class; raises on a family the table does not know."""
    parts = name.split("/")
    leaf, module = parts[-1], (parts[-2] if len(parts) > 1 else "")
    if ndim == 0:
        return "scalar"
    if ndim == 1:
        return "vector"
    if leaf == "weight" and module.startswith("Embed_"):
        return "embedding"
    if leaf == "weight" and ndim in (2, 4):
        return "conv_kernel" if ndim == 4 else "dense_kernel"
    raise ValueError(
        f"unknown parameter class for leaf {leaf!r} (rank {ndim}): not in "
        f"the layout vocabulary {PARAM_CLASSES} — add a canonical "
        "PartitionSpec for this family to parallel/layout.SpecLayout"
    )


@dataclasses.dataclass(frozen=True)
class SpecLayout:
    """Per parameter class, the dim of the port's tensor the reference's
    spec shards (None: replicated), over ``fsdp_axis``; the cohort's leaves
    ``[C, ...]`` shard their client axis over ``data_axis``."""

    data_axis: str = AXIS_COHORT
    fsdp_axis: str = AXIS_PARAM

    def sharded_dim(self, cls: str, ndim: int, transposed: bool = False) -> Optional[int]:
        if cls not in PARAM_CLASSES:
            raise ValueError(
                f"unknown parameter class {cls!r}; the layout table "
                f"covers {PARAM_CLASSES}"
            )
        if cls == "dense_kernel":
            return ndim - 1  # [..., out, in]: the input rows
        if cls == "conv_kernel":
            return 1 if transposed else 0  # the output channels
        if cls == "embedding":
            return 0  # the vocabulary rows
        return None


def param_spec(layout: SpecLayout, name: str, shape: Tuple[int, ...],
               fsdp_size: int) -> Optional[Shard]:
    """One leaf's at-rest shard, or None: replicated by its class, or
    because the fsdp axis does not divide its sharded dim."""
    cls = classify_param(name, len(shape))
    module = name.split("/")[-2] if "/" in name else ""
    dim = layout.sharded_dim(cls, len(shape), transposed=module.startswith("ConvTranspose_"))
    if dim is None or shape[dim] % max(fsdp_size, 1):
        return None
    return Shard(layout.fsdp_axis, dim)


def tree_specs(tree: Params, mesh, layout: Optional[SpecLayout] = None) -> Specs:
    """Every leaf's at-rest shard on ``mesh`` (all None off a fed mesh)."""
    layout = layout or SpecLayout()
    if not is_fed_mesh(mesh):
        return {k: None for k in tree}
    fsdp = int(mesh.shape.get(layout.fsdp_axis, 1))
    return {k: param_spec(layout, k, tuple(v.shape), fsdp) for k, v in tree.items()}


def shard_tree(tree: Params, mesh, specs: Optional[Specs] = None) -> Params:
    """This rank's at-rest shard of every leaf of the whole ``tree``."""
    specs = tree_specs(tree, mesh) if specs is None else specs
    size = int(mesh.shape.get(AXIS_PARAM, 1)) if is_fed_mesh(mesh) else 1
    coord = mesh.coords.get(AXIS_PARAM, 0) if is_fed_mesh(mesh) else 0
    return {k: local_shard(v, specs[k], coord, size) if specs[k] is not None else v
            for k, v in tree.items()}


def gather_tree(tree: Params, mesh, specs: Specs) -> Params:
    """The whole tree from every fsdp rank's shards (the at-use gather)."""
    group = mesh.groups.get(AXIS_PARAM) if is_fed_mesh(mesh) else None
    return {k: gather_full(v, specs[k], group) if specs[k] is not None else v
            for k, v in tree.items()}


def is_fed_mesh(mesh) -> bool:
    """True for the (data, fsdp) mesh; False for the legacy (clients[,
    data]) mesh and for None."""
    if mesh is None:
        return False
    names = set(mesh.axis_names)
    return AXIS_PARAM in names and AXIS_COHORT in names


def fed_mesh_shape(mesh_shape: Optional[dict]) -> bool:
    """Does a ``mesh_shape`` ask for the fed vocabulary? (an ``fsdp`` axis,
    or ``data`` without the legacy ``clients``)."""
    if not mesh_shape:
        return False
    return AXIS_PARAM in mesh_shape or (
        AXIS_COHORT in mesh_shape and "clients" not in mesh_shape
    )


def build_fed_mesh(mesh_shape: Optional[dict], world_size: int, device_type: str,
                   ranks: Optional[list] = None):
    """The named (data, fsdp) mesh over the process group's ``world_size``
    ranks; a missing axis is size 1 (``data`` by default takes the rest of
    the world). ``ranks`` (the elastic shrink onto survivors) lays the
    mesh over those ranks of the world instead, which it must span."""
    from .mesh import SimMesh

    n = int(world_size) if ranks is None else len(ranks)
    shape = dict(mesh_shape or {})
    unknown = set(shape) - {AXIS_COHORT, AXIS_PARAM}
    if unknown:
        raise ValueError(
            f"fed mesh axes are ({AXIS_COHORT!r}, {AXIS_PARAM!r}); got "
            f"unknown axes {sorted(unknown)} — the legacy simulator "
            "vocabulary is {'clients', 'data'} (parallel/mesh.build_mesh)"
        )
    for axis in (AXIS_COHORT, AXIS_PARAM):
        if axis in shape and int(shape[axis]) < 1:
            raise ValueError(
                f"fed mesh axis {axis!r}={shape[axis]!r}: must be >= 1 "
                "(omit the axis to auto-size it)"
            )
    fsdp = int(shape.get(AXIS_PARAM, 1))
    if fsdp > n:
        raise ValueError(
            f"fed mesh fsdp={fsdp} exceeds the {n} available devices"
        )
    data = int(shape.get(AXIS_COHORT, 0) or (n // max(fsdp, 1)))
    if data * fsdp > n:
        raise ValueError(
            f"fed mesh shape {{'data': {data}, 'fsdp': {fsdp}}} needs "
            f"{data * fsdp} devices, have {n}"
        )
    if data * fsdp < n and AXIS_COHORT not in shape:
        raise ValueError(
            f"fed mesh shape {{'data': {data}, 'fsdp': {fsdp}}} != "
            f"{n} devices"
        )
    if data * fsdp < n:
        raise ValueError(
            f"fed mesh shape {{'data': {data}, 'fsdp': {fsdp}}} spans {data * fsdp} of "
            f"the {n} ranks: the port runs one process a rank, so the mesh must span "
            "the world"
        )
    return SimMesh({AXIS_COHORT: data, AXIS_PARAM: fsdp}, device_type, ranks=ranks)


def cohort_axis_size(mesh) -> int:
    """How many lanes the cohort shards over: 'data' on a fed mesh,
    'clients' on the legacy mesh, 1 otherwise."""
    if mesh is None:
        return 1
    if is_fed_mesh(mesh):
        return int(mesh.shape[AXIS_COHORT])
    return int(mesh.shape.get("clients", 1))
