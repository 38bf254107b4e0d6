"""The distributed trainer's device mesh over ``torch.distributed``.

The port of ``fedml_tpu/parallel/mesh.py``'s ``build_mesh`` and of
``fedml_tpu/distributed.py``'s ``_resolve_mesh``: ``mesh_shape`` (axis
-> size, in the YAML's order) becomes a ``DeviceMesh`` over the process
group, one rank a device, ranks laid out row-major as JAX lays devices
out (the last axis fastest). Each axis's process group is
``mesh.get_group(axis)``. The default is one ``dp`` axis over the whole
world. The refusals are the JAX package's, word for word: an unknown
axis, ``sp`` or ``pp`` with any axis but ``dp``, more ranks than the
world has. The port runs one process a rank, every rank in the mesh, so
a mesh must span the world (JAX's multi-controller rule). ``pp`` is
refused after those checks: the pipeline mode is not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

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
    if "pp" in shape:
        raise NotImplementedError(
            f"mesh axis 'pp' ({shape}): the pipeline mode is not ported to PyTorch yet; "
            "it arrives with item 9b of the port (ROADMAP.md, queue A)"
        )
    return shape


def build_mesh(shape: Dict[str, int], device_type: str):
    """A ``DeviceMesh`` of ``shape`` over the initialised default process
    group, its dims named by the axes."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape.values()),
                            mesh_dim_names=tuple(shape.keys()))
