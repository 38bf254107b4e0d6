"""Elastic preemption: drain, durable exit, reshaped resume (port of
``fedml_tpu/parallel/elastic.py``).

Fleets lose cards mid-run (maintenance, spot preemption, a failed
link), and the response this module packages is: get durable, get out,
come back on whatever survived, and prove nothing changed.

1. **Signal.** A pluggable :class:`PreemptionSignal` polled once per
   round at the round boundary: :class:`SimulatedPreemption` (a scripted
   round trigger), :class:`FilePreemption` (another process touches a
   file), :class:`MetadataPreemption` (the GCE metadata server's
   ``maintenance-event``; an unreachable server reads as "no event") and
   :class:`ChaosPreemption` (the chaos plane's ``elastic.check`` event,
   ``core/chaos.py``). The port runs one process a rank: on a mesh of
   several ranks rank 0 polls and broadcasts its answer
   (:func:`poll_world`), so the world agrees, and a notice only another
   rank can see never splits or hangs it.

2. **Drain and durable exit.** On notice the round loop finishes the
   round in flight (the pipeline waits on every queued round's event and
   flushes its deferred metrics first), then :func:`preempt_now` appends
   a WAL ``kind="preempt"`` record write-ahead of a forced checkpoint and
   raises :class:`Preempted` on every rank, a clean controlled exit.
   Only rank 0 writes the WAL and the checkpoint; every rank takes part
   in gathering the params the checkpoint holds.

3. **Reshaped resume.** The restart builds its world on the surviving
   ranks (:func:`surviving_mesh` refuses to run below
   ``elastic_min_devices``), restores the checkpoint onto the new mesh at
   rest, appends the paired ``kind="resume"`` record, and reshards any
   exported streaming-accumulator state with
   :func:`reshape_limb_state`: limbs travel through
   ``export_state``/``fold_limbs``, so every fold made before the
   preemption is carried exactly once. The fed mesh finalizes bitwise
   the same on every ``(data, fsdp)`` shape, so the resumed run's params
   are bitwise those of the run that never stopped (for the linear
   model; a convolution's CPU arithmetic depends on how many clients a
   rank trains).

A "device" here is a rank of the process group (each rank owns one
card): a mesh's devices render as ``"<type>:<rank>"``, so the WAL's
``devices`` differ from the JAX package's strings while their count and
``mesh_shape`` agree.

Counters: ``elastic_preemptions_total`` (on the preempt path) and
``elastic_resumes_total`` (on a resume that consumed a preempt record).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence

__all__ = [
    "PreemptionNotice",
    "Preempted",
    "PreemptionSignal",
    "SimulatedPreemption",
    "FilePreemption",
    "MetadataPreemption",
    "ChaosPreemption",
    "make_signal",
    "poll_world",
    "surviving_mesh",
    "reshape_limb_state",
    "preempt_now",
    "recovery_clock",
]


class PreemptionNotice:
    """An impending-eviction notice: why, and whatever the source knew.

    ``detail`` is schema-free source context (the metadata event body,
    the chaos fault step, the trigger round); it rides into the WAL
    record verbatim, so a post-mortem can tell a scripted drill from a
    real maintenance event.
    """

    def __init__(self, reason: str, detail: Optional[Dict[str, Any]] = None):
        self.reason = str(reason)
        self.detail = dict(detail or {})

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"PreemptionNotice(reason={self.reason!r}, detail={self.detail!r})"


class Preempted(RuntimeError):
    """Clean controlled exit after a drained round and durable state.

    Raised by :func:`preempt_now` after the WAL preempt record and the
    forced checkpoint are durable: the catcher may exit the process
    knowing a restart on the surviving ranks resumes where this stopped.
    """

    def __init__(self, notice: PreemptionNotice, round_idx: int, ckpt_step: int):
        self.notice = notice
        self.round_idx = int(round_idx)
        self.ckpt_step = int(ckpt_step)
        super().__init__(
            f"preempted ({notice.reason}) after round {round_idx}; "
            f"checkpoint step {ckpt_step} is durable — restart on the "
            "surviving devices to resume"
        )


class PreemptionSignal:
    """Base seam: ``poll(round_idx)`` -> notice or None, polled at the
    round boundary only (after the round's fold is final and any cadence
    checkpoint has fired), so a notice never tears a round."""

    def poll(self, round_idx: int) -> Optional[PreemptionNotice]:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


class SimulatedPreemption(PreemptionSignal):
    """Scripted maintenance-event drill: fires once ``round_idx``
    reaches ``at_round``."""

    def __init__(self, at_round: int, reason: str = "maintenance-simulated"):
        self.at_round = int(at_round)
        self.reason = str(reason)

    def poll(self, round_idx: int) -> Optional[PreemptionNotice]:
        if int(round_idx) >= self.at_round:
            return PreemptionNotice(
                self.reason, {"at_round": self.at_round, "round": int(round_idx)}
            )
        return None

    def describe(self) -> str:
        return f"round:{self.at_round}"


class FilePreemption(PreemptionSignal):
    """Fires when ``path`` exists (an external supervisor touches the
    file to request a drain)."""

    def __init__(self, path: str):
        self.path = str(path)

    def poll(self, round_idx: int) -> Optional[PreemptionNotice]:
        import os

        if os.path.exists(self.path):
            return PreemptionNotice(
                "preempt-file", {"path": self.path, "round": int(round_idx)}
            )
        return None

    def describe(self) -> str:
        return f"file:{self.path}"


class MetadataPreemption(PreemptionSignal):
    """GCE metadata-server maintenance-event poll.

    ``http://metadata.google.internal/computeMetadata/v1/instance/
    maintenance-event`` returns ``NONE`` between events and
    ``TERMINATE_ON_HOST_MAINTENANCE`` (or similar) when eviction is
    scheduled. Off GCE the server is unreachable: that reads as "no
    event", never an error. Stdlib urllib only.
    """

    URL = (
        "http://metadata.google.internal/computeMetadata/v1/"
        "instance/maintenance-event"
    )

    def __init__(self, timeout_s: float = 1.0):
        self.timeout_s = float(timeout_s)

    def poll(self, round_idx: int) -> Optional[PreemptionNotice]:
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            self.URL, headers={"Metadata-Flavor": "Google"}
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                body = resp.read().decode("utf-8", "replace").strip()
        except (urllib.error.URLError, OSError, ValueError):
            return None  # off GCE / transient: no event
        if body and body.upper() != "NONE":
            return PreemptionNotice(
                "maintenance-event", {"event": body, "round": int(round_idx)}
            )
        return None

    def describe(self) -> str:
        return "metadata"


class ChaosPreemption(PreemptionSignal):
    """Bridge from the chaos plane: a ``preempt`` or ``device.loss``
    fault scheduled on the ``elastic.check`` event becomes a notice, so
    drills ride the same reproducible (schedule, seed) machinery as every
    other fault."""

    def poll(self, round_idx: int) -> Optional[PreemptionNotice]:
        from ..core.chaos import elastic_event

        fault = elastic_event(int(round_idx))
        if fault is None:
            return None
        return PreemptionNotice(
            str(fault.get("kind", "preempt")),
            {"chaos_fault": dict(fault), "round": int(round_idx)},
        )

    def describe(self) -> str:
        return "chaos"


def make_signal(spec) -> Optional[PreemptionSignal]:
    """Parse the ``preempt_signal`` knob into a signal source.

    ``None``/``""``/``"none"`` -> no signal; ``"round:K"`` ->
    :class:`SimulatedPreemption`; ``"file:/path"`` ->
    :class:`FilePreemption`; ``"metadata"`` ->
    :class:`MetadataPreemption`; ``"chaos"`` -> :class:`ChaosPreemption`.
    Anything else is a loud ValueError: a misspelled signal must not run
    signal-free.
    """
    if spec is None or isinstance(spec, PreemptionSignal):
        return spec
    s = str(spec).strip()
    if not s or s.lower() == "none":
        return None
    if s.startswith("round:"):
        raw = s[len("round:"):]
        try:
            at = int(raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"preempt_signal={spec!r}: 'round:K' needs an integer "
                "round index"
            ) from None
        if at < 0:
            raise ValueError(
                f"preempt_signal={spec!r}: round index must be >= 0"
            )
        return SimulatedPreemption(at)
    if s.startswith("file:"):
        path = s[len("file:"):]
        if not path:
            raise ValueError(
                f"preempt_signal={spec!r}: 'file:PATH' needs a path"
            )
        return FilePreemption(path)
    if s == "metadata":
        return MetadataPreemption()
    if s == "chaos":
        return ChaosPreemption()
    raise ValueError(
        f"preempt_signal={spec!r}: expected none | round:K | file:PATH "
        "| metadata | chaos"
    )


def _world() -> tuple:
    """``(rank, world size)`` of the initialised process group, else
    ``(0, 1)``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def poll_world(signal: PreemptionSignal, round_idx: int,
               mesh=None) -> Optional[PreemptionNotice]:
    """``signal.poll(round_idx)`` agreed on by the mesh: with a mesh of
    several ranks, its first rank polls and broadcasts its notice (or
    none) to every rank of the mesh, one collective a round; alone, the
    poll itself."""
    rank, world = _world()
    if mesh is None or world == 1:
        return signal.poll(int(round_idx))
    import torch.distributed as dist

    box = [None]
    first = mesh.ranks[0]  # rank 0, or a sub-mesh's first member
    if rank == first:
        notice = signal.poll(int(round_idx))
        box = [None if notice is None else (notice.reason, notice.detail)]
    dist.broadcast_object_list(box, src=first, group=mesh.group)
    if box[0] is None:
        return None
    return PreemptionNotice(*box[0])


def surviving_mesh(devices: Optional[Sequence[int]] = None,
                   mesh_shape: Optional[dict] = None, *, min_devices: int = 1,
                   device_type: str = "cuda"):
    """The fed mesh over the ranks that survived.

    The restart world's entry point: ``devices`` are the surviving ranks
    of the process group (None: every rank of the world) and
    ``mesh_shape`` the reshaped ``{data, fsdp}``. ``min_devices`` (the
    ``elastic_min_devices`` knob) is the floor below which resuming is
    refused loudly: below it the operator wants a page, not a crawl.
    """
    from .layout import build_fed_mesh

    _, world = _world()
    ranks = list(range(world)) if devices is None else [int(d) for d in devices]
    floor = max(1, int(min_devices))
    if len(ranks) < floor:
        raise RuntimeError(
            f"elastic resume refused: {len(ranks)} surviving devices "
            f"< elastic_min_devices={floor} — not enough capacity to "
            "continue; restore on a bigger slice or lower the floor"
        )
    return build_fed_mesh(mesh_shape, world, device_type, ranks=ranks)


def reshape_limb_state(state: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Re-place exported streaming-accumulator limbs onto ``mesh``.

    ``state`` is ``StreamingAccumulator.export_state()`` of an
    accumulator over whole params: three host-numpy limb trees plus the
    exact host-float ``total_w`` and int ``count``. Each limb becomes
    this rank's at-rest shard on the new mesh, on the mesh's device (the
    same placement params get); feeding the result to ``fold_limbs`` on
    a fresh accumulator of that rank's shards carries every fold made
    before the preemption across the reshape, bitwise: the limbs are the
    fold history, and ``fold_limbs`` folds each of them once.
    """
    from .layout import is_fed_mesh, shard_tree

    if mesh is None or not is_fed_mesh(mesh):
        return state
    import numpy as np
    import torch

    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    out = dict(state)
    out["limbs"] = [
        shard_tree({k: torch.as_tensor(np.asarray(v)).to(device) for k, v in limb.items()},
                   mesh)
        for limb in state["limbs"]
    ]
    return out


def _mesh_devices(mesh) -> List[str]:
    """The mesh's devices, ``"<type>:<rank>"`` in mesh order (none
    without a mesh)."""
    if mesh is None:
        return []
    return [f"{mesh.device_type}:{r}" for r in mesh.ranks]


def _mesh_shape(mesh) -> Dict[str, int]:
    """JSON-safe ``{axis: size}`` of a mesh (WAL extra blocks)."""
    if mesh is None:
        return {}
    return {str(k): int(v) for k, v in dict(mesh.shape).items()}


def preempt_now(
    api, ckpt, round_idx: int, notice: PreemptionNotice, *, saved: bool = False
) -> None:
    """Durable exit: WAL ``kind="preempt"`` write-ahead, forced
    checkpoint, then raise :class:`Preempted`.

    Called at the round boundary after round ``round_idx`` fully drained
    (its fold final in ``api.global_params``) on every rank of the world.
    The WAL record lands before the checkpoint publish: the invariant
    checker pairs every preempt record with the checkpoint it promises
    (``preempt_paired_with_checkpoint``), so a crash between the two
    writes is detectable from the artifacts. ``saved=True`` skips the
    forced save when the cadence block already published this round's
    step. Rank 0 writes; every rank takes part in the save's gather.
    """
    from ..core.checkpoint import RoundWAL

    if ckpt is None:
        raise RuntimeError(
            "preemption notice with no checkpointer: set checkpoint_dir "
            "so the drained round can be made durable before exiting"
        )
    mesh = getattr(api, "mesh", None)
    if _world()[0] == 0:
        extra = {
            "reason": notice.reason,
            "devices": _mesh_devices(mesh),
            "mesh_shape": _mesh_shape(mesh),
            **notice.detail,
        }
        RoundWAL(ckpt.dir).append(
            int(round_idx), int(round_idx), [], kind="preempt", extra=extra
        )
    if not saved:
        api._save_checkpoint(ckpt, int(round_idx))
    if mesh is not None and _world()[1] > 1:
        import torch.distributed as dist

        dist.barrier()  # no rank leaves before rank 0's step is durable
    tel = getattr(api, "telemetry", None)
    if tel is not None and getattr(tel, "enabled", False):
        tel.inc("elastic_preemptions_total")
    logging.warning(
        "preemption (%s): round %d drained, checkpoint step %d durable "
        "— exiting cleanly; resume on the surviving devices",
        notice.reason, int(round_idx), int(round_idx),
    )
    raise Preempted(notice, int(round_idx), int(round_idx))


def recovery_clock() -> float:
    """Monotonic stamp for the resume world's recovery time (from the
    restart world's build to its first completed round)."""
    return time.perf_counter()
