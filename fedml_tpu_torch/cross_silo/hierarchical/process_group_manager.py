"""Silo process group + silo control-fabric dispatch (port of
``fedml_tpu/cross_silo/hierarchical/process_group_manager.py``).

The reference (``cross_silo/hierarchical/process_group_manager.py:6-43``)
calls ``dist.init_process_group`` (NCCL/GLOO) for the silo's compute and
a second ``new_group()`` for control messaging. Here the compute group
is a ``torch.distributed`` process group of the silo's
``n_proc_in_silo`` processes, one rank each: gloo on the CPU, NCCL on
the card. It is the default group of each silo process, joined at
``distributed_coordinator`` (``"host:port"``, a TCP rendezvous that
process 0 hosts), or the one the caller initialised. The control group is a silo-private message fabric
selected by ``args.silo_backend``:

- ``LOCAL`` (default): in-process queues, for silo actors that are
  threads of ONE process (a one-rank silo, the test configuration);
- ``GRPC``: rank-addressed gRPC on ``args.silo_grpc_port_base + rank``,
  the path of one OS process per rank, the counterpart of the
  reference's torchrun rendezvous + second gloo group
  (``dist_trainer_launcher.py:23-48``).

A one-rank silo takes no group at all: its master's step is the plain
trainer's.
"""

from __future__ import annotations

import logging
import threading

import torch

_dist_lock = threading.Lock()
_dist_initialized = False


def ensure_distributed_initialized(args, device="cuda") -> bool:
    """Join the silo's process group (idempotent): the default
    ``torch.distributed`` group of ``n_proc_in_silo`` ranks at
    ``distributed_coordinator``, gloo for a CPU ``device``, NCCL for a
    card. ``fedml_tpu_torch.init()`` calls it before any model or data
    is built (the reference initializes torch.distributed from
    torchrun's environment first, ``fedml/__init__.py:85-130``). Returns
    True when this run is a multi-process silo."""
    global _dist_initialized
    import torch.distributed as dist

    coordinator = getattr(args, "distributed_coordinator", None)
    n_proc = int(getattr(args, "n_proc_in_silo", 1) or 1)
    if not coordinator:
        return False
    if n_proc <= 1:
        # fail loudly: a coordinator with a 1-process group is always a
        # misconfiguration (the other host would hang as an orphan slave)
        raise ValueError(
            "distributed_coordinator is set but n_proc_in_silo is "
            f"{n_proc}; a multi-controller silo needs n_proc_in_silo >= 2"
        )
    with _dist_lock:
        if not dist.is_initialized():
            cuda = torch.device(device).type == "cuda"
            dist.init_process_group(
                "nccl" if cuda else "gloo",
                init_method=f"tcp://{coordinator}",
                world_size=n_proc,
                rank=int(getattr(args, "proc_rank_in_silo", 0) or 0),
            )
            _dist_initialized = True
            logging.info(
                "torch.distributed: joined %s as process %s/%d",
                coordinator, getattr(args, "proc_rank_in_silo", 0), n_proc,
            )
    return True


def silo_fabric_name(args) -> str:
    """Silo-private control-fabric name (one fabric per FL client)."""
    run_id = getattr(args, "run_id", "0")
    silo = int(getattr(args, "rank", 1))  # FL rank of this silo's client
    return f"hier_{run_id}_silo{silo}"


def build_silo_fabric(args, rank: int, size: int):
    """Control-fabric dispatch for the master->slave round broadcast
    (the reference's second ``new_group()``, process_group_manager.py:
    30-34). Ranks are silo-process ranks 0..size-1 (0 = master)."""
    backend = str(getattr(args, "silo_backend", "LOCAL") or "LOCAL").upper()
    if backend == "LOCAL":
        from ...core.comm.local import LocalCommunicationManager

        return LocalCommunicationManager(silo_fabric_name(args), rank, size)
    if backend == "GRPC":
        from ...core.managers import build_grpc_manager

        # per-silo port block: silo k (FL rank k, 1-based) owns
        # [base + (k-1)*size, base + k*size), so co-hosted silos do not
        # collide (the port-space analog of silo_fabric_name)
        base = int(getattr(args, "silo_grpc_port_base", 9890))
        silo = max(int(getattr(args, "rank", 1)), 1)
        return build_grpc_manager(
            rank,
            size,
            ipconfig_path=getattr(args, "silo_grpc_ipconfig_path", None),
            port_base=base + (silo - 1) * size,
        )
    raise ValueError(f"unsupported silo_backend {backend!r}")


class ProcessGroupManager:
    """Identity + lifecycle of one process inside a silo.

    ``n_proc_in_silo`` / ``proc_rank_in_silo`` mirror the reference's
    torchrun-derived environment. With more than one process the silo's
    compute group (``group``) is the default ``torch.distributed`` group,
    joined here when ``fedml_tpu_torch.init()`` has not done it already
    (the idempotent safety net for managers built directly); its size
    and this process's rank there must be the knobs'. ``group`` is None
    for a one-rank silo."""

    def __init__(self, args, device="cuda") -> None:
        import torch.distributed as dist

        self.args = args
        self.n_proc_in_silo = int(getattr(args, "n_proc_in_silo", 1) or 1)
        self.proc_rank_in_silo = int(getattr(args, "proc_rank_in_silo", 0) or 0)
        self.fabric_name = silo_fabric_name(args)
        self.group = None
        self.multi_controller = False
        if self.n_proc_in_silo > 1:
            ensure_distributed_initialized(args, device)
            if not dist.is_initialized():
                raise ValueError(
                    f"n_proc_in_silo={self.n_proc_in_silo} needs the silo's "
                    "process group: set distributed_coordinator, or "
                    "initialise torch.distributed before building the silo"
                )
            world, rank = dist.get_world_size(), dist.get_rank()
            if (world, rank) != (self.n_proc_in_silo, self.proc_rank_in_silo):
                raise ValueError(
                    f"the process group is rank {rank} of {world}; the silo "
                    f"knobs say rank {self.proc_rank_in_silo} of "
                    f"{self.n_proc_in_silo}"
                )
            self.group = dist.group.WORLD
            self.multi_controller = True

    def is_master(self) -> bool:
        return self.proc_rank_in_silo == 0

    def slave_ranks(self):
        return range(1, self.n_proc_in_silo)

    def build_fabric(self):
        """This process's endpoint on the silo control fabric."""
        return build_silo_fabric(self.args, self.proc_rank_in_silo, self.n_proc_in_silo)

    def cleanup(self) -> None:
        """Leave the silo's process group if this module joined it."""
        global _dist_initialized
        import torch.distributed as dist

        with _dist_lock:
            if _dist_initialized and dist.is_initialized():
                dist.destroy_process_group()
            _dist_initialized = False
