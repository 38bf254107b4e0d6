"""PyTorch/CUDA port of ``fedml_tpu``, for one NVIDIA H100.

A second package beside ``fedml_tpu``: module paths mirror it
(``fedml_tpu_torch/serving/engine.py`` is the port of
``fedml_tpu/serving/engine.py``), it imports ``torch`` and never JAX or
anything of ``fedml_tpu``, and every Pallas kernel on a ported path is a
hand-written Hopper kernel under ``ops/csrc``. Entry points take
``device=`` and default to ``"cuda"``; the CPU runs only when asked for.

Ported so far: the serving path of the flash-attention TransformerLM
(``serving.ServingEngine`` over ``serving.ModelEndpoint``,
``models.create`` and the flash-attention forward kernel), and FedAvg
training through ``run_simulation()`` (``init`` -> ``data.load`` ->
``models.create`` -> ``SimulatorSingleProcess`` -> ``FedAvgAPI.train``)
of the CNNs, the GroupNorm CIFAR zoo and the flash TransformerLM (with
``remat``). The fifth slice adds the reference's entry with custom
operators, ``run_simulation(backend, client_trainer,
server_aggregator)`` (``core/frame.py``), checkpoint and resume
(``checkpoint_dir``, ``core/checkpoint.py``) and the federated RNNs of
Shakespeare and Stack Overflow (``models/rnn.py``). The eighth brings
poisoned worlds (``poison_type``), the robust aggregation planes
(``defense_type``: clipping, weak DP, the median), S-FedAvg and
HS-FedAvg, the encoded and clipped streaming folds and the robust term
kernel. The tenth brings ``training_type: distributed`` through
``run_distributed()``: the Switch-MoE transformer over dp x tp x ep and
ring / Ulysses sequence parallelism on ``torch.distributed``
(``distributed.py``, ``parallel/``); the twelfth its pipeline mode and
the mesh simulator, ``run_simulation(backend="MESH")`` over the fed
``(data, fsdp)`` mesh (``parallel/layout.py``); the thirteenth the comm
layer and serving over it. The fourteenth brings the cross-silo
scenario (``cross_silo/``): ``run_cross_silo_server`` /
``run_cross_silo_client`` over LOCAL, TRPC, gRPC or MQTT, with the
streaming, buffered and async aggregation modes, the deadline and quorum
closes, elastic membership, the failure detector, crash recovery with
RESYNC and the anomaly screen; ``run_hierarchical_cross_silo_server`` /
``run_hierarchical_cross_silo_client`` for silos that are
``torch.distributed`` process groups; the edge tier over ranks
(``edge_plane: ranks``); and the chaos plane (``core/chaos.py``). The
fifteenth brings the cross-device planes (``cross_device/``): the
Beehive check-in federation (``run_beehive_world``: a gateway folding
pairwise-masked uploads of devices that check in and vanish, a device
host training them by speed tier on the card) and the legacy model-file
server (``run_edge_server``), with ``centralized.py``, the edge agent
(``edge_agent.py``) and the CLI's ``version``, ``login``, ``logout``,
``build``, ``edge`` and ``device``. The sixteenth brings the evidence
and recovery plane: the run-artifact exporters (``core/telemetry.py``:
``trace.json``, ``metrics.prom``, ``telemetry.jsonl``, the stall
watchdog, the ``/metrics`` server; ``core/sys_stats.py``), the trace
stitcher and round analyzer (``core/tracing.py``, ``cli trace``), the
post-hoc invariant checker (``core/invariants.py``, ``cli check``) and
elastic preemption (``parallel/elastic.py``: a signal polled at the
round boundary, a durable exit, a resume on the surviving ranks).
ROADMAP.md lists the slices still to come.
"""

from __future__ import annotations

import contextlib
import logging
import os
import random as _random
from typing import Optional

import numpy as np

from . import constants
from .arguments import MATMUL_PRECISIONS, Arguments, add_args
from .device import DeviceLike, get_device

__version__ = "0.1.0"


def init(args: Optional[Arguments] = None, device: DeviceLike = None) -> Arguments:
    """Load args (``--cf <yaml>`` from the command line when none are
    given), seed ``random`` and ``numpy``, and set the matmul precision.
    A cross-silo run takes its ``process_id`` from ``rank`` (a
    cross-device one is rank 0, process 0), and a hierarchical silo
    with a ``distributed_coordinator`` joins its ``torch.distributed``
    group here, before anything is built: gloo for a CPU ``device``,
    NCCL for a card.

    ``matmul_precision`` maps onto the two process-wide TF32 switches,
    ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``: ``"highest"`` (the default)
    turns both off, so f32 products stay f32; ``"high"``/``"default"``
    turn both on. This is the only place the port sets them. The port's
    own randomness comes from explicit ``torch.Generator``s, so the
    global torch seed is left alone."""
    if args is None:
        args = Arguments(add_args())
    seed = int(getattr(args, "random_seed", 0))
    _random.seed(seed)
    np.random.seed(seed)
    import torch

    tf32 = MATMUL_PRECISIONS[str(getattr(args, "matmul_precision", "highest"))]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    logging.info(
        "matmul_precision=%s: TF32 %s for cuBLAS and cuDNN",
        args.matmul_precision, "on" if tf32 else "off",
    )
    if args.training_type == constants.FEDML_TRAINING_PLATFORM_CROSS_SILO:
        args.process_id = int(getattr(args, "rank", 0))
        if getattr(args, "distributed_coordinator", None):
            from .cross_silo.hierarchical.process_group_manager import (
                ensure_distributed_initialized,
            )

            ensure_distributed_initialized(args, device if device is not None else "cuda")
    elif args.training_type == constants.FEDML_TRAINING_PLATFORM_CROSS_DEVICE:
        args.rank = 0
        args.process_id = 0
    else:
        args.process_id = 0
    return args


def run_simulation(
    backend: str = constants.FEDML_SIMULATION_TYPE_SP,
    client_trainer=None,
    server_aggregator=None,
    *,
    device: DeviceLike = "cuda",
    args: Optional[Arguments] = None,
):
    """One-line simulation entry: trains ``args.comm_round`` rounds of
    the configured algorithm on ``device`` and returns the last
    evaluated round's stats. ``args`` defaults to ``--cf <yaml>`` from
    the command line. Custom L3 operators (``core.frame``) plug in as
    ``client_trainer`` / ``server_aggregator``, positionally as in the
    reference. ``backend="MESH"`` (alias ``"NCCL"``) runs the mesh
    simulator over ``args.mesh_shape`` (``simulation.SimulatorMesh``),
    each rank calling it, in a process group the caller initialised, one
    made from ``torchrun``'s environment, or alone as a world of one
    rank."""
    dev = get_device(device)
    mesh = backend in (constants.FEDML_SIMULATION_TYPE_MESH, constants.FEDML_SIMULATION_TYPE_NCCL)
    if not mesh and backend != constants.FEDML_SIMULATION_TYPE_SP:
        raise ValueError(f"unknown simulation backend {backend!r}")
    from . import data, models
    from .simulation import SimulatorMesh, SimulatorSingleProcess

    args = init(args)
    if not mesh:
        dataset = data.load(args, device=dev)
        model = models.create(args, dataset.class_num, device=dev)
        return SimulatorSingleProcess(
            args, dev, dataset, model,
            client_trainer=client_trainer, server_aggregator=server_aggregator,
        ).run()
    with _process_group(dev) as dev:
        dataset = data.load(args, device=dev)
        model = models.create(args, dataset.class_num, device=dev)
        return SimulatorMesh(
            args, dev, dataset, model,
            client_trainer=client_trainer, server_aggregator=server_aggregator,
        ).run()


@contextlib.contextmanager
def _process_group(dev):
    """The default process group for a distributed or mesh run: the caller's if
    one is initialised; else one from ``torchrun``'s environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``), each rank
    on card ``LOCAL_RANK``; else a world of one rank in this process.
    NCCL for the card, gloo for the CPU. A group made here is destroyed
    on the way out. Yields the rank's device."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        yield dev
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def run_distributed(args: Optional[Arguments] = None, *, device: DeviceLike = "cuda"):
    """One-line mesh-parallel LM training, the ``training_type:
    distributed`` platform: ``args.mesh_shape`` picks the parallelism
    (dp x tp x ep, or sp with an optional dp; see ``distributed.py``).
    Returns the last epoch's stats. ``args`` defaults to ``--cf <yaml>``
    from the command line. Each rank calls it, in a process group the
    caller initialised or one made from the environment (``torchrun``),
    or alone as a world of one rank."""
    dev = get_device(device)
    from . import data, models
    from .distributed import DistributedTrainer

    args = init(args)
    with _process_group(dev) as dev:
        dataset = data.load(args, device=dev)
        model = models.create(args, dataset.class_num, device=dev)
        return DistributedTrainer(args, dev, dataset, model).run()


def _cross_silo_parts(args, device):
    """init -> data.load -> models.create for one cross-silo process, on
    ``device``; a silo process of a group on card (silo - 1) *
    silo_device_count + proc_rank_in_silo when that knob is set."""
    import torch

    from . import data, models

    dev = get_device(device)
    args = init(args, dev)
    if args.training_type != constants.FEDML_TRAINING_PLATFORM_CROSS_SILO:
        raise ValueError(
            f"training_type={args.training_type!r}: the cross-silo entry "
            "points run training_type=cross_silo"
        )
    cnt = int(getattr(args, "silo_device_count", 0) or 0)
    if dev.type == "cuda" and cnt > 0:
        silo = max(int(getattr(args, "rank", 1)), 1)
        dev = torch.device("cuda", (silo - 1) * cnt + int(args.proc_rank_in_silo))
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dataset = data.load(args, device=dev)
    model = models.create(args, dataset.class_num, device=dev)
    return args, dev, dataset, model


def run_cross_silo_server(args: Optional[Arguments] = None, server_aggregator=None, *,
                          device: DeviceLike = "cuda"):
    """One-line cross-silo server (the reference's __init__.py:172-191):
    rank 0 of the federation, serving ``comm_round`` rounds to the silos
    over ``args.backend``; with ``edge_plane: ranks`` the root of the
    edge tier. Returns the last evaluated round's stats."""
    from .cross_silo import Server
    from .cross_silo.hierarchical import HierRoot

    args, dev, dataset, model = _cross_silo_parts(args, device)
    if str(getattr(args, "edge_plane", "inproc")) == "ranks":
        root = HierRoot(args, dev, dataset, model, server_aggregator=server_aggregator)
        root.run()
        return getattr(root.aggregator, "last_stats", None)
    return Server(args, dev, dataset, model, server_aggregator=server_aggregator).run()


def run_cross_silo_client(args: Optional[Arguments] = None, client_trainer=None, *,
                          device: DeviceLike = "cuda"):
    """One-line cross-silo client (the reference's __init__.py:193-211):
    silo ``args.rank`` (>= 1) of the federation; with ``edge_plane:
    ranks`` it connects to its edge aggregator's fabric."""
    from .cross_silo import Client
    from .cross_silo.hierarchical import hier_partition, prepare_client_args

    args, dev, dataset, model = _cross_silo_parts(args, device)
    if str(getattr(args, "edge_plane", "inproc")) == "ranks":
        prepare_client_args(args, hier_partition(args, dataset))
    Client(args, dev, dataset, model, client_trainer=client_trainer).run()


def run_hierarchical_cross_silo_server(args: Optional[Arguments] = None,
                                       server_aggregator=None, *,
                                       device: DeviceLike = "cuda"):
    """One-line hierarchical cross-silo server (the reference's
    __init__.py:214-233): protocol-identical to the horizontal server;
    the hierarchy lives in the silos (each FL client a process group)."""
    return run_cross_silo_server(args, server_aggregator=server_aggregator, device=device)


def run_hierarchical_cross_silo_client(args: Optional[Arguments] = None,
                                       client_trainer=None, *,
                                       device: DeviceLike = "cuda"):
    """One-line hierarchical cross-silo client (the reference's
    __init__.py:235-253): one process of silo ``args.rank``; master or
    slave as ``args.proc_rank_in_silo`` says, the way the reference forks
    on the torchrun-derived process rank. A silo of several processes
    joins its ``torch.distributed`` group at ``distributed_coordinator``
    (or the one the caller initialised)."""
    from .cross_silo import HierarchicalClient

    args, dev, dataset, model = _cross_silo_parts(args, device)
    HierarchicalClient(args, dev, dataset, model, client_trainer=client_trainer).run()


def run_edge_server(args: Optional[Arguments] = None, *, device: DeviceLike = "cuda"):
    """One-line cross-device server, the reference's ``run_mnn_server``
    (its __init__.py:256-274): edge clients ship model files over the
    pub/sub plane (``args.cross_device_backend``, MQTT by default) and
    the server averages and evaluates them on ``device``. Serves
    ``comm_round`` rounds to ``client_num_per_round`` edge clients and
    returns the evaluation history."""
    from . import data, models
    from .cross_device import ServerEdge

    dev = get_device(device)
    args = init(args, dev)
    dataset = data.load(args, device=dev)
    model = models.create(args, dataset.class_num, device=dev)
    return ServerEdge(args, dev, dataset, model).run()
