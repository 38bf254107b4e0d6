"""Spawned ``torch.distributed`` worlds for the port's CPU tests.

``run_world(fn, world, payload, tmp_path)`` starts ``world`` processes
(the ``spawn`` start method: the test process has JAX's threads), each
joining a gloo group through a ``FileStore`` under ``tmp_path`` (no TCP
port to collide across pytest-xdist workers) with one intra-op thread,
and calls ``fn(rank, payload)``; it returns every rank's result. A rank
that raises fails the test with its traceback; a world that outlives its
timeout (a hung collective) is killed and fails the test. This module
imports no JAX, so the children stay small; the worker functions live
here, importable by name in a child.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import time
import traceback
from typing import Any, Callable, List

import numpy as np


def _child(rank: int, world: int, store_path: str, fn_name: str, payload: Any,
           out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
        result = globals()[fn_name](rank, payload)
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_world(fn: Callable, world: int, payload: Any, tmp_path, timeout: float = 120.0
              ) -> List[Any]:
    """``fn(rank, payload)`` on every rank of a spawned gloo world; the
    results in rank order."""
    ctx = mp.get_context("spawn")
    out_dir = os.path.join(str(tmp_path), f"world_{fn.__name__}_{time.monotonic_ns()}")
    os.makedirs(out_dir)
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=_child, args=(r, world, store, fn.__name__, payload, out_dir),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = {r: open(os.path.join(out_dir, f"{r}.err")).read()
              for r in range(world) if os.path.exists(os.path.join(out_dir, f"{r}.err"))}
    if errors:
        raise AssertionError("ranks failed:\n" + "\n".join(
            f"-- rank {r}:\n{e}" for r, e in sorted(errors.items())))
    if hung:
        raise AssertionError(f"world of {world} timed out after {timeout} s; ranks {hung} "
                             "still running were killed")
    bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if bad:
        raise AssertionError(f"ranks exited nonzero: {bad}")
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def free_port_block(n: int, attempts: int = 50) -> int:
    """The first of ``n`` consecutive free loopback ports (a TRPC or gRPC
    rank binds ``base + rank``)."""
    import random
    import socket

    rng = random.Random()
    for _ in range(attempts):
        base = rng.randint(20000, 55000)
        socks = []
        try:
            for i in range(n):
                s = socket.socket()
                s.bind(("127.0.0.1", base + i))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no contiguous {n}-port block found")


# -- workers ------------------------------------------------------------


def _port_args(knobs: dict):
    from fedml_tpu_torch.arguments import Arguments

    a = Arguments()
    for k, v in knobs.items():
        setattr(a, k, v)
    a._validate()
    return a


def train(rank: int, payload: dict) -> list:
    """Each run of ``payload["runs"]`` in turn: ``DistributedTrainer``
    over the world with the run's knobs, full params (numpy, carried in)
    and, when given, the epochs' permutations; rank 0 returns, for each,
    the stats, the trained params (gathered whole), the slot occupancies
    of the last step and this rank's parameter shapes."""
    out = [_train_one(run) for run in payload["runs"]]
    return out if rank == 0 else None


def evaluate(rank: int, payload: dict) -> list:
    """Each run's ``DistributedTrainer.evaluate()`` on its carried-in
    params, before any training; rank 0 returns them."""
    out = [_trainer(run).evaluate() for run in payload["runs"]]
    return out if rank == 0 else None


def _trainer(run: dict):
    import torch

    import fedml_tpu_torch
    from fedml_tpu_torch import data, models
    from fedml_tpu_torch.distributed import DistributedTrainer

    args = fedml_tpu_torch.init(_port_args(run["args"]))
    dev = torch.device("cpu")
    dataset = data.load(args, device=dev)
    model = models.create(args, dataset.class_num, device=dev)
    params = None
    if run.get("params") is not None:
        params = {k: torch.tensor(v) for k, v in run["params"].items()}
    return DistributedTrainer(args, dev, dataset, model, params=params)


def _train_one(run: dict) -> dict:
    trainer = _trainer(run)
    perms = run.get("perms")
    if perms is not None:
        import torch

        trainer.epoch_permutation = lambda ep: torch.tensor(perms[ep], dtype=torch.int64)
    stats = trainer.run()
    return {"stats": stats,
            "params": {k: v.numpy() for k, v in trainer.full_params().items()},
            "occupancy": [o.numpy() for o in getattr(trainer, "last_occupancy", [])],
            "local_shapes": {k: tuple(v.shape) for k, v in trainer.params.items()}}


def run_api(rank: int, payload: dict) -> dict:
    """``fedml_tpu_torch.run_distributed`` in the world's process group."""
    import fedml_tpu_torch

    return fedml_tpu_torch.run_distributed(_port_args(payload["args"]), device="cpu")


def attention(rank: int, payload: dict) -> list:
    """Each case of ``payload["cases"]``: the sequence-sharded attention
    on this rank's shard of the case's [B, T, H, D] q, k, v; every rank's
    output shard and, with ``g``, the gradients of sum(o * g) for its q,
    k, v shards, or the ``ValueError`` it raised."""
    import torch.distributed as dist

    group = dist.new_group(list(range(dist.get_world_size())))
    return [_attention_one(rank, group, case) for case in payload["cases"]]


def _attention_one(rank: int, group, case: dict) -> dict:
    import torch
    import torch.distributed as dist

    from fedml_tpu_torch.parallel.sequence import make_sequence_sharded_attention

    t = case["q"].shape[1] // dist.get_world_size()
    dtype = getattr(torch, case.get("dtype", "float32"))
    q, k, v = (torch.tensor(case[x][:, rank * t:(rank + 1) * t]).to(dtype).requires_grad_()
               for x in "qkv")
    try:
        attn = make_sequence_sharded_attention(group, case["strategy"], causal=case["causal"],
                                               ring_block_k=case.get("block_k"))
        o = attn(q, k, v)
    except ValueError as e:
        return {"error": str(e)}
    out = {"o": o.detach().float().numpy()}
    if case.get("g") is not None:
        g = torch.tensor(case["g"][:, rank * t:(rank + 1) * t]).to(dtype)
        out["grads"] = [x.float().numpy() for x in torch.autograd.grad(o, (q, k, v), g)]
    return out


def collectives(rank: int, payload: dict) -> dict:
    """Each differentiable collective forward and backward on
    rank-dependent inputs."""
    import torch
    import torch.distributed as dist

    from fedml_tpu_torch.parallel import collectives as c

    n = dist.get_world_size()
    group = dist.new_group(list(range(n)))
    x = (torch.arange(2 * n * 3, dtype=torch.float64).reshape(2, n, 3) + 100 * rank
         ).requires_grad_()
    out = {}
    for name, fn in (("copy_to", lambda t: c.copy_to(t, group)),
                     ("reduce_from", lambda t: c.reduce_from(t, group)),
                     ("gather_from", lambda t: c.gather_from(t, 1, group)),
                     ("all_to_all", lambda t: c.all_to_all(t, 1, 0, group)),
                     ("ring_shift", lambda t: c.ring_shift(t, group))):
        y = fn(x)
        wy = torch.arange(y.numel(), dtype=torch.float64).reshape(y.shape) + rank
        (gx,) = torch.autograd.grad((y * wy).sum(), x)
        out[name] = (y.detach().numpy(), gx.numpy())
    return out


def layer(rank: int, payload: dict) -> list:
    """Each case of ``payload["cases"]``: an (MoE) transformer's logits
    and parameter gradients under the case's sharded mesh, on the same
    full params and tokens every rank holds; the layout's shards of the
    gradients gathered whole (rank 0 returns them)."""
    out = [_layer_one(case) for case in payload["cases"]]
    return out if rank == 0 else None


def _layer_one(case: dict) -> dict:
    import torch
    import torch.distributed as dist

    from fedml_tpu_torch import models
    from fedml_tpu_torch.models.moe import collect
    from fedml_tpu_torch.parallel.expert import attach_ep, tp_ep_layout
    from fedml_tpu_torch.parallel.mesh import build_mesh, resolve_mesh_shape
    from fedml_tpu_torch.parallel.tensor import attach_tp, gather_full, local_shard

    shape = resolve_mesh_shape(case["mesh_shape"], dist.get_world_size())
    mesh = build_mesh(shape, "cpu")
    coords = dict(zip(shape, (int(c) for c in np.unravel_index(dist.get_rank(),
                                                               tuple(shape.values())))))
    groups = {a: mesh.get_group(a) for a in shape}
    model = models.create(_port_args(case["args"]), case["vocab"], device="cpu")
    full = {k: torch.tensor(v) for k, v in case["params"].items()}
    layout = tp_ep_layout(full, shape, model.module.num_heads)
    if "tp" in shape:
        attach_tp(model.module, layout, groups["tp"], shape["tp"])
    if "ep" in shape:
        attach_ep(model.module, layout, groups["ep"], coords["ep"], shape["ep"])
    local = {k: (v if layout[k] is None else local_shard(
        v, layout[k], coords[layout[k].axis], shape[layout[k].axis])).clone().requires_grad_()
        for k, v in full.items()}
    with collect(model.module) as sink:
        logits = model.apply(local, torch.tensor(case["x"]))
    loss = (logits * torch.tensor(case["w"])).sum() + sum(sink["moe_aux_loss"], 0.0)
    grads = torch.autograd.grad(loss, list(local.values()))
    gathered = {k: g if layout[k] is None else gather_full(g, layout[k], groups[layout[k].axis])
                for k, g in zip(local, grads)}
    return {"logits": logits.detach().numpy(),
            "grads": {k: g.numpy() for k, g in gathered.items()},
            "sharded": sorted(k for k, s in layout.items() if s is not None),
            "local_shapes": {k: tuple(v.shape) for k, v in local.items()}}


def train_ranks(rank: int, payload: dict) -> list:
    """``train``'s runs, every rank returning its stats and its own local
    params (the pipeline mode's replicated leaves must agree on every
    stage)."""
    out = []
    for run in payload["runs"]:
        trainer = _trainer(run)
        perms = run.get("perms")
        if perms is not None:
            import torch

            trainer.epoch_permutation = lambda ep, p=perms: torch.tensor(p[ep], dtype=torch.int64)
        stats = trainer.run()
        out.append({"stats": stats,
                    "local": {k: v.detach().numpy() for k, v in trainer.params.items()},
                    "params": {k: v.numpy() for k, v in trainer.full_params().items()}})
    return out


def pipeline_op(rank: int, payload: dict) -> dict:
    """``parallel.pipeline.pipeline_apply`` over the world (one stage a
    rank) with stage s ``tanh(h @ w[s] + b[s])`` on the payload's stacked
    ``w`` [S, D, D], ``b`` [S, D] and microbatches ``x`` [M, mb, D]; the
    output and this rank's gradients of sum(out * g) for w, b and x."""
    import torch
    import torch.distributed as dist

    from fedml_tpu_torch.parallel.pipeline import pipeline_apply

    group = dist.new_group(list(range(dist.get_world_size())))
    params = {k: torch.tensor(payload[k]).requires_grad_() for k in ("w", "b")}
    x = torch.tensor(payload["x"]).requires_grad_()
    w, b = params["w"][rank], params["b"][rank]
    out = pipeline_apply(lambda h: torch.tanh(h @ w + b), x, group)
    gw, gb, gx = torch.autograd.grad((out * torch.tensor(payload["g"])).sum(),
                                     (params["w"], params["b"], x))
    return {"out": out.detach().numpy(), "w": gw.numpy(), "b": gb.numpy(), "x": gx.numpy()}


def mesh_sim(rank: int, payload: dict) -> list:
    """Each run of ``payload["runs"]``: ``SimulatorMesh`` over the world
    with the run's knobs (its ``mesh_shape``), or ``SimulatorSingleProcess``
    with ``"single": True``; on the run's ``dataset`` (numpy, carried in)
    or the port's own loader's, from its ``params`` (whole, numpy) or the
    model's init; with ``"custom_trainer": True`` the stock trainer goes
    in as a custom ``client_trainer``. Every rank returns, for each, the stats, the whole
    params, its own at-rest leaf shapes and the warnings logged, or the
    error the construction raised."""
    return [_mesh_one(run) for run in payload["runs"]]


def devtime_series(rank: int, payload: dict) -> list:
    """Each run of ``payload["runs"]`` as ``mesh_sim`` runs it, from a
    fresh telemetry registry; for each, the ``exec_device_seconds``
    series of its snapshot: ``{"executable|bucket": count}``."""
    from fedml_tpu_torch.core.telemetry import Telemetry

    out = []
    for run in payload["runs"]:
        Telemetry.reset()
        _mesh_one(run)
        hists = Telemetry.get_instance().snapshot()["histograms"]
        out.append(exec_series(hists))
    return out


def exec_series(histograms: dict) -> dict:
    """``{"executable|bucket": count}`` of the ``exec_device_seconds``
    histograms of a telemetry snapshot (either package's)."""
    out = {}
    for key, h in histograms.items():
        if not key.startswith("exec_device_seconds{"):
            continue
        tags = dict(part.split("=", 1) for part in key[key.index("{") + 1:-1].split(","))
        out[f"{tags.get('executable', '')}|{tags.get('bucket', '')}"] = int(h["count"])
    return out


def _np_dataset(d: dict):
    import torch

    from fedml_tpu_torch.core.types import Batches
    from fedml_tpu_torch.data.loader import FederatedDataset

    def cv(b):
        return Batches(x=torch.tensor(b[0]), y=torch.tensor(b[1], dtype=torch.int64),
                       mask=torch.tensor(b[2]))

    return FederatedDataset(
        train_data_num=d["train_data_num"], test_data_num=d["test_data_num"],
        train_data_global=cv(d["train_data_global"]), test_data_global=cv(d["test_data_global"]),
        train_data_local_num_dict=dict(d["train_data_local_num_dict"]),
        train_data_local_dict={}, test_data_local_dict={}, class_num=d["class_num"],
        packed_train=cv(d["packed_train"]), packed_num_samples=np.asarray(d["packed_num_samples"]),
        packed_test=cv(d["packed_test"]), client_num=d["client_num"], task=d["task"],
    )


def _mesh_one(run: dict) -> dict:
    import logging

    import torch

    from fedml_tpu_torch.parallel.elastic import Preempted

    import fedml_tpu_torch
    from fedml_tpu_torch import data, models
    from fedml_tpu_torch.simulation import SimulatorMesh, SimulatorSingleProcess

    args = fedml_tpu_torch.init(_port_args(run["args"]))
    dev = torch.device("cpu")
    ds = _np_dataset(run["dataset"]) if run.get("dataset") else data.load(args, device=dev)
    model = models.create(args, ds.class_num, device=dev)
    warned: list = []

    class _Catch(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())

    catch = _Catch(logging.WARNING)
    logging.getLogger().addHandler(catch)
    operators = {}
    if run.get("custom_trainer"):  # the stock trainer through the operator seam
        from fedml_tpu_torch.core.frame import DefaultClientTrainer

        operators["client_trainer"] = DefaultClientTrainer(None)
    try:
        try:
            sim = (SimulatorSingleProcess(args, dev, ds, model, **operators) if run.get("single")
                   else SimulatorMesh(args, dev, ds, model, **operators))
        except (ValueError, NotImplementedError) as e:
            return {"error": f"{type(e).__name__}: {e}"}
        api = sim.fl_trainer
        if run.get("params") is not None:
            full = {k: torch.tensor(v) for k, v in run["params"].items()}
            api.global_params = api._at_rest(full) if hasattr(api, "_at_rest") else full
        _arm_preemption(api, run)
        preempted = None
        try:
            stats = sim.run()
        except Preempted as e:
            stats, preempted = None, [e.round_idx, e.ckpt_step]
    finally:
        logging.getLogger().removeHandler(catch)
    full = api.full_params() if hasattr(api, "full_params") else api.global_params
    return {"stats": stats, "params": {k: v.detach().numpy() for k, v in full.items()},
            "local_shapes": {k: tuple(v.shape) for k, v in api.global_params.items()},
            "history": list(getattr(api, "history", [])), "warned": warned,
            "preempted": preempted}


def _arm_preemption(api, run: dict) -> None:
    """A run's preemption drill: ``preempt_at`` (a round) arms a
    ``SimulatedPreemption``; ``preempt_file`` ``{"path", "visible_to"}``
    arms a ``FilePreemption`` of ``path`` on rank ``visible_to`` only (the
    other ranks watch a path that never exists)."""
    import torch.distributed as dist

    from fedml_tpu_torch.parallel.elastic import FilePreemption, SimulatedPreemption

    if run.get("preempt_at") is not None:
        api._preempt_signal = SimulatedPreemption(int(run["preempt_at"]))
    if run.get("preempt_file"):
        spec = run["preempt_file"]
        seen = dist.get_rank() == spec["visible_to"]
        api._preempt_signal = FilePreemption(spec["path"] if seen else spec["path"] + ".absent")


def mesh_api(rank: int, payload: dict) -> dict:
    """``fedml_tpu_torch.run_simulation(backend=...)`` in the world's
    process group."""
    import fedml_tpu_torch

    return fedml_tpu_torch.run_simulation(backend=payload.get("backend", "MESH"),
                                          device="cpu", args=_port_args(payload["args"]))


def mesh_folds(rank: int, payload: dict) -> dict:
    """The streaming fold on fsdp-sharded params: over a {data: 1, fsdp:
    world} mesh, each rank folds its at-rest shards of the payload's
    trees (in two orders, and with part of them handed on as limbs by
    ``fold_limbs``); the gathered results, and the exact weighted mean of
    the stacked shards gathered whole."""
    import torch
    import torch.distributed as dist

    from fedml_tpu_torch.core.aggregation import StreamingAccumulator, exact_weighted_mean
    from fedml_tpu_torch.parallel.layout import build_fed_mesh, gather_tree, shard_tree, tree_specs

    mesh = build_fed_mesh({"data": 1, "fsdp": dist.get_world_size()}, dist.get_world_size(),
                          "cpu")
    trees = [{k: torch.tensor(v) for k, v in t.items()} for t in payload["trees"]]
    ws = payload["ws"]
    specs = tree_specs(trees[0], mesh)
    local = [shard_tree(t, mesh, specs) for t in trees]
    a1, a2 = StreamingAccumulator(local[0]), StreamingAccumulator(local[0])
    for i in range(len(local)):
        a1.fold(local[i], ws[i])
    for i in reversed(range(len(local))):
        a2.fold(local[i], ws[i])
    partial, root = StreamingAccumulator(local[0]), StreamingAccumulator(local[0])
    for t, w in zip(local[2:], ws[2:]):
        partial.fold(t, w)
    for t, w in zip(local[:2], ws[:2]):
        root.fold(t, w)
    root.fold_limbs(partial._limbs, sum(ws[2:]), count=partial.count)
    stacked = {k: torch.stack([t[k] for t in local]) for k in local[0]}
    mean = exact_weighted_mean(stacked, torch.tensor(ws) / sum(ws))

    def whole(tree):
        return {k: v.numpy() for k, v in gather_tree(tree, mesh, specs).items()}

    return {"forward": whole(a1.finalize()), "reverse": whole(a2.finalize()),
            "limbs": whole(root.finalize()), "count": root.count, "mean": whole(mean),
            "sharded": sorted(k for k, s in specs.items() if s is not None)}


def limb_travel(rank: int, payload: dict) -> dict:
    """The elastic plane's limb travel over a world: fold uploads 0-1
    whole (the world's ``{data: world, fsdp: 1}`` mesh keeps params
    whole), export the accumulator, ``reshape_limb_state`` onto
    ``surviving_mesh(payload["ranks"], payload["shape"])``, ``fold_limbs``
    on the survivors and fold uploads 2-3 there; raw, or with ``int8``
    each upload an int8-encoded delta against ``base`` folded through
    ``fold_encoded`` (the survivors then keep fsdp 1: an encoded upload
    decodes whole). The survivors' finalize gathered whole, and the
    unsplit fold of all four; ranks outside the survivors return their
    membership only."""
    import torch
    import torch.distributed as dist

    from fedml_tpu_torch.core.aggregation import StreamingAccumulator
    from fedml_tpu_torch.core.compression import Int8Codec
    from fedml_tpu_torch.parallel.elastic import reshape_limb_state, surviving_mesh
    from fedml_tpu_torch.parallel.layout import (build_fed_mesh, gather_tree, shard_tree,
                                                 tree_specs)

    world = dist.get_world_size()
    ups = [{k: torch.tensor(v) for k, v in t.items()} for t in payload["trees"]]
    base = {k: torch.tensor(v) for k, v in payload["base"].items()}
    ws = payload["ws"]
    codec = Int8Codec() if payload.get("int8") else None
    enc = [codec.encode({k: u[k] - base[k] for k in u}) for u in ups] if codec else None

    def fold(acc, i, mesh, specs, like):
        if codec is not None:
            acc.fold_encoded(codec, enc[i], like, ws[i])
        else:
            acc.fold(shard_tree(ups[i], mesh, specs), ws[i])

    full_mesh = build_fed_mesh({"data": world, "fsdp": 1}, world, "cpu")
    full_specs = tree_specs(base, full_mesh)
    ref, old = StreamingAccumulator(base), StreamingAccumulator(base)
    for i in range(4):
        fold(ref, i, full_mesh, full_specs, base)
    for i in range(2):
        fold(old, i, full_mesh, full_specs, base)
    mesh = surviving_mesh(payload["ranks"], payload["shape"], device_type="cpu",
                          min_devices=len(payload["ranks"]))
    out = {"member": mesh.member, "ranks": mesh.ranks, "full_ranks": full_mesh.ranks}
    state = reshape_limb_state(old.export_state(), mesh)
    if not mesh.member:
        return out
    specs = tree_specs(base, mesh)
    local_base = shard_tree(base, mesh, specs)
    new = StreamingAccumulator(local_base)
    new.fold_limbs(state["limbs"], state["total_w"], count=state["count"])
    for i in (2, 3):
        fold(new, i, mesh, specs, local_base)
    got = gather_tree(new.finalize(), mesh, specs)
    out.update(count=new.count, total_w=new.total_w, ref_total_w=ref.total_w,
               got={k: v.numpy() for k, v in got.items()},
               ref={k: v.numpy() for k, v in ref.finalize().items()},
               local_shapes={k: tuple(v.shape) for k, v in state["limbs"][0].items()})
    return out


def lane_gather(rank: int, payload: dict) -> list:
    """``SimMesh.gather_lane`` over a {data: world} mesh: each rank holds
    its contiguous share of the payload's federation (``x``, ``y``,
    ``mask`` numpy, [clients, ...]); for each cohort of ``payload["idx"]``
    this rank's lane ``[lo, hi)`` and the rows it received."""
    import torch
    import torch.distributed as dist

    from fedml_tpu_torch.core.types import Batches
    from fedml_tpu_torch.parallel.layout import build_fed_mesh
    from fedml_tpu_torch.parallel.mesh import shard_federation

    world = dist.get_world_size()
    mesh = build_fed_mesh({"data": world}, world, "cpu")
    packed = Batches(**{k: torch.tensor(payload[k]) for k in ("x", "y", "mask")})
    shard, _ = shard_federation(packed, packed.mask.sum(dim=(1, 2)), mesh)
    per = shard.mask.shape[0]
    out = []
    for idx in payload["idx"]:
        lane = mesh.gather_lane(shard, torch.tensor(idx, dtype=torch.int64), per)
        out.append({"span": mesh.lanes(len(idx)),
                    **{k: getattr(lane, k).numpy() for k in ("x", "y", "mask")}})
    return out


def planet_mesh(rank: int, payload: dict) -> dict:
    """The planet config's knobs through ``FedAvgAPI(mesh=...)`` on the
    payload's fed ``mesh_shape`` (none: no mesh); the whole params, the
    loop's stats and every rank's at-rest shapes."""
    import torch
    import torch.distributed as dist

    import fedml_tpu_torch
    from fedml_tpu_torch import data, models
    from fedml_tpu_torch.parallel.layout import build_fed_mesh
    from fedml_tpu_torch.simulation import FedAvgAPI

    args = fedml_tpu_torch.init(_port_args(payload["args"]))
    dev = torch.device("cpu")
    ds = data.load(args, device=dev)
    model = models.create(args, ds.class_num, device=dev)
    shape = payload.get("mesh_shape")
    mesh = build_fed_mesh(shape, dist.get_world_size(), "cpu") if shape else None
    api = FedAvgAPI(args, dev, ds, model, mesh=mesh)
    api.train()
    return {"params": {k: v.numpy() for k, v in api.full_params().items()},
            "stats": dict(api.pipeline_stats), "history": list(api.history),
            "local_shapes": {k: tuple(v.shape) for k, v in api.global_params.items()}}


def mesh_serve(rank: int, payload: dict) -> list:
    """Each run of ``payload["runs"]``: the run's model (port knobs
    ``args``, whole ``params`` numpy) served through ``MeshModelEndpoint``
    over the fed ``mesh_shape`` of the world: rank 0 runs a
    ``ServingEngine`` and sends ``xs`` as one paused burst, then again
    after each of the ``pubs`` swapped in as versions 1, 2, ... (and, with
    ``remesh``, after re-meshing onto that shape); the other ranks follow.
    Rank 0 returns the bursts' rows, the refusals it met and every rank's
    at-rest leaf shapes; with ``fleet`` the bursts go through a
    ``FleetFrontend`` of two mesh endpoints over LOCAL instead."""
    return [_mesh_serve_one(rank, run) for run in payload["runs"]]


def _mesh_serve_one(rank: int, payload: dict) -> dict:
    import torch
    import torch.distributed as dist

    from fedml_tpu_torch import models
    from fedml_tpu_torch.core.telemetry import Telemetry
    from fedml_tpu_torch.parallel.layout import build_fed_mesh
    from fedml_tpu_torch.serving import MeshModelEndpoint, ServingEngine, ServingFleet

    Telemetry.reset()  # this run's counters alone
    args = _port_args(payload["args"])
    model = models.create(args, payload["output_dim"], device="cpu")
    params = {k: torch.tensor(v) for k, v in payload["params"].items()}
    mesh = build_fed_mesh(payload["mesh_shape"], dist.get_world_size(), "cpu")
    pubs = [{k: torch.tensor(v) for k, v in p.items()} for p in payload["pubs"]]
    if payload.get("fleet"):
        fleet = ServingFleet.build(model, params, args, fleet_size=2, mesh=mesh)
        if rank != 0:
            fleet.follow()
            return {"local_shapes": _shapes(fleet.engines[0].endpoint)}
        return _fleet_bursts(args, fleet, payload, pubs)
    ep = MeshModelEndpoint(model, params, mesh)
    shapes = _shapes(ep)
    if rank != 0:
        ep.follow()
        return {"local_shapes": shapes}
    out = {"local_shapes": shapes, "rows": [], "errors": []}
    xs = [np.asarray(x) for x in payload["xs"]]
    with ServingEngine(ep, args) as eng:
        out["rows"].append(_mesh_burst(eng, xs))
        for v, pub in enumerate(pubs):
            ep.swap(pub, version=v + 1)
            out["rows"].append(_mesh_burst(eng, xs))
        # a stale publish is dropped and counted; a ragged batch refused
        out["stale_version"] = ep.swap(params, version=1)
        out["rejected"] = Telemetry.get_instance().get_counter(
            "serving_swaps_rejected_total", reason="stale_version")
        if ep.shard_multiple > 1:
            try:
                ep.infer(np.stack(xs[:1] * (ep.shard_multiple + 1)))
            except ValueError as e:
                out["errors"].append(str(e))
        try:  # a shrink must keep rank 0, which serves
            ep.remesh(devices=[1])
        except ValueError as e:
            out["errors"].append(str(e))
        if payload.get("remesh"):
            eng.stop()
            ep.remesh(mesh_shape=payload["remesh"])
            eng.batcher.shard_multiple = ep.shard_multiple
            eng.start()
            out["rows"].append(_mesh_burst(eng, xs))
        if payload.get("shrink"):  # the elastic shrink onto surviving ranks
            eng.stop()
            ep.remesh(**payload["shrink"])
            eng.batcher.shard_multiple = ep.shard_multiple
            eng.start()
            out["rows"].append(_mesh_burst(eng, xs))
            out["shrunk_mesh"] = dict(ep.mesh.shape)
        out["version"], out["swaps"] = ep.version, ep.swaps
    ep.release()
    return out


def _shapes(ep) -> dict:
    return {k: tuple(v.shape) for k, v in ep.params().items()}


def _mesh_burst(engine, xs):
    engine.pause()
    futs = engine.submit_many(xs, deadline_s=60.0)
    engine.resume()
    return np.stack([f.result(timeout=60) for f in futs])


def _fleet_bursts(args, fleet, payload, pubs) -> dict:
    """Rank 0 of a mesh fleet: clients over LOCAL ask the FleetFrontend
    for each of ``xs``, before and after each publish."""
    import threading

    from fedml_tpu_torch.serving import FleetFrontend, ServingClient, build_serving_com

    out = {"local_shapes": _shapes(fleet.engines[0].endpoint), "rows": []}
    xs = [np.asarray(x) for x in payload["xs"]]
    fleet.start()
    fe = FleetFrontend(fleet, build_serving_com(args, 0, 2, "LOCAL"), args)
    t = threading.Thread(target=fe.serve_forever, daemon=True)
    t.start()
    cl = ServingClient(build_serving_com(args, 1, 2, "LOCAL"), rank=1, args=args)
    try:
        out["rows"].append(np.stack([cl.request(x, timeout_s=30.0) for x in xs]))
        for v, pub in enumerate(pubs):
            fleet.hot_swap(pub, version=v + 1)
            out["rows"].append(np.stack([cl.request(x, timeout_s=30.0) for x in xs]))
        if payload.get("shrink"):  # the elastic shrink onto surviving ranks
            out["remeshed"] = fleet.remesh(**payload["shrink"])
            out["rows"].append(np.stack([cl.request(x, timeout_s=30.0) for x in xs]))
            out["shrunk_mesh"] = [dict(e.endpoint.mesh.shape) for e in fleet.engines]
        out["routed"] = list(fleet.routed)
    finally:
        cl.close()
        fe.stop()
        fleet.stop()
        fleet.release()
    return out


def cli_serve(rank: int, payload: dict) -> str:
    """``python -m fedml_tpu_torch.cli serve`` (its ``main``) on every rank
    of the world; rank 0 returns what it printed."""
    import contextlib
    import io

    from fedml_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(payload["argv"])
    assert rc == 0, rc
    return buf.getvalue()


def silo_step(rank: int, payload: dict) -> dict:
    """One silo of the world's ranks (``n_proc_in_silo`` = the world):
    ``TrainerDistAdapter.train`` of ``payload["silo"]`` at round 0 over
    the group, and, in the same process, the plain trainer's; each rank
    returns both params (numpy) and its ``batch_share``."""
    import torch.distributed as dist

    from fedml_tpu_torch import data, models
    from fedml_tpu_torch.cross_silo.hierarchical import (
        ProcessGroupManager,
        TrainerDistAdapter,
    )
    from fedml_tpu_torch.cross_silo.horizontal.fedml_client_manager import FedMLTrainer

    args = _port_args(dict(payload["args"], n_proc_in_silo=dist.get_world_size(),
                           proc_rank_in_silo=rank))
    dataset = data.load(args, device="cpu")
    model = models.create(args, dataset.class_num, device="cpu")
    params = model.init(__import__("torch").Generator().manual_seed(0))
    pg = ProcessGroupManager(args, device="cpu")
    adapter = TrainerDistAdapter(args, dataset, model, pg)
    adapter.update_dataset(payload["silo"])
    split, n = adapter.train(params, 0)
    plain = FedMLTrainer(args, dataset, models.create(args, dataset.class_num, device="cpu"))
    plain.update_dataset(payload["silo"])
    whole, n_whole = plain.train(params, 0)
    return {"split": {k: v.numpy() for k, v in split.items()},
            "whole": {k: v.numpy() for k, v in whole.items()},
            "n": (n, n_whole), "share": adapter.batch_share(),
            "group": pg.group is not None}
