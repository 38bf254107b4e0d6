"""Hierarchical cross-silo on the port: silos that are ``torch.distributed``
process groups (``fedml_tpu_torch/cross_silo/hierarchical``), on the CPU.

The JAX package's oracle (tests/test_hierarchical_cross_silo.py):
hierarchical == horizontal. There each silo shards its batch over a mesh
axis; here each silo is a gloo group, one OS process per rank, that
splits every batch's examples over its ranks and all-reduces the
gradient sums and counts, so the only difference from a plain client is
the summation order (1e-5, the JAX package's tolerance).

- A world of 2 silos x 2 ranks: the server in this process over TRPC,
  each silo started by ``launch_silo_processes`` (2 OS processes
  meeting at a TCP rendezvous, the silo's control fabric on gRPC);
  the server's final params within 1e-5 of a horizontal world's.
- A one-rank silo degenerates cleanly: no group, the plain trainer,
  bitwise the horizontal world.
- Each rank's share of the batch: a spawned gloo world of 2 ranks
  (``tests/torch_world.py``) trains one silo over the group; the
  shares partition the batch and the step is the whole batch's (within
  1e-5 of the one-process trainer in every rank).
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest

from fedml_tpu_torch.cross_silo import HierarchicalClient, Server
from fedml_tpu_torch.cross_silo.hierarchical import ProcessGroupManager, launch_silo_processes
from test_torch_cross_silo import (  # noqa: F401 (autouse fixture)
    BASE,
    _reset_planes,
    assert_bitwise,
    build,
    join_all,
    params_of,
    run_world,
)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_world import free_port_block, run_world as run_gloo_world

ATOL = 1e-5
HIER = dict(synthetic_train_size=256, synthetic_test_size=64, client_num_in_total=2,
            client_num_per_round=2, comm_round=2)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_silo_worker.py")


def test_two_silos_of_two_ranks_match_the_horizontal_world(tmp_path):
    flat = params_of(run_world("hier_flat", **HIER))
    trpc = free_port_block(3)
    a0, ds0, m0 = build(0, "hier_mp", "TRPC", trpc_port_base=trpc, **HIER)
    server = Server(a0, "cpu", ds0, m0)
    done = threading.Event()
    errors = []

    def serve():
        try:
            server.run()
        except BaseException as e:  # surfaced below, never swallowed
            errors.append(e)
        done.set()

    st = threading.Thread(target=serve, daemon=True)
    st.start()
    silo_ports = free_port_block(4)
    procs = []
    for silo in (1, 2):
        procs += launch_silo_processes(
            WORKER, 2, coordinator_port=free_port_block(1), silo_grpc_port_base=silo_ports,
            extra_argv=["--rank", str(silo), "--trpc_port_base", str(trpc),
                        "--run_id", "hier_mp", "--knobs", json.dumps(dict(BASE, **HIER)),
                        "--out", str(tmp_path)])
    try:
        deadline = time.monotonic() + 120
        while not done.is_set():
            failed = [p.returncode for p in procs if p.poll() not in (None, 0)]
            assert not failed, f"a silo process failed: {failed}"
            assert time.monotonic() < deadline, "the hierarchical world hung"
            time.sleep(0.1)
        codes = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    join_all([st])
    assert not errors, errors
    assert codes == [0, 0, 0, 0]
    assert server.manager.round_idx == 2
    seen = {}
    for silo in (1, 2):
        for proc in (0, 1):
            with open(tmp_path / f"silo{silo}_proc{proc}.json") as f:
                seen[silo, proc] = json.load(f)
    assert all(s["group"] for s in seen.values())
    assert seen[1, 0]["share"] == [0, 8] and seen[1, 1]["share"] == [8, 16]
    assert seen[1, 1]["rounds_joined"] == seen[2, 1]["rounds_joined"] == 2
    got = params_of(server)
    for k, v in flat.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=ATOL, err_msg=k)


def test_a_one_rank_silo_degenerates_cleanly():
    flat = params_of(run_world("hier1_flat", **HIER))
    a0, ds0, m0 = build(0, "hier1", **HIER)
    server = Server(a0, "cpu", ds0, m0)
    actors = []
    for silo in (1, 2):
        a, ds, m = build(silo, "hier1", n_proc_in_silo=1, **HIER)
        actors.append(HierarchicalClient(a, "cpu", ds, m))
        assert actors[-1].trainer.pg.group is None
        assert actors[-1].trainer.batch_share() == (0, 16)
    threads = [threading.Thread(target=c.run, daemon=True) for c in actors]
    for t in threads:
        t.start()
    server.run()
    join_all(threads)
    assert server.manager.round_idx == 2
    assert_bitwise(flat, params_of(server))


def test_each_rank_takes_its_share_of_the_batch(tmp_path):
    knobs = dict(training_type="cross_silo", dataset="mnist", synthetic_train_size=256,
                 synthetic_test_size=64, model="lr", client_num_in_total=2,
                 client_num_per_round=2, epochs=2, batch_size=16, learning_rate=0.1,
                 shuffle=True)
    outs = run_gloo_world(__import__("torch_world").silo_step, 2,
                          {"args": knobs, "silo": 1}, tmp_path)
    assert [o["share"] for o in outs] == [(0, 8), (8, 16)]
    assert all(o["group"] for o in outs)
    for o in outs:
        assert o["n"][0] == o["n"][1]
        for k, v in o["whole"].items():
            np.testing.assert_allclose(o["split"][k], v, atol=ATOL, err_msg=k)
    for k in outs[0]["split"]:  # every rank ends every step with the same params
        np.testing.assert_array_equal(outs[0]["split"][k], outs[1]["split"][k])


def test_a_silo_of_several_ranks_needs_its_group():
    a, ds, m = build(1, "nogroup", n_proc_in_silo=2, **HIER)
    with pytest.raises(ValueError, match="process group"):
        ProcessGroupManager(a, device="cpu")
    a.distributed_coordinator = "127.0.0.1:1"
    a.n_proc_in_silo = 1
    from fedml_tpu_torch.cross_silo.hierarchical import ensure_distributed_initialized

    with pytest.raises(ValueError, match="n_proc_in_silo"):
        ensure_distributed_initialized(a, device="cpu")
