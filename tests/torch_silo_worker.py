"""One OS process of a hierarchical silo (test worker), started by
``fedml_tpu_torch.cross_silo.hierarchical.launch_silo_processes``: the
torchrun-style entry of one silo rank. Process 0 is the silo's master
(an FL client of the server over TRPC), the others its slaves; all join
the silo's gloo group at the coordinator. Writes what it saw to
``--out``.

    python tests/torch_silo_worker.py --proc_rank_in_silo 0 --n_proc_in_silo 2 \
        --distributed_coordinator 127.0.0.1:<port> --silo_grpc_port_base <base> \
        --rank 1 --trpc_port_base <base> --run_id r --out <dir>
"""

import argparse
import json
import os
import sys


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--proc_rank_in_silo", type=int, required=True)
    p.add_argument("--n_proc_in_silo", type=int, required=True)
    p.add_argument("--distributed_coordinator", required=True)
    p.add_argument("--silo_grpc_port_base", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--trpc_port_base", type=int, required=True)
    p.add_argument("--run_id", required=True)
    p.add_argument("--knobs", default="{}")
    p.add_argument("--out", required=True)
    ns = p.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    torch.set_num_threads(1)
    import fedml_tpu_torch
    from fedml_tpu_torch import data, models
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.cross_silo import HierarchicalClient

    a = Arguments()
    knobs = dict(json.loads(ns.knobs), backend="TRPC", silo_backend="GRPC",
                 rank=ns.rank, run_id=ns.run_id, trpc_port_base=ns.trpc_port_base,
                 n_proc_in_silo=ns.n_proc_in_silo, proc_rank_in_silo=ns.proc_rank_in_silo,
                 distributed_coordinator=ns.distributed_coordinator,
                 silo_grpc_port_base=ns.silo_grpc_port_base)
    for k, v in knobs.items():
        setattr(a, k, v)
    a._validate()
    args = fedml_tpu_torch.init(a, "cpu")
    dataset = data.load(args, device="cpu")
    model = models.create(args, dataset.class_num, device="cpu")
    client = HierarchicalClient(args, "cpu", dataset, model)
    group = client.trainer.pg.group is not None
    share = client.trainer.batch_share()
    client.run()
    out = {"group": group, "share": list(share),
           "rounds_joined": getattr(client.manager, "rounds_joined", None)}
    with open(os.path.join(ns.out, f"silo{ns.rank}_proc{ns.proc_rank_in_silo}.json"), "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
