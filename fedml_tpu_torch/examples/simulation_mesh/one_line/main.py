"""One-line mesh simulation — the cohort's client axis sharded over the
ranks of a ``torch.distributed`` world, one process a rank, aggregation
as a collective (the reference's SimulatorNCCL stub done for real;
SURVEY.md §7 step 4).

On one card this is a world of one rank. A world of several ranks is
started by torchrun, one process a card (NCCL), or on the CPU with
``device_args: {device_type: cpu}`` in the YAML (gloo):

  torchrun --nproc_per_node 8 main.py --cf fedml_config.yaml

client_num_per_round must tile the mesh's 'clients' axis (here the
world, 8 ranks).

For the production (data, fsdp) mesh — params sharded at rest, the
round bitwise identical at any mesh shape — set

  train_args:
    mesh_shape: {data: 4, fsdp: 2}

and client_num_per_round must tile the 'data' axis instead.
"""

import fedml_tpu_torch

if __name__ == "__main__":
    final_stats = fedml_tpu_torch.run_simulation(backend="MESH")
    print("FINAL:", final_stats)
