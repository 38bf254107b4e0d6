"""Mesh-parallel (distributed) LM training, stage by stage.

The one_line wrapper (``fedml_tpu_torch.run_distributed()``) does
exactly these stages; spelling them out is the integration surface —
each object can be replaced or inspected before the next stage consumes
it. (Reference analog: the step_by_step example tier,
python/examples/cross_silo/.../step_by_step/; the reference has no
mesh-parallel platform to give this treatment to.)

Run:  torchrun --nproc_per_node 8 main.py --cf fedml_config.yaml
      (8 cards, NCCL; on the CPU, gloo, with
      device_args: {device_type: cpu} in the YAML)
"""

import fedml_tpu_torch
from fedml_tpu_torch import data, device, models
from fedml_tpu_torch.distributed import DistributedTrainer

if __name__ == "__main__":
    # 1. init: parse --cf yaml into typed Arguments. mesh_args picks
    #    the parallelism: {"dp": 8}, {"dp": 2, "sp": 4}, {"pp": 4},
    #    {"dp": 2, "tp": 2, "ep": 2}, ...
    args = fedml_tpu_torch.init()

    # 2. device and process group: one process a rank (torchrun's
    #    environment), each rank on card LOCAL_RANK (NCCL) or the CPU
    #    (gloo); the group is destroyed on the way out
    with fedml_tpu_torch.process_group(device.get_device(args)) as dev:
        # 3. data: global batches; the trainer shards them over the mesh
        #    (batch axis -> dp, token axis -> sp)
        dataset = data.load(args, device=dev)

        # 4. model: a transformer LM with pluggable attention (sp swaps
        #    in ring / Ulysses attention; pp slices the layer stack)
        model = models.create(args, dataset.class_num, device=dev)

        # 5. runner: builds the DeviceMesh from mesh_args, shards
        #    params/opt-state/data over its axes, and runs the epoch loop
        #    (checkpointing + metrics included)
        trainer = DistributedTrainer(args, dev, dataset, model)
        print("FINAL:", trainer.run())
