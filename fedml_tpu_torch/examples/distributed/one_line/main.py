"""Mesh-parallel (distributed) LM training — one line.

No reference counterpart: the reference's parallelism stops at FL
process-parallelism + in-silo DDP. Here the YAML's ``mesh_shape``
drives dp x tp x ep sharding, sequence parallelism (sp), or a GPipe
pipeline (pp) over the ranks of a ``torch.distributed`` world — see
``fedml_tpu_torch/distributed.py``. The shipped shape, {dp: 2, tp: 2,
ep: 2}, needs a world of 8 ranks, one process a rank:

Run:  torchrun --nproc_per_node 8 main.py --cf fedml_config.yaml
      (8 cards, NCCL; on the CPU, gloo, with
      device_args: {device_type: cpu} in the YAML)
"""

import fedml_tpu_torch

if __name__ == "__main__":
    print("FINAL:", fedml_tpu_torch.run_distributed())
