"""Long-context LM training — one line.

No reference counterpart (its only sequence models are small LSTMs,
SURVEY.md §2.9): this is the long-context path — the sequence axis
sharded over the mesh's ``sp`` ranks.

- ``sp_strategy: "ring"`` (this config): K/V blocks rotate over the
  ranks with a blockwise online softmax — per-rank score panels are
  O(T/sp x T/sp); the full [T, T] matrix never exists.
- ``sp_strategy: "ulysses"``: all-to-all head re-sharding; the per-rank
  attention for each head group runs the hand-written flash kernel
  (``fedml_tpu_torch/ops/flash_attention.py``) on a card, so even the
  gathered sequence never materializes its score matrix. Needs
  ``num_heads % sp == 0`` — this config ships num_heads: 8 so flipping
  the strategy alone works.

Run:  torchrun --nproc_per_node 8 main.py --cf fedml_config.yaml
      (8 cards, NCCL; on the CPU, gloo, with
      device_args: {device_type: cpu} in the YAML)
Try:  sp_strategy: "ulysses"
      mesh_shape: {dp: 2, sp: 4}  (batch sharded across replicas)
      seq_len: 4096               (drives the stand-in data length)
"""

import fedml_tpu_torch

if __name__ == "__main__":
    print("FINAL:", fedml_tpu_torch.run_distributed())
