"""Hierarchical cross-silo client: this FL client is a silo whose ranks
form a ``torch.distributed`` process group, each training its share of
every batch (reference nests torch DDP here,
trainer_dist_adapter.py:40-141). This config runs one process per silo.

Run:  python client.py --cf fedml_config.yaml --rank <1..N>

Silos of several processes (one a card or host): set n_proc_in_silo,
proc_rank_in_silo, distributed_coordinator and silo_backend in the
YAML — or spawn them with
fedml_tpu_torch.cross_silo.hierarchical.launch_silo_processes.
"""

import fedml_tpu_torch

if __name__ == "__main__":
    fedml_tpu_torch.run_hierarchical_cross_silo_client()
