"""Hierarchical cross-silo server — protocol-identical to horizontal
(the hierarchy lives client-side; reference __init__.py:214-233).

Run:  python server.py --cf fedml_config.yaml --rank 0
"""

import fedml_tpu_torch

if __name__ == "__main__":
    fedml_tpu_torch.run_hierarchical_cross_silo_server()
