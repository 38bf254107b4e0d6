"""Cross-silo FL client (reference: ...one_line/torch_client.py).

Run:  python client.py --cf fedml_config.yaml --rank <1..N>
"""

import fedml_tpu_torch

if __name__ == "__main__":
    fedml_tpu_torch.run_cross_silo_client()
