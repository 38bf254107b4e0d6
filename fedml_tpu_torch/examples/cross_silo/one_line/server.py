"""Cross-silo FL server (reference:
python/examples/cross_silo/grpc_fedavg_mnist_lr_example/one_line/
torch_server.py).

Run:  python server.py --cf fedml_config.yaml --rank 0
"""

import fedml_tpu_torch

if __name__ == "__main__":
    fedml_tpu_torch.run_cross_silo_server()
