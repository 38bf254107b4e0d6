"""One-line single-process simulation (reference:
python/examples/simulation/sp_fedavg_mnist_lr_example/one_line/main.py).

Run:  python main.py --cf fedml_config.yaml
"""

import fedml_tpu_torch

if __name__ == "__main__":
    final_stats = fedml_tpu_torch.run_simulation()
    print("FINAL:", final_stats)
