"""Cross-silo FL client, stage by stage (reference:
...grpc_fedavg_mnist_lr_example/step_by_step/torch_client.py).

Run:  python client.py --cf fedml_config.yaml --rank <1..N>
"""

import fedml_tpu_torch
from fedml_tpu_torch import data, device, models
from fedml_tpu_torch.core.tracking import device_trace
from fedml_tpu_torch.cross_silo import Client

if __name__ == "__main__":
    # 1. init: parse --cf yaml + --rank into typed Arguments
    args = fedml_tpu_torch.init()

    # 2. device
    dev = device.get_device(args)

    # 3. data: this silo's shard (rank indexes the partition)
    dataset = data.load(args, device=dev)

    # 4. model
    model = models.create(args, dataset.class_num, device=dev)

    # 5. runner: connect, train on request, ship updates (swap in a
    #    custom ClientTrainer via Client(..., client_trainer=...))
    client = Client(args, dev, dataset, model)
    with device_trace(args, dev):
        client.run()
