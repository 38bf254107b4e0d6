"""Cross-silo FL server, stage by stage (reference teaching surface:
python/examples/cross_silo/grpc_fedavg_mnist_lr_example/step_by_step/
torch_server.py — init / device / data / model / runner as explicit
user-visible stages instead of the one_line wrapper).

Run:  python server.py --cf fedml_config.yaml --rank 0
"""

import fedml_tpu_torch
from fedml_tpu_torch import data, device, models
from fedml_tpu_torch.core.tracking import device_trace
from fedml_tpu_torch.cross_silo import Server

if __name__ == "__main__":
    # 1. init: parse --cf yaml + --rank into typed Arguments
    args = fedml_tpu_torch.init()

    # 2. device: the torch device this process trains/aggregates on
    #    (device_args.device_type: "cuda" by default)
    dev = device.get_device(args)

    # 3. data: load + partition + pack onto the device
    dataset = data.load(args, device=dev)

    # 4. model: factory keyed on model_args.model
    model = models.create(args, dataset.class_num, device=dev)

    # 5. runner: gRPC server loop — presence handshake, cohort
    #    selection, aggregation (swap in a custom ServerAggregator via
    #    Server(..., server_aggregator=...) to override aggregation)
    server = Server(args, dev, dataset, model)
    with device_trace(args, dev):
        server.run()
