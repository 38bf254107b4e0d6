"""Cross-device ("Beehive") round loop, single-host demonstration.

The reference's cross-device server (run_mnn_server, __init__.py:256)
serves Android/MNN clients over MQTT+S3: control messages on pub/sub
topics, model FILES on a payload store. Real edge clients are external
devices; this example runs the server plus three SIMULATED edge clients
(fedml_tpu_torch.cross_device.EdgeClientSim speaks the exact device
protocol: announce ONLINE, download the model file, train, upload file
+ sample count).

Run:  python main.py --cf fedml_config.yaml
"""

import tempfile
import threading

import fedml_tpu_torch
from fedml_tpu_torch import device, models
from fedml_tpu_torch.arguments import load_arguments
from fedml_tpu_torch.core.comm.payload_store import FilePayloadStore
from fedml_tpu_torch.core.local_trainer import make_local_train_fn
from fedml_tpu_torch.core.optimizers import create_client_optimizer
from fedml_tpu_torch.core.types import Batches
from fedml_tpu_torch.cross_device import EdgeClientSim, ServerEdge
from fedml_tpu_torch.data import load

if __name__ == "__main__":
    args = fedml_tpu_torch.init(load_arguments("cross_device"))
    args.payload_store_dir = getattr(
        args, "payload_store_dir", None
    ) or tempfile.mkdtemp(prefix="beehive_store_")
    dev = device.get_device(args)
    dataset = load(args, device=dev)
    model = models.create(args, dataset.class_num, device=dev)
    store = FilePayloadStore(args.payload_store_dir)
    server = ServerEdge(args, dev, dataset, model, store=store)

    n = int(args.client_num_per_round)
    clients = []
    for rank in range(1, n + 1):
        # a module a client thread: torch.func.functional_call swaps the
        # module's parameters in place while it runs
        local_model = models.create(args, dataset.class_num, device=dev)
        trainer = make_local_train_fn(
            local_model.apply, local_model.loss_fn, create_client_optimizer(args),
            epochs=int(args.epochs),
        )
        local = Batches(
            x=dataset.packed_train.x[rank - 1],
            y=dataset.packed_train.y[rank - 1],
            mask=dataset.packed_train.mask[rank - 1],
        )
        clients.append(
            EdgeClientSim(args, trainer, local, store, rank=rank, size=n + 1)
        )
    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    server.run()
    for t in threads:
        t.join(timeout=30)
    print("FINAL:", server.aggregator.history[-1] if server.aggregator.history else {})
