"""Custom-operator cross-silo client (reference example tier:
...grpc_fedavg_mnist_lr_example/custom/ — user subclasses the L3
operator frame, core/alg_frame/client_trainer.py:4-40, and hands it to
the runner).

The SAME ``ClippedDeltaTrainer`` pattern as
``examples/simulation_sp/custom`` — the L3 seam (core/frame.py) is a
pure train-fn factory, so one subclass runs unchanged under the SP
simulator, the mesh simulator, and (here) a real gRPC cross-silo
client process.

Run:  python client.py --cf fedml_config.yaml --rank <1..N>
"""

import torch

import fedml_tpu_torch
from fedml_tpu_torch import DefaultClientTrainer


class ClippedDeltaTrainer(DefaultClientTrainer):
    """Local training with a client-side update-norm cap."""

    MAX_NORM = 1.0

    def make_train_fn(self, args):
        inner = super().make_train_fn(args)

        def train(params, batches, rng):
            new, metrics = inner(params, batches, rng)
            delta = {k: new[k] - params[k] for k in params}
            norm = torch.sqrt(sum((d * d).sum() for d in delta.values()))
            scale = torch.clamp(self.MAX_NORM / torch.clamp(norm, min=1e-12), max=1.0)
            clipped = {k: params[k] + scale * delta[k] for k in params}
            return clipped, metrics

        return train


if __name__ == "__main__":
    fedml_tpu_torch.run_cross_silo_client(
        client_trainer=ClippedDeltaTrainer(model=None)
    )
