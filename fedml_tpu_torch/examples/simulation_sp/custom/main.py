"""Custom-operator simulation (reference:
python/examples/simulation/sp_fedavg_mnist_lr_example/custom/ — user
subclasses the L3 operator frame, core/alg_frame/client_trainer.py:4-40).

The trainer below clips each client's delta to a max L2 norm before it
leaves the device — a 10-line federated-robustness tweak. The SAME
subclass works under the mesh simulator and cross-silo (see
examples/cross_silo/custom).

Run:  python main.py --cf fedml_config.yaml
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
    # model is created inside run_simulation; the trainer binds lazily
    # to it via make_train_fn, so passing the class-level instance with
    # model=None is fine for operators that don't touch self.model.
    final_stats = fedml_tpu_torch.run_simulation(
        client_trainer=ClippedDeltaTrainer(model=None)
    )
    print("FINAL:", final_stats)
