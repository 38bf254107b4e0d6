"""Model hub (port of ``fedml_tpu/models/__init__.py``).

``create(args, output_dim, device=...)`` builds the model ``args.model``
names on ``device``. The port has the ``transformer`` branch so far;
every other name raises ``NotImplementedError`` naming the slice of the
port that brings it (ROADMAP.md, queue A).
"""

from __future__ import annotations

import torch

from ..device import DeviceLike, get_device
from .spec import FedModel

__all__ = ["FedModel", "create"]

# model name -> the port slice that brings it
_LATER = {
    **dict.fromkeys(
        ("lr", "mlp", "cnn", "resnet18", "resnet18_gn", "resnet56", "resnet"),
        "the FedAvg training slice",
    ),
    "moe_transformer": "the ring/Ulysses slice, with the expert-parallel planes",
}


def create(args, output_dim: int, device: DeviceLike = "cuda") -> FedModel:
    """The model ``args.model`` names, its weights on ``device``."""
    dev = get_device(device)
    name = str(getattr(args, "model", "lr")).lower()
    if name == "transformer":
        from .transformer import TransformerLM

        # class_num is the floor, so every label id is a valid token
        vocab = max(int(getattr(args, "vocab_size", 0) or 0), output_dim)
        seq_len = int(getattr(args, "seq_len", 64))
        module = TransformerLM(
            vocab_size=vocab,
            num_layers=int(getattr(args, "num_layers", 2)),
            num_heads=int(getattr(args, "num_heads", 4)),
            embed_dim=int(getattr(args, "embed_dim", 128)),
            max_len=max(seq_len, int(getattr(args, "max_len", 512))),
            attention=getattr(args, "attention_impl", "full"),
        ).to(dev)
        return FedModel(
            name="transformer_lm",
            module=module,
            task="nwp",
            example_shape=(seq_len,),
            example_dtype=torch.int64,
            input_bound=vocab,
        )
    later = _LATER.get(name, "a later slice")
    raise NotImplementedError(
        f"model {name!r} is not ported to PyTorch yet; it arrives with "
        f"{later} (ROADMAP.md, queue A). Ported: 'transformer'."
    )
