"""Model hub (port of ``fedml_tpu/models/__init__.py``).

``create(args, output_dim, device=...)`` builds the model ``args.model``
names on ``device``. Ported so far: ``lr``, ``mlp`` (multi-label tag
prediction for ``stackoverflow_lr``), ``cnn`` (the FEMNIST
CNN, or the CIFAR one for RGB datasets), the GroupNorm CIFAR zoo
(``resnet18``/``resnet18_gn``, ``resnet56``/``resnet``, ``vgg11``-``19``,
``mobilenet``, ``mobilenet_v3``, ``efficientnet-b0``-``b4``),
``transformer`` (``remat`` included), ``moe_transformer`` (Switch
MoE blocks every ``moe_every``, ``num_experts``, ``capacity_factor``), ``rnn`` (the Shakespeare LSTM,
or the Stack Overflow one for ``stackoverflow*`` datasets), ``deeplab``
(FedSeg's DeepLabLite, ``seg_width``) and ``darts`` (FedNAS's search
network, ``nas_*``); every other name raises ``NotImplementedError``
naming the slice of the port that brings it (ROADMAP.md, queue A). The
pairs of the split and adversarial algorithms (``gan``, ``gkt``,
``vfl``) are built by their simulators, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from ..device import DeviceLike, get_device
from .cnn import CNNCifar, CNNFedAvg
from .efficientnet import efficientnet
from .linear import MLP, LogisticRegression
from .mobilenet import MobileNetV1, MobileNetV3Small
from .resnet import resnet18_gn, resnet56
from .spec import FedModel
from .vgg import vgg

__all__ = ["FedModel", "create"]

_IMAGE_SHAPES = {
    "mnist": (28, 28, 1),
    "femnist": (28, 28, 1),
    "fashion_mnist": (28, 28, 1),
    "cifar10": (32, 32, 3),
    "cifar100": (32, 32, 3),
    "cinic10": (32, 32, 3),
    "fed_cifar100": (32, 32, 3),
    "fets2021": (64, 64, 4),
}
_RGB = ("cifar10", "cifar100", "cinic10", "fed_cifar100", "imagenet", "gld23k", "gld160k")


def _example_shape(args, default=(28, 28, 1)):
    ds = str(getattr(args, "dataset", "synthetic")).lower()
    if ds in ("synthetic", "stackoverflow_lr"):
        return (int(getattr(args, "input_dim", 60)),)
    if ds in ("imagenet", "gld23k", "gld160k"):
        hw = int(getattr(args, "image_size", 64) or 64)
        return (hw, hw, 3)
    return _IMAGE_SHAPES.get(ds, default)


def _image_zoo(name: str):
    """(canonical name, builder(output_dim, in_channels)) of the
    GroupNorm CIFAR zoo, or None."""
    if name in ("resnet18", "resnet18_gn"):
        return "resnet18_gn", resnet18_gn
    if name in ("resnet56", "resnet"):
        return "resnet56", resnet56
    if name == "mobilenet":
        return "mobilenet", MobileNetV1
    if name in ("mobilenet_v3", "mobilenetv3"):
        return "mobilenet_v3", MobileNetV3Small
    if name.startswith("vgg"):
        return name, lambda out, in_channels: vgg(name, out, in_channels)
    if name.startswith("efficientnet"):
        return name, lambda out, in_channels: efficientnet(name, out, in_channels)
    return None


def create(args, output_dim: int, device: DeviceLike = "cuda") -> FedModel:
    """The model ``args.model`` names, its weights on ``device``."""
    dev = get_device(device)
    name = str(getattr(args, "model", "lr")).lower()
    ds = str(getattr(args, "dataset", "synthetic")).lower()
    if name in ("lr", "mlp"):
        shape = _example_shape(args)
        in_dim = math.prod(shape)
        module = (
            LogisticRegression(in_dim, output_dim)
            if name == "lr"
            else MLP(in_dim, int(getattr(args, "hidden_dim", 64)), output_dim)
        )
        # multi-label tag prediction pairs the same modules with the
        # sigmoid cross-entropy (the reference's model hub: lr on
        # stackoverflow_lr)
        task = "tag_prediction" if ds == "stackoverflow_lr" else "classification"
        return FedModel(name=name, module=module.to(dev), task=task, example_shape=shape)
    if name == "cnn":
        if ds in _RGB:
            shape = _example_shape(args, (32, 32, 3))
            return FedModel(
                name="cnn_cifar",
                module=CNNCifar(output_dim, image_size=shape[0]).to(dev),
                example_shape=shape,
            )
        return FedModel(
            name="cnn", module=CNNFedAvg(output_dim).to(dev), example_shape=(28, 28, 1)
        )
    zoo = _image_zoo(name)
    if zoo is not None:
        canonical, build = zoo
        shape = _example_shape(args, (32, 32, 3))
        return FedModel(
            name=canonical,
            module=build(output_dim, in_channels=shape[-1]).to(dev),
            example_shape=shape,
        )
    if name == "deeplab":
        from .deeplab import DeepLabLite

        shape = _example_shape(args, (64, 64, 3))
        module = DeepLabLite(output_dim, width=int(getattr(args, "seg_width", 32)),
                             in_channels=shape[-1])
        return FedModel(name="deeplab_lite", module=module.to(dev), task="segmentation",
                        example_shape=shape)
    if name == "darts":
        from .darts import DARTSNetwork

        shape = _example_shape(args, (32, 32, 3))
        module = DARTSNetwork(
            output_dim,
            width=int(getattr(args, "nas_width", 16)),
            num_cells=int(getattr(args, "nas_cells", 2)),
            steps=int(getattr(args, "nas_steps", 2)),
            in_channels=shape[-1],
        )
        return FedModel(name="darts_search", module=module.to(dev), example_shape=shape)
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
            remat=bool(getattr(args, "remat", False)),
        ).to(dev)
        return FedModel(
            name="transformer_lm",
            module=module,
            task="nwp",
            example_shape=(seq_len,),
            example_dtype=torch.int32,
            input_bound=vocab,
        )
    if name == "moe_transformer":
        from .moe import MoETransformerLM

        vocab = max(int(getattr(args, "vocab_size", 0) or 0), output_dim)
        seq_len = int(getattr(args, "seq_len", 64))
        module = MoETransformerLM(
            vocab_size=vocab,
            num_layers=int(getattr(args, "num_layers", 2)),
            num_heads=int(getattr(args, "num_heads", 4)),
            embed_dim=int(getattr(args, "embed_dim", 128)),
            max_len=max(seq_len, int(getattr(args, "max_len", 512))),
            num_experts=int(getattr(args, "num_experts", 8)),
            capacity_factor=float(getattr(args, "capacity_factor", 1.25)),
            moe_every=int(getattr(args, "moe_every", 2)),
            attention=getattr(args, "attention_impl", "full"),
            remat=bool(getattr(args, "remat", False)),
        ).to(dev)
        return FedModel(
            name="moe_transformer_lm",
            module=module,
            task="nwp",
            example_shape=(seq_len,),
            example_dtype=torch.int32,
            input_bound=vocab,
        )
    if name == "rnn":
        from .rnn import RNNOriginalFedAvg, RNNStackOverflow

        # the vocab covers the dataset's token ids (class_num is the
        # floor); an explicit vocab_size still wins over the default
        if "stackoverflow" in ds:
            vocab = max(int(getattr(args, "vocab_size", 0) or 10004), output_dim)
            canonical, module = "rnn_stackoverflow", RNNStackOverflow(vocab_size=vocab)
            seq_len = int(getattr(args, "seq_len", 20))
        else:
            vocab = max(int(getattr(args, "vocab_size", 0) or 90), output_dim)
            canonical, module = "rnn_fedavg", RNNOriginalFedAvg(vocab_size=vocab)
            seq_len = int(getattr(args, "seq_len", 80))
        return FedModel(
            name=canonical,
            module=module.to(dev),
            task="nwp",
            example_shape=(seq_len,),
            example_dtype=torch.int32,
            input_bound=vocab,
        )
    raise NotImplementedError(
        f"model {name!r} is not ported to PyTorch yet; it arrives with "
        "a later slice (ROADMAP.md, queue A). Ported: 'lr', 'mlp', 'cnn', the GroupNorm "
        "CIFAR zoo ('resnet18', 'resnet56', 'vgg*', 'mobilenet', 'mobilenet_v3', "
        "'efficientnet-b*'), 'transformer', 'moe_transformer', 'rnn', 'deeplab' and "
        "'darts'."
    )
