"""Model spec: an ``nn.Module`` + task type + loss, as one handle.

The port of ``fedml_tpu/models/spec.py``. Params are a flat
``{slash/joined/key: Tensor}`` dict (``Block_0/Dense_0/weight``), the
port's counterpart of the JAX package's params pytree: ``apply`` runs
the module on them through ``torch.func.functional_call``, so an
endpoint can swap the whole dict atomically without touching the
module. ``loss_fn`` looks the task's loss up in ``core.losses``, as the
JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..core.losses import LOSSES

Params = Dict[str, torch.Tensor]

# standard deviation of a standard normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC (or NHW) images, as the packed federation stores them ->
    NCHW for the convolutions; integer inputs become f32 and float
    inputs keep their dtype (flax ``ensure_float``: bf16 stays bf16)."""
    if x.dim() == 3:  # [B, H, W] -> [B, H, W, 1]
        x = x[..., None]
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return x.permute(0, 3, 1, 2)


def _orthogonal(rows: int, cols: int, generator: torch.Generator) -> torch.Tensor:
    """flax's ``orthogonal`` initializer: Q of the QR decomposition of a
    standard normal matrix, its columns' signs fixed by R's diagonal,
    ``[rows, cols]`` with orthonormal rows or columns."""
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return q if rows >= cols else q.T


@dataclasses.dataclass(frozen=True)
class FedModel:
    name: str
    module: nn.Module
    task: str = "classification"
    example_shape: Tuple[int, ...] = ()  # one example, no batch dim
    example_dtype: torch.dtype = torch.float32
    # integer inputs (token ids) must lie in [0, input_bound): checked on
    # the host where requests arrive, because an out-of-range id would
    # otherwise trip a device-side assert inside the embedding lookup
    input_bound: Optional[int] = None

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def init(self, generator: torch.Generator) -> Params:
        """Fresh params on the model's device, drawn from ``generator``
        (a CPU generator) from flax's default distributions: dense and
        convolution kernels lecun-normal (a normal truncated at two
        standard deviations, scaled to variance 1/fan_in; fan_in is the
        product of a weight's dims after the first), embeddings a plain
        normal of variance 1/width, biases zero, normalisation scales
        one; a weight a module lists in ``orthogonal_blocks`` (the LSTM's
        hidden kernels) orthogonal, block by block of that many rows; a
        weight a module lists in ``normal_scales`` (DARTS' alphas) that
        scale times a standard normal; a weight a module lists in
        ``truncated_fans`` lecun-normal at that fan_in, one in
        ``zero_params`` zero (a routed FFN's expert stacks and biases). A transposed convolution's weight
        is ``[in, out, kh, kw]``: its fan_in is ``in * kh * kw``, as
        flax's ``ConvTranspose`` kernel ``[kh, kw, in, out]`` has it."""
        def full(name, key):
            return f"{name}.{key}" if name else key

        # weight name -> fan_in
        truncated = {
            full(name, "weight"): (
                mod.weight.shape[0] * math.prod(mod.weight.shape[2:])
                if isinstance(mod, nn.ConvTranspose2d) else math.prod(mod.weight.shape[1:])
            )
            for name, mod in self.module.named_modules()
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d))
        }
        # a module's own truncated-normal weights (a routed FFN's expert
        # stacks, whose fan_in flax counts over the stack) and zero ones
        truncated.update({
            full(name, key): fan
            for name, mod in self.module.named_modules()
            for key, fan in getattr(mod, "truncated_fans", {}).items()
        })
        zeros = {full(name, key) for name, mod in self.module.named_modules()
                 for key in getattr(mod, "zero_params", ())}
        orthogonal = {
            full(name, key): rows
            for name, mod in self.module.named_modules()
            for key, rows in getattr(mod, "orthogonal_blocks", {}).items()
        }
        scaled = {
            full(name, key): scale
            for name, mod in self.module.named_modules()
            for key, scale in getattr(mod, "normal_scales", {}).items()
        }
        out = {}
        for key, p in self.module.named_parameters():
            leaf = key.rsplit(".", 1)[-1]
            if key in scaled:
                val = torch.randn(p.shape, generator=generator) * scaled[key]
            elif key in orthogonal:
                rows = orthogonal[key]
                val = torch.cat([_orthogonal(rows, p.shape[1], generator)
                                 for _ in range(p.shape[0] // rows)])
            elif leaf == "bias" or key in zeros:
                val = torch.zeros(p.shape)
            elif p.dim() == 1:
                val = torch.ones(p.shape)
            elif key in truncated:
                std = truncated[key] ** -0.5 / _TRUNC_STD
                val = nn.init.trunc_normal_(torch.empty(p.shape), 0.0, std, -2 * std,
                                            2 * std, generator=generator)
            else:
                val = torch.randn(p.shape, generator=generator) * math.prod(p.shape[1:]) ** -0.5
            out[key.replace(".", "/")] = val.to(device=p.device, dtype=p.dtype)
        return out

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        named = {k.replace("/", "."): v for k, v in params.items()}
        return torch.func.functional_call(self.module, named, (x,), strict=True)

    def param_count(self, params: Params) -> int:
        return sum(int(p.numel()) for p in params.values())

    @property
    def loss_fn(self) -> Callable:
        if self.task not in LOSSES:
            raise NotImplementedError(
                f"task {self.task!r}: its loss is not ported yet; it arrives "
                "with the slice that trains it (ROADMAP.md, queue A)"
            )
        return LOSSES[self.task]

    def metrics_from_sums(self, sums: Dict[str, float]) -> Dict[str, float]:
        """Summed ``loss_sum`` / ``correct`` / ``count`` (tensors or host
        floats) -> mean ``loss``, ``acc`` and the ``count``; for tag
        prediction, ``precision`` and ``recall`` from the summed
        ``tp``/``fp``/``fn`` and their F1 as ``acc``."""
        count = float(sums["count"])
        out = {
            "loss": float(sums["loss_sum"]) / max(count, 1.0),
            "count": count,
        }
        if self.task == "tag_prediction" and "tp" in sums:
            tp, fp, fn = float(sums["tp"]), float(sums["fp"]), float(sums["fn"])
            prec = tp / max(tp + fp, 1.0)
            rec = tp / max(tp + fn, 1.0)
            out["precision"] = prec
            out["recall"] = rec
            out["acc"] = 2 * prec * rec / max(prec + rec, 1e-12)
        else:
            out["acc"] = float(sums["correct"]) / max(count, 1.0)
        return out
