"""Model spec: an ``nn.Module`` + task type + example shape, as one handle.

The port of ``fedml_tpu/models/spec.py``. Params are a flat
``{slash/joined/key: Tensor}`` dict (``Block_0/Dense_0/weight``), the
port's counterpart of the JAX package's params pytree: ``apply`` runs
the module on them through ``torch.func.functional_call``, so an
endpoint can swap the whole dict atomically without touching the
module.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

Params = Dict[str, torch.Tensor]


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
        (a CPU generator): dense and embedding weights from a normal
        with variance 1/fan_in (flax's lecun-normal family), biases
        zero, normalisation scales one."""
        out = {}
        for key, p in self.module.named_parameters():
            leaf = key.rsplit(".", 1)[-1]
            if leaf == "bias":
                val = torch.zeros(p.shape)
            elif p.dim() == 1:
                val = torch.ones(p.shape)
            else:
                val = torch.randn(p.shape, generator=generator) * p.shape[1] ** -0.5
            out[key.replace(".", "/")] = val.to(device=p.device, dtype=p.dtype)
        return out

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        named = {k.replace("/", "."): v for k, v in params.items()}
        return torch.func.functional_call(self.module, named, (x,), strict=True)

    def param_count(self, params: Params) -> int:
        return sum(int(p.numel()) for p in params.values())
