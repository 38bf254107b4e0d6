"""Versioned model endpoint: params on the device, atomic hot swap.

The port of ``fedml_tpu/serving/endpoint.py``. The endpoint owns the
served params (a flat ``{key: Tensor}`` dict on its device) and runs the
model's forward on bucket-padded batches.

``swap`` replaces the params dict atomically under a lock, after
checking that the new dict has the same keys and, per tensor, the same
shape, dtype and device as the one served. That is the port's analogue
of the JAX endpoint's structure/shape/dtype/sharding check: weights
for another model configuration fail loudly before any request sees
them.

What does not carry over: eager PyTorch has no trace, so there is no
per-bucket trace count (``trace_counts``). The served forward is
``build_forward``'s, which the compiled-artifact audit traces across the
serve-bucket census on fake tensors (``serving.forward``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..analysis.compiled import auditable, pow2_budget
from ..models.spec import FedModel, Params

__all__ = ["ModelEndpoint", "build_forward"]


@auditable(
    "serving.forward",
    census_budget=lambda ctx: pow2_budget(ctx.serve_buckets),
)
def _audit_forward_cases(ctx):
    """`cli audit` provider: the served forward the endpoint runs,
    traced across the serve-bucket census on fake tensors. The hot rule
    proves a request never makes the card wait on the host."""
    from ..analysis.compiled import LoweringCase

    fn = build_forward(ctx.model().apply)
    params = ctx.abstract_params()
    return [
        LoweringCase(key=f"b{b}", fn=fn, args=(params, ctx.sds((b, ctx.feature_dim))))
        for b in ctx.serve_buckets
    ]


def build_forward(apply_fn):
    """The served forward as a pure function of the model's ``apply``:
    ``fwd(params, x)`` on one bucket-padded batch on the device, without
    autograd. Module-level, so that the audit traces the computation the
    endpoints run without building one."""

    def fwd(params: Params, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return apply_fn(params, x)

    return fwd


def _spec(params: Params) -> List[Tuple[str, Tuple[int, ...], str, str]]:
    """Per-key (shape, dtype, device) — metadata only, no device reads."""
    return [
        (k, tuple(v.shape), str(v.dtype), str(v.device))
        for k, v in sorted(params.items())
    ]


class ModelEndpoint:
    """The served (model, params, version) triple behind the engine."""

    def __init__(self, model: FedModel, params: Dict, version: int = 0) -> None:
        self.model = model
        # the card (or the CPU, when the model was created there) the
        # model's module lives on
        self.device = model.device
        self._lock = threading.Lock()
        self._params = self._place(params)
        self._served = build_forward(model.apply)
        self.version = int(version)
        self.swaps = 0

    # -- placement -----------------------------------------------------
    def _place(self, params: Dict) -> Params:
        """Own copies on the endpoint's device: the initial params and
        every swap go through the same placement, and a caller's later
        in-place edit can never reach the served weights."""
        return {
            k: torch.as_tensor(v).detach().to(self.device, copy=True)
            for k, v in params.items()
        }

    # -- inference -----------------------------------------------------
    shard_multiple: int = 1

    def params(self) -> Params:
        with self._lock:
            return self._params

    def infer(self, x: np.ndarray) -> torch.Tensor:
        """Forward one (already bucket-padded) host batch on the device.
        The params read and the forward use the same snapshot — a swap
        landing midway affects the NEXT batch, never tears this one."""
        params = self.params()
        xt = torch.as_tensor(x).to(self.device)
        return self._served(params, xt)

    # -- hot swap ------------------------------------------------------
    def swap(self, new_params: Dict, version: Optional[int] = None) -> int:
        """Atomically replace the served params; returns the new version
        (``version`` or the old version + 1). Raises ``ValueError`` when
        the new params change any key, shape, dtype or device."""
        return self._install(self._placed_checked(new_params), version)

    def _placed_checked(self, new_params: Dict) -> Params:
        """``new_params`` placed as the served ones are, after checking
        that they match them key by key."""
        placed = self._place(new_params)
        old, new = _spec(self.params()), _spec(placed)
        if old != new:
            diff = [(a, b) for a, b in zip(old, new) if a != b][:3]
            raise ValueError(
                "hot swap rejected: published params do not match the "
                "served model's keys/shapes/dtypes/device "
                f"({len(old)} served, {len(new)} published; first "
                f"differences served->published: {diff})"
            )
        return placed

    def _install(self, placed: Params, version: Optional[int]) -> int:
        with self._lock:
            self._params = placed
            self.version = int(version) if version is not None else self.version + 1
            self.swaps += 1
            v = self.version
        from ..core.telemetry import Telemetry

        tel = Telemetry.get_instance()
        if tel.enabled:
            tel.inc("serving_swaps_total")
            tel.set_gauge("serving_model_version", v)
            tel.recorder.instant("serve.swap", cat="serving", version=v)
        return v

    def swap_from_checkpoint_state(self, state: Dict, version: int) -> int:
        """Swap in a ``CheckpointWatcher``-published state (the round
        loop's ``{params, server_state, generator, round_idx}``): its flat
        params dict, under the published step as the version."""
        return self.swap(state["params"], version=version)
