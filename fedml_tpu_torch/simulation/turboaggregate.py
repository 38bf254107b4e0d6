"""TurboAggregate: FedAvg with secure aggregation (port of ``fedml_tpu/simulation/turboaggregate.py``).

The reference's ``turboaggregate`` (``TA_trainer.py``,
``mpc_function.py``): clients' updates are quantized into a prime field
and combined through additive shares around a ring of groups, so the
server learns only their weighted sum. Local training is the FedAvg
round on the card; the aggregation is the host protocol
(``core/secure_agg.py`` ``TurboAggregateProtocol``), the boundary where
the reference exchanges numpy shares between MPI ranks.

After each round the cohort's trained params reach the host in one
copy of a flat ``[C, N]`` buffer (``_FlatSpec.flatten_stacked``); the
protocol's field sum is exact and elementwise and the shares cancel
mod p, so the new global model is bitwise the JAX package's for the same
updates and weights. It is cast to float32, as the JAX package's
unflatten does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.aggregation import _FlatSpec, normalize_weights
from ..core.secure_agg import TurboAggregateProtocol
from .fedavg_api import FedAvgAPI


class TurboAggregateAPI(FedAvgAPI):
    """The FedAvg round loop with secure weighted aggregation. args:
    ``ta_groups`` (ring groups, default 4), ``ta_quant_scale`` (field
    quantization scale, default 2^16: weighted updates must satisfy
    ``|x| * scale * C < p / 2``)."""

    algorithm = "TurboAggregate"
    _keep_stacked = True

    def __init__(self, args, device, dataset, model) -> None:
        if getattr(args, "defense_type", None):
            raise ValueError(
                "TurboAggregate replaces the aggregation step with the "
                "secure-sum protocol; robust defense_type cannot be "
                "combined with it (the server never sees raw updates)"
            )
        super().__init__(args, device, dataset, model)
        self.protocol = TurboAggregateProtocol(
            n_clients=int(args.client_num_per_round),
            n_groups=int(getattr(args, "ta_groups", 4)),
            scale=float(getattr(args, "ta_quant_scale", 2.0**16)),
            seed=int(getattr(args, "random_seed", 0)),
        )
        self._spec = _FlatSpec(self.global_params)

    def _aggregate(self, global_params, server_state, new_stacked, weights, cohort, rng):
        # the aggregation happens on the host, in _post_round_stacked
        return global_params, server_state

    def _post_round_stacked(self, stacked: Dict[str, torch.Tensor], idx: np.ndarray,
                            round_idx: int) -> None:
        """The new global model: the protocol's weighted sum of the
        cohort's trained params, weighted by their packed sample counts."""
        ns = torch.as_tensor(np.take(np.asarray(self.dataset.packed_num_samples), idx))
        weights = normalize_weights(ns).numpy().astype(np.float64)
        # one device -> host copy for the whole cohort
        host = self._spec.flatten_stacked(stacked).cpu().numpy()
        agg = self.protocol.secure_weighted_sum(list(host), weights)
        flat = torch.from_numpy(agg.astype(np.float32)).to(self.device)
        self.global_params = self._at_rest(
            {k: v.clone() for k, v in self._spec.views(flat).items()})
