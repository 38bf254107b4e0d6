"""Custom-aggregator cross-silo server (reference custom tier —
server_aggregator subclass, core/alg_frame/server_aggregator.py).

The aggregator below coordinate-clips incoming silo params before the
weighted average — server-side robustness in ~10 lines on the L3 seam
(core/frame.py ServerAggregator.aggregate: a pure reduction over the
stacked cohort axis).

Run:  python server.py --cf fedml_config.yaml --rank 0
"""

import torch

import fedml_tpu_torch
from fedml_tpu_torch import DefaultServerAggregator


class CoordClipAggregator(DefaultServerAggregator):
    """Weighted FedAvg over coordinate-clipped client params."""

    CLIP = 5.0

    def aggregate(self, global_params, stacked_params, weights, rng):
        clipped = {k: torch.clamp(p, -self.CLIP, self.CLIP) for k, p in stacked_params.items()}
        return super().aggregate(global_params, clipped, weights, rng)


if __name__ == "__main__":
    fedml_tpu_torch.run_cross_silo_server(
        server_aggregator=CoordClipAggregator(model=None)
    )
