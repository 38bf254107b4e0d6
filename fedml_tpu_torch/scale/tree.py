"""Two-tier edge-aggregator tree, bit-identical to flat aggregation.

The port of ``fedml_tpu/scale/tree.py`` over the port's
``StreamingAccumulator``. The E edges are one ``AccumulatorBank`` (their
limbs the rows of one ``[E, 3, N]`` f32 buffer), so a group's edge terms
fold in one launch (``fold_edge_terms``) and the root merges every
touched edge in one launch of its 3·E' limb rows (``finalize``), each
bitwise the per-edge folds and merges it replaces.
The cross-silo server's use of it arrives with ``cross_silo/``
(ROADMAP.md, queue A item 11). The text below is the JAX package's own.

``core/topology.py`` carried the hierarchical (edge-aggregator)
topology as a mixing-matrix abstraction; this module makes it a real
aggregation path. ``E`` edge aggregators each fold their subtree's
uploads through the ``StreamingAccumulator`` — the exact-expansion,
order-independent fold — and the root folds the E edge expansions via
``StreamingAccumulator.merge``. Because every hop is the same add-only
exact fold, the tree's float32 finalize is **bitwise identical** to
folding every upload into one flat accumulator, for raw and for
quantized (codec-encoded) uploads alike. That identity is asserted
(tests + the ``detail.planet`` bench), not hoped: it is what lets an
edge tier be inserted under a live federation without changing a single
result bit.

Used two ways:

- the cross-silo server (``fedml_aggregator``) routes each rank's
  upload to its edge's accumulator (``acc_for``) and finalizes through
  the root — an in-process LOCAL-world edge tier (``edge_num`` knob);
- the registry-backed simulator folds per-(group, edge) weighted
  partial sums (``StreamingAccumulator.fold_weighted_term``) so a 10k
  cohort costs O(groups x edges) folds, not O(cohort).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from ..core.aggregation import AccumulatorBank, StreamingAccumulator
from ..core.scheduler import assign_by_load as _assign_by_load
from ..core.topology import EdgeTreeTopology

Params = Any

__all__ = ["EdgeAggregationTree"]


class EdgeAggregationTree:
    """E per-edge ``StreamingAccumulator``s + a root merge.

    ``edge_of(index)`` maps an upload identity (cross-silo rank,
    registry client id) to its edge: an explicit ``assignment`` dict
    wins, else round-robin ``index % E`` (stable, stateless — a
    reconnecting rank lands on the same edge). ``assign_by_load``
    builds a load-balanced assignment from per-client sizes via the
    scheduler's boustrophedon deal."""

    def __init__(
        self,
        template: Params,
        edge_num: int,
        assignment: Optional[Dict[int, int]] = None,
    ) -> None:
        self.topology = EdgeTreeTopology(edge_num)
        self.topology.generate_topology()
        self.edge_num = int(edge_num)
        self._template = template
        self._edges = AccumulatorBank(template, self.edge_num)
        self._assignment = dict(assignment) if assignment else None

    @staticmethod
    def assign_by_load(
        client_sizes: Sequence[int], edge_num: int
    ) -> Dict[int, int]:
        """index -> edge, near-equal total load per edge
        (``core/scheduler.assign_by_load``)."""
        return _assign_by_load(client_sizes, edge_num)

    # -- routing ------------------------------------------------------
    def edge_of(self, index: int) -> int:
        if self._assignment is not None:
            return int(self._assignment[int(index)])
        return int(index) % self.edge_num

    def acc(self, edge: int) -> StreamingAccumulator:
        """Edge ``edge``'s accumulator (term-level folds)."""
        return self._edges[int(edge)]

    def acc_for(self, index: int) -> StreamingAccumulator:
        """The accumulator upload ``index`` folds into — exposes every
        ``fold*`` variant (raw/encoded/clipped) of the underlying
        ``StreamingAccumulator`` so callers keep their one fold
        vocabulary."""
        return self._edges[self.edge_of(index)]

    def fold_edge_terms(self, terms: torch.Tensor, weights: Sequence[float]) -> int:
        """Fold row ``e`` of ``terms`` ``[E, N]`` (an already-weighted
        partial sum) into edge ``e``'s accumulator for every edge whose
        weight in ``weights`` (E host floats) is > 0, in one launch:
        bitwise ``acc(e).fold_weighted_term(terms[e], weights[e])`` for
        each such edge. Returns the edges folded."""
        return self._edges.fold_terms(terms, weights)

    # -- aggregate state ----------------------------------------------
    @property
    def count(self) -> int:
        return self._edges.count

    @property
    def total_w(self) -> float:
        return self._edges.total_w

    def running_mean(self) -> Optional[Params]:
        """Top-limb mean over every edge (anomaly-screen scoring aid,
        same contract as ``StreamingAccumulator.running_mean``)."""
        return self._edges.running_mean()

    def finalize(self) -> Params:
        """Root fold: merge every non-empty edge expansion into one
        root accumulator, in edge order and in one launch, and finalize
        — bit-identical to the flat fold of the same uploads (see module
        docstring)."""
        root = StreamingAccumulator(self._template)
        self._edges.merge_into(root)
        return root.finalize()

    def reset(self) -> None:
        self._edges.reset()
