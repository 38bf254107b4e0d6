"""Planet-scale population plane (port of ``fedml_tpu/scale/``).

The population is data, not objects: N >= 1M registered clients as
columnar numpy (or memmap) state of a few bytes each, sampled in
O(cohort) and materialized on demand.

- ``registry``: the columnar ``ClientRegistry`` (bitwise the JAX
  package's columns, cohorts and labels);
- ``cohort``: the heterogeneity-aware packer of a sampled cohort into
  pow2 (bucket, nb) groups (plans equal to the JAX package's);
- ``tree``: the two-tier edge-aggregator tree over the exact streaming
  fold, bit-identical to flat aggregation;
- ``engine``: the registry-backed round loop the simulator routes to
  when ``client_registry_size`` is set.
"""

from .cohort import CohortGroup, CohortPlan, pack_cohort
from .registry import ClientRegistry
from .tree import EdgeAggregationTree

__all__ = [
    "ClientRegistry",
    "CohortGroup",
    "CohortPlan",
    "pack_cohort",
    "EdgeAggregationTree",
]
