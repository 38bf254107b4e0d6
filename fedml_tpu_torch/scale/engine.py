"""Registry-backed round loop: 10k-client cohorts from a 1M registry.

The port of ``fedml_tpu/scale/engine.py``. The stock round gathers the
sampled cohort out of an eagerly packed federation tensor, O(total
clients) memory before the first round. This loop keeps the population
as the columnar ``ClientRegistry`` (bytes per client) and materializes
only each round's cohort:

    sample (Floyd, O(cohort), host)
      -> pack (pow2 nb x pow2 client buckets, LPT-balanced groups, host)
      -> materialize per group (labels on the host; features made on
         the device by one ``ops/synth_features`` launch)
      -> vmapped local training per group (``torch.func.vmap`` over the
         group's client axis, as the stock round trains a cohort)
      -> per-(group, edge) weighted partial sums, folded through the
         two-tier ``EdgeAggregationTree`` (``edge_num >= 2``) or a flat
         ``StreamingAccumulator`` — one ``ops/exact_fold`` launch a group
         and one for the tree's root merge, bit-identical either way
      -> O(model) finalize (the limbs collapse on the host).

Host memory a round is O(cohort x client data), independent of the
registry's size. Evaluation runs on the dataset's global holdouts (the
registry dataset builds no per-client evaluation data).

On a fed ``(data, fsdp)`` mesh (``api.mesh``) every data rank
materializes and trains its lane of each group against the params
gathered whole at use, the trained params are all-gathered in slot order,
and every rank computes the group's terms and folds them as the one-rank
loop does; the finalized params rest fsdp-sharded again.

In eager PyTorch nothing is traced: the per-(bucket, nb) state the JAX
loop keeps as its jit cache is here the census of shapes seen, and
``trace_count`` counts each shape's first call, as the JAX loop counts
its traces. The loop is synchronous: a round's finalize reads the
limbs on the host.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List

import numpy as np
import torch

from ..analysis.compiled import auditable, pow2_budget
from ..core import devtime
from ..core.aggregation import StreamingAccumulator
from ..core.compile_cache import maybe_enable_compile_cache
from ..core.round_pipeline import _mark, _seconds
from ..core.telemetry import Telemetry
from ..core.tracking import DeferredMetrics
from ..core.types import Batches
from ..parallel.mesh import train_lane
from .cohort import pack_cohort
from .registry import ClientRegistry
from .tree import EdgeAggregationTree

Params = Dict[str, torch.Tensor]

__all__ = ["PlanetRoundLoop", "build_group_fn", "planet_knobs_active"]


def build_group_fn(
    local_train,
    *,
    use_round_lr: bool = False,
    mesh=None,
    at_use=None,
    on_trace=None,
):
    """The per-(bucket, nb) group computation as a pure function of its
    collaborators: ``group_fn(global_params, batches, ns, valid,
    edge_onehot, rng, lr_mult=None) -> (global_params, terms, edge_w,
    summed)``.

    Local training runs vmapped over the group's client axis (padded
    slots' batches fully masked through ``valid``), then each edge's
    weighted partial sum is one ``torch.einsum("cf,ce->ef", w[:, None] *
    flat, onehot)`` per leaf — the term-rounding step of the streaming
    fold, computed groupwise. ``terms`` is ``[E, N]`` f32, the leaves laid
    end to end in ``global_params``' order (the accumulator's flat
    layout); ``edge_w`` ``[E]`` the edges' weights; ``summed`` the
    group's metric sums; the edge count E is ``edge_onehot``'s width.
    ``global_params`` is returned unchanged as the first output, as the
    JAX function's donated carry is. ``on_trace``
    fires on the first call of each (bucket, nb) shape. ``rng`` is the
    shuffle's uniforms (``core/local_trainer.py``), or None.

    With a fed ``mesh`` (``parallel/mesh.SimMesh``), ``global_params`` are
    this rank's at-rest shards (``at_use`` gathers them whole),
    ``batches`` are this rank's lane of the group (``mesh.lanes(C)`` of
    its C slots; ``ns``, ``valid``, ``edge_onehot`` and ``rng`` stay the
    whole group's), the trained params are gathered back in slot order
    and the terms and metrics are the whole group's on every rank.
    """
    from ..parallel.layout import is_fed_mesh

    if mesh is not None and not is_fed_mesh(mesh):
        raise ValueError(
            "client_registry_size: the registry-backed round loop "
            "aggregates via the streaming fold and synthesizes "
            "cohort data on demand; unsupported with the legacy (clients) mesh"
        )
    seen: set = set()

    def group_fn(global_params, batches: Batches, ns, valid, edge_onehot, rng,
                 lr_mult=None):
        C = ns.shape[0]
        if on_trace is not None and (C, batches.num_batches) not in seen:
            seen.add((C, batches.num_batches))
            on_trace()
        lo, hi = mesh.lanes(C) if mesh is not None else (0, C)
        vm = valid[lo:hi].reshape((-1,) + (1,) * (batches.mask.dim() - 1))
        masked = Batches(x=batches.x, y=batches.y,
                         mask=batches.mask * vm.to(batches.mask.dtype))
        params = at_use(global_params) if mesh is not None else global_params
        stacked, metrics = train_lane(
            local_train, params, masked, None if rng is None else rng[lo:hi],
            lr_mult if use_round_lr else None
        )
        summed = {k: v.sum() for k, v in metrics.items()}
        if mesh is not None:
            stacked = mesh.gather_stacked(stacked, C)
            summed = mesh.sum_lanes(summed)
        w = ns * valid  # [C]; padded slots weigh zero

        def edge_sums(leaf: torch.Tensor) -> torch.Tensor:
            flat = leaf.to(torch.float32).reshape(C, -1)
            return torch.einsum("cf,ce->ef", w[:, None] * flat, edge_onehot)

        terms = torch.cat([edge_sums(stacked[k]) for k in global_params], dim=1)
        edge_w = torch.einsum("c,ce->e", w, edge_onehot)
        return global_params, terms, edge_w, summed

    return group_fn


@auditable(
    "planet.group_fn",
    round_shaped=True,
    census_budget=lambda ctx: (
        pow2_budget(ctx.cohort_buckets) * pow2_budget(ctx.nb_census)
    ),
)
def _audit_group_fn_cases(ctx):
    """`cli audit` provider: the per-(bucket, nb) group computation the
    planet loop runs, traced across the two-axis pow2 census on fake
    tensors, with no registry and no data."""
    from ..analysis.compiled import LoweringCase

    fn = build_group_fn(ctx.local_train_fn())
    params = ctx.abstract_params()
    E = max(1, ctx.edge_num)
    return [
        LoweringCase(
            key=f"b{b}xnb{nb}",
            fn=fn,
            args=(params, ctx.abstract_group_batches(b, nb), ctx.sds((b,)), ctx.sds((b,)),
                  ctx.sds((b, E)), ctx.abstract_uniforms(b, nb)),
        )
        for b in ctx.cohort_buckets
        for nb in ctx.nb_census
    ]


def planet_knobs_active(args) -> bool:
    """True when the registry-backed population plane is requested."""
    return int(getattr(args, "client_registry_size", 0) or 0) > 0


class PlanetRoundLoop:
    """Drives a FedAvg API's training over a ``ClientRegistry``.

    Constructed once and cached on the API across ``train()`` calls
    (``FedAvgAPI._planet_loop``), so the shape census survives repeat
    ``train()`` calls and a warm re-run replays with no new shapes.
    ``stats`` after ``run`` (also ``api.pipeline_stats`` and one ``kind:
    "pipeline"`` metrics record): registry size and bytes, cohort size,
    edge count, rounds, trace count, shape keys, waste fraction, and
    every round's ``[start, end]`` on the card's clock
    (``round_spans_s``), its packed samples, its folds (the (group, edge)
    folds with weight > 0 plus the tree's root merges) and its groups."""

    def __init__(self, api) -> None:
        self.api = api
        args = api.args
        self._validate(api)
        # the kernels' build cache: idempotent, shared with the api's own call
        maybe_enable_compile_cache(args)
        self.cohort_size = int(
            getattr(args, "cohort_size", 0) or 0
        ) or int(args.client_num_per_round)
        self.edge_num = int(getattr(args, "edge_num", 0) or 0)
        self.registry = ClientRegistry(
            int(args.client_registry_size),
            seed=int(getattr(args, "random_seed", 0)),
            memmap_dir=getattr(args, "registry_dir", None),
        )
        if self.cohort_size > self.registry.size:
            raise ValueError(
                f"cohort_size={self.cohort_size} exceeds "
                f"client_registry_size={self.registry.size}"
            )
        ds = api.dataset
        self.class_num = int(ds.class_num)
        # feature geometry comes from the global eval pack: [nb, bs, *F]
        self.feature_shape = tuple(int(d) for d in ds.test_data_global.x.shape[2:])
        self.sigma = float(getattr(args, "synthetic_sigma", 1.0) or 1.0)
        self.waste_cap = float(getattr(args, "packing_waste_cap", 4.0) or 4.0)
        self.stats: Dict[str, Any] = {}
        self._group_fn = None
        self._trace_count = 0
        self._shape_keys_seen: set = set()
        self._trunc_warned = False

    @staticmethod
    def _validate(api) -> None:
        """The JAX loop's refusals, word for word."""
        from ..parallel.layout import is_fed_mesh

        args = api.args
        unsupported = []
        if getattr(api, "mesh", None) is not None and not is_fed_mesh(api.mesh):
            # the fed (data, fsdp) mesh splits each (bucket, nb) group over
            # its data ranks; the legacy 'clients' mesh pre-shards an eager
            # federation this loop never builds
            unsupported.append("the legacy (clients) mesh")
        if getattr(api, "server_aggregator", None) is not None:
            unsupported.append("a custom server_aggregator")
        if getattr(api, "robust", None) is not None:
            unsupported.append(f"defense_type={args.defense_type!r}")
        if getattr(api, "_keep_stacked", False):
            unsupported.append(f"algorithm {api.algorithm} (stacked hooks)")
        if getattr(args, "sim_mode", "vectorized") != "vectorized":
            unsupported.append(f"sim_mode={args.sim_mode!r}")
        if api.algorithm not in ("FedAvg", "FedProx"):
            unsupported.append(
                f"federated_optimizer={api.algorithm} (custom server step)"
            )
        if getattr(api.dataset, "task", "classification") != "classification":
            unsupported.append(f"task={api.dataset.task!r}")
        if unsupported:
            raise ValueError(
                "client_registry_size: the registry-backed round loop "
                "aggregates via the streaming fold and synthesizes "
                "cohort data on demand; unsupported with "
                + ", ".join(unsupported)
            )

    def _build_group_fn(self):
        api = self.api

        def on_trace() -> None:
            # first call of a (bucket, nb) shape: the JAX loop's trace
            self._trace_count += 1

        return build_group_fn(
            api._local_train,
            use_round_lr=api._round_lr is not None,
            mesh=getattr(api, "mesh", None),
            at_use=api.full_params,
            on_trace=on_trace,
        )

    # -- round loop ---------------------------------------------------
    def run(self, packed, nsamples, comm_rounds: int, freq: int, profiler, ckpt=None,
            start_round: int = 0) -> Dict[str, float]:
        """Rounds ``start_round`` to ``comm_rounds - 1``; with ``ckpt``
        (the API's checkpointer) the state is saved every
        ``api._ckpt_freq`` rounds and after the last."""
        api = self.api
        args = api.args
        del packed, nsamples  # registry mode has no eager federation
        if self._group_fn is None:
            self._group_fn = self._build_group_fn()
        tel = Telemetry.get_instance()
        tel = tel if tel.enabled else None
        cuda = api.device.type == "cuda"
        E = max(1, self.edge_num)
        bs = int(args.batch_size)
        # edge_flat_fold is the A/B harness: terms still partition per
        # edge (identical term set, identical rounding) but fold into ONE
        # flat accumulator — the baseline the tree's bit-identity is
        # held against
        flat_fold = bool(getattr(args, "edge_flat_fold", False))
        mesh = getattr(api, "mesh", None)
        # the accumulators' template: the whole params (at rest on a mesh
        # a rank holds its fsdp shards)
        template = api.full_params()
        tree = (
            EdgeAggregationTree(template, self.edge_num)
            if self.edge_num >= 2 and not flat_fold
            else None
        )
        ckpt_freq = getattr(api, "_ckpt_freq", 1)
        final_stats: Dict[str, float] = {}
        waste_fracs: List[float] = []
        spans, samples, folds, groups = [], [], [], []
        checkpoints = 0
        x_dtype = api.dataset.test_data_global.x.dtype

        for round_idx in range(start_round, comm_rounds):
            profiler.tick(round_idx)
            t0 = time.perf_counter()
            start = _mark(cuda)
            gp = api.global_params
            idx = self.registry.sample_cohort(round_idx, self.cohort_size)
            plan = pack_cohort(
                self.registry.num_samples[idx],
                idx,
                bs,
                speed_tier=self.registry.speed_tier[idx],
                waste_cap=self.waste_cap,
                telemetry=tel,
            )
            waste_fracs.append(plan.waste_frac)
            packed_total = int(sum(g.num_samples.sum() for g in plan.groups))
            if not self._trunc_warned:
                # no silent caps — but once per loop, not per group per
                # round; the flag burns only on OBSERVED truncation
                total = int(self.registry.num_samples[idx].sum())
                if packed_total < total:
                    self._trunc_warned = True
                    logging.warning(
                        "planet cohort packing: long-tail truncation — "
                        "dropping %d/%d samples (%.2f%%) this round "
                        "under packing_waste_cap=%.1f (similar every "
                        "round; raise args.packing_waste_cap to keep "
                        "them)",
                        total - packed_total, total,
                        100.0 * (total - packed_total) / max(total, 1),
                        self.waste_cap,
                    )
            lr_mult = api._lr_mult(round_idx)
            acc = tree if tree is not None else StreamingAccumulator(template)
            summed = None
            round_folds = 0
            for group in plan.groups:
                if group.shape_key not in self._shape_keys_seen:
                    self._shape_keys_seen.add(group.shape_key)
                    if tel is not None:
                        tel.recorder.instant(
                            "planet.trace", cat="compile",
                            bucket=group.bucket, nb=group.nb,
                        )
                # on a mesh a rank makes only its lane's clients (each
                # client's data is keyed by its registry id, whatever the
                # group it lands in)
                lo, hi = mesh.lanes(group.bucket) if mesh is not None else (0, group.bucket)
                if hi > lo:
                    batches, _ = self.registry.materialize_group(
                        group.client_idx[lo:hi], group.nb, bs, self.feature_shape,
                        self.class_num, sigma=self.sigma, dtype=x_dtype, device=api.device,
                    )
                else:  # a group smaller than the data axis: an empty lane here
                    batches = Batches(
                        x=torch.zeros((0, group.nb, bs) + self.feature_shape, dtype=x_dtype,
                                      device=api.device),
                        y=torch.zeros((0, group.nb, bs), dtype=torch.int64, device=api.device),
                        mask=torch.zeros((0, group.nb, bs), device=api.device))
                # edge routing is a property of the CLIENT (registry id
                # mod E), not of its slot — stable across cohorts
                onehot = np.zeros((group.bucket, E), dtype=np.float32)
                onehot[np.arange(group.bucket), group.client_idx % E] = 1.0
                rng = api._shuffle_uniforms(group.real_clients, group.bucket,
                                            examples=group.nb * bs)
                with devtime.measure(
                    "planet.group_fn", bucket=f"b{group.bucket}xnb{group.nb}"
                ):
                    gp, terms, edge_w, m = self._group_fn(
                        gp,
                        batches,
                        torch.as_tensor(group.num_samples, device=api.device),
                        torch.as_tensor(group.valid, device=api.device),
                        torch.as_tensor(onehot, device=api.device),
                        rng,
                        lr_mult,
                    )
                # deliberate O(E)-scalar fetch: the per-edge fold weights
                # drive the host's fold bookkeeping (total_w is an exact
                # python-float sum); the model-sized terms stay on the device
                edge_w = edge_w.double().cpu().numpy().tolist()
                # the group's edges with weight > 0, in edge order: one
                # fold launch (the tree: each into its edge; flat: all
                # into the one accumulator)
                if tree is not None:
                    round_folds += tree.fold_edge_terms(terms, edge_w)
                else:
                    round_folds += acc.fold_weighted_terms(terms, edge_w)
                summed = m if summed is None else {k: summed[k] + m[k] for k in summed}
            if tree is not None:  # the root merges each edge that was folded into
                round_folds += sum(1 for e in range(E) if tree.acc(e).count)
            api.global_params = api._at_rest(acc.finalize())
            if tree is not None:
                tree.reset()
            end = _mark(cuda)
            spans.append((start, end))
            samples.append(packed_total)
            folds.append(round_folds)
            groups.append(len(plan.groups))
            if tel is not None:
                tel.inc("pipeline_rounds_dispatched_total")
                tel.heartbeat("pipeline.round", round_idx)

            if round_idx % freq == 0 or round_idx == comm_rounds - 1:
                stats = self._eval_round(round_idx, summed, t0, start, end)
                api.history.append(stats)
                final_stats = stats
                api.metrics_reporter.report_server_training_metric(stats)
            saved = False
            if ckpt is not None and (
                (round_idx + 1) % ckpt_freq == 0 or round_idx == comm_rounds - 1
            ):
                api._save_checkpoint(ckpt, round_idx)
                checkpoints += 1
                saved = True
            # the elastic seam: a preemption notice forces a durable exit
            # at the round boundary (the round's fold is final)
            api._maybe_preempt(ckpt, round_idx, saved=saved)

        if cuda and spans:
            spans[-1][1].synchronize()
        origin = spans[0][0] if spans else None
        self.stats = {
            "loop": "planet",
            "registry_clients": self.registry.size,
            "registry_bytes": self.registry.nbytes(),
            "cohort_size": self.cohort_size,
            "edge_num": self.edge_num,
            "rounds": comm_rounds - start_round,
            "trace_count": self._trace_count,
            "shape_keys": sorted(self._shape_keys_seen),
            "waste_frac_mean": float(np.mean(waste_fracs)) if waste_fracs else 0.0,
            "checkpoints": checkpoints,
            "round_samples": samples,
            "round_folds": folds,
            "round_groups": groups,
            "round_spans_s": [[_seconds(origin, a), _seconds(origin, b)] for a, b in spans],
        }
        api.pipeline_stats = self.stats
        api.metrics_reporter.report({"kind": "pipeline", **self.stats})
        if tel is not None:
            tel.set_gauge("registry_clients", self.registry.size)
        logging.debug("planet round loop: %s", self.stats)
        return final_stats

    def _eval_round(self, round_idx, summed, t0, start, end) -> Dict[str, float]:
        """The round's record: the global model on the global holdouts,
        the cohort's summed training metrics, the round's wall time and
        its time on the card's clock (one fetch of every metric)."""
        api = self.api
        ds = api.dataset
        ring = DeferredMetrics()
        ring.push(round_idx, {
            "summed": summed,
            "train": api._eval(api.full_params(), ds.train_data_global),
            "test": api._eval(api.full_params(), ds.test_data_global),
        })
        (_, host), = ring.flush()
        if not isinstance(end, float):
            end.synchronize()
        return api._stats_from_host(
            round_idx, host, time.perf_counter() - t0, _seconds(start, end)
        )
