"""FedAvg-family simulation on one card (port of ``simulation/fedavg_api.py``).

A round gathers the sampled cohort from the packed federation on the
device, trains every client of it at once (``core/local_trainer.py``:
``torch.func.vmap`` over the client axis, eager, epochs x batches
driven from Python), weights the clients by their packed sample counts
and averages. Global params never leave the device; the loop reads a
device value only at its evaluation cadence, as the JAX loop does.

Client sampling keeps the reference's determinism contract, bitwise:
``np.random.RandomState(round_idx).choice`` without replacement. The
round's other randomness, the per-epoch shuffles, comes from one
``torch.Generator`` on the device seeded by ``args.random_seed``.

The vectorized mode runs through the round pipeline
(``core/round_pipeline.py``: ``pipeline_depth`` rounds in flight, pow2
cohort buckets, metrics fetched at flushes only), as the JAX package's
does; the synchronous loop serves the sequential mode.

Ported: ``FedAvgAPI`` with the ``vectorized`` and ``sequential`` modes,
``FedProxAPI``, ``FedOptAPI`` (server optimizers) and ``FedNovaAPI``;
custom operators (``client_trainer``/``server_aggregator``,
``core/frame.py``); checkpoint and resume (``checkpoint_dir``, every
``checkpoint_freq`` rounds, ``core/checkpoint.py``): a resumed run is
bitwise the run that was never stopped; the registry-backed population
plane (``client_registry_size > 0``): ``train()`` hands the rounds to a
``scale.engine.PlanetRoundLoop`` cached on the API (``_planet_loop``),
which samples each cohort from a columnar client registry and folds it
through the exact aggregation; the robust aggregation planes
(``defense_type``: norm-diff clipping and weak DP, whose clip is one K3
launch a round, and the coordinate-wise median; ``core/aggregation.py``
``RobustAggregator``), and the algorithm hooks the fork's defenses plug
into (``simulation/defenses.py``): ``_init_server_state``,
``_preprocess`` (in the round, before local training; HS-FedAvg),
``_keep_stacked`` with ``_post_round_stacked`` (the cohort's trained
params after each round, on the synchronous loop; S-FedAvg), and
``_extra_checkpoint_state`` / ``_restore_extra_state`` (algorithm state
in the checkpoint); the evidence-and-recovery plane: ``train()`` arms
the stall watchdog (``stall_timeout_s``), the ``/metrics`` server
(``metrics_port``) and the round profiler, exports the run's artifacts
to ``telemetry_dir`` in its ``finally``, and polls the preemption
signal (``preempt_signal``, ``parallel/elastic.py``) at each round
boundary after the cadence save; a restore that consumes a WAL preempt
record appends the paired resume record.

On a simulator mesh (``attach_mesh``; ``simulation/simulator.SimulatorMesh``
attaches it, ``parallel/mesh.py`` and ``parallel/layout.py`` hold the
placement) the round follows the reference's ``build_round_fn`` fed
branch: each cohort rank keeps its share of the federation, the round's
cohort is assembled from its owners, the params are gathered whole at
use (``fsdp``), every rank draws the whole cohort's shuffle uniforms and
trains its lane of the cohort with its rows, the trained params are
all-gathered over the cohort axis in client order, and every rank folds
the same stacked cohort (on the fed mesh through ``exact_weighted_mean``,
in client-index order), so every mesh shape finalizes to the same bits;
the result rests fsdp-sharded again. Evaluation sums each rank's own
clients' metrics over the cohort axis.

``get_algorithms()`` is the name -> API table, as in the JAX package.
Its ``build_eval_all`` (a module-level ``jax.vmap`` factory over the
clients' evaluation, kept out of ``self`` for jit's sake) is left out:
it has no PyTorch meaning, and the port's evaluation sums the clients'
metrics in ``make_eval_fn``'s callers directly.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core import devtime
from .. import constants
from ..analysis.compiled import auditable, pow2_budget
from ..core.aggregation import (
    RobustAggregator,
    derive_defense_rng,
    exact_weighted_mean,
    normalize_weights,
    stack_pytrees,
    weighted_average,
)
from ..core.compile_cache import maybe_enable_compile_cache
from ..core.frame import bind_operator, cohort_train_fn
from ..core.local_trainer import (
    compute_dtype_from_args,
    make_eval_fn,
    make_local_train_fn,
)
from ..core.optimizers import (
    create_client_optimizer,
    create_server_optimizer,
    resolve_round_lr_schedule,
)
from ..core.round_pipeline import RoundPipeline
from ..core.telemetry import Telemetry
from ..core.tracing import RoundProfiler
from ..core.tracking import DeferredMetrics, MetricsReporter
from ..core.types import Batches
from ..data.loader import FederatedDataset
from ..device import DeviceLike, get_device
from ..models.spec import FedModel
from ..parallel.mesh import train_lane
from ..scale.engine import PlanetRoundLoop, planet_knobs_active

Params = Dict[str, torch.Tensor]


def dist_rank() -> int:
    """This process's rank in the initialised process group (0 without
    one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _take(b: Batches, idx: torch.Tensor) -> Batches:
    return Batches(
        x=b.x.index_select(0, idx),
        y=b.y.index_select(0, idx),
        mask=b.mask.index_select(0, idx),
    )


def build_round_fn(local_train, aggregate, preprocess=None, keep_stacked: bool = False,
                   mesh=None, at_use=None, at_rest=None, aggregate_reads_masks: bool = False):
    """The round engine as a pure function of its collaborators:
    ``round_fn(global_params, server_state, packed, nsamples, idx, rng,
    lr_mult=None, valid=None) -> (new_global, new_state,
    summed_metrics)``, every tensor on the device, plus the cohort's
    trained params with ``keep_stacked``. ``aggregate`` may be a bound
    method (the algorithms' server step plugs in there); ``preprocess``
    (``(cohort, server_state) -> (cohort, server_state)``) runs on the
    gathered cohort before local training.

    ``valid`` ([C] in {0, 1}) marks the real slots of a bucket-padded
    cohort: a padded slot's batches are all masked, so local training
    leaves its params as they were and counts nothing, and its
    aggregation weight is zero.

    With a simulator ``mesh`` (``parallel/mesh.SimMesh``), ``packed`` is
    this cohort rank's share of the federation: the rank takes its lane
    of the cohort from the lane's owners, ``at_use`` gathers the at-rest
    params whole, the rank trains its lane (with its rows of ``rng``;
    ``preprocess`` sees the lane), the trained params are gathered back
    in client order, every rank aggregates the same stacked cohort,
    ``at_rest`` shards the result, and the metrics are summed over the
    cohort axis. The aggregation's ``cohort`` is then None, or with
    ``aggregate_reads_masks`` the whole cohort's masks (a ``Batches``
    whose ``x`` and ``y`` are None)."""

    def round_fn(global_params, server_state, packed: Batches, nsamples, idx, rng,
                 lr_mult=None, valid=None):
        C = idx.shape[0]
        if mesh is None:
            lo, hi = 0, C
            cohort = _take(packed, idx)
        else:
            lo, hi = mesh.lanes(C)
            cohort = mesh.gather_lane(packed, idx, packed.mask.shape[0])
            global_params = at_use(global_params)
        ns = nsamples.index_select(0, idx)
        if valid is not None:
            vm = valid[lo:hi].reshape((-1,) + (1,) * (cohort.mask.dim() - 1))
            cohort = Batches(x=cohort.x, y=cohort.y, mask=cohort.mask * vm.to(cohort.mask.dtype))
        if preprocess is not None:
            cohort, server_state = preprocess(cohort, server_state)
        if mesh is None:
            new_stacked, train_metrics = local_train(global_params, cohort, rng, lr_mult)
            seen = cohort
        else:
            trained, train_metrics = train_lane(
                local_train, global_params, cohort, None if rng is None else rng[lo:hi], lr_mult)
            new_stacked = mesh.gather_stacked(trained, C)
            seen = None
            if aggregate_reads_masks:
                seen = Batches(x=None, y=None,
                               mask=mesh.gather_stacked({"mask": cohort.mask}, C)["mask"])
        weights = normalize_weights(ns, valid)
        new_global, new_state = aggregate(
            global_params, server_state, new_stacked, weights, seen, rng
        )
        summed = {k: v.sum() for k, v in train_metrics.items()}
        if mesh is not None:
            new_global = at_rest(new_global)
            summed = mesh.sum_lanes(summed)
        if keep_stacked:
            return new_global, new_state, summed, new_stacked
        return new_global, new_state, summed

    return round_fn


def _audit_round_cases(ctx, fn, params):
    """The round's census: ``fn`` at each cohort bucket over a packed
    federation of twice the largest bucket."""
    from ..analysis.compiled import LoweringCase

    n_total = max(ctx.cohort_buckets) * 2
    packed = ctx.abstract_batches(n_total)
    nsamples = ctx.sds((n_total,))
    return [
        LoweringCase(
            key=f"b{b}",
            fn=fn,
            args=(params, (), packed, nsamples, ctx.sds((b,), "int64"),
                  ctx.abstract_uniforms(b)),
            kwargs={"valid": ctx.sds((b,))},
        )
        for b in ctx.cohort_buckets
    ]


@auditable(
    "simulation.round_fn",
    round_shaped=True,
    census_budget=lambda ctx: pow2_budget(ctx.cohort_buckets),
)
def _audit_round_fn_cases(ctx):
    """`cli audit` provider: the round engine the runtime builds (same
    builder), traced across the pow2 cohort census on fake tensors: no
    dataset, no params, nothing executed. The host-transfer checker
    proves the round never makes the card wait on the host."""

    def aggregate(global_params, server_state, stacked, weights, cohort, rng):
        # the stock FedAvg reduction: the shape every _aggregate
        # override (FedOpt/FedNova/defenses) is generic over
        return weighted_average(stacked, weights), server_state

    fn = build_round_fn(ctx.local_train_fn(), aggregate)
    return _audit_round_cases(ctx, fn, ctx.abstract_params())


@auditable(
    "simulation.round_fn_mesh",
    round_shaped=True,
    census_budget=lambda ctx: pow2_budget(ctx.cohort_buckets),
)
def _audit_round_fn_mesh_cases(ctx):
    """`cli audit` provider for the mesh round: the same builder as
    ``FedAvgAPI.attach_mesh`` on the fed ``{data: 1, fsdp: 1}`` mesh of
    the audit's world of one rank (the JAX provider lowers a 1x1 mesh on
    one CPU device), the params at their at-rest shards, the at-use
    gather and the at-rest shard around it, and the exact fold the mesh
    path really runs (``exact_weighted_mean``, K1)."""
    from ..parallel.layout import gather_tree, shard_tree, tree_specs

    mesh = ctx.mesh()
    full = ctx.abstract_params()
    specs = tree_specs(full, mesh)

    def aggregate(global_params, server_state, stacked, weights, cohort, rng):
        return exact_weighted_mean(stacked, weights), server_state

    fn = build_round_fn(ctx.local_train_fn(), aggregate, mesh=mesh,
                        at_use=lambda p: gather_tree(p, mesh, specs),
                        at_rest=lambda p: shard_tree(p, mesh, specs))
    with ctx.fake_mode():
        params = shard_tree(full, mesh, specs)
    return _audit_round_cases(ctx, fn, params)


def deterministic_client_sampling(
    round_idx: int, client_num_in_total: int, client_num_per_round: int
) -> np.ndarray:
    """Reference determinism contract: MT19937 seeded with
    ``round_idx``, ``choice`` without replacement, through a local
    ``RandomState`` (the caller's global NumPy RNG is left alone)."""
    if client_num_in_total == client_num_per_round:
        return np.arange(client_num_in_total, dtype=np.int32)
    rs = np.random.RandomState(round_idx)
    return np.asarray(
        rs.choice(range(client_num_in_total), client_num_per_round, replace=False),
        dtype=np.int32,
    )


class FedAvgAPI:
    """Single-card simulator for the FedAvg family.

    ``args.sim_mode``: ``"vectorized"`` (default; the cohort trains as
    one vmapped batch of clients) or ``"sequential"`` (a Python loop
    over clients, each a cohort of one).

    ``client_trainer`` / ``server_aggregator`` (``core/frame.py``)
    replace the stock local training and aggregation: the trainer's
    per-client function is vmapped over the cohort (called per client in
    the sequential mode), and the aggregator reduces the stacked cohort
    inside the round function."""

    algorithm = "FedAvg"
    # algorithms that need the cohort's trained params after each round
    # (S-FedAvg's Shapley scoring) turn this on: they run on the
    # synchronous loop, which hands them to _post_round_stacked
    _keep_stacked = False
    # the aggregation reads the cohort's masks (on a mesh they are
    # gathered whole for it; its other leaves stay on their lanes)
    _aggregate_reads_masks = False
    # algorithms whose server step IS the algorithm (FedOpt's optimizer,
    # FedNova's normalized combine) turn this off, so that a custom
    # server_aggregator raises instead of being dropped
    _accepts_custom_aggregator = True

    def __init__(
        self,
        args,
        device: DeviceLike,
        dataset: FederatedDataset,
        model: FedModel,
        client_trainer=None,
        server_aggregator=None,
        mesh=None,
    ) -> None:
        if server_aggregator is not None and not self._accepts_custom_aggregator:
            raise ValueError(
                f"{self.algorithm} defines its own server aggregation; a "
                "custom server_aggregator would be ignored — not supported"
            )
        self.args = args
        self.device = get_device(device)
        self.dataset = dataset
        self.model = model
        self.client_trainer = bind_operator(client_trainer, model, args)
        self.server_aggregator = bind_operator(server_aggregator, model, args)
        self.mode = getattr(args, "sim_mode", "vectorized")
        if self.mode == "sequential" and (
            self._keep_stacked or type(self)._preprocess is not FedAvgAPI._preprocess
        ):
            raise NotImplementedError(
                f"{self.algorithm} uses in-round hooks that only run in "
                "vectorized mode; sim_mode='sequential' is not supported"
            )
        self.history: List[Dict[str, float]] = []
        self.pipeline_stats: Dict[str, float] = {}

        seed = int(getattr(args, "random_seed", 0))
        self.global_params = model.init(torch.Generator().manual_seed(seed))
        # the round's randomness: the per-epoch shuffle uniforms
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        # round-indexed LR schedule (decay across rounds, constant within
        # one local fit): None for lr_schedule=constant
        self._round_lr = resolve_round_lr_schedule(args)
        self.shuffle = bool(getattr(args, "shuffle", True))
        self.epochs = int(args.epochs)
        # the per-client function of a custom trainer (the sequential
        # mode calls it per client), or None for the stock trainer
        self._client_train = None
        if client_trainer is not None:
            if self._round_lr is not None:
                raise ValueError(
                    "lr_schedule with a custom client_trainer: the trainer owns "
                    "its optimizer, so the engine cannot apply the round-indexed "
                    "LR — implement the schedule inside the trainer or use "
                    "lr_schedule=constant"
                )
            client_trainer.set_id(0)
            self._client_train = client_trainer.make_train_fn(args)
            self._local_train = cohort_train_fn(self._client_train)
        else:
            self._local_train = self._stock_local_train()
        self._eval = make_eval_fn(
            model.apply, model.loss_fn, compute_dtype=compute_dtype_from_args(args)
        )
        self.robust = RobustAggregator(args) if getattr(args, "defense_type", None) else None
        # the round being run (weak DP's noise is drawn from a generator
        # seeded by the run seed and this index)
        self._round_idx = 0
        # the in-round hook, when the algorithm has one
        self._round_preprocess = (
            self._preprocess if type(self)._preprocess is not FedAvgAPI._preprocess else None)
        self._round_fn = build_round_fn(self._local_train, self._aggregate,
                                        self._round_preprocess, keep_stacked=self._keep_stacked)
        self.server_state = self._init_server_state()
        # self.history is the round record of truth; the reporter only
        # fans out to sinks
        self.metrics_reporter = MetricsReporter(args, keep_history=False)
        # the process-wide registry and flight recorder (the round
        # pipeline's events land on trace.json's timeline); the export's
        # sys_* gauges read this API's card
        self.telemetry = Telemetry.get_instance(args)
        self.telemetry.bind_device(self.device)
        # the kernels' build cache (core/compile_cache.py): no-op unless
        # args.compile_cache_dir is set; idempotent process-wide, so every
        # engine (sync loop, round pipeline, planet loop, serving) shares
        # one directory
        maybe_enable_compile_cache(args)
        # the preemption seam (parallel/elastic.py): a caller may set a
        # signal object here; train() otherwise builds it from the knob
        self._preempt_signal = None
        # the simulator mesh (attach_mesh): None on one rank
        self.mesh, self._fed_mesh, self._specs = None, False, None
        if mesh is not None:
            self.attach_mesh(mesh)

    def _stock_local_train(self, data_group=None):
        """The stock local training (FedProx's term for FedProx); with a
        ``data_group``, each batch's examples split over its ranks."""
        args = self.args
        prox_mu = (float(getattr(args, "fedprox_mu", 0.0))
                   if self.algorithm == "FedProx" else 0.0)
        return make_local_train_fn(
            self.model.apply,
            self.model.loss_fn,
            create_client_optimizer(
                args,
                lr=float(args.learning_rate) if self._round_lr is not None else None,
            ),
            epochs=self.epochs,
            prox_mu=prox_mu,
            shuffle=self.shuffle,
            compute_dtype=compute_dtype_from_args(args),
            data_group=data_group,
        )

    # -- the simulator mesh --------------------------------------------
    def attach_mesh(self, mesh) -> None:
        """Run on ``mesh`` (``parallel/mesh.SimMesh``): the packed
        federation padded to the cohort axis and cut to this rank's share,
        the params at rest per the layout (fsdp-sharded on a fed mesh,
        whole on the legacy one), the round rebuilt on the mesh. On a fed
        mesh the plain FedAvg/FedProx aggregation becomes the exact fold;
        any other warns, as the JAX package warns, that it is not
        bitwise across mesh shapes. A legacy mesh's ``data`` axis splits
        each batch's examples over its ranks (the stock trainer's; a
        custom trainer trains its clients whole on every data rank)."""
        from ..parallel.layout import is_fed_mesh, shard_tree, tree_specs
        from ..parallel.mesh import pad_federation, shard_federation

        self.mesh = mesh
        self._fed_mesh = is_fed_mesh(mesh)
        ds = self.dataset
        if getattr(ds, "packed_train", None) is not None:
            n = mesh.lanes_count
            train, ns = pad_federation(ds.packed_train, ds.packed_num_samples, n)
            test, _ = pad_federation(ds.packed_test, ds.packed_num_samples, n)
            ds.packed_train, _ = shard_federation(train, ns, mesh)
            ds.packed_test, _ = shard_federation(test, ns, mesh)
            ds.packed_num_samples = ns.numpy()
        if self._fed_mesh and (
            self.robust is not None
            or self.server_aggregator is not None
            or type(self)._aggregate is not FedAvgAPI._aggregate
        ):
            logging.warning(
                "(data, fsdp) mesh with %s: aggregation does not go "
                "through the exact expansion fold, so final params are "
                "correct to float tolerance but NOT bitwise identical "
                "across mesh shapes (the detail.multichip identity "
                "gate covers the plain FedAvg/FedProx path only)",
                "defense_type" if self.robust is not None
                else ("a custom server_aggregator"
                      if self.server_aggregator is not None
                      else f"algorithm {self.algorithm}"),
            )
        if not self._fed_mesh and mesh.shape.get("data", 1) > 1 and self._client_train is None:
            # a custom trainer's per-client function cannot be split: its
            # data ranks train their lane's clients whole, the same function
            self._local_train = self._stock_local_train(mesh.groups["data"])
        self._specs = tree_specs(self.global_params, mesh)
        self.global_params = shard_tree(self.global_params, mesh, self._specs)
        self._round_fn = build_round_fn(self._local_train, self._aggregate,
                                        self._round_preprocess, keep_stacked=self._keep_stacked,
                                        mesh=mesh, at_use=self.full_params,
                                        at_rest=self._at_rest,
                                        aggregate_reads_masks=self._aggregate_reads_masks)

    def _round_exec_name(self) -> str:
        """The registry name of the round this API dispatches: the
        ``executable`` tag of its ``exec_device_seconds`` series, which
        ``cli perf`` joins to the audit report's row of that name."""
        return "simulation.round_fn_mesh" if self.mesh is not None else "simulation.round_fn"

    def full_params(self, params: Optional[Params] = None) -> Params:
        """``params`` (default: the global params) whole: on a fed mesh
        gathered from the fsdp ranks' at-rest shards."""
        params = self.global_params if params is None else params
        if not self._fed_mesh:
            return params
        from ..parallel.layout import gather_tree

        return gather_tree(params, self.mesh, self._specs)

    def _at_rest(self, params: Params) -> Params:
        """Whole params as the API keeps them: this rank's fsdp shards on a
        fed mesh, else themselves."""
        if not self._fed_mesh:
            return params
        from ..parallel.layout import shard_tree

        return shard_tree(params, self.mesh, self._specs)

    def _cohort(self, idx: np.ndarray) -> Batches:
        """The packed federation's clients ``idx``; on a mesh this rank's
        lane of them, taken from their owners."""
        packed = self.dataset.packed_train
        t = torch.as_tensor(idx, dtype=torch.int64, device=packed.mask.device)
        if self.mesh is None:
            return _take(packed, t)
        return self.mesh.gather_lane(packed, t, packed.mask.shape[0])

    # -- algorithm hooks ----------------------------------------------
    def _init_server_state(self):
        return ()

    def _aggregate(self, global_params, server_state, new_stacked, weights, cohort, rng):
        """FedAvg: the weighted average, the custom aggregator's
        reduction, or the robust aggregation ``defense_type`` names."""
        if self.server_aggregator is not None:
            return (self.server_aggregator.aggregate(global_params, new_stacked, weights, rng),
                    server_state)
        if self.robust is not None:
            noise = None
            if self.robust.defense_type == constants.DEFENSE_WEAK_DP:
                noise = derive_defense_rng(int(getattr(self.args, "random_seed", 0)),
                                           self._round_idx, self.device)
            return self.robust.aggregate(new_stacked, weights, global_params, noise), server_state
        if self._fed_mesh:
            # placement-independent: every mesh shape, {data: 1} included,
            # finalizes to the same f32 params
            return exact_weighted_mean(new_stacked, weights), server_state
        return weighted_average(new_stacked, weights), server_state

    def _preprocess(self, cohort: Batches, server_state):
        """Applied to the gathered cohort before local training, inside the
        round (HS-FedAvg's FFT input normalization plugs in here)."""
        return cohort, server_state

    def _post_round_stacked(self, stacked: Params, idx: np.ndarray, round_idx: int) -> None:
        """Fed the cohort's trained params after each round when
        ``_keep_stacked`` is set (S-FedAvg's scoring)."""

    def _extra_checkpoint_state(self):
        """Algorithm state to persist beside the params (S-FedAvg's
        reputation): a dict of tensors, or None."""
        return None

    def _restore_extra_state(self, extra) -> None:
        """Take back what ``_extra_checkpoint_state`` saved."""

    # -- reference-parity sampling ------------------------------------
    def _client_sampling(
        self, round_idx: int, client_num_in_total: int, client_num_per_round: int
    ) -> np.ndarray:
        return deterministic_client_sampling(
            round_idx, client_num_in_total, client_num_per_round
        )

    def _lr_mult(self, round_idx: int):
        """Round-indexed LR multiplier (schedule(r) / peak), or None."""
        if self._round_lr is None:
            return None
        return float(np.float32(self._round_lr(round_idx) / float(self.args.learning_rate)))

    def _shuffle_uniforms(self, cohort_size: int, bucket: Optional[int] = None,
                          examples: Optional[int] = None):
        """The round's shuffle draws, ``[bucket, epochs, examples]``, or
        None; ``examples`` defaults to the packed federation's nb*bs.
        Only the ``cohort_size`` real clients draw (so a padded cohort
        sees the draws of the exact one, and the sequential mode those
        of the vectorized); padded slots repeat the first row, which
        their all-zero masks make inert."""
        if not self.shuffle:
            return None
        if examples is None:
            packed = self.dataset.packed_train
            examples = packed.num_batches * packed.batch_size
        n = examples
        u = torch.rand(
            (cohort_size, self.epochs, n), generator=self.generator, device=self.device
        )
        if bucket is not None and bucket > cohort_size:
            u = torch.cat([u, u[:1].expand((bucket - cohort_size,) + tuple(u.shape[1:]))])
        return u

    # -- round loop ----------------------------------------------------
    def train(self) -> Dict[str, float]:
        args = self.args
        planet = planet_knobs_active(args)
        if planet:
            # the registry-backed plane: no eager federation to pack
            packed = nsamples = None
        else:
            packed = self.dataset.packed_train
            nsamples = torch.as_tensor(
                self.dataset.packed_num_samples, dtype=torch.float32, device=self.device
            )
        comm_rounds = int(args.comm_round)
        freq = max(1, int(getattr(args, "frequency_of_the_test", 5)))
        ckpt, start_round = self._maybe_restore()
        if self._preempt_signal is None:
            from ..parallel.elastic import make_signal

            self._preempt_signal = make_signal(getattr(args, "preempt_signal", None))
        # the stall watchdog (armed only when stall_timeout_s > 0) and the
        # pull-based /metrics endpoint (off unless metrics_port)
        watchdog = self.telemetry.maybe_start_watchdog(args)
        self.telemetry.maybe_start_metrics_server(args)
        profiler = RoundProfiler(args, self.device)
        try:
            if planet:
                # the loop (registry, shape census) persists across
                # train() calls, so a warm re-run replays its shapes
                if getattr(self, "_planet_loop", None) is None:
                    self._planet_loop = PlanetRoundLoop(self)
                return self._planet_loop.run(packed, nsamples, comm_rounds, freq, profiler,
                                             ckpt, start_round)
            if self.mode == "sequential" or self._keep_stacked:
                return self._train_rounds_sync(packed, nsamples, comm_rounds, freq, profiler,
                                               ckpt, start_round)
            return RoundPipeline(self).run(packed, nsamples, comm_rounds, freq, profiler,
                                           ckpt, start_round)
        finally:
            profiler.close()
            if ckpt is not None:
                ckpt.close()
            if watchdog is not None:
                self.telemetry.stop_watchdog()
            self.telemetry.stop_metrics_server()
            # one trace.json + metrics.prom + telemetry.jsonl snapshot per
            # run when telemetry_dir is set
            self.telemetry.export_run_artifacts(getattr(args, "telemetry_dir", None))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- checkpoint / resume -------------------------------------------
    def _maybe_restore(self):
        """``(checkpointer, start_round)``: ``(None, 0)`` without
        ``checkpoint_dir``; else the checkpointer, and the round after
        the latest saved step, whose params, server state and generator
        state are now the API's (0 when there is no step yet)."""
        ckpt_dir = getattr(self.args, "checkpoint_dir", None)
        if not ckpt_dir:
            return None, 0
        from ..core.checkpoint import RoundCheckpointer

        # None = every 10 rounds, the JAX package's cadence
        self._ckpt_freq = max(1, int(getattr(self.args, "checkpoint_freq", None) or 10))
        ckpt = RoundCheckpointer(ckpt_dir)
        state = ckpt.restore()
        if state is None:
            return ckpt, 0
        params = state["params"]
        if set(params) != set(self.global_params):
            raise ValueError(
                f"checkpoint under {ckpt.dir} holds params {sorted(params)}, the model "
                f"has {sorted(self.global_params)}"
            )
        self.global_params = self._at_rest({k: v.to(self.device) for k, v in params.items()})
        leaves, spec = pytree.tree_flatten(self.server_state)
        saved = state["server_state"]
        if len(saved) != len(leaves):
            raise ValueError(
                f"checkpoint under {ckpt.dir} holds {len(saved)} server-state leaves, "
                f"{self.algorithm} has {len(leaves)}"
            )
        self.server_state = pytree.tree_unflatten([v.to(self.device) for v in saved], spec)
        self.generator.set_state(state["generator"])
        self._restore_extra_state(state.get("extra"))
        start_round = int(state["round_idx"]) + 1
        self._note_elastic_resume(ckpt, start_round)
        logging.info("resuming from round %d", start_round)
        return ckpt, start_round

    def _writes_state(self) -> bool:
        """Whether this process writes the run's checkpoints and WAL:
        rank 0 of a mesh's world, or the process of a one-rank run."""
        return self.mesh is None or dist_rank() == 0

    def _note_elastic_resume(self, ckpt, start_round: int) -> None:
        """If the WAL's last word is ``kind="preempt"``, this restore is
        the elastic resume: append the paired ``kind="resume"`` record
        (the invariant checker's evidence,
        ``preempt_paired_with_checkpoint``) and count it. A WAL ending in
        anything else (or none) is a plain restart: no record, no
        counter. Rank 0 appends; every rank reads the same last word."""
        from ..core.checkpoint import RoundWAL
        from ..parallel.elastic import _mesh_devices, _mesh_shape

        wal = RoundWAL(ckpt.dir)
        last = wal.last()
        if last is None or last.get("kind") != "preempt":
            return
        if self.mesh is not None:
            import torch.distributed as dist

            # every rank has read the preempt before rank 0 answers it
            dist.barrier(group=self.mesh.group)
        if self._writes_state():
            wal.append(int(start_round), int(last.get("ckpt_step") or 0), [], kind="resume",
                       extra={"devices": _mesh_devices(self.mesh),
                              "mesh_shape": _mesh_shape(self.mesh)})
        if self.telemetry.enabled:
            self.telemetry.inc("elastic_resumes_total")
        logging.warning(
            "elastic resume: preempt record at round %s consumed; continuing "
            "from round %d on %d device(s)",
            last.get("round_idx"), int(start_round), len(_mesh_devices(self.mesh)) or 1,
        )

    def _maybe_preempt(self, ckpt, round_idx: int, saved: bool = False, drain=None) -> None:
        """Poll the preemption signal at the round boundary (rank 0's
        answer, on a mesh of several ranks); on notice call ``drain``
        (the round pipeline empties its window there), make the round
        durable (WAL ``kind="preempt"`` write-ahead of a forced
        checkpoint) and raise ``Preempted``. ``saved=True``: the cadence
        block already published this round's step."""
        if self._preempt_signal is None:
            return
        from ..parallel.elastic import poll_world, preempt_now

        notice = poll_world(self._preempt_signal, round_idx, self.mesh)
        if notice is not None:
            if drain is not None:
                drain()
            preempt_now(self, ckpt, round_idx, notice, saved=saved)

    def _save_checkpoint(self, ckpt, round_idx: int) -> None:
        """Round ``round_idx``'s state: the global params, the server
        state's leaves, the generator's state after the round's draws
        (the state the next round draws from), and the algorithm's
        ``extra`` state when it has one."""
        state = {
            "params": self.full_params(),
            "server_state": pytree.tree_leaves(self.server_state),
            "generator": self.generator.get_state(),
            "round_idx": int(round_idx),
        }
        extra = self._extra_checkpoint_state()
        if extra is not None:
            state["extra"] = extra
        if self._writes_state():  # every rank gathers, rank 0 writes
            ckpt.save(round_idx, state)

    def _train_rounds_sync(self, packed, nsamples, comm_rounds, freq, profiler,
                           ckpt=None, start_round=0):
        """The synchronous loop of the sequential mode (a Python loop
        over the cohort's clients) and of the ``_keep_stacked``
        algorithms (the vectorized round, its cohort's trained params
        handed to ``_post_round_stacked``). A round that evaluates waits for the
        card before its evaluation and records ``train_time_s`` (round
        start to training done on the device) beside ``round_time_s``
        (to the end of evaluation). With a checkpointer, rounds run from
        ``start_round`` and the state is saved every ``checkpoint_freq``
        rounds and after the last; the preemption signal is polled at
        each round's end, after the save."""
        final_stats: Dict[str, float] = {}
        for round_idx in range(start_round, comm_rounds):
            profiler.tick(round_idx)
            t0 = time.perf_counter()
            summed = self._sync_round(round_idx, packed, nsamples)
            if round_idx % freq == 0 or round_idx == comm_rounds - 1:
                self._sync()
                train_time = time.perf_counter() - t0
                ring = DeferredMetrics()
                ring.push(round_idx, {"summed": summed, **self._eval_sums()})
                (_, host), = ring.flush()
                stats = self._stats_from_host(
                    round_idx, host, time.perf_counter() - t0, train_time
                )
                self.history.append(stats)
                final_stats = stats
                self.metrics_reporter.report_server_training_metric(stats)
            saved = False
            if ckpt is not None and (
                (round_idx + 1) % self._ckpt_freq == 0 or round_idx == comm_rounds - 1
            ):
                self._save_checkpoint(ckpt, round_idx)
                saved = True
            self._maybe_preempt(ckpt, round_idx, saved=saved)
        return final_stats

    def _sync_round(self, round_idx: int, packed, nsamples) -> Dict[str, torch.Tensor]:
        """One round of the synchronous loop: sample, train, aggregate
        (and hand the cohort's trained params to ``_post_round_stacked``);
        the round's summed training metrics, left on the device."""
        idx = self._client_sampling(
            round_idx, self.dataset.client_num, int(self.args.client_num_per_round)
        )
        rng = self._shuffle_uniforms(len(idx))
        lr_mult = self._lr_mult(round_idx)
        self._round_idx = round_idx
        if self.mode == "sequential":
            # no round series: the JAX package measures only the vmapped
            # round (a sequential round is many executables, not one)
            self.global_params, summed = self._sequential_round(idx, rng, lr_mult, nsamples)
            return summed
        with devtime.measure(self._round_exec_name(), bucket=f"b{len(idx)}"):
            out = self._round_fn(
                self.global_params, self.server_state, packed, nsamples,
                torch.as_tensor(idx, dtype=torch.int64, device=self.device), rng,
                lr_mult,
            )
            self.global_params, self.server_state, summed = out[:3]
            if self._keep_stacked:
                self._post_round_stacked(out[3], idx, round_idx)
        return summed

    def run_round(self, round_idx: int) -> Dict[str, torch.Tensor]:
        """One round of the synchronous loop on the API's own federation
        (what a harness times round by round); its summed training
        metrics, on the device."""
        nsamples = torch.tensor(np.asarray(self.dataset.packed_num_samples),
                                dtype=torch.float32, device=self.device)
        return self._sync_round(round_idx, self.dataset.packed_train, nsamples)

    def _sequential_round(self, idx: np.ndarray, rng, lr_mult, nsamples):
        """Reference shape: a Python loop over the sampled clients, each
        with its slice of the round's shuffle draws: the stock trainer
        trains it as a cohort of one, a custom trainer's per-client
        function takes it alone. On a mesh a rank loops over its lane,
        and the lanes' params and sums are gathered."""
        stacked, sums = [], None
        cohort = self._cohort(idx)
        lo, hi = (0, len(idx)) if self.mesh is None else self.mesh.lanes(len(idx))
        params = self.full_params()
        for j in range(hi - lo):
            if self._client_train is not None:
                p, m = self._client_train(
                    params,
                    Batches(x=cohort.x[j], y=cohort.y[j], mask=cohort.mask[j]),
                    None if rng is None else rng[lo + j],
                )
                stacked.append(p)
            else:
                client = Batches(
                    x=cohort.x[j:j + 1], y=cohort.y[j:j + 1], mask=cohort.mask[j:j + 1]
                )
                p, m = self._local_train(
                    params, client, None if rng is None else rng[lo + j:lo + j + 1],
                    lr_mult,
                )
                stacked.append({k: v[0] for k, v in p.items()})
                m = {k: v[0] for k, v in m.items()}
            sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
        stacked = stack_pytrees(stacked)
        if self.mesh is not None:
            stacked = self.mesh.gather_stacked(stacked, len(idx))
            sums = self.mesh.sum_lanes(sums)
        ns = nsamples.index_select(
            0, torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        )
        new_global, self.server_state = self._aggregate(
            params, self.server_state, stacked, normalize_weights(ns), None, rng,
        )
        return self._at_rest(new_global), sums

    # -- evaluation ----------------------------------------------------
    def _eval_sums(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Summed metrics of the global model over every client's train
        and test data, left on the device. The eval function sums over
        every leading axis, so one call covers all clients (the JAX
        package vmaps it: ``build_eval_all``)."""
        params = self.full_params()
        sums = {
            "train": self._eval(params, self.dataset.packed_train),
            "test": self._eval(params, self.dataset.packed_test),
        }
        if self.mesh is not None:  # each rank evaluated its own clients
            sums = {k: self.mesh.sum_lanes(v) for k, v in sums.items()}
        return sums

    def _stats_from_host(self, round_idx: int, host, round_time_s, train_time_s):
        """A round's history record from its fetched metrics: the global
        model's train and test accuracy and loss, the round's wall
        ``round_time_s`` and training ``train_time_s``, and the
        cohort's mean training loss and real-example count over the
        last local epoch (``train_loss_cohort``, ``cohort_samples``)."""
        tr = self.model.metrics_from_sums(host["train"])
        te = self.model.metrics_from_sums(host["test"])
        summed = host["summed"]
        return {
            "train_acc": tr["acc"],
            "train_loss": tr["loss"],
            "test_acc": te["acc"],
            "test_loss": te["loss"],
            "round": round_idx,
            "round_time_s": round_time_s,
            "train_time_s": train_time_s,
            "train_loss_cohort": summed["loss_sum"] / max(summed["count"], 1.0),
            "cohort_samples": summed["count"],
        }

    def evaluate_global(self) -> Dict[str, float]:
        sums = self._eval(self.full_params(), self.dataset.test_data_global)
        return self.model.metrics_from_sums(sums)

    def _local_test_on_all_clients(self, round_idx: int) -> Dict[str, float]:
        """The global model's train and test accuracy and loss over every
        client's data, fetched to the host (the algorithms with their own
        round loops report these)."""
        sums = self._eval_sums()
        tr = self.model.metrics_from_sums(sums["train"])
        te = self.model.metrics_from_sums(sums["test"])
        return {"train_acc": tr["acc"], "train_loss": tr["loss"],
                "test_acc": te["acc"], "test_loss": te["loss"]}


class FedProxAPI(FedAvgAPI):
    """FedProx = FedAvg + the proximal term in the client loss
    (``args.fedprox_mu``)."""

    algorithm = "FedProx"


class FedOptAPI(FedAvgAPI):
    """Server-side adaptive optimization (the reference's
    ``FedOptAggregator``): the averaged client delta is a
    pseudo-gradient fed to the server optimizer
    (``args.server_optimizer``: sgd, momentum, adam, adagrad, yogi)."""

    algorithm = "FedOpt"
    _accepts_custom_aggregator = False

    def _init_server_state(self):
        self._server_opt = create_server_optimizer(self.args)
        return self._server_opt.init(self.global_params)

    def _aggregate(self, global_params, server_state, new_stacked, weights, cohort, rng):
        avg = weighted_average(new_stacked, weights)
        pseudo_grad = {k: global_params[k] - avg[k] for k in global_params}
        updates, new_state = self._server_opt.update(pseudo_grad, server_state, global_params)
        return {k: global_params[k] + updates[k] for k in global_params}, new_state


class FedNovaAPI(FedAvgAPI):
    """Normalized averaging (the reference's ``fednova``): client deltas
    are normalized by their local step counts a_i and recombined with
    tau_eff = sum(p_i a_i): w+ = w - tau_eff * sum(p_i (w - w_i) / a_i),
    a_i = epochs * (# non-empty batches), exact for plain-SGD clients.
    Needs the cohort's masks, so only the vectorized mode runs it."""

    algorithm = "FedNova"
    _accepts_custom_aggregator = False
    _aggregate_reads_masks = True

    def _aggregate(self, global_params, server_state, new_stacked, weights, cohort, rng):
        if cohort is None:
            raise NotImplementedError("FedNova requires vectorized mode")
        epochs = float(self.args.epochs)
        nonempty = (cohort.mask.sum(dim=-1) > 0).to(torch.float32).sum(dim=-1)
        a_i = torch.clamp(epochs * nonempty, min=1.0)  # [C]
        tau_eff = (weights * a_i).sum()

        def combine(g, s):
            shape = (-1,) + (1,) * g.dim()
            w = weights.reshape(shape).to(g.dtype)
            ai = a_i.reshape(shape).to(g.dtype)
            return g - tau_eff.to(g.dtype) * (w * (g[None] - s) / ai).sum(dim=0)

        return {k: combine(global_params[k], new_stacked[k]) for k in global_params}, server_state


def get_algorithms():
    """Name -> API class registry (the simulators' table, read at call
    time: ``simulator.py`` imports this module)."""
    from .simulator import _ALGORITHMS

    return _ALGORITHMS
