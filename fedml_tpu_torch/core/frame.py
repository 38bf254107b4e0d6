"""L3 algorithm frame: the custom-operator seam (port of ``fedml_tpu/core/frame.py``).

Users customize federated training by subclassing a ``ClientTrainer`` /
``ServerAggregator`` pair (the reference's
``core/alg_frame/client_trainer.py:4-40`` and ``server_aggregator.py:4-35``)
and handing it to ``run_simulation(backend, client_trainer,
server_aggregator)``. The seam is a pure-function factory:

- ``ClientTrainer.make_train_fn(args)`` returns a **per-client**
  function ``fn(params, batches, rng) -> (new_params, metrics)``:
  ``params`` the global params (``{key: Tensor}``), ``batches`` one
  client's ``Batches`` (``[nb, bs, ...]`` and its mask), ``rng`` that
  client's row of the round's shuffle uniforms (``[epochs, nb*bs]``,
  drawn by the engine from its device ``torch.Generator``; see
  ``FedAvgAPI._shuffle_uniforms``), or None when ``args.shuffle`` is
  off. ``metrics`` holds the client's ``loss_sum``, ``correct`` and
  ``count``. The vectorized engine maps the function over the cohort
  with ``torch.func.vmap``; the sequential one calls it in a loop.
- ``ServerAggregator.aggregate(global_params, stacked_params, weights,
  rng)`` reduces the stacked cohort (leaves ``[C, ...]``; ``weights``
  ``[C]`` sum to 1 and are zero on the slots a pow2 bucket padded) inside
  the round function.

The reference's imperative surface (``get/set_model_params``,
``train(train_data, device, args)``, ``test``) sits on the functional
core.

``DefaultClientTrainer`` and ``DefaultServerAggregator`` are the stock
operators. The default trainer's function carries the stock cohort-level
trainer as its ``cohort`` attribute, and the engine runs that directly,
so passing the default trainer is the stock engine, bitwise; a subclass
that wraps the function gets the per-client route.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .types import Batches

Params = Dict[str, torch.Tensor]
TrainFn = Callable[[Params, Batches, Optional[torch.Tensor]], Tuple[Params, Dict[str, Any]]]


def _compute_dtype(operator, args):
    from .local_trainer import compute_dtype_from_args

    return compute_dtype_from_args(args if args is not None else operator.args)


def _test(operator, test_data, args):
    """The global-model metrics of ``operator.params`` on ``test_data``."""
    from .local_trainer import make_eval_fn

    if operator._eval_fn is None:
        operator._eval_fn = make_eval_fn(
            operator.model.apply, operator.model.loss_fn,
            compute_dtype=_compute_dtype(operator, args),
        )
    return operator.model.metrics_from_sums(operator._eval_fn(operator.params, test_data))


class ClientTrainer(abc.ABC):
    """Abstract client operator (client_trainer.py:4-40).

    Subclasses implement :meth:`make_train_fn`; everything else has
    working defaults. ``model`` is a :class:`fedml_tpu_torch.models.spec.FedModel`.
    """

    def __init__(self, model, args=None) -> None:
        self.model = model
        self.id = 0
        self.args = args
        self.params: Optional[Params] = None
        self.local_train_dataset = None
        self.local_test_dataset = None
        self.local_sample_number = 0
        self._train_fn = None
        self._train_fn_args = None
        self._eval_fn = None
        self._train_calls = 0

    def set_id(self, trainer_id) -> None:
        self.id = trainer_id

    def update_dataset(self, train_data, test_data, sample_num) -> None:
        self.local_train_dataset = train_data
        self.local_test_dataset = test_data
        self.local_sample_number = sample_num

    # -- functional seam (the part subclasses write) -------------------
    @abc.abstractmethod
    def make_train_fn(self, args) -> TrainFn:
        """Return the per-client local-training function
        ``fn(params, batches, rng) -> (new_params, metrics)``.

        It must be ``torch.func.vmap``-safe: no Python side effects and
        no Python control flow on tensor values. ``batches`` is one
        client's :class:`Batches` ([nb, bs, ...] + mask), ``rng`` its
        shuffle uniforms ``[epochs, nb*bs]`` or None; ``metrics`` must
        include ``loss_sum`` / ``correct`` / ``count``. Inputs are never
        written to.
        """

    # -- reference-parity imperative surface ---------------------------
    def get_model_params(self) -> Optional[Params]:
        return self.params

    def set_model_params(self, model_parameters: Params) -> None:
        self.params = model_parameters

    def train(self, train_data: Batches, device=None, args=None) -> Params:
        """Imperative wrapper over the functional core
        (client_trainer.py ``train(train_data, device, args)``): trains
        ``self.params`` on one client's ``train_data`` and keeps the
        result. Each call draws its own shuffle uniforms, from a
        generator seeded by (``random_seed``, trainer id, call number),
        so repeated calls do not replay one permutation."""
        args = args if args is not None else self.args
        if self._train_fn is None or args is not self._train_fn_args:
            self._train_fn = self.make_train_fn(args)
            self._train_fn_args = args
        self._train_calls += 1
        rng = None
        if bool(getattr(args, "shuffle", True)):
            seed = np.random.SeedSequence(
                [int(getattr(args, "random_seed", 0) or 0), int(self.id), self._train_calls]
            ).generate_state(1)[0]
            dev = train_data.mask.device
            gen = torch.Generator(device=dev).manual_seed(int(seed))
            n = train_data.num_batches * train_data.batch_size
            rng = torch.rand((int(args.epochs), n), generator=gen, device=dev)
        self.params, _ = self._train_fn(self.params, train_data, rng)
        return self.params

    def test(self, test_data: Batches, device=None, args=None) -> Dict[str, float]:
        return _test(self, test_data, args)

    def test_on_the_server(
        self, train_data_local_dict, test_data_local_dict, device=None, args=None
    ) -> bool:
        return False


class DefaultClientTrainer(ClientTrainer):
    """The stock operator: the masked SGD local training of
    ``core.local_trainer.make_local_train_fn``, FedProx-aware via
    ``args.fedprox_mu``. Its per-client function trains the client as a
    cohort of one; the stock cohort-level function rides along as
    ``fn.cohort``."""

    def make_train_fn(self, args) -> TrainFn:
        from .local_trainer import make_local_train_fn
        from .optimizers import create_client_optimizer

        cohort = make_local_train_fn(
            self.model.apply,
            self.model.loss_fn,
            create_client_optimizer(args),
            epochs=int(args.epochs),
            prox_mu=float(getattr(args, "fedprox_mu", 0.0) or 0.0),
            shuffle=bool(getattr(args, "shuffle", True)),
            compute_dtype=_compute_dtype(self, args),
        )

        def train(params: Params, batches: Batches, rng=None):
            one = Batches(x=batches.x[None], y=batches.y[None], mask=batches.mask[None])
            p, m = cohort(params, one, None if rng is None else rng[None])
            return {k: v[0] for k, v in p.items()}, {k: v[0] for k, v in m.items()}

        train.cohort = cohort
        return train


def cohort_train_fn(train_fn: TrainFn) -> Callable:
    """A per-client ``train_fn`` as the engine's cohort-level
    ``local_train(params, batches, rng=None, lr_mult=None)``: the stock
    function where ``train_fn`` carries it (``DefaultClientTrainer``),
    else ``torch.func.vmap`` of ``train_fn`` over the cohort axis of the
    batches and the uniforms. ``lr_mult`` is always None here (the
    engine refuses a round-indexed schedule with a custom trainer)."""
    stock = getattr(train_fn, "cohort", None)
    if stock is not None:
        return stock

    def local_train(params: Params, batches: Batches, rng=None, lr_mult=None):
        def one(x, y, mask, u):
            return train_fn(params, Batches(x=x, y=y, mask=mask), u)

        in_dims = (0, 0, 0, None if rng is None else 0)
        return torch.func.vmap(one, in_dims=in_dims)(batches.x, batches.y, batches.mask, rng)

    return local_train


class ServerAggregator(abc.ABC):
    """Abstract server operator (server_aggregator.py:4-35)."""

    def __init__(self, model, args=None) -> None:
        self.model = model
        self.id = 0
        self.args = args
        self.params: Optional[Params] = None
        self._eval_fn = None

    def set_id(self, aggregator_id) -> None:
        self.id = aggregator_id

    def get_model_params(self) -> Optional[Params]:
        return self.params

    def set_model_params(self, model_parameters: Params) -> None:
        self.params = model_parameters

    # -- functional seam -----------------------------------------------
    @abc.abstractmethod
    def aggregate(
        self, global_params: Params, stacked_params: Params, weights: torch.Tensor, rng
    ) -> Params:
        """Pure reduction over the stacked cohort axis.

        ``stacked_params`` leaves are ``[C, ...]`` (client axis
        leading); ``weights`` is ``[C]``, sums to 1 and is zero on
        padded slots; ``rng`` is the round's shuffle uniforms (or None).
        Called inside the round function, on the device.
        """

    def test(self, test_data: Batches, device=None, args=None) -> Dict[str, float]:
        return _test(self, test_data, args)

    def test_on_the_server(
        self, train_data_local_dict, test_data_local_dict, device=None, args=None
    ) -> bool:
        return False


def bind_operator(operator, model, args):
    """Late-bind model/args onto a user-constructed operator. Users may
    build a trainer before the model exists (``run_simulation`` creates
    the model itself), so engines call this before ``make_train_fn``.
    A value the user set is never overwritten, but a value bound here is
    bound again on reuse (one trainer across two engines tracks the
    second engine's model), dropping the cached functions."""
    if operator is None:
        return None
    if getattr(operator, "model", None) is None or getattr(
        operator, "_auto_bound_model", False
    ):
        if operator.model is not model:
            operator.model = model
            operator._train_fn = None
            operator._eval_fn = None
        operator._auto_bound_model = True
    if getattr(operator, "args", None) is None or getattr(
        operator, "_auto_bound_args", False
    ):
        operator.args = args
        operator._auto_bound_args = True
    return operator


class DefaultServerAggregator(ServerAggregator):
    """The stock operator: the sample-weighted FedAvg mean
    (``core.aggregation.weighted_average``)."""

    def aggregate(self, global_params, stacked_params, weights, rng) -> Params:
        from .aggregation import weighted_average

        return weighted_average(stacked_params, weights)
