"""Client optimizers as functional update rules (port of ``core/optimizers.py``).

The JAX package builds its client optimizers from optax; here each rule
is a pair of plain functions on dicts of tensors, with optax's
semantics, so that ``torch.func.vmap`` runs them per client and the
local trainer can revert their state on a fully masked batch
(``torch.optim`` keeps its state inside the object and cannot do
either):

- ``init(params) -> state``;
- ``update(grads, state, params) -> (updates, new_state)``; the new
  params are ``params + updates``.

``sgd`` is optax's: momentum as ``trace`` (``t = g + m * t``, then
``-lr * t``); ``weight_decay`` adds ``wd * params`` to the gradient
*before* it (``add_decayed_weights``). ``adam`` and ``adamw`` keep
optax's defaults (b1 0.9, b2 0.999, eps 1e-8, bias correction);
``adamw`` adds the decayed weights after the Adam scaling. The server
optimizers of FedOpt (``create_server_optimizer``) are optax's ``sgd``
(momentum ``server_momentum``), ``adam`` (``server_beta1``/``_beta2``),
``adagrad`` and ``yogi`` at their optax defaults.

The learning-rate schedules are optax's formulas, as host functions of
a step or round index; a step-indexed one rides in the optimizer's state
as optax's ``scale_by_schedule`` does (the distributed trainer).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch._C._functorch import is_batchedtensor

Params = Dict[str, torch.Tensor]
State = Any
Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
    init: Callable[[Params], State]
    update: Callable[[Params, State, Params], Tuple[Params, State]]


def _map(fn, *trees: Params) -> Params:
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def trace(decay: float) -> GradientTransformation:
    """Momentum: ``t = g + decay * t``; the update is ``t``."""

    def init(params):
        return {"trace": _map(torch.zeros_like, params)}

    def update(updates, state, params):
        t = _map(lambda g, tr: g + decay * tr, updates, state["trace"])
        return t, {"trace": t}

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params):
        return _map(lambda g, p: g + weight_decay * p, updates, params), state

    return GradientTransformation(lambda params: (), update)


def scale_by_learning_rate(lr: Union[float, Schedule]) -> GradientTransformation:
    """``-lr * u``; a schedule is optax's ``scale_by_schedule``: step k
    (counted in the state, from 0) scales by ``-lr(k)``. The count is an
    int32 on the CPU, so reading it costs no wait for the card. Under
    ``vmap`` (a cohort's step, where no count can be read on the host) the
    schedule is a table of its values up to ``lr.steps``, past which it is
    constant, indexed by the count and cast to the updates' dtype: the
    same product as the host read's Python float, which the multiply
    casts to that dtype."""
    if callable(lr):
        table = []  # made at the first step under vmap

        def init(params):
            return {"count": torch.zeros((), dtype=torch.int32)}

        def scheduled(updates, state, params):
            count = state["count"]
            if is_batchedtensor(count):
                if not table:
                    table.append(torch.tensor([lr(k) for k in range(int(lr.steps) + 1)],
                                              dtype=torch.float64))
                values = table[0]
                step = values[count.clamp(max=len(values) - 1).long()]
                return (_map(lambda u: -step.to(u.device, u.dtype) * u, updates),
                        {"count": count + 1})
            step = lr(int(count))
            return _map(lambda u: -step * u, updates), {"count": count + 1}

        return GradientTransformation(init, scheduled)

    def update(updates, state, params):
        return _map(lambda u: -lr * u, updates), state

    return GradientTransformation(lambda params: (), update)


def scale_by_adam(
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
) -> GradientTransformation:
    def init(params):
        some = next(iter(params.values()))
        return {
            "count": torch.zeros((), dtype=torch.int32, device=some.device),
            "mu": _map(torch.zeros_like, params),
            "nu": _map(torch.zeros_like, params),
        }

    def update(updates, state, params):
        mu = _map(lambda g, m: (1 - b1) * g + b1 * m, updates, state["mu"])
        nu = _map(lambda g, v: (1 - b2) * (g * g) + b2 * v, updates, state["nu"])
        count = state["count"] + 1

        def step(m, v):
            # bias corrections in the moment's dtype, as optax computes
            # them (1 - 0.999**1 cancels: f32 keeps ~5 digits of it)
            c = count.to(m.dtype)
            return (m / (1 - b1**c)) / (torch.sqrt(v / (1 - b2**c)) + eps)

        return _map(step, mu, nu), {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def scale_by_rss(
    initial_accumulator_value: float = 0.1, eps: float = 1e-7
) -> GradientTransformation:
    """Adagrad's scaling: ``g / sqrt(sum of g^2 so far + eps)`` (0 where
    the sum is 0)."""

    def init(params):
        return {"sum_of_squares": _map(
            lambda p: torch.full_like(p, initial_accumulator_value), params)}

    def update(updates, state, params):
        ss = _map(lambda g, t: g * g + t, updates, state["sum_of_squares"])
        out = _map(
            lambda g, t: torch.where(t > 0, torch.rsqrt(t + eps), torch.zeros_like(t)) * g,
            updates, ss,
        )
        return out, {"sum_of_squares": ss}

    return GradientTransformation(init, update)


def scale_by_yogi(
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-3,
    initial_accumulator_value: float = 1e-6,
) -> GradientTransformation:
    """Yogi: Adam with the additive second-moment update
    ``v - (1 - b2) * sign(v - g^2) * g^2``."""

    def init(params):
        some = next(iter(params.values()))
        full = lambda p: torch.full_like(p, initial_accumulator_value)  # noqa: E731
        return {
            "count": torch.zeros((), dtype=torch.int32, device=some.device),
            "mu": _map(full, params),
            "nu": _map(full, params),
        }

    def update(updates, state, params):
        mu = _map(lambda g, m: (1 - b1) * g + b1 * m, updates, state["mu"])
        nu = _map(lambda g, v: v - (1 - b2) * torch.sign(v - g * g) * (g * g),
                  updates, state["nu"])
        count = state["count"] + 1

        def step(m, v):
            c = count.to(m.dtype)
            return (m / (1 - b1**c)) / (torch.sqrt(v / (1 - b2**c)) + eps)

        return _map(step, mu, nu), {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def sgd(lr: Union[float, Schedule], momentum: Optional[float] = None) -> GradientTransformation:
    if momentum is None:
        return scale_by_learning_rate(lr)
    return chain(trace(momentum), scale_by_learning_rate(lr))


def adam(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2), scale_by_learning_rate(lr))


def adamw(lr: Union[float, Schedule], weight_decay: float = 1e-4) -> GradientTransformation:
    return chain(
        scale_by_adam(), add_decayed_weights(weight_decay), scale_by_learning_rate(lr)
    )


_CLIENT_OPTS = {
    "sgd": lambda lr, args: sgd(lr, momentum=(getattr(args, "momentum", 0.0) or None)),
    "adam": lambda lr, args: adam(lr),
    "adamw": lambda lr, args: adamw(
        lr, weight_decay=getattr(args, "weight_decay", 0.0)
    ),
}


_SERVER_OPTS = {
    "sgd": lambda lr, args: sgd(lr, momentum=(getattr(args, "server_momentum", 0.0) or None)),
    "adam": lambda lr, args: adam(
        lr, b1=getattr(args, "server_beta1", 0.9), b2=getattr(args, "server_beta2", 0.999)
    ),
    "adagrad": lambda lr, args: chain(scale_by_rss(), scale_by_learning_rate(lr)),
    "yogi": lambda lr, args: chain(scale_by_yogi(), scale_by_learning_rate(lr)),
}


def create_server_optimizer(args) -> GradientTransformation:
    """FedOpt's server optimizer ``args.server_optimizer`` at
    ``args.server_lr`` (default 1.0)."""
    name = str(getattr(args, "server_optimizer", "sgd")).lower()
    if name not in _SERVER_OPTS:
        raise ValueError(f"unknown server_optimizer {name!r}")
    return _SERVER_OPTS[name](float(getattr(args, "server_lr", 1.0)), args)


# -- schedules (optax's formulas) ---------------------------------------
def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        return init_value * 0.5 * (1 + math.cos(math.pi * count / decay_steps))

    schedule.steps = decay_steps  # constant from here on
    return schedule


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int
) -> Schedule:
    """Linear ramp ``init_value -> peak_value`` over ``warmup_steps``,
    then cosine decay to 0 at ``decay_steps``."""
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        return decay(count - warmup_steps)

    schedule.steps = decay_steps  # constant from here on
    return schedule


def _validate_schedule_name(args) -> str:
    name = str(getattr(args, "lr_schedule", "constant") or "constant").lower()
    if name not in ("constant", "cosine"):
        raise ValueError(f"lr_schedule {name!r}: pick 'constant' or 'cosine'")
    return name


def resolve_learning_rate(args) -> Union[float, Schedule]:
    """``args.learning_rate``, or a STEP-indexed cosine schedule over it
    (``lr_total_steps``, optional linear ``warmup_steps`` ramp). Steps
    count within one optimizer lifetime, the distributed trainer's
    meaning; FL uses the round-indexed ``resolve_round_lr_schedule``."""
    base = float(args.learning_rate)
    name = _validate_schedule_name(args)
    if name == "constant":
        return base
    total = int(getattr(args, "lr_total_steps", 0) or 0)
    rounds = int(getattr(args, "lr_total_rounds", 0) or 0)
    if rounds and total:
        raise ValueError(
            "lr_total_steps and lr_total_rounds are both set — ambiguous: "
            "pick step-indexed (distributed trainer) or round-indexed (FL)"
        )
    if rounds:
        raise ValueError(
            "lr_total_rounds is round-indexed but this training path "
            "counts optimizer steps (there are no federation rounds "
            "here); use lr_total_steps"
        )
    if total <= 0:
        raise ValueError("lr_schedule=cosine needs lr_total_steps > 0")
    warm = int(getattr(args, "warmup_steps", 0) or 0)
    if warm >= total:
        raise ValueError(
            f"warmup_steps ({warm}) must be < lr_total_steps ({total})"
        )
    if warm > 0:
        return warmup_cosine_decay_schedule(0.0, base, warm, total)
    return cosine_decay_schedule(base, total)


def resolve_round_lr_schedule(args) -> Optional[Schedule]:
    """ROUND-indexed client LR schedule for FL, or None for constant.

    The client optimizer starts afresh every round, so the FL schedule
    decays across rounds: ``lr_schedule: cosine`` + ``lr_total_rounds: R``
    gives ``round_idx -> lr`` (peak ``args.learning_rate``, optional
    linear ``warmup_rounds`` ramp starting at peak/(warm+1)); the round
    engine holds the LR constant within each local fit."""
    base = float(args.learning_rate)
    name = _validate_schedule_name(args)
    if name == "constant":
        return None
    rounds = int(getattr(args, "lr_total_rounds", 0) or 0)
    steps = int(getattr(args, "lr_total_steps", 0) or 0)
    if rounds and steps:
        raise ValueError(
            "lr_total_steps and lr_total_rounds are both set — ambiguous: "
            "pick step-indexed (distributed trainer) or round-indexed (FL)"
        )
    if not rounds:
        raise ValueError(
            "lr_schedule=cosine in a federated scenario needs "
            "lr_total_rounds: FL re-inits the client optimizer every "
            "round, so a step-indexed schedule (lr_total_steps) would "
            "silently restart each round. Set lr_total_rounds to decay "
            "across the federation, or lr_schedule=constant."
        )
    warm = int(getattr(args, "warmup_rounds", 0) or 0)
    if warm >= rounds:
        raise ValueError(
            f"warmup_rounds ({warm}) must be < lr_total_rounds ({rounds})"
        )
    if warm > 0:
        return warmup_cosine_decay_schedule(base / (warm + 1), base, warm, rounds)
    return cosine_decay_schedule(base, rounds)


def create_client_optimizer(args, lr: Optional[float] = None,
                            schedules: bool = False) -> GradientTransformation:
    """The client optimizer ``args.client_optimizer`` names. ``lr``
    overrides the resolved LR: the FL round engine passes the constant
    peak and scales the updates by its round-indexed multiplier, which
    equals rebuilding the optimizer at ``schedule(round)`` since every
    rule ends in ``scale_by_learning_rate``. A step-indexed schedule
    (``lr_total_steps``) is taken only with ``schedules=True``: the
    distributed trainer's optimizer, one lifetime of steps; the FL
    trainers vmap their step, which a host-read count cannot follow."""
    name = str(getattr(args, "client_optimizer", "sgd")).lower()
    if name not in _CLIENT_OPTS:
        raise ValueError(f"unknown client_optimizer {name!r}")
    wd = float(getattr(args, "weight_decay", 0.0) or 0.0)
    if lr is None:
        lr = resolve_learning_rate(args)
    if callable(lr) and not schedules:
        raise NotImplementedError(
            "a step-indexed lr_schedule (lr_total_steps) belongs to the "
            "distributed trainer (training_type: distributed, run_distributed); "
            "a federated run decays by round (lr_total_rounds)"
        )
    tx = _CLIENT_OPTS[name](lr if callable(lr) else float(lr), args)
    if name == "sgd" and wd > 0.0:
        tx = chain(add_decayed_weights(wd), tx)
    return tx
