"""One client's local training: the port against the JAX package.

The same client data (a fully masked tail batch included), the same
initial params and ``shuffle=False`` go through both packages'
``make_local_train_fn`` for 2 epochs. The masked batch is skipped in
both, params *and* optimizer state, so the second epoch starts from the
same momentum trace. The port's optimizers are functional rewrites of
optax's rules; its shuffle draws from PyTorch's stream, so it is tested
for its properties rather than against ``jax.random.permutation``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu import models as jax_models
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.core import optimizers as jax_optimizers
from fedml_tpu.core.local_trainer import (
    compute_dtype_from_args as jax_compute_dtype,
    make_local_train_fn as jax_make_local_train_fn,
)
from fedml_tpu.core.types import Batches as JaxBatches
from fedml_tpu_torch import models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.core import optimizers
from fedml_tpu_torch.core.local_trainer import (
    _shuffle_batches,
    compute_dtype_from_args,
    make_eval_fn,
    make_local_train_fn,
)
from fedml_tpu_torch.core.types import Batches
from fedml_tpu_torch.data.packing import pack_clients
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# f32: params after 12 steps from the same start, differing by
# summation order only
ATOL = 1e-5
# Adam divides each moment by its root mean square, so where a gradient
# element cancels to ~eps (1e-8) the f32 rounding of the two packages'
# sums is amplified into a step of up to lr: in f32 a handful of the
# CNN's 428,350 elements land ~1.5e-5 apart after 12 steps. The adam and
# adamw cases therefore run in float64 on both sides, which compares the
# rules (moments, bias correction, masked-batch revert of the count)
# rather than the rounding, at the same 1e-5.
FLOAT64_CASES = ("adam", "adamw")
# bf16 compute over f32 master params: each package rounds activations
# and gradients to bf16 in its own order (tests/test_mixed_precision.py)
BF16_ATOL = 0.05

N, BS, NB = 70, 16, 6  # 5 batches with data (the 5th partly), 1 fully masked

CASES = {
    "sgd_momentum_wd": dict(momentum=0.9, weight_decay=1e-3),
    "fedprox": dict(momentum=0.9, prox_mu=0.5),
    "lr_mult": dict(momentum=0.9, weight_decay=1e-3, lr_mult=0.5),
    "adam": dict(client_optimizer="adam", learning_rate=1e-3),
    "adamw": dict(client_optimizer="adamw", learning_rate=1e-3, weight_decay=1e-2),
    "plain_sgd": dict(),
}


def _args(cls, **kw):
    a = cls()
    for k, v in {"model": "cnn", "dataset": "femnist", "learning_rate": 0.05, **kw}.items():
        setattr(a, k, v)
    return a


def _client(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 62, size=N).astype(np.int64)
    packed, _ = pack_clients([x], [y], BS, num_batches=NB, device="cpu")
    return packed  # leaves [1, NB, BS, ...]


def _run_both(case, dtype="float32"):
    if case in FLOAT64_CASES:
        with jax.enable_x64(True):
            return _run_both_at(case, dtype, torch.float64)
    return _run_both_at(case, dtype, torch.float32)


def _run_both_at(case, dtype, float_dtype):
    kw = dict(CASES[case])
    prox_mu = kw.pop("prox_mu", 0.0)
    lr_mult = kw.pop("lr_mult", None)
    jargs, targs = _args(JaxArguments, dtype=dtype, **kw), _args(Arguments, dtype=dtype, **kw)
    jm = jax_models.create(jargs, 62)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    np_dtype = np.float64 if float_dtype == torch.float64 else np.float32
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np_dtype)), jp)
    tm = models.create(targs, 62, device="cpu")
    tp = params_from_flax(jax.tree.map(np.asarray, jp))
    packed = _client()
    packed = Batches(x=packed.x.to(float_dtype), y=packed.y, mask=packed.mask.to(float_dtype))

    jfn = jax_make_local_train_fn(
        jm.apply, jm.loss_fn, jax_optimizers.create_client_optimizer(jargs),
        epochs=2, prox_mu=prox_mu, shuffle=False, compute_dtype=jax_compute_dtype(jargs),
    )
    jb = JaxBatches(x=jnp.asarray(packed.x[0].numpy()), y=jnp.asarray(packed.y[0].numpy()),
                    mask=jnp.asarray(packed.mask[0].numpy()))
    extra = () if lr_mult is None else (jnp.float32(lr_mult),)
    jout, jmetrics = jax.jit(jfn)(jp, jb, jax.random.PRNGKey(0), *extra)

    tfn = make_local_train_fn(
        tm.apply, tm.loss_fn, optimizers.create_client_optimizer(targs),
        epochs=2, prox_mu=prox_mu, shuffle=False, compute_dtype=compute_dtype_from_args(targs),
    )
    tout, tmetrics = tfn(tp, packed, None, lr_mult)
    want = params_from_flax(jax.tree.map(np.asarray, jout))
    return tp, want, tout, jmetrics, tmetrics


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_client_matches_jax(case):
    start, want, got, jmetrics, tmetrics = _run_both(case)
    moved = max(float((got[k][0] - start[k]).abs().max()) for k in want)
    assert moved > 1e-3  # the client really trained
    for k in want:
        assert tuple(got[k].shape) == (1,) + tuple(want[k].shape)
        assert got[k].dtype == want[k].dtype
        np.testing.assert_allclose(got[k][0].numpy(), want[k].numpy(), atol=ATOL, err_msg=k)
    # the last epoch's sums: 70 real examples, the masked batch adds none
    assert float(tmetrics["count"][0]) == float(jmetrics["count"]) == N
    for k in ("loss_sum", "correct"):
        np.testing.assert_allclose(float(tmetrics[k][0]), float(jmetrics[k]), atol=1e-4,
                                   err_msg=k)
        assert tmetrics[k].dtype == torch.float32


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
@pytest.mark.parametrize("float_dtype", [np.float32, np.float64])
def test_update_rules_match_optax_on_the_same_gradients(name, float_dtype):
    """Three steps of each rule from the same params and gradients (a
    zero-gradient element included) against optax, in f32 and in f64
    (where optax computes Adam's bias corrections in f64 too)."""
    with jax.enable_x64(float_dtype == np.float64):
        _rules_against_optax(name, float_dtype)


def _rules_against_optax(name, float_dtype):
    import optax

    rng = np.random.default_rng(5)
    params = {"w": rng.normal(size=(4, 3)).astype(float_dtype), "b": np.zeros(3, float_dtype)}
    grads = [{k: rng.normal(scale=1e-3, size=v.shape).astype(float_dtype)
              for k, v in params.items()} for _ in range(3)]
    grads[1]["w"][0, 0] = 0.0
    jtx = {"adam": optax.adam(1e-3), "adamw": optax.adamw(1e-3, weight_decay=0.1),
           "sgd": optax.chain(optax.add_decayed_weights(0.01), optax.sgd(0.1, momentum=0.9))}[name]
    ttx = {"adam": optimizers.adam(1e-3), "adamw": optimizers.adamw(1e-3, weight_decay=0.1),
           "sgd": optimizers.chain(optimizers.add_decayed_weights(0.01),
                                   optimizers.sgd(0.1, momentum=0.9))}[name]
    jp, js = {k: jnp.asarray(v) for k, v in params.items()}, None
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in grads:
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update({k: torch.as_tensor(v) for k, v in g.items()}, ts, tp)
        tp = {k: tp[k] + tu[k] for k in tp}
    rtol = 1e-6 if float_dtype == np.float32 else 1e-12
    for k in params:
        assert tp[k].numpy().dtype == np.asarray(jp[k]).dtype == float_dtype
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=rtol, atol=1e-9 * rtol)


def test_one_client_bf16_matches_jax():
    start, want, got, jmetrics, tmetrics = _run_both("sgd_momentum_wd", dtype="bfloat16")
    for k in want:
        assert got[k].dtype == torch.float32  # f32 master params
        np.testing.assert_allclose(got[k][0].numpy(), want[k].numpy(), atol=BF16_ATOL, err_msg=k)
    assert float(tmetrics["count"][0]) == N and tmetrics["loss_sum"].dtype == torch.float32


def test_fully_masked_client_keeps_its_params():
    tm = models.create(_args(Arguments), 62, device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    packed = _client()
    empty = Batches(x=packed.x, y=packed.y, mask=torch.zeros_like(packed.mask))
    fn = make_local_train_fn(tm.apply, tm.loss_fn, optimizers.adam(1e-2), epochs=2,
                             shuffle=False)
    out, metrics = fn(params, empty)
    for k in params:
        assert torch.equal(out[k][0], params[k])
    assert float(metrics["count"][0]) == 0.0


def test_round_lr_schedules_match_optax():
    for kw in (dict(lr_total_rounds=10), dict(lr_total_rounds=10, warmup_rounds=3)):
        jargs = _args(JaxArguments, lr_schedule="cosine", **kw)
        targs = _args(Arguments, lr_schedule="cosine", **kw)
        js = jax_optimizers.resolve_round_lr_schedule(jargs)
        ts = optimizers.resolve_round_lr_schedule(targs)
        for r in range(12):
            np.testing.assert_allclose(ts(r), float(js(r)), rtol=1e-6, err_msg=f"{kw} r{r}")
    step = dict(lr_schedule="cosine", lr_total_steps=20, warmup_steps=5)
    js = jax_optimizers.resolve_learning_rate(_args(JaxArguments, **step))
    ts = optimizers.resolve_learning_rate(_args(Arguments, **step))
    for s in range(22):
        np.testing.assert_allclose(ts(s), float(js(s)), rtol=1e-6, atol=1e-9)
    assert optimizers.resolve_round_lr_schedule(_args(Arguments)) is None


@pytest.mark.parametrize("kw", [
    dict(lr_schedule="cosine"),
    dict(lr_schedule="cosine", lr_total_rounds=5, lr_total_steps=5),
    dict(lr_schedule="cosine", lr_total_rounds=5, warmup_rounds=5),
    dict(lr_schedule="linear"),
])
def test_round_lr_schedule_errors_match_jax(kw):
    for mod, cls in ((jax_optimizers, JaxArguments), (optimizers, Arguments)):
        with pytest.raises(ValueError):
            mod.resolve_round_lr_schedule(_args(cls, **kw))


def test_unknown_client_optimizer_and_dtype_raise():
    with pytest.raises(ValueError, match="unknown client_optimizer"):
        optimizers.create_client_optimizer(_args(Arguments, client_optimizer="lion"))
    with pytest.raises(ValueError, match="float16"):
        compute_dtype_from_args(_args(Arguments, dtype="float16"))


# -- the shuffle's properties ------------------------------------------
def _ragged_cohort():
    sizes = (70, 16, 5, 33)
    xs = [np.arange(n, dtype=np.float32).reshape(n, 1) + 1000 * c for c, n in enumerate(sizes)]
    ys = [np.full(n, c, np.int64) for c, n in enumerate(sizes)]
    packed, _ = pack_clients(xs, ys, BS, num_batches=NB, device="cpu")
    return sizes, packed


def test_shuffle_permutes_the_real_examples_and_keeps_padding_at_the_tail():
    sizes, packed = _ragged_cohort()
    u = torch.rand((len(sizes), NB * BS), generator=torch.Generator().manual_seed(0))
    out = _shuffle_batches(packed, u)
    assert tuple(out.x.shape) == tuple(packed.x.shape)
    for c, n in enumerate(sizes):
        flat_mask = out.mask[c].reshape(-1)
        # real examples first, then the padding
        assert torch.equal(flat_mask, (torch.arange(NB * BS) < n).to(flat_mask.dtype))
        got = out.x[c].reshape(-1)[:n]
        assert sorted(got.tolist()) == sorted(packed.x[c].reshape(-1)[:n].tolist())
        assert torch.equal(out.y[c].reshape(-1)[:n], torch.full((n,), c))
        # ceil(n / bs) non-empty steps per epoch
        assert int((out.mask[c].sum(-1) > 0).sum()) == -(-n // BS)
    # a random order, and another draw gives another
    assert not torch.equal(out.x[0].reshape(-1)[:70], packed.x[0].reshape(-1)[:70])
    u2 = torch.rand((len(sizes), NB * BS), generator=torch.Generator().manual_seed(1))
    assert not torch.equal(_shuffle_batches(packed, u2).x[0], out.x[0])


def test_shuffled_training_needs_its_draws_and_uses_them():
    tm = models.create(_args(Arguments, model="lr", dataset="mnist"), 10, device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=(40, 28, 28, 1)).astype(np.float32) for _ in range(2)]
    ys = [rng.integers(0, 10, size=40) for _ in range(2)]
    packed, _ = pack_clients(xs, ys, 8, device="cpu")
    fn = make_local_train_fn(tm.apply, tm.loss_fn, optimizers.sgd(0.1), epochs=2)
    with pytest.raises(ValueError, match="rng"):
        fn(params, packed)
    gen = torch.Generator().manual_seed(0)
    u = torch.rand((2, 2, 40), generator=gen)
    a, _ = fn(params, packed, u)
    b, _ = fn(params, packed, u.clone())
    c, _ = fn(params, packed, torch.rand((2, 2, 40), generator=gen))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_eval_sums_match_the_masked_examples():
    tm = models.create(_args(Arguments, model="lr", dataset="mnist"), 10, device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    sizes, packed = _ragged_cohort()
    x = torch.randn(tuple(packed.mask.shape) + (28, 28, 1), generator=torch.Generator().manual_seed(3))
    b = Batches(x=x, y=packed.y, mask=packed.mask)
    sums = make_eval_fn(tm.apply, tm.loss_fn)(params, b)
    real = packed.mask.reshape(-1) > 0
    logits = tm.apply(params, x.reshape(-1, 28, 28, 1)[real]).detach()
    labels = packed.y.reshape(-1)[real]
    nll = torch.nn.functional.cross_entropy(logits, labels, reduction="sum")
    assert float(sums["count"]) == sum(sizes)
    np.testing.assert_allclose(float(sums["loss_sum"]), float(nll), rtol=1e-5)
    assert float(sums["correct"]) == float((logits.argmax(-1) == labels).sum())
