"""Mixed precision (``args.dtype: bfloat16``) through the port's trainer core.

The port of ``tests/test_mixed_precision.py``: bf16 compute inside the
hot loop over f32 master weights, f32 optimizer state and f32 loss
reductions. The reference's oracles, on the same toy (a logistic
regression on separable blobs): the knob resolves and validates; master
params stay f32 and still learn; the bf16 loss tracks the f32 one (and
the JAX package's bf16 loss); evaluation runs in bf16; the one-line
simulation runs end to end under bf16. Then the same contract on a
convolutional network with GroupNorm (the dense slice's model): the
masters and the momentum trace stay f32 after a bf16 fit, the loss
sees f32 logits, and the metric sums are f32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.core import local_trainer as jax_trainer
from fedml_tpu.core.types import Batches as JaxBatches
import fedml_tpu_torch
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.core import optimizers
from fedml_tpu_torch.core.local_trainer import (
    compute_dtype_from_args,
    make_eval_fn,
    make_local_train_fn,
)
from fedml_tpu_torch.core.losses import softmax_cross_entropy
from fedml_tpu_torch.core.types import Batches
from fedml_tpu_torch.models.resnet import ResNet
from fedml_tpu_torch.models.spec import FedModel
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _toy_numpy():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 8, 2)).astype(np.float32)  # [nb, bs, d]
    y = (x.sum(-1) > 0).astype(np.int64)
    return x, y, np.ones((4, 8), np.float32)


def _toy():
    """Tiny logistic regression + separable blob batches, one client."""
    x, y, mask = _toy_numpy()

    def apply_fn(params, xb):
        return xb @ params["w"] + params["b"]

    params = {"w": torch.zeros((2, 2)), "b": torch.zeros((2,))}
    batches = Batches(x=torch.tensor(x)[None], y=torch.tensor(y)[None],
                      mask=torch.tensor(mask)[None])
    return apply_fn, softmax_cross_entropy, params, batches


def _fit(dtype, epochs, lr=0.5):
    apply_fn, loss_fn, params, batches = _toy()
    fn = make_local_train_fn(apply_fn, loss_fn, optimizers.sgd(lr), epochs=epochs,
                             shuffle=False, compute_dtype=dtype)
    p, m = fn(params, batches)
    return {k: v[0] for k, v in p.items()}, {k: float(v[0]) for k, v in m.items()}


class TestComputeDtype:
    def test_resolution_and_validation(self):
        a = Arguments()
        assert compute_dtype_from_args(a) is None
        a.dtype = "bfloat16"
        assert compute_dtype_from_args(a) == torch.bfloat16
        a.dtype = "int8"
        with pytest.raises(ValueError, match="dtype"):
            compute_dtype_from_args(a)
        with pytest.raises(ValueError, match="dtype"):
            a._validate()

    def test_master_params_stay_f32_and_learn(self):
        p, m = _fit(torch.bfloat16, epochs=5)
        assert p["w"].dtype == torch.float32 and p["b"].dtype == torch.float32
        assert float(p["w"].abs().sum()) > 0  # actually trained
        assert m["correct"] / m["count"] > 0.9

    def test_bf16_loss_tracks_f32(self):
        (p32, m32), (p16, m16) = _fit(None, epochs=3), _fit(torch.bfloat16, epochs=3)
        assert abs(m16["loss_sum"] / m16["count"] - m32["loss_sum"] / m32["count"]) < 0.05
        for k in p32:
            np.testing.assert_allclose(p16[k].numpy(), p32[k].numpy(), atol=0.05)

    def test_bf16_loss_tracks_the_jax_package(self):
        """The same toy through the JAX trainer under bf16: both round
        the forward to bf16 over f32 masters, so their losses agree to
        bf16 rounding (the f32-vs-bf16 gap above is 0.05)."""
        x, y, mask = _toy_numpy()

        def apply_fn(params, xb):
            return xb @ params["w"] + params["b"]

        def loss_fn(logits, yb, mb):
            ll = jnp.take_along_axis(jax.nn.log_softmax(logits), yb[..., None], -1)[..., 0]
            count = mb.sum()
            loss = -(ll * mb).sum() / jnp.maximum(count, 1)
            return loss, {"loss": loss, "correct": ((logits.argmax(-1) == yb) * mb).sum(),
                          "count": count}

        fn = jax.jit(jax_trainer.make_local_train_fn(
            apply_fn, loss_fn, optax.sgd(0.5), epochs=3, shuffle=False,
            compute_dtype=jnp.bfloat16))
        params = {"w": jnp.zeros((2, 2), jnp.float32), "b": jnp.zeros((2,), jnp.float32)}
        jp, jm = fn(params, JaxBatches(x=jnp.asarray(x), y=jnp.asarray(y),
                                       mask=jnp.asarray(mask)), jax.random.PRNGKey(0))
        tp, tm = _fit(torch.bfloat16, epochs=3)
        assert abs(tm["loss_sum"] / tm["count"]
                   - float(jm["loss_sum"]) / float(jm["count"])) < 5e-3
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=5e-3)

    def test_eval_fn_bf16(self):
        apply_fn, loss_fn, params, batches = _toy()
        out = make_eval_fn(apply_fn, loss_fn, compute_dtype=torch.bfloat16)(params, batches)
        assert float(out["count"]) == 32
        assert all(v.dtype == torch.float32 for v in out.values())
        assert np.isfinite(float(out["loss_sum"]))


class TestConvNetWithGroupNorm:
    def _setup(self):
        model = FedModel(name="resnet_narrow", module=ResNet((1, 1), (8, 16), 4),
                         example_shape=(8, 8, 3))
        params = model.init(torch.Generator().manual_seed(0))
        g = torch.Generator().manual_seed(1)
        x = torch.randn((2, 3, 6, 8, 8, 3), generator=g)  # [C, nb, bs, 8, 8, 3]
        y = torch.randint(0, 4, (2, 3, 6), generator=g)
        mask = torch.ones((2, 3, 6))
        mask[1, 2] = 0  # one fully masked batch
        return model, params, Batches(x=x, y=y, mask=mask)

    def test_masters_and_optimizer_state_stay_f32(self):
        model, params, batches = self._setup()
        seen = []

        def spy_loss(logits, y, mask):
            seen.append(logits.dtype)
            return softmax_cross_entropy(logits, y, mask)

        opt = optimizers.sgd(0.1, momentum=0.9)
        states = []
        real_update = opt.update

        def update(grads, state, p):
            updates, new_state = real_update(grads, state, p)
            states.append({k: v.dtype for k, v in new_state[0]["trace"].items()})
            assert all(g.dtype == torch.float32 for g in grads.values())
            return updates, new_state

        fn = make_local_train_fn(model.apply, spy_loss, optimizers.GradientTransformation(
            opt.init, update), epochs=2, shuffle=False, compute_dtype=torch.bfloat16)
        p, m = fn(params, batches)
        assert all(v.dtype == torch.float32 for v in p.values())
        assert set(seen) == {torch.float32}  # logits reach the loss in f32
        assert states and all(d == torch.float32 for s in states for d in s.values())
        assert all(v.dtype == torch.float32 for v in m.values())
        assert float(m["count"].sum()) == 2 * 3 * 6 - 6
        moved = max(float((p[k] - params[k]).abs().max()) for k in params)
        assert moved > 1e-3

    def test_bf16_fit_tracks_f32(self):
        model, params, batches = self._setup()
        out = {}
        for dt in (None, torch.bfloat16):
            fn = make_local_train_fn(model.apply, model.loss_fn, optimizers.sgd(0.05),
                                     epochs=1, shuffle=False, compute_dtype=dt)
            out[dt] = fn(params, batches)
        (p32, m32), (p16, m16) = out[None], out[torch.bfloat16]
        loss32 = float(m32["loss_sum"].sum() / m32["count"].sum())
        loss16 = float(m16["loss_sum"].sum() / m16["count"].sum())
        assert abs(loss16 - loss32) < 0.05 * abs(loss32)
        for k in params:
            np.testing.assert_allclose(p16[k].numpy(), p32[k].numpy(), atol=0.02, err_msg=k)


class TestEndToEnd:
    def test_simulation_runs_under_bf16(self):
        args = Arguments()
        for k, v in dict(dataset="mnist", synthetic_train_size=400, synthetic_test_size=80,
                         model="lr", partition_method="homo", client_num_in_total=4,
                         client_num_per_round=4, comm_round=3, epochs=1, batch_size=16,
                         learning_rate=0.1, frequency_of_the_test=1, dtype="bfloat16",
                         log_metrics=False).items():
            setattr(args, k, v)
        args._validate()
        stats = fedml_tpu_torch.run_simulation(device="cpu", args=args)
        assert stats["train_acc"] > 0.8  # separable synthetic converges
