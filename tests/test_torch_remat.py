"""Rematerialized transformer blocks (port of ``tests/test_remat.py`` for
``TransformerLM``; the MoE model waits for its slice).

``remat`` must be a pure memory optimization: the same parameter names
(so the JAX package's remat checkpoints carry across), the same outputs,
and under the port's vmapped local step the same gradients, bitwise, with
dense attention and with flash (its plain versions on the CPU). The
flash functions' ``vmap`` rules still fold the cohort: per layer and
step, two forward calls (the forward and its recomputation) and one
backward call for the whole cohort.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.transformer import TransformerLM as JaxTransformerLM
from fedml_tpu_torch import models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.core import optimizers
from fedml_tpu_torch.core.local_trainer import make_local_train_fn
from fedml_tpu_torch.core.types import Batches
from fedml_tpu_torch.models.transformer import Rematerialize
from fedml_tpu_torch.ops import flash_attention as fa
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# f32, the same weights in both packages
F32_ATOL = 1e-5
KW = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32, max_len=16)


def _model(attention="full", remat=False):
    args = Arguments()
    for k, v in dict(model="transformer", dataset="shakespeare", seq_len=16, **KW,
                     attention_impl=attention, remat=remat).items():
        setattr(args, k, v)
    args._validate()
    return models.create(args, KW["vocab_size"], device="cpu")


def _cohort(clients=3, batches=2, bs=4, T=16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    V = KW["vocab_size"]
    return Batches(x=torch.randint(0, V, (clients, batches, bs, T), generator=gen,
                                   dtype=torch.int32),
                   y=torch.randint(0, V, (clients, batches, bs, T), generator=gen),
                   mask=torch.ones(clients, batches, bs))


def test_remat_matches_jax_remat_and_keeps_names():
    """The JAX package's remat model and the port's, from the same flax
    params: the same parameter tree (flax names, no CheckpointBlock
    prefix) and the same logits."""
    tokens = np.random.default_rng(0).integers(0, KW["vocab_size"], (4, 16))
    jm = JaxTransformerLM(remat=True, **KW)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(tokens, jnp.int32))["params"]
    want = np.asarray(jax.jit(jm.apply)({"params": jp}, jnp.asarray(tokens, jnp.int32)))
    plain, remat = _model(), _model(remat=True)
    names = [k.replace(".", "/") for k, _ in remat.module.named_parameters()]
    assert names == [k.replace(".", "/") for k, _ in plain.module.named_parameters()]
    params = params_from_flax(jax.tree.map(np.asarray, jp))
    assert set(params) == set(names)
    x = torch.tensor(tokens, dtype=torch.int32)
    out_r = remat.apply(params, x)
    np.testing.assert_allclose(out_r.detach().numpy(), want, atol=F32_ATOL)
    assert torch.equal(out_r, plain.apply(params, x))


@pytest.mark.parametrize("attention", ["full", "flash"])
def test_vmapped_step_gradients_are_bitwise_those_without_remat(attention):
    """Two local steps of a 3-client cohort through the port's trainer
    (``vmap`` over ``grad_and_value``): params and metrics bitwise equal
    with and without remat."""
    out = {}
    for remat in (False, True):
        model = _model(attention, remat)
        params = model.init(torch.Generator().manual_seed(1))
        step = make_local_train_fn(model.apply, model.loss_fn, optimizers.sgd(0.5), epochs=1,
                                   shuffle=False)
        out[remat] = (params, *step(params, _cohort()))
    start, plain, plain_m = out[False]
    _, remat, remat_m = out[True]
    assert max(float((plain[k][0] - start[k]).abs().max()) for k in start) > 1e-3
    for k in plain:
        assert torch.equal(plain[k], remat[k]), k
    for k in plain_m:
        assert torch.equal(plain_m[k], remat_m[k]), k


def test_flash_calls_per_layer_and_step(monkeypatch):
    """Under remat the cohort's step calls the flash forward twice per
    layer (the forward, then its recomputation in the backward) and the
    backward once, each on the whole cohort folded into its batch."""
    calls = {"fwd": [], "bwd": []}
    real_fwd, real_bwd = fa.flash_forward, fa.flash_backward

    def fwd(q, *a, **kw):
        calls["fwd"].append(q.shape[0])
        return real_fwd(q, *a, **kw)

    def bwd(q, *a, **kw):
        calls["bwd"].append(q.shape[0])
        return real_bwd(q, *a, **kw)

    monkeypatch.setattr(fa, "flash_forward", fwd)
    monkeypatch.setattr(fa, "flash_backward", bwd)
    clients, steps, bs = 3, 2, 4
    for remat, per_step in ((False, 1), (True, 2)):
        calls["fwd"].clear()
        calls["bwd"].clear()
        model = _model("flash", remat)
        params = model.init(torch.Generator().manual_seed(1))
        step = make_local_train_fn(model.apply, model.loss_fn, optimizers.sgd(0.5), epochs=1,
                                   shuffle=False)
        step(params, _cohort(clients, steps, bs))
        layers = KW["num_layers"]
        assert calls["fwd"] == [clients * bs] * (per_step * layers * steps), remat
        assert calls["bwd"] == [clients * bs] * (layers * steps), remat


def test_evaluation_runs_one_forward_per_layer(monkeypatch):
    """Without a gradient (evaluation) remat adds nothing."""
    count = []
    real = fa.flash_forward
    monkeypatch.setattr(fa, "flash_forward", lambda *a, **kw: count.append(1) or real(*a, **kw))
    model = _model("flash", remat=True)
    params = model.init(torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.apply(params, torch.zeros((2, 16), dtype=torch.int32))
    assert len(count) == KW["num_layers"]


def _chain(x, w):
    for _ in range(6):
        x = torch.sin(x * w) * 1.5
    return x


def test_backward_records_nothing_outside_its_recomputation():
    """The recomputation is differentiated by its own ``vjp`` only: under
    an enclosing autograd that records the backward (``create_graph``,
    which ``torch.func.grad`` always uses) the gradients carry no history,
    so no block's recomputed activations outlive its backward."""
    x = torch.randn(64)
    w = torch.randn(64, requires_grad=True)
    out = Rematerialize.apply(lambda x, p: _chain(x, p["w"]), ("w",), x, w)
    (gw,) = torch.autograd.grad(out.sum(), w, create_graph=True)
    assert gw.grad_fn is None and not gw.requires_grad
    (want,) = torch.autograd.grad(_chain(x, w).sum(), w)
    assert torch.equal(gw, want)


_PEAK = textwrap.dedent("""
    import torch
    from fedml_tpu_torch.models.transformer import Rematerialize

    def block(x, p):
        for _ in range(6):
            x = torch.sin(x * p["w"]) * 1.5
        return x

    def step(remat, clients, n):
        def net(w, x):
            for _ in range(4):
                x = Rematerialize.apply(block, ("w",), x, w) if remat else block(x, {"w": w})
            return x.sum()

        w, x = torch.randn(clients, n), torch.randn(clients, n)
        torch.func.vmap(torch.func.grad(net))(w, x)

    def rss():
        # this process's own high-water mark (getrusage's ru_maxrss would
        # also count the image of the process that spawned this one)
        with open("/proc/self/status") as f:
            return next(int(line.split()[1]) for line in f if line.startswith("VmHWM:"))

    step(True, 2, 16)
    step(False, 2, 16)  # both paths warm
    base = rss()
    step(True, 4, 1 << 18)  # 4 clients x 1 MiB a tensor
    with_remat = rss() - base
    step(False, 4, 1 << 18)  # the high-water mark only rises: this is the larger
    print(with_remat, rss() - base)
""")


def test_remat_lowers_peak_memory_under_vmap_grad():
    """Four blocks of six elementwise steps over a 4-client cohort under
    ``vmap(grad)``, in a fresh process: the peak resident memory with
    remat is under half of that without (one block's activations live at
    a time, not four blocks')."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _PEAK], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    with_remat, without = map(int, out.split())
    assert with_remat < 0.5 * without, (with_remat, without)


def test_factory_threads_remat():
    assert _model(remat=True).module.remat is True
    assert _model().module.remat is False
