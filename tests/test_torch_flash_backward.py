"""The port's flash-attention backward and its ``torch.func`` rules against
the JAX package, on the CPU.

The JAX side runs as its own tests run it: the Pallas forward in
interpret mode and the ``custom_vjp`` backward ``_bwd``. On CPU tensors
the port's functions take their plain versions (the blockwise
``_flash_backward`` and the dense ``flash_attention_backward_reference``);
the CUDA kernel is held against the dense version on the card by
``chip_smoke.py``. Here numpy emulations of the kernels' arithmetic (3xTF32
``wgmma`` passes for f32 inputs, bf16 ``wgmma`` passes with P and dS
split into bf16 hi + lo for bf16 inputs) are held against ``_bwd``, and the ``vmap`` rules are
checked to fold the
vmapped client axis into one call on a strided view, which is what makes
one kernel launch serve a whole cohort on the card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops.flash_attention import _bwd, _fwd
from fedml_tpu.ops.flash_attention import flash_attention as jax_flash
from fedml_tpu_torch.ops import flash_attention as tfa
from test_torch_flash_attention import _bf16, _bf16_rna, _chip_smoke, _tf32
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

C, B, T, H, D = 2, 2, 32, 2, 16
BLOCK = 16
# the JAX package's gradient tolerance (tests/test_longcontext.py
# TestFlashAttention, flash vs dense gradients)
GRAD_ATOL = 5e-4
# bf16 gradients: both packages compute in f32 from bf16 residuals and
# round once to bf16; the forward's O may land one bf16 step apart, which
# moves the cotangent 2*O by as much, so the bound is 2% of the largest
# gradient
BF16_RTOL_OF_MAX = 2e-2


def _normal(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _loss_jax(causal):
    def loss(q, k, v):
        o = jax_flash(q, k, v, causal, None, BLOCK, BLOCK)
        return (o.astype(jnp.float32) ** 2).sum()

    return loss


def _loss_port(causal):
    def loss(q, k, v):
        o = tfa.flash_attention(q, k, v, causal, None, BLOCK, BLOCK)
        return (o.float() ** 2).sum()

    return loss


@pytest.mark.parametrize("causal", [True, False])
def test_vmap_grad_matches_jax_and_a_per_client_loop(causal):
    """The trainer's transform, ``vmap(grad(...))`` over a client axis,
    through the port's autograd function (it raised before the function
    had ``setup_context`` and ``vmap`` rules)."""
    q, k, v = (_normal(s, (C, B, T, H, D)) for s in (1, 2, 3))
    want = jax.vmap(jax.grad(_loss_jax(causal), argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    grad = torch.func.grad(_loss_port(causal), argnums=(0, 1, 2))
    got = torch.func.vmap(grad)(tq, tk, tv)
    loop = [grad(tq[c], tk[c], tv[c]) for c in range(C)]
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), atol=GRAD_ATOL)
        for c in range(C):
            np.testing.assert_allclose(got[i][c].numpy(), loop[c][i].numpy(), atol=1e-6)


def test_vmap_grad_in_bf16_matches_jax():
    q, k, v = (_normal(s, (C, B, T, H, D)) for s in (4, 5, 6))
    want = jax.vmap(jax.grad(_loss_jax(True), argnums=(0, 1, 2)))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    got = torch.func.vmap(torch.func.grad(_loss_port(True), argnums=(0, 1, 2)))(
        *(torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w,
                                   atol=BF16_RTOL_OF_MAX * np.abs(w).max())


def _jax_residuals(q, k, v, g, causal):
    _, res = _fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, BLOCK, BLOCK)
    want = _bwd(causal, None, BLOCK, BLOCK, res, jnp.asarray(g))
    return [np.asarray(r) for r in res], [np.asarray(w) for w in want]


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backwards_match_jax_bwd(causal):
    """The dense reference (the kernel's yardstick on the card) and the
    blockwise CPU path, at a key block below T, on ``_bwd``'s residuals."""
    q, k, v, g = (_normal(s, (B, T, H, D)) for s in (7, 8, 9, 10))
    res, want = _jax_residuals(q, k, v, g, causal)
    args = [torch.tensor(a) for a in res] + [torch.tensor(g)]
    dense = tfa.flash_attention_backward_reference(*args, causal, None)
    blockwise = tfa._flash_backward(*args, causal, None, BLOCK)
    for got in (dense, blockwise):
        for x, w in zip(got, want):
            np.testing.assert_allclose(x.numpy(), w, atol=GRAD_ATOL)


def _tf32_product(a, b, split_a, split_b):
    """a @ b as the f32 kernels' TF32 ``wgmma`` computes it: each operand
    that is not exact in TF32 split into hi = tf32(x) and lo = tf32(x -
    hi), both rounded to nearest (ties away), and three passes into one
    f32 accumulator, lo·hi + hi·lo + hi·hi (3xTF32 when both are split)."""
    a_hi, b_hi = _tf32(a), _tf32(b)

    def mm(x, y):
        return np.matmul(x, y, dtype=np.float32)

    out = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    if split_a:
        out = out + mm(_tf32(a - a_hi), b_hi)
    if split_b:
        out = out + mm(a_hi, _tf32(b - b_hi))
    return out + mm(a_hi, b_hi)


def _bf16_product(a, b, split_a):
    """a @ b as the bf16 kernels' ``wgmma`` computes it: b holds exact
    bf16 values; a is one too (``split_a`` False) or an f32 operand split
    into bf16 hi = bf16(a) (ties to even) and lo = bf16(a - hi) (ties
    away), two passes into one f32 accumulator, lo first."""
    def mm(x, y):
        return np.matmul(x, y, dtype=np.float32)

    if not split_a:
        return mm(_bf16(a), b)
    hi = _bf16(a)
    return mm(_bf16_rna(a - hi), b) + mm(hi, b)


def _emulated_kernel_backward(q, k, v, o, lse, g, causal, exact, split=True):
    """(dQ, dK, dV) computed as the CUDA kernels compute them, in f32.
    f32 inputs (``exact`` False): every product 3xTF32 on ``wgmma``.
    bf16 inputs (``exact``: the arrays hold bf16 values): S and dP one
    bf16 pass each, the products with the f32 P and dS two (bf16 hi +
    lo), or one when ``split`` is False (P and dS rounded to bf16, as
    SDPA keeps them). Both routes take P as exp2(S scale log2 e - lse
    log2 e), form dS without the scale and scale dK and dQ once, after
    the sums."""
    qf, kf, vf, of, gf = (x.transpose(0, 2, 1, 3) for x in (q, k, v, o, g))
    scale = np.float32(D**-0.5)
    log2e = np.float32(np.log2(np.e))
    delta = (gf * of).sum(-1, dtype=np.float32)
    if exact:
        def product(a, b, first):
            return _bf16_product(a, b, split_a=split and not first)
    else:
        def product(a, b, first):
            return _tf32_product(a, b, True, True)
    s = product(qf, kf.swapaxes(-1, -2), True)
    dp = product(gf, vf.swapaxes(-1, -2), True)
    keep = np.tril(np.ones((T, T), bool)) if causal else np.ones((T, T), bool)
    p = np.where(keep, np.exp2(s * (scale * log2e) - lse[..., None] * log2e), np.float32(0))
    ds = p * (dp - delta[..., None])
    dv = product(p.swapaxes(-1, -2), gf, False)
    dk = product(ds.swapaxes(-1, -2), qf, False) * scale
    dq = product(ds, kf, False) * scale
    return [x.transpose(0, 2, 1, 3) for x in (dq, dk, dv)]


def _kernel_arithmetic_case(causal, exact, split=True):
    """(emulated (dQ, dK, dV), ``_bwd``'s) on the file's seeded inputs,
    rounded to bf16 values when ``exact``."""
    arrays = [_normal(s, (B, T, H, D)) for s in (11, 12, 13, 14)]
    if exact:
        arrays = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrays]
    q, k, v, g = arrays
    (rq, rk, rv, ro, lse), want = _jax_residuals(q, k, v, g, causal)
    return _emulated_kernel_backward(rq, rk, rv, ro, lse, g, causal, exact, split), want


@pytest.mark.parametrize("exact", [False, True], ids=["f32", "bf16_values"])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_arithmetic_matches_jax_bwd(causal, exact):
    """The kernels keep ``_bwd``'s f32 result: 3xTF32 for f32 inputs (TF32
    ``wgmma``, the hi/lo split of every operand); for bf16 inputs one bf16
    pass for S and dP and two (bf16 hi + lo) for the products with the f32
    P and dS."""
    got, want = _kernel_arithmetic_case(causal, exact)
    for x, w in zip(got, want):
        np.testing.assert_allclose(x, w, atol=GRAD_ATOL)


def test_bf16_rounding_is_to_nearest_even():
    ulp = 2.0**-7  # bf16's spacing in [1, 2)
    x = np.array([1 + ulp / 4, 1 + ulp / 2, 1 + 3 * ulp / 2, 1 + 3 * ulp / 4, -(1 + ulp / 2)],
                 np.float32)
    np.testing.assert_array_equal(
        _bf16(x), np.array([1, 1, 1 + 2 * ulp, 1 + ulp, -1], np.float32))
    assert not (_bf16(x).view(np.uint32) & 0xFFFF).any()


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_hi_lo_split_is_needed(causal):
    """One bf16 pass for the products with P and dS moves the gradients
    past hi + lo's error by an order of magnitude (PERF.md records both,
    from this file run as a script)."""
    split, want = _kernel_arithmetic_case(causal, True)
    one, _ = _kernel_arithmetic_case(causal, True, split=False)
    err_split = max(np.abs(x - w).max() for x, w in zip(split, want))
    err_one = max(np.abs(x - w).max() for x, w in zip(one, want))
    assert err_one > 10 * err_split


def test_vmap_rules_fold_the_client_axis_into_one_call(monkeypatch):
    """One forward and one backward call for the whole cohort, batch
    C*B, on views of the fused projection (no copy), as the transformer
    block cuts q, k and v."""
    calls = []
    forward, backward = tfa.flash_forward, tfa.flash_backward

    def spy(tag, fn):
        def call(q, *rest):
            calls.append((tag, tuple(q.shape), q.stride()))
            return fn(q, *rest)
        return call

    monkeypatch.setattr(tfa, "flash_forward", spy("forward", forward))
    monkeypatch.setattr(tfa, "flash_backward", spy("backward", backward))
    qkv = torch.tensor(_normal(15, (C, B, T, 3 * H * D)))

    def loss(x):
        q, k, v = (t.view(B, T, H, D) for t in x.split(H * D, dim=-1))
        return (tfa.flash_attention(q, k, v, True, None, BLOCK, BLOCK) ** 2).sum()

    got = torch.func.vmap(torch.func.grad(loss))(qkv)
    fused = (T * 3 * H * D, 3 * H * D, D, 1)
    assert calls == [("forward", (C * B, T, H, D), fused),
                     ("backward", (C * B, T, H, D), fused)]
    want = torch.stack([torch.func.grad(loss)(qkv[c]) for c in range(C)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_vmap_rule_broadcasts_an_unbatched_operand():
    q = torch.tensor(_normal(16, (B, T, H, D)))
    kv = torch.tensor(_normal(17, (C, B, T, H, D)))

    def loss(q, kv):
        return (tfa.flash_attention(q, kv, kv, False, None, BLOCK, BLOCK) ** 2).sum()

    grad = torch.func.grad(loss, argnums=(0, 1))
    got = torch.func.vmap(grad, in_dims=(None, 0))(q, kv)
    for c in range(C):
        want = grad(q, kv[c])
        np.testing.assert_allclose(got[0][c].numpy(), want[0].numpy(), atol=1e-6)
        np.testing.assert_allclose(got[1][c].numpy(), want[1].numpy(), atol=1e-6)


def test_cpu_tensors_take_the_plain_backward():
    """A CPU tensor never reaches the backward kernel: no launch is
    counted, and the kernel's own entry refuses a tensor off the card."""
    q, k, v, g = (torch.tensor(_normal(s, (B, T, H, D))) for s in (18, 19, 20, 21))
    o, lse = tfa.flash_forward(q, k, v, True)
    before = tfa.BWD_KERNEL.launches
    got = tfa.flash_backward(q, k, v, o, lse, g, True, None, BLOCK)
    want = tfa._flash_backward(q, k, v, o, lse, g, True, D**-0.5, BLOCK)
    assert all(torch.equal(x, w) for x, w in zip(got, want))
    assert tfa.BWD_KERNEL.launches == before
    with pytest.raises(ValueError, match="not CUDA"):
        tfa.BWD_KERNEL(q, k, v, o, lse, g, True, D**-0.5)


def test_no_second_derivative():
    q = torch.tensor(_normal(22, (B, T, H, D)))

    def loss(q):
        return (tfa.flash_attention(q, q, q, True, None, BLOCK, BLOCK) ** 2).sum()

    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.func.grad(lambda q: torch.func.grad(loss)(q).sum())(q)


@pytest.mark.parametrize("shape, dtype, want_ms", [
    ((32, 4096, 8, 64), torch.bfloat16, 1.390),  # the training path's
    ((8, 4096, 8, 64), torch.float32, 2.083),
    ((32, 4096, 8, 64), torch.float32, 8.332),  # the f32 training path's
])
def test_backward_bound_counts_five_products(shape, dtype, want_ms):
    """chip_smoke.py's bound for the backward: S, dP, dV, dK and dQ at 2·D
    flops per causal pair, bf16 at 989 TFLOP/s, f32 as three TF32 passes
    at 495; operations bound it at these shapes."""
    bound_ms, bound_by = _chip_smoke().flash_bwd_bound(*shape, dtype, True)
    assert bound_by == "operations"
    assert bound_ms == pytest.approx(want_ms, abs=5e-4)


if __name__ == "__main__":
    # the max |error| against _bwd of the bf16 kernels' arithmetic, with P
    # and dS split into bf16 hi + lo (the kernels) and as one bf16 pass
    for causal in (True, False):
        for split in (True, False):
            got, want = _kernel_arithmetic_case(causal, True, split)
            errs = [float(np.abs(x - w).max()) for x, w in zip(got, want)]
            print(f"causal={causal} {'hi + lo' if split else 'one pass'}: max |err| dQ/dK/dV "
                  f"{' / '.join(f'{e:.3g}' for e in errs)} (tolerance {GRAD_ATOL}; max |grad| "
                  f"{max(float(np.abs(w).max()) for w in want):.3g})")
