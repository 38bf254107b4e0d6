"""The port's flash attention (``fedml_tpu_torch.ops.flash_attention``)
against the JAX package's Pallas kernel, run in interpret mode on the CPU.

On a CPU tensor the port's wrapper takes the kernel's plain version, so
these tests hold that version, the autograd function around it and the
blockwise backward against the JAX kernel on the same inputs. The CUDA
kernel itself is held against the same plain version on the card by
``chip_smoke.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops.flash_attention import _flash_forward
from fedml_tpu.ops.flash_attention import flash_attention as jax_flash
from fedml_tpu.ops.flash_attention import pick_block as jax_pick_block
from fedml_tpu_torch.ops import flash_attention as tfa
from fedml_tpu_torch.parallel.sequence import full_attention

B, T, H, D = 2, 64, 4, 16
BLOCK = 16
# the tolerance the JAX package's own flash-vs-full test uses
# (tests/test_longcontext.py TestFlashAttention.test_matches_full)
ATOL = 2e-5
GRAD_ATOL = 5e-4


def _qkv(seed: int, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, T, H, D)).astype(dtype) for _ in range(3)]


def _torch(*arrays, requires_grad=False):
    return [torch.tensor(a, requires_grad=requires_grad) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
def test_output_and_lse_match_jax_kernel(causal):
    q, k, v = _qkv(10)
    want_o = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal, None, BLOCK, BLOCK)
    _, want_lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal, None, BLOCK, BLOCK, True)
    got_o, got_lse = tfa.flash_forward(*_torch(q, k, v), causal, None, BLOCK, BLOCK)
    assert got_o.shape == (B, T, H, D) and got_lse.shape == (B, H, T)
    assert got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=ATOL)
    # the autograd function returns the same O
    np.testing.assert_allclose(
        tfa.flash_attention(*_torch(q, k, v), causal, None, BLOCK, BLOCK).numpy(),
        np.asarray(want_o), atol=ATOL,
    )


def test_bf16_output_matches_jax_kernel():
    """bf16 in, f32 inside, bf16 out: the two may land one bf16 step
    apart (2**-7 for |O| < 1 ... 2**-6 below 4)."""
    q, k, v = _qkv(11)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jax_flash(jq, jk, jv, True, None, BLOCK, BLOCK)
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (q, k, v))
    got, lse = tfa.flash_forward(tq, tk, tv, True, None, BLOCK, BLOCK)
    assert got.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=2e-2
    )


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax(causal):
    q, k, v = _qkv(12)

    def loss(q, k, v):
        return (jax_flash(q, k, v, causal, None, BLOCK, BLOCK) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _torch(q, k, v, requires_grad=True)
    (tfa.flash_attention(tq, tk, tv, causal, None, BLOCK, BLOCK) ** 2).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=GRAD_ATOL)


def test_blockwise_backward_matches_dense_autograd():
    """The port's hand-written backward against torch autograd through
    dense attention, at a key block smaller than T."""
    q, k, v = _qkv(13)
    a = _torch(q, k, v, requires_grad=True)
    b = _torch(q, k, v, requires_grad=True)
    (tfa.flash_attention(*a, True, None, BLOCK, BLOCK) ** 2).sum().backward()
    (full_attention(*b, causal=True) ** 2).sum().backward()
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), atol=GRAD_ATOL)


def test_rejects_indivisible_blocks():
    q, k, v = _qkv(14)
    with pytest.raises(ValueError, match="divide") as port:
        tfa.flash_attention(*_torch(q, k, v), True, None, 48, 48)
    with pytest.raises(ValueError, match="divide") as ref:
        jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, None, 48, 48)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("minimum", [1, 8, 32])
def test_pick_block_matches_jax(minimum):
    for t in range(1, 600):
        assert tfa.pick_block(t, minimum) == jax_pick_block(t, minimum), t


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never reaches the kernel: no launch is counted, and
    the kernel's own entry refuses a tensor that is not on a card."""
    q, k, v = _torch(*_qkv(15))
    before = tfa.FWD_KERNEL.launches
    o, lse = tfa.flash_forward(q, k, v, True)
    want_o, want_lse = tfa.flash_attention_reference(q, k, v, True)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert tfa.FWD_KERNEL.launches == before
    with pytest.raises(ValueError, match="not CUDA"):
        tfa.FWD_KERNEL(q, k, v, True, D**-0.5)
