"""Sequence parallelism: the port's ring and Ulysses attention against the
JAX package's (``fedml_tpu/parallel/sequence.py``) and the dense oracle.

The port runs in spawned gloo worlds of 2 and 4 ranks (``torch_world.py``),
each rank holding a contiguous shard of the sequence; the JAX package runs
the same strategy under ``shard_map`` on as many of the test process's
CPU devices, on the same seeded numpy q, k, v. Outputs agree to ``ATOL``
(both fold in f32: the differences are summation order); gradients (of
sum(o * g), through the ring shifts' and the all-to-alls' backward) are
held to dense attention's autograd in float64 to ``GRAD_ATOL``. The bf16
ring tracks the f32 oracle to ``BF16_ATOL``: its scores and state are f32
and only O is rounded, once, to bf16 (a bf16 step at |O| < 2 is 2**-7).
The collectives themselves are checked forward and backward against what
their definitions give.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_world
from fedml_tpu.parallel import sequence as jax_sequence
from fedml_tpu_torch.parallel.sequence import full_attention, make_sequence_sharded_attention
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 2e-6
GRAD_ATOL = 1e-5
BF16_ATOL = 2**-7


def _qkvg(B=2, T=32, H=4, D=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(4)]


def _jax_attention(n, strategy, causal, q, k, v, block_k=None):
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    fn = jax_sequence.make_sequence_sharded_attention(mesh, strategy=strategy, causal=causal,
                                                      ring_block_k=block_k)
    return np.asarray(jax.jit(fn)(*(jnp.asarray(x) for x in (q, k, v))))


def _oracle(q, k, v, g, causal):
    """Dense attention and its gradients, float64."""
    qt, kt, vt = (torch.tensor(x, dtype=torch.float64).requires_grad_() for x in (q, k, v))
    o = full_attention(qt, kt, vt, causal=causal)
    grads = torch.autograd.grad(o, (qt, kt, vt), torch.tensor(g, dtype=torch.float64))
    return o.detach().numpy(), [x.numpy() for x in grads]


def _gathered(results, i, key="o"):
    """Case ``i``'s output (or gradients) concatenated over the ranks."""
    if key == "o":
        return np.concatenate([r[i]["o"] for r in results], axis=1)
    return [np.concatenate([r[i]["grads"][j] for r in results], axis=1) for j in range(3)]


CASES_2 = [  # (strategy, causal, block_k, dtype)
    ("ring", True, None, "float32"),
    ("ring", False, None, "float32"),
    ("ring", True, 4, "float32"),
    ("ring", True, 4, "bfloat16"),
    ("ulysses", True, None, "float32"),  # T 32 tiles: the flash path
    ("ulysses", False, None, "float32"),  # not causal: dense attention
]
CASES_4 = [
    ("ring", True, 2, "float32"),
    ("ulysses", True, None, "float32"),
]


@pytest.mark.parametrize("world, cases", [(2, CASES_2), (4, CASES_4)])
def test_ring_and_ulysses_match_jax_and_the_dense_oracle(world, cases, tmp_path):
    q, k, v, g = _qkvg(seed=world)
    payload = {"cases": [dict(q=q, k=k, v=v, g=g, strategy=s, causal=c, block_k=b, dtype=d)
                         for s, c, b, d in cases]}
    results = torch_world.run_world(torch_world.attention, world, payload, tmp_path)
    for i, (strategy, causal, block_k, dtype) in enumerate(cases):
        o = _gathered(results, i)
        want_o, want_grads = _oracle(q, k, v, g, causal)
        if dtype == "bfloat16":
            # the bf16 inputs' oracle: the rounding of q, k, v is the input's
            qb, kb, vb = (torch.tensor(x).bfloat16().float().numpy() for x in (q, k, v))
            np.testing.assert_allclose(o, _oracle(qb, kb, vb, g, causal)[0], atol=BF16_ATOL)
            continue
        np.testing.assert_allclose(o, _jax_attention(world, strategy, causal, q, k, v, block_k),
                                   atol=ATOL, err_msg=f"{strategy} causal={causal}")
        np.testing.assert_allclose(o, want_o, atol=ATOL)
        for got, want in zip(_gathered(results, i, "grads"), want_grads):
            np.testing.assert_allclose(got, want, atol=GRAD_ATOL,
                                       err_msg=f"{strategy} causal={causal} block_k={block_k}")


def test_refusals_match_jax_word_for_word(tmp_path):
    """An indivisible ring block and heads Ulysses cannot split refuse at
    the call, an unknown strategy and a ring block for Ulysses at
    construction, in the JAX package's words."""
    q, k, v, _ = _qkvg(H=3)
    results = torch_world.run_world(torch_world.attention, 2, {"cases": [
        dict(q=q, k=k, v=v, strategy="ring", causal=True, block_k=3),
        dict(q=q, k=k, v=v, strategy="ulysses", causal=True),
    ]}, tmp_path)
    mesh = Mesh(np.array(jax.devices()[:2]), ("sp",))
    for i, (strategy, block_k) in enumerate((("ring", 3), ("ulysses", None))):
        with pytest.raises(ValueError) as want:
            _jax_attention(2, strategy, True, q, k, v, block_k)
        assert results[0][i] == {"error": str(want.value)}
    for kwargs in (dict(strategy="bogus"), dict(strategy="ulysses", ring_block_k=8)):
        with pytest.raises(ValueError) as want:
            jax_sequence.make_sequence_sharded_attention(mesh, **kwargs)
        with pytest.raises(ValueError) as got:
            make_sequence_sharded_attention(None, **kwargs)
        assert str(got.value) == str(want.value)


def test_collectives_forward_and_backward(tmp_path):
    """Each collective on x_r = arange + 100 r (shape [2, n, 3]) and the
    gradient of sum(y * w_r), w_r = arange + r, in a world of 4."""
    n = 4
    results = torch_world.run_world(torch_world.collectives, n, {}, tmp_path)
    xs = [np.arange(2 * n * 3, dtype=np.float64).reshape(2, n, 3) + 100 * r for r in range(n)]

    def w(shape, r):
        return np.arange(np.prod(shape), dtype=np.float64).reshape(shape) + r

    for r, out in enumerate(results):
        y, g = out["copy_to"]
        np.testing.assert_array_equal(y, xs[r])
        np.testing.assert_array_equal(g, sum(w(xs[0].shape, s) for s in range(n)))
        y, g = out["reduce_from"]
        np.testing.assert_array_equal(y, sum(xs))
        np.testing.assert_array_equal(g, w(xs[0].shape, r))
        y, g = out["gather_from"]  # along dim 1: [2, n * n, 3]
        np.testing.assert_array_equal(y, np.concatenate(xs, axis=1))
        np.testing.assert_array_equal(g, w(y.shape, r)[:, r * n:(r + 1) * n])
        y, g = out["all_to_all"]  # dim 1 scattered, dim 0 gathered: [2 n, 1, 3]
        np.testing.assert_array_equal(y, np.concatenate([x[:, r:r + 1] for x in xs], axis=0))
        back = np.zeros_like(xs[r])
        for s in range(n):  # rank s's gradient rows for this rank's chunk s
            back[:, s:s + 1] = w(y.shape, s)[2 * r:2 * r + 2]
        np.testing.assert_array_equal(g, back)
        y, g = out["ring_shift"]
        np.testing.assert_array_equal(y, xs[(r - 1) % n])
        np.testing.assert_array_equal(g, w(xs[0].shape, (r + 1) % n))
