"""The port's flash attention (``fedml_tpu_torch.ops.flash_attention``)
against the JAX package's Pallas kernel, run in interpret mode on the CPU.

On a CPU tensor the port's wrapper takes the kernel's plain version, so
these tests hold that version, the autograd function around it and the
blockwise backward against the JAX kernel on the same inputs. The CUDA
kernel itself is held against the same plain version on the card by
``chip_smoke.py``; here numpy emulations of its two routes' arithmetic
(f32 inputs as 3xTF32, bf16 inputs as bf16 ``wgmma`` passes with P split
into bf16 hi + lo) are held against the JAX kernel, and the rules the
wrapper applies before a launch are checked. Run as a script, the file
prints the bf16 route's errors against the JAX kernel, with P split and
as one bf16 pass.
"""

from __future__ import annotations

import importlib.util
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops.flash_attention import _bwd, _flash_forward, _fwd
from fedml_tpu.ops.flash_attention import flash_attention as jax_flash
from fedml_tpu.ops.flash_attention import pick_block as jax_pick_block
from fedml_tpu_torch.ops import flash_attention as tfa
from fedml_tpu_torch.parallel.sequence import full_attention
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

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


# -- the CUDA kernel's arithmetic, emulated in numpy -------------------------


def _tf32(x):
    """Round to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as the kernel's ``tf32()`` does (the rounding of
    cvt.rna.tf32.f32)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_matmul(a, b, passes):
    """a @ b on TF32 operands with f32 accumulation: one pass (hi·hi) or
    the kernel's 3xTF32 (lo·hi + hi·lo + hi·hi of x = hi + lo)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)

    def mm(x, y):
        return np.matmul(x, y, dtype=np.float32)

    if passes == 1:
        return mm(a_hi, b_hi)
    return (mm(a_lo, b_hi) + mm(a_hi, b_lo)) + mm(a_hi, b_hi)


def _emulated_kernel(q, k, v, causal, passes):
    """(O, lse) computed as the CUDA kernel computes them: both products
    in TF32 passes, scores in log2 units, unnormalised weights exp2(s - m)
    split again for P·V, O = acc / max(l, 1e-30)."""
    qf, kf, vf = (x.transpose(0, 2, 1, 3) for x in (q, k, v))
    scale_log2 = np.float32(D**-0.5 * np.log2(np.e))
    s = _tf32_matmul(qf, kf.transpose(0, 1, 3, 2), passes) * scale_log2
    if causal:
        s = np.where(np.tril(np.ones((T, T), bool)), s, np.float32(-1e30))
    m = s.max(axis=-1, keepdims=True)
    p = np.exp2(s - m)
    l = np.maximum(p.sum(axis=-1, keepdims=True), np.float32(1e-30))
    o = _tf32_matmul(p, vf, passes) / l
    lse = m[..., 0] * np.float32(np.log(2.0)) + np.log(l[..., 0])
    return o.transpose(0, 2, 1, 3), lse


@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_emulation_matches_jax_kernel(causal):
    """The kernel's 3xTF32 split keeps the JAX kernel's f32 result within
    the file's tolerance; one TF32 pass does not."""
    q, k, v = _qkv(16)
    want_o, want_lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal, None, BLOCK, BLOCK, True)
    want_o, want_lse = np.asarray(want_o), np.asarray(want_lse)
    o, lse = _emulated_kernel(q, k, v, causal, passes=3)
    np.testing.assert_allclose(o, want_o, atol=ATOL)
    np.testing.assert_allclose(lse, want_lse, atol=ATOL)
    one_o, one_lse = _emulated_kernel(q, k, v, causal, passes=1)
    assert np.abs(one_o - want_o).max() > ATOL
    assert np.abs(one_lse - want_lse).max() > ATOL


def _bf16(x):
    """Round to bf16 (8 mantissa bits), to nearest with ties to even, as
    the kernel's ``__floats2bfloat162_rn`` does; returned as f32."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    rounded = bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))
    return (rounded & np.uint32(0xFFFF0000)).view(np.float32)


def _bf16_rna(x):
    """Round to bf16, to nearest with ties away from zero, as the kernel
    rounds P's lo part ((bits + 0x8000) & 0xffff0000); returned as f32."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x8000)) & np.uint32(0xFFFF0000)).view(np.float32)


_BK = 64  # the bf16 kernel's key tile


def _emulated_wgmma_kernel(q, k, v, causal, split=True):
    """(O, lse) computed as the bf16 ``wgmma`` kernel computes them from
    bf16-valued inputs: S one bf16 pass (exact products, f32 sums), the
    online softmax over 64-key tiles in log2 units (masked scores -1e30,
    the running max of the raw scores, P = exp2(s * scale_log2 - m *
    scale_log2)), P V as bf16 hi + lo passes into one f32 accumulator, lo
    first (one bf16 pass when ``split`` is False), O = acc / max(l, 1e-30),
    lse = m * scale_log2 * ln 2 + log(max(l, 1e-30))."""
    qf, kf, vf = (x.transpose(0, 2, 1, 3) for x in (q, k, v))
    scale_log2 = np.float32(D**-0.5 * np.log2(np.e))

    def mm(x, y):
        return np.matmul(x, y, dtype=np.float32)

    neg = np.float32(-1e30)
    m = np.full(qf.shape[:-1] + (1,), neg, np.float32)
    l = np.zeros_like(m)
    acc = np.zeros(qf.shape, np.float32)
    rows = np.arange(T)[:, None]
    for k0 in range(0, T, _BK):
        s = mm(qf, kf[..., k0:k0 + _BK, :].swapaxes(-1, -2))
        if causal:
            s = np.where(k0 + np.arange(s.shape[-1])[None, :] > rows, neg, s)
        mx = np.maximum(m, s.max(axis=-1, keepdims=True))
        corr = np.exp2((m - mx) * scale_log2)
        p = np.exp2(s * scale_log2 - mx * scale_log2)
        l = l * corr + p.sum(axis=-1, keepdims=True, dtype=np.float32)
        vt = vf[..., k0:k0 + _BK, :]
        if split:
            hi = _bf16(p)
            pv = mm(_bf16_rna(p - hi), vt) + mm(hi, vt)
        else:
            pv = mm(_bf16(p), vt)
        acc = acc * corr + pv
        m = mx
    l = np.maximum(l, np.float32(1e-30))
    lse = m[..., 0] * scale_log2 * np.float32(np.log(2.0)) + np.log(l[..., 0])
    return (acc / l).transpose(0, 2, 1, 3), lse


def _bf16_kernel_case(causal, split=True):
    """(emulated (O, lse), the Pallas kernel's in interpret mode) on the
    file's seeded inputs rounded to bf16 values, held as f32."""
    q, k, v = (_bf16(x) for x in _qkv(17))
    want_o, want_lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal, None, BLOCK, BLOCK, True)
    return _emulated_wgmma_kernel(q, k, v, causal, split), (np.asarray(want_o),
                                                            np.asarray(want_lse))


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_wgmma_emulation_matches_jax_kernel(causal):
    """The bf16 kernel's arithmetic (one bf16 pass for S, P as bf16 hi +
    lo) keeps the JAX kernel's f32 result within the file's tolerance."""
    (o, lse), (want_o, want_lse) = _bf16_kernel_case(causal)
    np.testing.assert_allclose(o, want_o, atol=ATOL)
    np.testing.assert_allclose(lse, want_lse, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_one_pass_for_p_exceeds_the_tolerance(causal):
    """P rounded once to bf16 (one pass for P V) moves O past the file's
    tolerance; lse does not depend on it."""
    (o, lse), (want_o, want_lse) = _bf16_kernel_case(causal, split=False)
    assert np.abs(o - want_o).max() > ATOL
    np.testing.assert_allclose(lse, want_lse, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_chip_smoke_bf16_limits_pass_hi_lo_and_fail_one_pass(causal):
    """chip_smoke.py's element-wise limits on the kernel's bf16 O hold the
    emulated hi + lo route and refuse the emulated one-pass route, both
    rounded once to bf16 as the kernel rounds O, on the same inputs."""
    chip_smoke = _chip_smoke()
    q, k, v = (_bf16(x) for x in _qkv(17))
    o32, a32, _ = chip_smoke.plain_bf16_readings(*_torch(q, k, v), causal, D**-0.5)
    readings = {}
    for split in (True, False):
        o, _ = _emulated_wgmma_kernel(q, k, v, causal, split)
        readings[split] = chip_smoke.bf16_o_readings(torch.tensor(o).to(torch.bfloat16),
                                                     o32, a32)
    (excess, mismatch, _), (one_excess, one_mismatch, _) = readings[True], readings[False]
    assert excess <= chip_smoke.BF16_O_EXCESS and mismatch <= chip_smoke.BF16_O_MISMATCH
    assert one_excess > chip_smoke.BF16_O_EXCESS and one_mismatch > chip_smoke.BF16_O_MISMATCH


def test_tf32_rounding_is_to_nearest_ties_away():
    """The kernel's rounding, (bits + 0x1000) & 0xffffe000, is the one
    cvt.rna.tf32.f32 defines: to nearest, ties away from zero."""
    ulp = 2.0**-10  # TF32's spacing in [1, 2)
    x = np.array([1 + ulp / 4, 1 + ulp / 2, 1 + 3 * ulp / 4, -(1 + ulp / 2), 1 + ulp],
                 np.float32)
    np.testing.assert_array_equal(
        _tf32(x), np.array([1, 1 + ulp, 1 + ulp, -(1 + ulp), 1 + ulp], np.float32))
    hi = _tf32(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any()


# -- the bound chip_smoke.py reports for the kernel ---------------------------


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dtype, want_ms", [(torch.float32, 0.833), (torch.bfloat16, 0.139)])
def test_flash_bound_counts_the_route(dtype, want_ms):
    """Main path [8, 4096, 8, 64] causal: 1.37e11 flops, in f32 three
    TF32 passes at 495 TFLOP/s, in bf16 one pass at 989 TFLOP/s."""
    bound_ms, bound_by = _chip_smoke().flash_bound(8, 4096, 8, 64, dtype, True)
    assert bound_by == "operations"
    assert bound_ms == pytest.approx(want_ms, abs=5e-4)


_KERNEL_SOURCES = Path(tfa.__file__).resolve().parent / "csrc"


@pytest.mark.parametrize("source, kind", [("flash_attention_fwd.cu", "flash forward"),
                                          ("flash_attention_bwd.cu", "flash backward")])
def test_every_kernel_of_the_sources_counts_as_its_flash_kind(source, kind):
    """Every ``__global__`` kernel in a flash source lands in its flash
    kind of chip_smoke.py's profile (first match wins; an unmatched name
    would count as elementwise work and fail the profiled round's launch
    gate), under the name the profiler gives it."""
    chip_smoke = _chip_smoke()
    text = (_KERNEL_SOURCES / source).read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                       text)
    assert len(names) == text.count("__global__") >= 2
    for name in names:
        profiled = f"void (anonymous namespace)::{name}<64>(CUtensorMap_st, CUtensorMap_st)"
        assert chip_smoke.kernel_kind(profiled, chip_smoke.TRANSFORMER_KINDS) == kind, name


# -- what the wrapper hands the kernel's TMA loads ----------------------------


def test_kernel_operand_keeps_fused_projection_views():
    qkv = torch.zeros((B, T, 3 * H * D))
    for view in (t.view(B, T, H, D) for t in qkv.split(H * D, dim=-1)):
        x, strides = tfa.kernel_operand(view)
        assert x is view
        assert strides == (T * 3 * H * D, 3 * H * D, D)


def test_kernel_operand_copies_a_misaligned_view():
    flat = torch.arange(B * T * H * D + 1, dtype=torch.float32)
    view = flat[1:].view(B, T, H, D)  # base 4 bytes past an aligned one
    assert view.data_ptr() % 16
    x, strides = tfa.kernel_operand(view)
    assert x.data_ptr() % 16 == 0 and x.is_contiguous()
    assert torch.equal(x, view)
    assert strides == (T * H * D, H * D, D)


def test_kernel_operand_ignores_strides_of_length_one_dims():
    x = torch.zeros((1, T, 1, D)).as_strided((1, T, 1, D), (3, D, 1, 1))
    got, strides = tfa.kernel_operand(x)
    assert got is x
    assert strides == (T * D, D, D)


# -- the shapes the wrapper hands the kernels ---------------------------------


@pytest.mark.parametrize("shape", [
    (4096, 48, 16, 32),  # evaluation's shape: 4,096 sequences x 16 heads
    (65536, 64, 1, 64),
    (1, 128, 70000, 128),
    (2, 64 * 65535, 1, 16),  # the most query tiles the grid's y takes
])
def test_check_shape_takes_any_batch_times_heads(shape):
    """batch x heads is the kernels' grid x (up to 2**31 - 1): the check
    refuses none, on shapes alone, without a card."""
    for dtype in (torch.float32, torch.bfloat16):
        tfa.check_shape(shape, dtype)


@pytest.mark.parametrize("shape, dtype, match", [
    ((2, 64, 4, 48), torch.float32, "head dim 48"),  # the wrapper pads it first
    ((2, 64, 4, 64), torch.float16, "unsupported"),
    # T past grid y's 65535 tiles folds into grid x; this batch x heads
    # folded would need a grid x past 2**31 - 1
    ((2**30, 64 * 65536, 1, 64), torch.bfloat16, "65535 tiles"),
])
def test_check_shape_refuses_what_the_kernels_lack(shape, dtype, match):
    with pytest.raises(ValueError, match=match):
        tfa.check_shape(shape, dtype)


def test_kernel_head_dim_pads_up_to_128():
    want = {1: 16, 16: 16, 24: 32, 32: 32, 48: 64, 64: 64, 80: 128, 96: 128, 128: 128}
    assert {d: tfa.kernel_head_dim(d) for d in want} == want


@pytest.mark.parametrize("D", [129, 160, 256])
def test_head_dim_over_128_raises(D):
    with pytest.raises(ValueError, match="limit of 128"):
        tfa.kernel_head_dim(D)
    q = torch.zeros((1, 16, 1, D))
    with pytest.raises(ValueError, match="limit of 128"):
        tfa.FWD_KERNEL(q, q, q, True, D**-0.5)
    with pytest.raises(ValueError, match="limit of 128"):
        tfa.BWD_KERNEL(q, q, q, q, torch.zeros((1, 1, 16)), q, True, D**-0.5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [24, 48, 80, 96])
def test_zero_padded_head_dim_computes_the_same_function(D, causal):
    """The route the wrappers take for a head dim the kernels lack: pad
    q, k, v (O and dO) with zero columns up to the next kernel dim, run,
    cut back. Through the plain versions it matches the unpadded call."""
    rng = np.random.default_rng(D)
    q, k, v, g = (torch.tensor(rng.normal(size=(B, T, H, D)).astype(np.float32))
                  for _ in range(4))
    scale = D**-0.5
    o, lse = tfa.flash_attention_reference(q, k, v, causal, scale)
    got_o, got_lse = tfa.padded_forward(tfa.flash_attention_reference, q, k, v, causal, scale)
    assert got_o.shape == (B, T, H, D) and got_o.is_contiguous()
    np.testing.assert_allclose(got_o.numpy(), o.numpy(), atol=1e-6)
    np.testing.assert_allclose(got_lse.numpy(), lse.numpy(), atol=1e-6)
    want = tfa.flash_attention_backward_reference(q, k, v, o, lse, g, causal, scale)
    got = tfa.padded_backward(tfa.flash_attention_backward_reference, q, k, v, o, lse, g,
                              causal, scale)
    for x, w in zip(got, want):
        assert x.shape == (B, T, H, D) and x.is_contiguous()
        np.testing.assert_allclose(x.numpy(), w.numpy(), atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [24, 48, 80, 96])
def test_zero_padded_head_dim_matches_jax_kernel_and_bwd(D, causal):
    """The padded route against the reference itself, which takes any D:
    the forward against the Pallas kernel (interpret mode), the backward
    against ``_bwd`` on that kernel's residuals."""
    rng = np.random.default_rng(100 + D)
    q, k, v, g = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(4))
    want_o, res = _fwd(*(jnp.asarray(x) for x in (q, k, v)), causal, None, BLOCK, BLOCK)
    want_lse = res[4]
    want = _bwd(causal, None, BLOCK, BLOCK, res, jnp.asarray(g))
    scale = D**-0.5
    got_o, got_lse = tfa.padded_forward(tfa.flash_attention_reference, *_torch(q, k, v),
                                        causal, scale)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=ATOL)
    got = tfa.padded_backward(tfa.flash_attention_backward_reference,
                              *_torch(*(np.asarray(r) for r in res), g), causal, scale)
    for x, w in zip(got, want):
        assert x.shape == (B, T, H, D)
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=GRAD_ATOL)


if __name__ == "__main__":
    # the max |error| against the Pallas kernel (interpret mode) of the bf16
    # route's arithmetic, with P as bf16 hi + lo (the kernel) and as one
    # bf16 pass
    for causal in (True, False):
        for split in (True, False):
            (o, lse), (want_o, want_lse) = _bf16_kernel_case(causal, split)
            print(f"causal={causal} {'hi + lo' if split else 'one pass'}: max |err| O "
                  f"{float(np.abs(o - want_o).max()):.3g}, lse "
                  f"{float(np.abs(lse - want_lse).max()):.3g} (tolerance {ATOL}; max |O| "
                  f"{float(np.abs(want_o).max()):.3g})")
