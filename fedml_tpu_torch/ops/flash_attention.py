"""Flash attention, [B, T, H, D] layout: a hand-written Hopper kernel.

The port of ``fedml_tpu/ops/flash_attention.py``. The forward is the CUDA
C++ kernel in ``csrc/flash_attention_fwd.cu``, which replaces the Pallas
TPU kernel ``_flash_kernel`` (``fedml_tpu/ops/flash_attention.py:32``).
Causal attention at the serving shapes is bound by operations on an H100.
Both products run on the tensor cores: f32 inputs as 3xTF32 (each f32
product is three TF32 products of a hi/lo split, so the bound is three
passes at the 495 TFLOP/s TF32 peak and the result keeps f32's
accuracy), bf16 inputs with their exact TF32 values; K/V tiles arrive
by TMA through a ring of shared-memory stages. The source describes the
design.

Dispatch follows the tensor's device and nothing else: a CPU tensor takes
the plain version, ``flash_attention_reference``; a CUDA tensor launches
the kernel or raises. Every launch adds one to ``FWD_KERNEL.launches``.

The backward is the port of the JAX package's ``_bwd``, which is plain
array code there too: a blockwise FlashAttention-2 recompute over key
blocks that rebuilds one [T, bk] score panel at a time from the saved
log-sum-exp, never the dense [T, T] matrix.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from . import _build

__all__ = [
    "FWD_KERNEL",
    "flash_attention",
    "flash_attention_reference",
    "flash_forward",
    "kernel_operand",
    "pick_block",
]

_NEG_INF = -1e30

# torch dtype -> the kernel's dtype code
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
# TMA reads from a 16-byte-aligned base with 16-byte multiples as strides
_TMA_ALIGN = 16


def kernel_operand(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """``x`` [B, T, H, D] as the kernel's TMA loads read it, with its
    (batch, time, head) element strides.

    TMA needs a 16-byte-aligned base address and a 16-byte multiple for
    every stride it steps over. The q/k/v views of a fused projection
    meet that as they are; a view that does not is copied to a
    contiguous tensor. A dimension of size 1 is never stepped over, so
    its stride is given as the contiguous one."""
    size = x.element_size()
    steps = [x.stride(i) for i in range(3) if x.shape[i] > 1]
    if x.data_ptr() % _TMA_ALIGN or any(s * size % _TMA_ALIGN for s in steps):
        x = x.clone(memory_format=torch.contiguous_format)
    _, T, H, D = x.shape
    dense = (T * H * D, H * D, D)
    return x, tuple(x.stride(i) if x.shape[i] > 1 else dense[i] for i in range(3))


class FlashForwardKernel:
    """ctypes binding of ``flash_attention_fwd`` plus its launch count.

    ``launches`` rises by one each time the kernel is launched, and
    nowhere else; callers reset it with ``reset_launches``."""

    name = "flash_attention_fwd"

    def __init__(self) -> None:
        self.launches = 0
        self._lock = threading.Lock()
        self._fn = None
        self._err = None

    def reset_launches(self) -> None:
        with self._lock:
            self.launches = 0

    def _bind(self):
        if self._fn is None:
            lib = _build.load(self.name)
            fn = lib.flash_attention_fwd
            fn.argtypes = (
                [ctypes.c_void_p] * 5
                + [ctypes.c_int] * 5
                + [ctypes.c_longlong] * 9
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
            err = lib.flash_attention_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def __call__(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        causal: bool,
        scale: float,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Launch on CUDA tensors; returns (O in q's dtype, lse f32 [B,H,T])."""
        B, T, H, D = q.shape
        for name, x in (("q", q), ("k", k), ("v", v)):
            if not x.is_cuda:
                raise ValueError(f"flash kernel: {name} is on {x.device}, not CUDA")
            if x.dtype != q.dtype or x.shape != q.shape or x.device != q.device:
                raise ValueError(
                    f"flash kernel: {name} is {x.dtype} {tuple(x.shape)} on "
                    f"{x.device}; q is {q.dtype} {tuple(q.shape)} on {q.device}"
                )
            if x.stride(-1) != 1:
                raise ValueError(f"flash kernel: {name}'s last dim is not unit-stride")
        if q.dtype not in _DTYPE_CODES:
            raise ValueError(
                f"flash kernel: dtype {q.dtype} unsupported (float32 or bfloat16)"
            )
        if D not in _HEAD_DIMS:
            raise ValueError(f"flash kernel: head dim {D} not in {_HEAD_DIMS}")
        if B * H > 65535:
            raise ValueError(f"flash kernel: batch*heads {B * H} exceeds 65535")
        fn = self._bind()
        (q, qs), (k, ks), (v, vs) = (kernel_operand(x) for x in (q, k, v))
        o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                _DTYPE_CODES[q.dtype], B, T, H, D, *qs, *ks, *vs,
                float(scale), int(bool(causal)), stream,
            )
        if rc != 0:
            raise RuntimeError(
                f"flash_attention_fwd launch failed: CUDA error {rc} "
                f"({self._err(rc).decode()})"
            )
        with self._lock:
            self.launches += 1
        return o, lse


FWD_KERNEL = FlashForwardKernel()


def pick_block(t: int, minimum: int = 8) -> Optional[int]:
    """Largest power-of-two block <= 128 that divides ``t`` — the one
    block-size policy every flash call site uses. Returns None when the
    only dividing blocks are smaller than ``minimum`` (callers fall
    back to dense attention rather than running degenerate tiles)."""
    for b in (128, 64, 32, 16, 8, 4, 2, 1):
        if t % b == 0:
            return b if b >= minimum else None
    return None


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: dense scores in f32, masked
    with -1e30. Returns (O in q's dtype, lse f32 [B, H, T])."""
    T = q.shape[1]
    scale = scale or (q.shape[-1] ** -0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v.float())
    return o.to(q.dtype), lse


def _check_blocks(T: int, block_q: int, block_k: int) -> Tuple[int, int]:
    bq, bk = min(block_q, T), min(block_k, T)
    if T % bq or T % bk:
        raise ValueError(f"seq len {T} must divide block sizes ({bq}, {bk})")
    return bq, bk


def flash_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, lse) — the counterpart of the JAX ``_flash_forward``.

    ``block_q``/``block_k`` keep their meaning for the caller (T must
    divide into them, else ``ValueError``); the CUDA kernel picks its
    own tiles."""
    _check_blocks(q.shape[1], block_q, block_k)
    scale = scale or (q.shape[-1] ** -0.5)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    if q.device.type == "cuda":
        return FWD_KERNEL(q, k, v, causal, scale)
    raise ValueError(f"flash attention: no path for device {q.device}")


def _flash_backward(q, k, v, o, lse, g, causal, scale, block_k):
    """Blockwise backward (FlashAttention-2 recompute): a loop over key
    blocks rebuilding [T, bk] score panels from the saved log-sum-exp —
    peak memory O(B·H·T·bk), never the dense [T, T] matrix."""
    B, T, H, D = q.shape
    sc = scale or (D**-0.5)
    bk = min(block_k, T)
    qf, kf, vf, of, gf = (x.float() for x in (q, k, v, o, g))
    d_sum = (gf * of).sum(-1).transpose(1, 2)  # D_i = do_i · o_i  [B,H,T]
    q_pos = torch.arange(T, device=q.device)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for j in range(T // bk):
        ks = kf[:, j * bk:(j + 1) * bk]  # [B,bk,H,D]
        vs = vf[:, j * bk:(j + 1) * bk]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, ks) * sc  # [B,H,T,bk]
        if causal:
            k_pos = j * bk + torch.arange(bk, device=q.device)
            s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), _NEG_INF)
        p = torch.exp(s - lse[..., None])
        dp = torch.einsum("bqhd,bkhd->bhqk", gf, vs)
        ds = p * (dp - d_sum[..., None]) * sc
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, ks)
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qf))
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, gf))
    return (
        dq.to(q.dtype),
        torch.cat(dks, dim=1).to(k.dtype),
        torch.cat(dvs, dim=1).to(v.dtype),
    )


class FlashAttention(torch.autograd.Function):
    """Flash attention with the blockwise recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k):
        o, lse = flash_forward(q, k, v, causal, scale, block_q, block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.block_k = causal, scale, block_k
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(
            q, k, v, o, lse, g, ctx.causal, ctx.scale, ctx.block_k
        )
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Flash attention, [B, T, H, D] layout. Differentiable."""
    return FlashAttention.apply(q, k, v, causal, scale, block_q, block_k)
