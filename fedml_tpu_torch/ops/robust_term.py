"""K3, the robust aggregation term: a hand-written Hopper kernel and its plain version.

The JAX package clips each client's delta against the global model
(``RobustAggregator.clip_updates``, ``fedml_tpu/core/aggregation.py:709-720``)
and makes each streamed upload's weighted term, decoded and clipped
(``_weighted_term_encoded`` ... ``_weighted_delta_term_decoded_clipped``,
``:281-406``). XLA generated that code on the TPU; here it is
``csrc/robust_term.cu``, CUDA C++ for ``sm_90a``: one kernel for every
variant, over the flat layout of a model's leaves (``core/aggregation.py``
``_FlatSpec``), one row an upload::

    out[r] = w_r * (base + src_r * s_r)

- ``src_r``: an f32 delta (the clip's ``theta_r - g``, which the caller
  lays out once, for its norm and for this term), or an int8 payload
  ``q_r`` times its leaf's f32 scale (``leaf_scales [R, L]`` and
  the leaves' spans ``leaf_offsets [L + 1]``, so one launch covers every
  leaf);
- ``base``: ``g`` (``add_g``) or nothing;
- ``s_r``: the clip scale ``min(1, bound / max(||delta_r||, 1e-12))``
  (``s [R]``) or nothing; the caller computes it with one torch reduction
  on the tensor's device, so the kernel and the plain version share it;
- ``w_r``: the upload's weight (``w [R]``) or nothing.

Every step is rounded on its own (``__fmul_rn``, ``__fadd_rn``, which
nvcc never contracts into an FMA), in the order of the plain version's
eager ops: ``d`` (or ``q * scale``); ``d * s``; ``g + .``; ``w * .``. So on the card the kernel is bitwise its
plain version, and a term stays a pure function of its upload, which the
add-only exact fold (``ops/exact_fold.py``) rests on. The JAX package may
contract ``g + d * s`` into an FMA where the port does not: the two agree
to an ulp, not bitwise.

The kernel is bound by bytes: each row reads its source (4 B an element,
1 B for int8) and writes 4 B; ``g`` counts once.

The kernel reads every row 16 bytes at a time, so its operands' rows
start on 16-byte boundaries: the port's own producers lay them out so
(``aligned_rows``, or one fresh row), and the wrapper copies an operand
that is not into such a layout first.

Dispatch follows the tensor's device and nothing else: a CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
Each launch adds one to ``TERM_KERNEL.launches``. A fake tensor (the
audit's trace, ``analysis/compiled.py``) launches nothing: the wrapper
records the call's work by the bound's formulas and returns a term of
the kernel's shape.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["TERM_KERNEL", "robust_term", "robust_term_reference"]

# the C entry's source kinds
_F32, _INT8 = 1, 2


def _leaf_sizes(leaf_offsets: torch.Tensor):
    return (leaf_offsets[1:] - leaf_offsets[:-1]).to(torch.int64)


def _check(src, g, add_g, leaf_scales, leaf_offsets, s, w) -> None:
    """The operands' shapes and types, the same rule for both versions."""
    if src.dim() != 2:
        raise ValueError(f"robust_term: src {tuple(src.shape)}; want [R, N]")
    R, N = src.shape
    if src.dtype == torch.int8:
        if leaf_scales is None or leaf_offsets is None:
            raise ValueError("robust_term: an int8 source needs leaf_scales and leaf_offsets")
        L = leaf_offsets.numel() - 1
        # the spans' values are read only off the card (no sync for them)
        spans_bad = not leaf_offsets.is_cuda and L >= 1 and (
            int(leaf_offsets[0]) != 0 or int(leaf_offsets[-1]) != N)
        if (leaf_scales.dtype != torch.float32 or tuple(leaf_scales.shape) != (R, L)
                or leaf_offsets.dtype != torch.int64 or L < 1 or spans_bad):
            raise ValueError(
                f"robust_term: leaf_scales {leaf_scales.dtype} {tuple(leaf_scales.shape)}, "
                f"leaf_offsets {leaf_offsets.dtype} {tuple(leaf_offsets.shape)}; want "
                f"float32 [{R}, L] and int64 [L + 1] from 0 to {N}")
    elif src.dtype not in (torch.float32, torch.float64) or (src.is_cuda
                                                             and src.dtype != torch.float32):
        raise ValueError(f"robust_term: src is {src.dtype}; want float32 or int8 (float64 "
                         "off the card)")
    real = torch.float32 if src.dtype == torch.int8 else src.dtype
    if add_g and (g is None or g.dtype != real or tuple(g.shape) != (N,)):
        raise ValueError(f"robust_term: g must be {real} [{N}] with add_g")
    for key, t in (("s", s), ("w", w)):
        if t is not None and (t.dtype != real or tuple(t.shape) != (R,)):
            raise ValueError(f"robust_term: {key} {t.dtype} {tuple(t.shape)}; want {real} [{R}]")


def robust_term_reference(src: torch.Tensor, g: Optional[torch.Tensor] = None, *,
                          add_g: bool = False,
                          leaf_scales: Optional[torch.Tensor] = None,
                          leaf_offsets: Optional[torch.Tensor] = None,
                          s: Optional[torch.Tensor] = None,
                          w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: ``[R, N]`` f32, eager ops in the kernel's order
    (float64 sources too, off the card: the float64 parity tests)."""
    _check(src, g, add_g, leaf_scales, leaf_offsets, s, w)
    if src.dtype == torch.int8:
        scale = torch.repeat_interleave(leaf_scales, _leaf_sizes(leaf_offsets), dim=1)
        d = src.to(torch.float32) * scale
    else:
        d = src
    if s is not None:
        d = d * s[:, None]
    if add_g:
        d = g + d
    if w is not None:
        d = w[:, None] * d
    return d.clone() if d is src else d


def aligned_rows(rows: int, n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """An uninitialised ``[rows, n]`` tensor whose rows start on 16-byte
    boundaries (the row stride rounded up), so the kernel takes its
    vector path."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    ld = -(-max(n, 1) // per) * per
    return torch.empty((rows, ld), dtype=dtype, device=device)[:, :n]


def _on_16_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` ([R, N] or [N]) if each of its rows starts on a 16-byte
    boundary, else a copy laid out by ``aligned_rows``."""
    rows = t.reshape(-1, t.shape[-1]) if t.dim() == 1 else t
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and (rows.shape[0] <= 1 or rows.stride(0) * t.element_size() % 16 == 0))
    if ok:
        return t
    out = aligned_rows(rows.shape[0], rows.shape[1], t.dtype, t.device)
    out.copy_(rows)
    return out.reshape(t.shape) if t.dim() == 1 else out


class RobustTermKernel(_build.Kernel):
    """``robust_term``: one launch over ``[R, N]``."""

    name = "robust_term"
    error_string = "robust_term_error_string"
    argtypes = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_longlong)

    def __call__(self, src, g=None, *, add_g=False, leaf_scales=None,
                 leaf_offsets=None, s=None, w=None) -> torch.Tensor:
        """The term ``[R, N]`` f32, its rows on 16-byte boundaries."""
        if src.dtype == torch.float64:
            raise ValueError(f"{self.name}: src is float64; the kernel takes float32 or int8")
        operands = {"src": src, **{k: v for k, v in (
            ("g", g), ("leaf_scales", leaf_scales), ("leaf_offsets", leaf_offsets),
            ("s", s), ("w", w)) if v is not None}}
        device = _build.cuda_device(self.name, **operands)
        _check(src, g, add_g, leaf_scales, leaf_offsets, s, w)
        R, N = src.shape
        if _build.faked(*operands.values()):
            # the bound's bytes (a row's source and its f32 output, g once,
            # the small operands) and one operation a step an element a row
            steps = (src.dtype == torch.int8) + (s is not None) + bool(add_g) + (w is not None)
            small = sum(t.numel() * t.element_size() for t in (leaf_scales, leaf_offsets, s, w)
                        if t is not None)
            self.trace(steps * R * N,
                       R * N * (src.element_size() + 4) + (N * 4 if add_g else 0) + small)
            return aligned_rows(R, N, device=device)
        src = _on_16_bytes(src)
        if add_g:
            g = _on_16_bytes(g)
        out = aligned_rows(R, N, device=device)
        if R == 0 or N == 0:
            return out
        if R > 2**31 - 1:
            raise ValueError(f"{self.name}: {R} rows; at most 2**31 - 1")
        kind = _INT8 if src.dtype == torch.int8 else _F32
        keep = [t.contiguous() if t is not None else None
                for t in (g, leaf_offsets, leaf_scales, s, w)]
        g_, off_, sc_, s_, w_ = keep

        def ptr(t):
            return None if t is None else t.data_ptr()

        self._launch(device, src.data_ptr(), src.stride(0), kind,
                     ptr(g_ if add_g else None), int(add_g), ptr(off_),
                     ptr(sc_), 0 if off_ is None else off_.numel() - 1, ptr(s_), ptr(w_),
                     out.data_ptr(), out.stride(0), R, N)
        return out


TERM_KERNEL = RobustTermKernel()


def robust_term(src: torch.Tensor, g: Optional[torch.Tensor] = None, *,
                add_g: bool = False,
                leaf_scales: Optional[torch.Tensor] = None,
                leaf_offsets: Optional[torch.Tensor] = None,
                s: Optional[torch.Tensor] = None,
                w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``w_r * (base + src_r * s_r)`` as the module docstring says,
    ``[R, N]`` f32: the kernel for CUDA tensors, the plain version for CPU
    ones."""
    kw = dict(add_g=add_g, leaf_scales=leaf_scales,
              leaf_offsets=leaf_offsets, s=s, w=w)
    if src.is_cuda or _build.faked(src):
        return TERM_KERNEL(src, g, **kw)
    return robust_term_reference(src, g, **kw)
