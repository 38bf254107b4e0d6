"""The exact aggregation fold: a hand-written Hopper kernel and its plain version.

The JAX package folds model uploads through a 3-limb float32 expansion
with Knuth two-sums (``_fold_leaf``/``_fold_tree``,
``fedml_tpu/core/aggregation.py:192-230``) and pins the bits of its
mesh aggregation the same way (``exact_weighted_mean``, ``:233-270``).
XLA generated that code on the TPU; here it is ``csrc/exact_fold.cu``,
CUDA C++ for ``sm_90a``, with two entries:

- ``fold`` (``FOLD_KERNEL``): terms ``[K, N]`` folded in index order into
  the limbs ``[3, N]``, in place. The streaming accumulator keeps one
  flat limb buffer for the whole model, so a fold is one launch whatever
  the number of leaves (K = 1 for a term, 3 for a limb set);
- ``weighted_mean`` (``MEAN_KERNEL``): ``x [C, N]`` (f32 or bf16) and
  ``w [C]`` -> the terms ``fl32(w_c * x_c)`` folded in client order and
  collapsed as ``(s0 + s1) + s2``, in ``x``'s dtype; one launch a leaf.

Every add of the kernel is rounded on its own (``__fadd_rn`` and
friends, which nvcc never contracts into an FMA), so the kernel is
bitwise its plain version below and both are bitwise the JAX package's
fold. The kernel is bound by bytes on the card: ``(6 + K) * N * 4`` for
``fold``, ``(C + 1) * N`` elements for ``weighted_mean``.

Dispatch follows the tensor's device and nothing else: a CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
Each launch adds one to the kernel's ``launches``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

__all__ = [
    "FOLD_KERNEL",
    "MEAN_KERNEL",
    "fold",
    "fold_leaf",
    "fold_reference",
    "two_sum",
    "weighted_mean",
    "weighted_mean_reference",
]

# torch dtype -> the weighted-mean entry's dtype code
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# -- the plain version ---------------------------------------------------
def two_sum(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Knuth two-sum: ``s + e == a + b`` exactly (round-to-nearest),
    branch-free, any magnitudes. Eager ops round each add on its own."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def fold_leaf(s0, s1, s2, t):
    """One term into the expansion: every add exact but the lowest
    limb's (its error ~2^-48 of the term)."""
    s0, e = two_sum(s0, t)
    s1, e = two_sum(s1, e)
    return s0, s1, s2 + e


def fold_reference(limbs: torch.Tensor, terms: torch.Tensor) -> None:
    """The plain ``fold``: ``terms`` ``[K, N]`` (or ``[N]``) folded in
    index order into ``limbs`` ``[3, N]`` f32, in place."""
    terms = terms.reshape(-1, limbs.shape[1])
    s0, s1, s2 = limbs[0].clone(), limbs[1].clone(), limbs[2].clone()
    for t in terms:
        s0, s1, s2 = fold_leaf(s0, s1, s2, t)
    limbs[0].copy_(s0)
    limbs[1].copy_(s1)
    limbs[2].copy_(s2)


def weighted_mean_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain ``weighted_mean``: ``x`` ``[C, N]``, ``w`` ``[C]`` f32 ->
    ``[N]`` in ``x``'s dtype."""
    z = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    s0, s1, s2 = z, z, z
    for c in range(x.shape[0]):
        s0, s1, s2 = fold_leaf(s0, s1, s2, w[c] * x[c].to(torch.float32))
    return ((s0 + s1) + s2).to(x.dtype)


# -- the kernel ----------------------------------------------------------
class ExactFoldKernel(_build.Kernel):
    """``exact_fold``: limbs ``[3, N]`` f32 += terms ``[K, N]`` f32, in place."""

    name = "exact_fold"
    error_string = "exact_fold_error_string"
    argtypes = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p)

    def __call__(self, limbs: torch.Tensor, terms: torch.Tensor) -> None:
        device = _build.cuda_device(self.name, limbs=limbs, terms=terms)
        if terms.dim() == 1:
            terms = terms.unsqueeze(0)
        n = limbs.shape[-1]
        if (limbs.dtype != torch.float32 or terms.dtype != torch.float32
                or limbs.dim() != 2 or limbs.shape[0] != 3
                or terms.dim() != 2 or terms.shape[1] != n):
            raise ValueError(
                f"{self.name}: limbs {limbs.dtype} {tuple(limbs.shape)}, terms {terms.dtype} "
                f"{tuple(terms.shape)}; want float32 [3, N] and [K, N]"
            )
        if limbs.stride(1) != 1 or terms.stride(1) != 1:
            raise ValueError(f"{self.name}: rows must be unit-stride")
        if n == 0 or terms.shape[0] == 0:
            return
        self._launch(device, limbs.data_ptr(), limbs.stride(0), terms.data_ptr(),
                     terms.stride(0), terms.shape[0], n)


class ExactWeightedMeanKernel(_build.Kernel):
    """``exact_weighted_mean``: x ``[C, N]`` (f32 or bf16), w ``[C]`` f32 ->
    ``[N]`` in x's dtype."""

    name = "exact_weighted_mean"
    library = "exact_fold"
    error_string = "exact_fold_error_string"
    argtypes = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        device = _build.cuda_device(self.name, x=x, w=w)
        if (x.dtype not in _DTYPE_CODES or x.dim() != 2 or w.dtype != torch.float32
                or tuple(w.shape) != (x.shape[0],)):
            raise ValueError(
                f"{self.name}: x {x.dtype} {tuple(x.shape)}, w {w.dtype} {tuple(w.shape)}; "
                "want float32 or bfloat16 [C, N] and float32 [C]"
            )
        if x.stride(1) != 1:
            x = x.contiguous()
        w = w.contiguous()
        out = torch.empty(x.shape[1], dtype=x.dtype, device=device)
        if x.shape[1]:
            self._launch(device, x.data_ptr(), x.stride(0), w.data_ptr(), x.shape[0],
                         out.data_ptr(), x.shape[1], _DTYPE_CODES[x.dtype])
        return out


FOLD_KERNEL = ExactFoldKernel()
MEAN_KERNEL = ExactWeightedMeanKernel()


def fold(limbs: torch.Tensor, terms: torch.Tensor) -> None:
    """Fold ``terms`` ``[K, N]`` (or one ``[N]``) in index order into
    ``limbs`` ``[3, N]`` f32, in place: the kernel for CUDA tensors, the
    plain version for CPU ones."""
    if limbs.is_cuda or terms.is_cuda:
        FOLD_KERNEL(limbs, terms)
    else:
        fold_reference(limbs, terms)


def weighted_mean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact weighted sum ``sum_c w_c x_c`` over ``x``'s leading axis,
    ``[N]`` in ``x``'s dtype: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    if x.is_cuda or w.is_cuda:
        return MEAN_KERNEL(x, w)
    return weighted_mean_reference(x, w)
