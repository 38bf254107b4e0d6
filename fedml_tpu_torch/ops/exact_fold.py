"""The exact aggregation fold: a hand-written Hopper kernel and its plain version.

The JAX package folds model uploads through a 3-limb float32 expansion
with Knuth two-sums (``_fold_leaf``/``_fold_tree``,
``fedml_tpu/core/aggregation.py:192-230``) and pins the bits of its
mesh aggregation the same way (``exact_weighted_mean``, ``:233-270``).
XLA generated that code on the TPU; here it is ``csrc/exact_fold.cu``,
CUDA C++ for ``sm_90a``: one fold kernel (``FOLD_KERNEL``) behind three
functions, and the weighted mean:

- ``fold``: terms ``[K, N]`` folded in index order into the limbs ``[3,
  N]``, in place. The streaming accumulator keeps one flat limb buffer
  for the whole model, so a fold is one launch whatever the number of
  leaves (K = 1 for a term, 3 for a limb set);
- ``fold_edges``: terms ``[E, N]`` folded into limbs ``[E, 3, N]``, edge
  ``e``'s term into edge ``e``'s limbs, for the edges a bitmask names: an
  edge tree's folds of one group, one launch;
- ``fold_set``: the rows of every edge a bitmask names of a buffer ``[E,
  R, N]``, edges in index order, folded into one limb set ``[3, N]``: an
  edge tree's root merge (``R = 3``, the edges' limbs folded where they
  lie, with no gathered copy) or a group's edge terms into one flat
  accumulator (``R = 1``), one launch;
- ``weighted_mean`` (``MEAN_KERNEL``): ``x [C, N]`` (f32 or bf16) and
  ``w [C]`` -> the terms ``fl32(w_c * x_c)`` folded in client order and
  collapsed as ``(s0 + s1) + s2``, in ``x``'s dtype; one launch a leaf.

Every add of the kernel is rounded on its own (``__fadd_rn`` and
friends, which nvcc never contracts into an FMA), so the kernel is
bitwise its plain version below and both are bitwise the JAX package's
fold; the one-launch entries fold their terms in the order the
one-term-at-a-time folds would, so each is bitwise those folds. The
kernel is bound by bytes on the card: ``(6 + K) * N * 4`` for a fold of
K terms, ``(C + 1) * N`` elements for ``weighted_mean`` (in bf16 its
instructions take about as long to issue as its bytes to move). A bitmask names
at most ``MAX_EDGES`` edges; ``fold_edges`` and ``fold_set`` take more
in launches of that many, in edge order.

Dispatch follows the tensor's device and nothing else: a CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
Each launch adds one to the kernel's ``launches``. A fake tensor (the
audit's trace, ``analysis/compiled.py``) launches nothing: the wrapper
records the call's work by the bound's formulas and returns outputs of
the kernel's shapes.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

__all__ = [
    "FOLD_KERNEL",
    "MAX_EDGES",
    "MEAN_KERNEL",
    "edge_mask",
    "fold",
    "fold_edges",
    "fold_edges_reference",
    "fold_leaf",
    "fold_reference",
    "fold_set",
    "fold_set_reference",
    "two_sum",
    "weighted_mean",
    "weighted_mean_reference",
]

# torch dtype -> the weighted-mean entry's dtype code
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# edges one bitmask (a 64-bit launch argument) names
MAX_EDGES = 64


def edge_mask(edges) -> int:
    """The bitmask of ``edges`` (edge indices), bit ``e`` for edge ``e``."""
    mask = 0
    for e in edges:
        mask |= 1 << int(e)
    return mask


def _edges_of(mask: int, count: int):
    return [e for e in range(count) if mask >> e & 1]


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


def fold_edges_reference(limbs: torch.Tensor, terms: torch.Tensor, mask: int) -> None:
    """The plain ``fold_edges``: for each edge ``e`` of ``mask``, ``terms[e]``
    (``[E, N]``) folded into ``limbs[e]`` (``[E, 3, N]``), in place."""
    for e in _edges_of(mask, limbs.shape[0]):
        fold_reference(limbs[e], terms[e])


def fold_set_reference(limbs: torch.Tensor, terms: torch.Tensor, mask: int) -> None:
    """The plain ``fold_set``: the rows of ``terms[e]`` (``[E, R, N]``) of
    each edge ``e`` of ``mask``, edges in index order, folded into
    ``limbs`` ``[3, N]``, in place."""
    edges = _edges_of(mask, terms.shape[0])
    if edges:
        fold_reference(limbs, terms[edges].reshape(-1, limbs.shape[1]))


def weighted_mean_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain ``weighted_mean``: ``x`` ``[C, N]``, ``w`` ``[C]`` f32 ->
    ``[N]`` in ``x``'s dtype."""
    z = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    s0, s1, s2 = z, z, z
    for c in range(x.shape[0]):
        s0, s1, s2 = fold_leaf(s0, s1, s2, w[c] * x[c].to(torch.float32))
    return ((s0 + s1) + s2).to(x.dtype)


# -- the kernel ----------------------------------------------------------
def _check_f32(name: str, **tensors) -> None:
    for key, t in tensors.items():
        if t.dtype != torch.float32 or t.stride(-1) != 1:
            raise ValueError(f"{name}: {key} is {t.dtype} with last stride {t.stride(-1)}; "
                             "want float32 with unit-stride rows")


def _check_mask(name: str, mask: int, count: int) -> None:
    if not 0 <= mask < 1 << min(count, MAX_EDGES):
        raise ValueError(f"{name}: edge mask {mask:#x} names edges outside the "
                         f"{min(count, MAX_EDGES)} it may")


class ExactFoldKernel(_build.Kernel):
    """``exact_fold``: one fold launch, in place. ``per_edge`` false:
    limbs ``[3, N]`` f32 += the rows of terms ``[E, R, N]`` f32 of the
    edges of the bitmask ``mask``, edges in index order. ``per_edge``
    true: limbs ``[E, 3, N]``, edge ``e``'s limbs += terms ``[E, N]`` row
    ``e``, for the edges of ``mask``."""

    name = "exact_fold"
    error_string = "exact_fold_error_string"
    argtypes = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p)

    def __call__(self, limbs: torch.Tensor, terms: torch.Tensor, mask: int,
                 per_edge: bool = False) -> None:
        device = _build.cuda_device(self.name, limbs=limbs, terms=terms)
        E, n = terms.shape[0], limbs.shape[-1]
        if per_edge:
            want, ok = "[E, 3, N] and [E, N]", (
                limbs.dim() == 3 and terms.dim() == 2 and tuple(limbs.shape) == (E, 3, n)
                and terms.shape[1] == n)
        else:
            want, ok = "[3, N] and [E, R, N]", (
                limbs.dim() == 2 and limbs.shape[0] == 3 and terms.dim() == 3
                and terms.shape[2] == n)
        if not ok:
            raise ValueError(f"{self.name}: limbs {tuple(limbs.shape)}, terms "
                             f"{tuple(terms.shape)}; want {want}")
        # per edge: one row an edge, edge e's limbs at limbs[e]; else R rows
        # an edge, all into the one limb set (a lone edge's stride unused)
        edge_t = terms.stride(0) if E > 1 else 0
        rows, ld_t, edge_l = ((1, 0, edge_t and limbs.stride(0)) if per_edge
                              else (terms.shape[1], terms.stride(1), 0))
        _check_f32(self.name, limbs=limbs, terms=terms)
        _check_mask(self.name, mask, E)
        if n == 0 or mask == 0 or rows == 0:
            return
        if _build.faked(limbs, terms):
            # (6 + K) * N * 4 bytes and 13 adds an element a term (two
            # two-sums and the low limb's add) for K terms into one limb set
            edges = bin(mask).count("1")
            K = edges * rows
            return self.trace(13 * K * n, (7 * edges if per_edge else 6 + K) * n * 4)
        self._launch(device, limbs.data_ptr(), edge_l, limbs.stride(-2), terms.data_ptr(),
                     edge_t, ld_t, rows, mask, int(per_edge), n)


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
        if _build.faked(x, w):
            # (C + 1) * N elements and w; a multiply and the fold's 13 adds
            # an element a client, the collapse's 2 adds an element
            C, n = x.shape
            self.trace((14 * C + 2) * n, (C + 1) * n * x.element_size() + C * 4)
            return out
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
    if limbs.is_cuda or terms.is_cuda or _build.faked(limbs, terms):
        FOLD_KERNEL(limbs, (terms if terms.dim() == 2 else terms.unsqueeze(0)).unsqueeze(0), 1)
    else:
        fold_reference(limbs, terms)


def fold_edges(limbs: torch.Tensor, terms: torch.Tensor, mask: int) -> None:
    """For each edge ``e`` of the bitmask ``mask``, fold ``terms[e]`` (``[E,
    N]``) into ``limbs[e]`` (``[E, 3, N]`` f32), in place: one kernel
    launch for CUDA tensors (one per ``MAX_EDGES`` edges), the plain
    version for CPU ones."""
    if not (limbs.is_cuda or terms.is_cuda or _build.faked(limbs, terms)):
        return fold_edges_reference(limbs, terms, mask)
    for e0 in range(0, max(terms.shape[0], 1), MAX_EDGES):
        part = (mask >> e0) & ((1 << MAX_EDGES) - 1)
        if part:
            FOLD_KERNEL(limbs[e0:e0 + MAX_EDGES], terms[e0:e0 + MAX_EDGES], part,
                        per_edge=True)


def fold_set(limbs: torch.Tensor, terms: torch.Tensor, mask: int) -> None:
    """Fold the rows of ``terms[e]`` (``[E, R, N]``) of each edge ``e`` of
    the bitmask ``mask``, edges in index order, into ``limbs`` ``[3, N]``
    f32, in place: one kernel launch for CUDA tensors (one per
    ``MAX_EDGES`` edges, in order), the plain version for CPU ones."""
    if not (limbs.is_cuda or terms.is_cuda or _build.faked(limbs, terms)):
        return fold_set_reference(limbs, terms, mask)
    for e0 in range(0, max(terms.shape[0], 1), MAX_EDGES):
        part = (mask >> e0) & ((1 << MAX_EDGES) - 1)
        if part:
            FOLD_KERNEL(limbs, terms[e0:e0 + MAX_EDGES], part)


def weighted_mean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact weighted sum ``sum_c w_c x_c`` over ``x``'s leading axis,
    ``[N]`` in ``x``'s dtype: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    if x.is_cuda or w.is_cuda or _build.faked(x, w):
        return MEAN_KERNEL(x, w)
    return weighted_mean_reference(x, w)
