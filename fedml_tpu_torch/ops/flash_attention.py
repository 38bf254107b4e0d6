"""Flash attention, [B, T, H, D] layout: hand-written Hopper kernels.

The port of ``fedml_tpu/ops/flash_attention.py``. The forward is
``csrc/flash_attention_fwd.cu``, CUDA C++ for Hopper, which replaces the
Pallas TPU kernel ``_flash_kernel`` (``fedml_tpu/ops/flash_attention.py:32``).
Causal attention at the paths' shapes is bound by operations on an H100,
and both products run on the tensor cores, with K/V tiles arriving by
TMA through a ring of shared-memory stages, in two routes that keep the
JAX kernel's f32 arithmetic:

- bf16 inputs (the training path): ``flash_fwd_wgmma_kernel``, bf16
  ``wgmma`` on bf16 tiles in shared memory. S = Q K^T is one pass; P
  stays in registers as the A operand of P V, split into bf16 hi + lo
  (two passes into one f32 accumulator); the softmax of one key tile runs
  while the products of the one before are in flight.
- f32 inputs (serving): ``flash_fwd_kernel``, 3xTF32 on ``mma.sync``
  (each f32 product is three TF32 products of a hi/lo split, so the bound
  is three passes at the 495 TFLOP/s TF32 peak and the result keeps f32's
  accuracy).

The source describes both designs.

The backward is ``csrc/flash_attention_bwd.cu``, the port of the JAX
package's ``_bwd`` (``:140-175``), which is plain array code there: a
blockwise FlashAttention-2 recompute from the saved log-sum-exp. The
kernels recompute the scores tile by tile on the tensor cores, in f32
arithmetic, with no atomics (each output element is summed in one fixed
order): bf16 inputs on ``wgmma`` with TMA-fed bf16 tiles (P and dS as
bf16 hi + lo), f32 inputs as 3xTF32 on TF32 ``wgmma`` with TMA-fed f32
tiles split into TF32 hi + lo (and copied transposed where a product
contracts over a tile's rows). ``_flash_backward`` keeps ``_bwd``'s
blockwise loop for CPU
tensors, one [T, bk] score panel at a time, never the dense [T, T]
matrix; ``flash_attention_backward_reference`` is the dense plain
version the kernel is held against.

Dispatch follows the tensor's device and nothing else: a CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises. Every
launch adds one to ``FWD_KERNEL.launches`` or ``BWD_KERNEL.launches``.
The D <= 128 kernels take head dims 16, 32, 64 and 128; the wrappers
run any other D up to 128 at the next of those, zero-padded (the padded
columns leave S, P and every real output column as they were). Head dims
129 to 512 take the rows route, ``csrc/flash_attention_rows.cu``
(``ROWS_FWD_KERNEL`` and ``ROWS_BWD_KERNEL``, counted apart), run at D
rounded up to a multiple of 64, or for the bf16 forward to 192, 256, 384
or 512 (``rows_head_dim``), zero-padded the same way: the same TMA rings
and ``wgmma`` products in blocks of two warpgroups. The bf16 forward
gives each warpgroup 64 of a block's 128 queries with Q resident and one
ring of K and V tiles both read, and so does the bf16 backward at 256
columns (128 keys or queries a block); the f32 forward and the other
backward launches split the head dim's chunks between the warpgroups,
which add their partial scores, and hold the output in 64-column units,
four a block (grid z past four, ``rows_grid``); f32 inputs go through a
pre-pass that writes TF32 hi/lo planes into a scratch tensor the wrapper
allocates (``rows_scratch``). On the CPU every D takes the same plain
versions; above 512 the wrappers raise. Any batch x heads launches (the
kernels' grid x), and so does any T: query and key tiles past grid y's
65,535 fold into grid x (``tile_grid``).

Both autograd functions carry ``vmap`` rules, so ``torch.func.vmap``
over ``torch.func.grad`` (the federated trainer's vmapped client step)
runs through them: the rule folds the vmapped client axis into the batch
(``[C, B, T, H, D] -> [C*B, T, H, D]``, a view where the strides allow)
and calls the function once, so one kernel launch serves the whole
cohort.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

__all__ = [
    "BWD_KERNEL",
    "FWD_KERNEL",
    "ROWS_BWD_KERNEL",
    "ROWS_FWD_KERNEL",
    "ROWS_MAX_HEAD_DIM",
    "flash_attention",
    "flash_attention_backward_reference",
    "flash_attention_reference",
    "flash_backward",
    "flash_forward",
    "check_shape",
    "kernel_head_dim",
    "kernel_operand",
    "padded_backward",
    "padded_forward",
    "pick_block",
    "rows_grid",
    "rows_head_dim",
    "rows_plan",
    "rows_scratch",
    "rows_share",
    "tile_grid",
]

_NEG_INF = -1e30

# torch dtype -> the kernels' dtype code
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
# the rows route (csrc/flash_attention_rows.cu) takes D above 128 up to this
ROWS_MAX_HEAD_DIM = 512
# queries or keys per tile: the kernels' grid y counts tiles, up to 65535,
# and the tiles past that fold into grid x, which takes up to 2**31 - 1
_TILE = 64
_GRID_Y = 65535
_GRID_X = 2**31 - 1
# the rows route's output columns a unit (the head dim is padded to a
# multiple of it), units a block, and a block's shared memory
ROWS_UNIT = 64
_ROWS_BLOCK_UNITS = 4
# the bf16 forward's head dims (``rows_fwd_bf16_kernel<DP>``), and the one
# the bf16 backward runs on 128-row kernels (``rows_dkdv128_kernel``,
# ``rows_dq128_kernel``; the others on the two-warpgroup split)
_ROWS_BF16_FWD_DIMS = (192, 256, 384, 512)
_ROWS_BWD128_DIM = 256
_SMEM = 232448
# TMA (and the backward's 16-byte loads) read from a 16-byte-aligned base
# with 16-byte multiples as strides
_TMA_ALIGN = 16


def kernel_head_dim(D: int) -> int:
    """The head dim the kernels run a D-wide head at: D where they take
    it, else the next one up (the wrapper zero-pads). Raises above 128."""
    for dim in _HEAD_DIMS:
        if D <= dim:
            return dim
    raise ValueError(f"flash attention: head dim {D} exceeds the kernels' limit of "
                     f"{_HEAD_DIMS[-1]}")


def tile_grid(bh: int, T: int, tile: int = _TILE) -> Tuple[int, int]:
    """The tensor-core kernels' launch grid (x, y) for ``bh`` = batch x
    heads rows of ceil(T / tile) tiles (64 rows; the rows route's bf16
    forward 128): bh on x, tiles on y while they fit y's 65,535; past that
    the tiles fold into x, ``fold`` = ceil(tiles / 65535) copies of the
    rows. ``work_grid`` in ``csrc/hopper.cuh`` is the same arithmetic; the
    kernels' ``block_work`` maps a block's linear index back to its (row,
    tile)."""
    tiles = -(-T // tile)
    fold = -(-tiles // _GRID_Y)
    return bh * fold, -(-tiles // fold)


def rows_head_dim(D: int, bf16_forward: bool = False) -> int:
    """The head dim the rows route runs a D-wide head at (129 <= D <=
    512): D rounded up to a multiple of ``ROWS_UNIT``, or for the bf16
    forward to one of its instantiations, 192, 256, 384 and 512; the
    wrapper zero-pads. Raises outside that range."""
    if not _HEAD_DIMS[-1] < D <= ROWS_MAX_HEAD_DIM:
        raise ValueError(f"flash attention: head dim {D} is not in the rows route's "
                         f"{_HEAD_DIMS[-1] + 1}-{ROWS_MAX_HEAD_DIM}")
    dp = -(-D // ROWS_UNIT) * ROWS_UNIT
    if bf16_forward:
        dp = next(d for d in _ROWS_BF16_FWD_DIMS if d >= dp)
    return dp


def rows_grid(bh: int, T: int, D: int, bf16_forward: bool = False) -> Tuple[int, int, int]:
    """The rows route's launch grid (x, y, z) for ``bh`` = batch x heads
    rows at head dim ``D``: ``tile_grid`` on x and y over tiles of 64 rows
    (``rows_grid`` in ``csrc/flash_attention_rows.cu``) and on z the
    blocks a tile takes, one for every four 64-column units of the padded
    head dim (two warpgroups of two units each); the bf16 forward's tiles
    are 128 queries and its z is 1 up to 256 columns, 2 above (a block a
    half of O's columns)."""
    if bf16_forward:
        return (*tile_grid(bh, T, 128), 1 if rows_head_dim(D, True) <= 256 else 2)
    units = rows_head_dim(D) // ROWS_UNIT
    return (*tile_grid(bh, T), -(-units // _ROWS_BLOCK_UNITS))


def rows_share(D: int, dtype: torch.dtype, z: int, wg: int) -> Tuple[range, range]:
    """Warpgroup ``wg`` (0 or 1) of block ``z``'s share of the padded head
    dim (``Share`` in ``csrc/flash_attention_rows.cu``): the S chunks it
    streams (64 columns in bf16, 32 in f32; the block's two warpgroups
    split them in halves and add their partial scores) and the 64-column
    output units it owns (two a warpgroup, four a block)."""
    dp = rows_head_dim(D)
    chunks = dp // _ROWS_ROUTE[dtype][1]
    half = -(-chunks // 2)
    c0 = wg * half
    u0 = z * _ROWS_BLOCK_UNITS + wg * 2
    return range(c0, min(chunks, c0 + half)), range(u0, max(u0, min(u0 + 2, dp // ROWS_UNIT)))


# a dtype's planes per operand (f32: TF32 hi and lo), S-chunk columns (one
# 128-byte box), and the dK/dV kernel's query step and the dQ kernel's key
# step: ``Route`` in csrc/flash_attention_rows.cu
_ROWS_ROUTE = {torch.bfloat16: (1, 64, 32, 32), torch.float32: (2, 32, 32, 32)}


def rows_plan(dtype: torch.dtype, kernel: str, D: Optional[int] = None) -> dict:
    """The rows route's ring for ``kernel`` ("fwd", "dkdv" or "dq") at
    ``dtype``, as ``FwdCfg``/``DkdvCfg``/``DqCfg`` and ``Budget`` in
    ``csrc/flash_attention_rows.cu`` compute it: a stage's bytes (the
    larger of an S item, two chunk tiles, and a unit item), the stages a
    warpgroup's ring holds, a warpgroup's exchange buffer (its partial S,
    and dP in the backward, f32) and the block's shared memory (two rings,
    two exchange buffers and 1 KB of barriers within 227 KB; bf16's
    backward also two regions of resident tiles). The bf16
    forward (``Bf16FwdCfg``, at head dim ``D``) has one ring the block's
    two warpgroups share, a stage a K tile of the head dim (64 keys, 32
    above 256 columns), and Q resident in place of the exchange buffers."""
    if kernel in ("dkdv", "dq") and dtype == torch.bfloat16 and D is not None \
            and rows_head_dim(D) == _ROWS_BWD128_DIM:
        # 128 rows a block: two resident [128, 256] tiles, one shared ring of
        # [32, 256] tiles
        stage, res = 32 * 256 * 2, 2 * 128 * 256 * 2
        stages = (_SMEM - 1024 - res) // stage
        return {"stage_bytes": stage, "stages": stages, "resident_bytes": res,
                "smem_bytes": res + stages * stage + 1024}
    if kernel == "fwd" and dtype == torch.bfloat16:
        dp = rows_head_dim(D, True)
        bk = 64 if dp <= 256 else 32
        stage, q_bytes = bk * dp * 2, 128 * dp * 2
        stages = (_SMEM - 1024 - q_bytes) // stage
        return {"stage_bytes": stage, "stages": stages, "resident_bytes": q_bytes,
                "smem_bytes": q_bytes + stages * stage + 1024}
    planes, _, dkdv_bq, dq_bk = _ROWS_ROUTE[dtype]
    box = 64 * 128  # a 128-byte-wide box of 64 rows

    def unit_item(n):  # bf16 [n, 64] natural; f32 [64, n] transposed, hi and lo
        return n * 128 if planes == 1 else 2 * (n // 32) * box

    # bf16's backward keeps the warpgroup's chunks of K and V (dK/dV) or Q
    # and dO (dQ) resident, up to 4 boxes each, and streams the other pair
    res = 8 * box if planes == 1 and kernel != "fwd" else 0
    if kernel == "fwd":
        s_item, u_item, x = 2 * box * planes, unit_item(64), 64 * 64 * 4
    elif kernel == "dkdv":
        s_item = 2 * dkdv_bq * 128 if res else box * planes + dkdv_bq * 128 * planes
        u_item, x = unit_item(dkdv_bq), 2 * 64 * dkdv_bq * 4
    elif kernel == "dq":
        s_item = 2 * dq_bk * 128 if res else box * planes + dq_bk * 128 * planes
        u_item, x = unit_item(dq_bk), 2 * 64 * dq_bk * 4
    else:
        raise ValueError(f"rows_plan: no kernel {kernel!r}")
    stage = max(s_item, u_item)
    stages = (_SMEM - 1024 - 2 * x - 2 * res) // 2 // stage
    return {"stage_bytes": stage, "stages": stages, "exchange_bytes": x,
            "smem_bytes": 2 * res + 2 * stages * stage + 2 * x + 1024}


def rows_scratch(dtype: torch.dtype, backward: bool, B: int, T: int, H: int, D: int) -> int:
    """f32 elements of the rows route's scratch at [B, T, H, D] (``D``
    padded by ``rows_head_dim``): the pre-pass's TF32 hi and lo planes,
    natural [B, T, H, D] and transposed [B, H, D, T rounded up to 64]: Q,
    K and V^T forward; Q, K, V, dO and Q^T, dO^T, K^T backward. 0 for
    bf16, which the kernels read as it is."""
    if dtype != torch.float32:
        return 0
    D = rows_head_dim(D)
    n, nt = B * T * H * D, B * H * D * (-(-T // 64) * 64)
    return 8 * n + 6 * nt if backward else 4 * n + 2 * nt


def check_shape(shape, dtype: torch.dtype, name: str = "flash attention") -> None:
    """Raises unless a kernel takes a [B, T, H, D] operand of ``dtype``:
    f32 or bf16; D one of the D <= 128 kernels' head dims, or 129 to 512
    (the rows route, which the wrapper runs at ``rows_head_dim(D)``); a
    grid that fits (``tile_grid``'s x at most 2**31 - 1). Any T and any
    batch x heads short of that launch."""
    B, T, H, D = shape
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dtype} unsupported (float32 or bfloat16)")
    if D not in _HEAD_DIMS and not _HEAD_DIMS[-1] < D <= ROWS_MAX_HEAD_DIM:
        raise ValueError(
            f"{name}: head dim {D} not in {_HEAD_DIMS} nor in the rows route's "
            f"{_HEAD_DIMS[-1] + 1}-{ROWS_MAX_HEAD_DIM}"
        )
    x, _ = tile_grid(B * H, T)
    if x > _GRID_X:
        raise ValueError(
            f"{name}: batch x heads {B * H} at seq len {T} needs a grid x of {x}: "
            f"its tiles of {_TILE} fold into x past grid y's {_GRID_Y} tiles, and x "
            f"takes at most {_GRID_X}"
        )


def _route_head_dim(D: int) -> bool:
    """True when a D-wide head runs on the rows route; raises above its
    limit of 512."""
    if D > ROWS_MAX_HEAD_DIM:
        raise ValueError(
            f"flash attention: head dim {D} exceeds the kernels' limit of "
            f"{ROWS_MAX_HEAD_DIM} (tensor-core kernels up to {_HEAD_DIMS[-1]}, the rows "
            f"route above)"
        )
    return D > _HEAD_DIMS[-1]


def _pad_head(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` [..., D] zero-padded to ``dim`` columns (itself if D == dim)."""
    D = x.shape[-1]
    return x if D == dim else torch.nn.functional.pad(x, (0, dim - D))


def _cut_head(x: torch.Tensor, D: int) -> torch.Tensor:
    return x if x.shape[-1] == D else x[..., :D].contiguous()


def padded_forward(forward, q, k, v, causal, scale, head_dim=kernel_head_dim):
    """``forward(q, k, v, causal, scale)`` -> (O, lse) run at the kernels'
    head dim: q, k and v zero-padded to ``head_dim(D)`` and O cut back to
    D. ``scale`` is the caller's, the original D's. The padded columns add
    zeros to every score, so the result is the same function."""
    D = q.shape[-1]
    dim = head_dim(D)
    o, lse = forward(*(_pad_head(x, dim) for x in (q, k, v)), causal, scale)
    return _cut_head(o, D), lse


def padded_backward(backward, q, k, v, o, lse, g, causal, scale, head_dim=kernel_head_dim):
    """``backward(q, k, v, o, lse, g, causal, scale)`` -> (dQ, dK, dV)
    run at the kernels' head dim, as ``padded_forward`` runs the forward:
    zero columns of O and dO leave delta as it is, and the gradients'
    padded columns, cut off here, are zero."""
    D = q.shape[-1]
    dim = head_dim(D)
    q, k, v, o, g = (_pad_head(x, dim) for x in (q, k, v, o, g))
    return tuple(_cut_head(x, D) for x in backward(q, k, v, o, lse, g, causal, scale))


def kernel_operand(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """``x`` [B, T, H, D] as the kernels read it, with its (batch, time,
    head) element strides.

    The kernels need a 16-byte-aligned base address and a 16-byte
    multiple for every stride they step over. The q/k/v views of a fused
    projection meet that as they are; a view that does not is copied to
    a contiguous tensor. A dimension of size 1 is never stepped over, so
    its stride is given as the contiguous one."""
    size = x.element_size()
    steps = [x.stride(i) for i in range(3) if x.shape[i] > 1]
    if x.data_ptr() % _TMA_ALIGN or any(s * size % _TMA_ALIGN for s in steps):
        x = x.clone(memory_format=torch.contiguous_format)
    _, T, H, D = x.shape
    dense = (T * H * D, H * D, D)
    return x, tuple(x.stride(i) if x.shape[i] > 1 else dense[i] for i in range(3))


class _Kernel(_build.Kernel):
    """A flash entry point: ``_build.Kernel`` plus the operand checks
    every flash wrapper shares."""

    def _check(self, named, like: torch.Tensor) -> None:
        """Every named operand on a card, of ``like``'s dtype, shape and
        device, unit-stride in D; the shape and dtype are ones the kernel
        takes (``check_shape``)."""
        for name, x in named:
            if not x.is_cuda:
                raise ValueError(f"{self.name}: {name} is on {x.device}, not CUDA")
            if x.dtype != like.dtype or x.shape != like.shape or x.device != like.device:
                raise ValueError(
                    f"{self.name}: {name} is {x.dtype} {tuple(x.shape)} on {x.device}; "
                    f"q is {like.dtype} {tuple(like.shape)} on {like.device}"
                )
            if x.stride(-1) != 1:
                raise ValueError(f"{self.name}: {name}'s last dim is not unit-stride")
        check_shape(like.shape, like.dtype, self.name)


class FlashForwardKernel(_Kernel):
    """``flash_attention_fwd``: (O in q's dtype, lse f32 [B, H, T])."""

    name = "flash_attention_fwd"
    error_string = "flash_attention_error_string"
    argtypes = (
        (ctypes.c_void_p,) * 5
        + (ctypes.c_int,) * 5
        + (ctypes.c_longlong,) * 9
        + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
    )

    def __call__(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        causal: bool,
        scale: float,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Launch on CUDA tensors; returns (O in q's dtype, lse f32 [B,H,T]).
        A head dim the kernel lacks runs zero-padded to the next one."""
        return padded_forward(self._run, q, k, v, causal, scale)

    def _run(self, q, k, v, causal, scale):
        self._check((("q", q), ("k", k), ("v", v)), q)
        B, T, H, D = q.shape
        (q, qs), (k, ks), (v, vs) = (kernel_operand(x) for x in (q, k, v))
        o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
        self._launch(
            q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _DTYPE_CODES[q.dtype], B, T, H, D, *qs, *ks, *vs,
            float(scale), int(bool(causal)),
        )
        return o, lse


class RowsForwardKernel(FlashForwardKernel):
    """``flash_rows_fwd`` (``csrc/flash_attention_rows.cu``): the forward
    at head dims 129 to 512, run at ``rows_head_dim(D)`` (zero-padded; for
    bf16 the next of 192, 256, 384 and 512). Same arguments and results as
    :class:`FlashForwardKernel`; f32 takes a scratch tensor for the
    pre-pass's planes."""

    name = "flash_rows_fwd"
    library = "flash_attention_rows"
    error_string = "flash_rows_error_string"
    argtypes = (
        (ctypes.c_void_p,) * 6
        + (ctypes.c_int,) * 5
        + (ctypes.c_longlong,) * 9
        + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
    )

    def __call__(self, q, k, v, causal, scale):
        bf16 = q.dtype == torch.bfloat16
        return padded_forward(self._run, q, k, v, causal, scale,
                              head_dim=lambda D: rows_head_dim(D, bf16))

    def _run(self, q, k, v, causal, scale):
        self._check((("q", q), ("k", k), ("v", v)), q)
        B, T, H, D = q.shape
        (q, qs), (k, ks), (v, vs) = (kernel_operand(x) for x in (q, k, v))
        o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
        scratch = torch.empty(rows_scratch(q.dtype, False, B, T, H, D), dtype=torch.float32,
                              device=q.device)
        self._launch(
            q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), scratch.data_ptr() if scratch.numel() else None,
            _DTYPE_CODES[q.dtype], B, T, H, D, *qs, *ks, *vs,
            float(scale), int(bool(causal)),
        )
        return o, lse


class FlashBackwardKernel(_Kernel):
    """``flash_attention_bwd``: (dQ, dK, dV) in q's dtype, contiguous."""

    name = "flash_attention_bwd"
    error_string = "flash_attention_bwd_error_string"
    argtypes = (
        (ctypes.c_void_p,) * 10
        + (ctypes.c_int,) * 5
        + (ctypes.c_longlong,) * 15
        + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
    )

    def __call__(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        o: torch.Tensor,
        lse: torch.Tensor,
        g: torch.Tensor,
        causal: bool,
        scale: float,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Launch on CUDA tensors: q, k, v, O and dO ``g`` [B, T, H, D]
        of one dtype, lse f32 [B, H, T]. Returns (dQ, dK, dV). A head dim
        the kernel lacks runs zero-padded to the next one."""
        return padded_backward(self._run, q, k, v, o, lse, g, causal, scale)

    def _run(self, q, k, v, o, lse, g, causal, scale):
        self._check((("q", q), ("k", k), ("v", v), ("o", o), ("g", g)), q)
        B, T, H, D = q.shape
        if lse.dtype != torch.float32 or lse.shape != (B, H, T) or lse.device != q.device:
            raise ValueError(
                f"{self.name}: lse is {lse.dtype} {tuple(lse.shape)} on {lse.device}; "
                f"want float32 {(B, H, T)} on {q.device}"
            )
        lse = lse.contiguous()
        (q, qs), (k, ks), (v, vs), (o, os_), (g, gs) = (
            kernel_operand(x) for x in (q, k, v, o, g)
        )
        grads = [torch.empty((B, T, H, D), dtype=q.dtype, device=q.device) for _ in range(3)]
        delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
        self._launch(
            q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), g.data_ptr(), *(x.data_ptr() for x in grads),
            delta.data_ptr(), _DTYPE_CODES[q.dtype], B, T, H, D,
            *qs, *ks, *vs, *os_, *gs, float(scale), int(bool(causal)),
        )
        return tuple(grads)


class RowsBackwardKernel(FlashBackwardKernel):
    """``flash_rows_bwd``: the backward at head dims 129 to 512, run at
    ``rows_head_dim(D)`` (zero-padded; bf16 at 256 on its 128-row
    kernels): the f32 pre-pass, delta, dK and dV, then dQ, on the stream,
    counted as one launch. Same arguments and results as
    :class:`FlashBackwardKernel`."""

    name = "flash_rows_bwd"
    library = "flash_attention_rows"
    error_string = "flash_rows_error_string"
    argtypes = (
        (ctypes.c_void_p,) * 11
        + (ctypes.c_int,) * 5
        + (ctypes.c_longlong,) * 15
        + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
    )

    def __call__(self, q, k, v, o, lse, g, causal, scale):
        return padded_backward(self._run, q, k, v, o, lse, g, causal, scale,
                               head_dim=rows_head_dim)

    def _run(self, q, k, v, o, lse, g, causal, scale):
        self._check((("q", q), ("k", k), ("v", v), ("o", o), ("g", g)), q)
        B, T, H, D = q.shape
        if lse.dtype != torch.float32 or lse.shape != (B, H, T) or lse.device != q.device:
            raise ValueError(
                f"{self.name}: lse is {lse.dtype} {tuple(lse.shape)} on {lse.device}; "
                f"want float32 {(B, H, T)} on {q.device}"
            )
        lse = lse.contiguous()
        (q, qs), (k, ks), (v, vs), (o, os_), (g, gs) = (
            kernel_operand(x) for x in (q, k, v, o, g)
        )
        grads = [torch.empty((B, T, H, D), dtype=q.dtype, device=q.device) for _ in range(3)]
        delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
        scratch = torch.empty(rows_scratch(q.dtype, True, B, T, H, D), dtype=torch.float32,
                              device=q.device)
        self._launch(
            q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), g.data_ptr(), *(x.data_ptr() for x in grads),
            delta.data_ptr(), scratch.data_ptr() if scratch.numel() else None,
            _DTYPE_CODES[q.dtype], B, T, H, D,
            *qs, *ks, *vs, *os_, *gs, float(scale), int(bool(causal)),
        )
        return tuple(grads)


FWD_KERNEL = FlashForwardKernel()
BWD_KERNEL = FlashBackwardKernel()
ROWS_FWD_KERNEL = RowsForwardKernel()
ROWS_BWD_KERNEL = RowsBackwardKernel()


def pick_block(t: int, minimum: int = 8) -> Optional[int]:
    """Largest power-of-two block <= 128 that divides ``t`` — the one
    block-size policy every flash call site uses. Returns None when the
    only dividing blocks are smaller than ``minimum`` (callers fall
    back to dense attention rather than running degenerate tiles)."""
    for b in (128, 64, 32, 16, 8, 4, 2, 1):
        if t % b == 0:
            return b if b >= minimum else None
    return None


def _causal_keep(T: int, device) -> torch.Tensor:
    return torch.ones((T, T), dtype=torch.bool, device=device).tril()


def _acc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the plain versions' arithmetic type: f32, or float64 for
    a float64 input (the kernels take f32 and bf16 only)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: dense scores in f32,
    masked with -1e30. Returns (O in q's dtype, lse f32 [B, H, T])."""
    T = q.shape[1]
    scale = scale or (q.shape[-1] ** -0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", _acc(q), _acc(k)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(T, q.device), _NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), _acc(v))
    return o.to(q.dtype), lse


def flash_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: ``_bwd``'s
    arithmetic on the dense [B, H, T, T] panel, in f32. Returns (dQ, dK,
    dV) in q's dtype."""
    T = q.shape[1]
    sc = scale or (q.shape[-1] ** -0.5)
    qf, kf, vf, of, gf = (_acc(x) for x in (q, k, v, o, g))
    delta = (gf * of).sum(-1).transpose(1, 2)  # [B,H,T]
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sc
    if causal:
        s = s.masked_fill(~_causal_keep(T, q.device), _NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - delta[..., None]) * sc
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    rows = _route_head_dim(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    if q.device.type == "cuda":
        return (ROWS_FWD_KERNEL if rows else FWD_KERNEL)(q, k, v, causal, scale)
    raise ValueError(f"flash attention: no path for device {q.device}")


def _flash_backward(q, k, v, o, lse, g, causal, scale, block_k):
    """Blockwise backward (FlashAttention-2 recompute): a loop over key
    blocks rebuilding [T, bk] score panels from the saved log-sum-exp —
    peak memory O(B·H·T·bk), never the dense [T, T] matrix."""
    B, T, H, D = q.shape
    sc = scale or (D**-0.5)
    bk = min(block_k, T)
    qf, kf, vf, of, gf = (_acc(x) for x in (q, k, v, o, g))
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


def flash_backward(q, k, v, o, lse, g, causal=True, scale=None, block_k=128):
    """(dQ, dK, dV) of flash attention from the forward's O and lse and
    the output's gradient ``g``: the blockwise plain loop on the CPU, the
    backward kernel on a card."""
    scale = scale or (q.shape[-1] ** -0.5)
    rows = _route_head_dim(q.shape[-1])
    if q.device.type == "cpu":
        return _flash_backward(q, k, v, o, lse, g, causal, scale, block_k)
    if q.device.type == "cuda":
        return (ROWS_BWD_KERNEL if rows else BWD_KERNEL)(q, k, v, o, lse, g, causal, scale)
    raise ValueError(f"flash attention: no path for device {q.device}")


# -- vmap: fold the vmapped axis into the batch ---------------------------------


def _fold(x: torch.Tensor, bdim: Optional[int], n: int) -> torch.Tensor:
    """A vmapped operand as one batch: the vmapped dim ``bdim`` (None:
    unbatched, so broadcast) moved to the front and merged with the
    batch dim, a view wherever the strides allow."""
    x = x.movedim(bdim, 0) if bdim is not None else x.expand((n,) + tuple(x.shape))
    return x.flatten(0, 1)


def _unfold(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.unflatten(0, (n, -1))


class FlashAttention(torch.autograd.Function):
    """Flash attention, returning (O, lse); its backward is
    :class:`FlashAttentionBackward`. Usable under ``torch.func``."""

    @staticmethod
    def forward(q, k, v, causal, scale, block_q, block_k):
        return flash_forward(q, k, v, causal, scale, block_q, block_k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, scale, _, block_k = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        ctx.causal, ctx.scale, ctx.block_k = causal, scale, block_k

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = FlashAttentionBackward.apply(
            q, k, v, o, lse, g, ctx.causal, ctx.scale, ctx.block_k
        )
        return dq, dk, dv, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, scale, block_q, block_k):
        n = info.batch_size
        folded = [_fold(x, d, n) for x, d in zip((q, k, v), in_dims)]
        o, lse = FlashAttention.apply(*folded, causal, scale, block_q, block_k)
        return (_unfold(o, n), _unfold(lse, n)), (0, 0)


class FlashAttentionBackward(torch.autograd.Function):
    """(dQ, dK, dV) as a function of its own, so that the backward, which
    ``torch.func.grad`` runs under the enclosing ``vmap``, folds the
    vmapped axis too and never hands the kernel a batched tensor. Not
    differentiable itself."""

    @staticmethod
    def forward(q, k, v, o, lse, g, causal, scale, block_k):
        return flash_backward(q, k, v, o, lse, g, causal, scale, block_k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, g, causal, scale, block_k):
        n = info.batch_size
        folded = [_fold(x, d, n) for x, d in zip((q, k, v, o, lse, g), in_dims)]
        grads = FlashAttentionBackward.apply(*folded, causal, scale, block_k)
        return tuple(_unfold(x, n) for x in grads), (0, 0, 0)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Flash attention, [B, T, H, D] layout. Differentiable, and
    vmappable under ``torch.func`` (grad included)."""
    return FlashAttention.apply(q, k, v, causal, scale, block_q, block_k)[0]
