"""Per-client keyed synthetic features: a hand-written Hopper kernel and its plain version.

The registry path synthesizes each cohort group's features on the device
(``fedml_tpu/data/synthetic.py:150-225``, XLA-generated there):
``x[c, s] = means[y[c, s]] + sigma * noise[c, s]``, where the noise of
sample ``s`` of client ``c`` is a function of (the client's seed, ``s``)
alone. A device generator cannot give that (``torch.randn`` draws by
the tensor's offset, so a client's noise would move with its slot), so
the noise comes from a counter-based generator keyed per element:
Philox4x32-10 with key ``(seed, 0)`` and counter ``(s, d // 4, 0, 0)``,
its four words turned into four normals by two Box-Muller pairs (the
source, ``csrc/synth_features.cu``, states the formula). The bits are
the port's own, not ``jax.random``'s threefry.

``SYNTH_KERNEL`` writes a group's ``[C, S, dim]`` features in one launch,
one (client, sample) row per thread group with rows on the grid's x
dimension (``check_shape``: up to 2^31 - 1 rows); it is bound by the
bytes it writes where its instructions a Philox block allow. ``synth_features_reference`` is the
plain version: the same Philox in int64 tensor ops (each 32-bit product
split into 16-bit halves, so nothing overflows) and the same Box-Muller,
one float op at a time; its integer words are bitwise the kernel's, its
features agree to the rounding of ``log``, ``sin`` and ``cos``.
``WORDS_KERNEL`` returns the kernel's raw words, for that comparison.

Dispatch follows the tensors' device: CPU tensors take the plain
version; CUDA tensors launch the kernel or raise. Each launch of the
features kernel adds one to ``SYNTH_KERNEL.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = [
    "SYNTH_KERNEL",
    "WORDS_KERNEL",
    "box_muller",
    "check_shape",
    "philox4x32_10",
    "philox_words_reference",
    "synth_features",
    "synth_features_reference",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_TWO_PI_F32 = float(torch.tensor(2 * math.pi, dtype=torch.float32))
# the kernels' grid: one (client, sample) row per thread group, rows
# indexed in 32 bits on the grid's x dimension; a row's dim blocks of 4
# counted in a 32-bit int
MAX_ROWS = 2**31 - 1
MAX_DIM = 2**31 - 4


# -- the plain version ---------------------------------------------------
def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of ``a * m`` for int64 tensors holding uint32
    values; partial products of 16-bit halves stay below 2^34."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    ll, lh, hl, hh = a_lo * m_lo, a_lo * m_hi, a_hi * m_lo, a_hi * m_hi
    mid = lh + hl + (ll >> 16)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = (hh + (mid >> 16)) & _MASK32
    return hi, lo


def philox4x32_10(ctr, key):
    """Philox4x32-10 on int64 tensors holding uint32 values (broadcast
    against each other): ``ctr`` four words, ``key`` two; returns the four
    output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_words_reference(seeds: torch.Tensor, samples: int, blocks4: int) -> torch.Tensor:
    """``[C, samples, blocks4, 4]`` int64 words (uint32 values): counter
    ``(s, j, 0, 0)``, key ``(seeds[c], 0)``."""
    dev = seeds.device
    s = torch.arange(samples, dtype=torch.int64, device=dev).reshape(1, -1, 1)
    j = torch.arange(blocks4, dtype=torch.int64, device=dev).reshape(1, 1, -1)
    k0 = (seeds.to(torch.int64) & _MASK32).reshape(-1, 1, 1)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    shape = (seeds.shape[0], samples, blocks4)
    words = philox4x32_10((s, j, zero, zero), (k0, zero))
    return torch.stack([w.expand(shape) for w in words], dim=-1)


def box_muller(a: torch.Tensor, b: torch.Tensor):
    """Two normals from two words, one float op at a time: u in (0, 1],
    v in [0, 1), r = sqrt(-2 ln u), (r cos 2 pi v, r sin 2 pi v)."""
    scale = 2.0**-24
    u = ((a >> 8) + 1).to(torch.float32) * scale
    v = (b >> 8).to(torch.float32) * scale
    r = torch.sqrt(torch.log(u) * -2.0)
    theta = v * torch.tensor(_TWO_PI_F32, dtype=torch.float32, device=v.device)
    return r * torch.cos(theta), r * torch.sin(theta)


def synth_features_reference(y: torch.Tensor, means: torch.Tensor, seeds: torch.Tensor,
                             sigma: float, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version: ``y`` ``[C, S]`` labels, ``means`` ``[classes,
    dim]`` f32, ``seeds`` ``[C]`` (uint32 values) -> ``[C, S, dim]``."""
    C, S = y.shape
    dim = means.shape[1]
    blocks4 = -(-dim // 4)
    w = philox_words_reference(seeds, S, blocks4)
    n0, n1 = box_muller(w[..., 0], w[..., 1])
    n2, n3 = box_muller(w[..., 2], w[..., 3])
    noise = torch.stack([n0, n1, n2, n3], dim=-1).reshape(C, S, 4 * blocks4)[..., :dim]
    sig = torch.tensor(sigma, dtype=torch.float32, device=y.device)
    return (means[y] + noise * sig).to(dtype)


# -- the kernel ----------------------------------------------------------
def check_shape(clients: int, samples: int, dim: int, name: str = "synth_features") -> None:
    """Raises unless the kernels take ``[clients, samples, dim]``: at most
    ``MAX_ROWS`` (client, sample) rows and ``MAX_DIM`` dims."""
    if clients * samples > MAX_ROWS:
        raise ValueError(f"{name}: {clients} x {samples} = {clients * samples} rows exceed the "
                         f"kernel's {MAX_ROWS}")
    if dim > MAX_DIM:
        raise ValueError(f"{name}: dim {dim} exceeds the kernel's {MAX_DIM}")


def _seeds_i64(seeds: torch.Tensor) -> torch.Tensor:
    """Seeds as the kernels read them: contiguous int64, whose low 32 bits
    are the key (no launch for the int64 seeds the path holds)."""
    return seeds.to(torch.int64).contiguous()


class SynthFeaturesKernel(_build.Kernel):
    """``synth_features``: y ``[C, S]`` int64, means ``[classes, dim]`` f32,
    seeds ``[C]`` -> features ``[C, S, dim]`` (f32 or bf16)."""

    name = "synth_features"
    error_string = "synth_features_error_string"
    argtypes = ((ctypes.c_void_p,) * 3 + (ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p))

    def __call__(self, y, means, seeds, sigma: float, dtype=torch.float32) -> torch.Tensor:
        device = _build.cuda_device(self.name, y=y, means=means, seeds=seeds)
        if (y.dim() != 2 or y.dtype != torch.int64 or means.dim() != 2
                or means.dtype != torch.float32 or tuple(seeds.shape) != (y.shape[0],)
                or dtype not in _DTYPE_CODES):
            raise ValueError(
                f"{self.name}: y {y.dtype} {tuple(y.shape)}, means {means.dtype} "
                f"{tuple(means.shape)}, seeds {tuple(seeds.shape)}, out {dtype}; want int64 "
                "[C, S], float32 [classes, dim], [C] and float32 or bfloat16"
            )
        C, S = y.shape
        dim = means.shape[1]
        check_shape(C, S, dim, self.name)
        out = torch.empty((C, S, dim), dtype=dtype, device=device)
        if out.numel():
            y, means, seeds = y.contiguous(), means.contiguous(), _seeds_i64(seeds)
            self._launch(device, y.data_ptr(), means.data_ptr(), seeds.data_ptr(),
                         float(sigma), out.data_ptr(), C, S, dim, _DTYPE_CODES[dtype])
        return out


class PhiloxWordsKernel(_build.Kernel):
    """``synth_philox_words``: the words ``synth_features`` draws, ``[C, S,
    blocks4, 4]`` int64 (uint32 values); a check, not a path."""

    name = "synth_philox_words"
    library = "synth_features"
    error_string = "synth_features_error_string"
    argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_void_p)

    def __call__(self, seeds: torch.Tensor, samples: int, blocks4: int) -> torch.Tensor:
        device = _build.cuda_device(self.name, seeds=seeds)
        check_shape(seeds.shape[0], samples, 4 * blocks4, self.name)
        out = torch.empty((seeds.shape[0], samples, blocks4, 4), dtype=torch.int32, device=device)
        if out.numel():
            self._launch(device, _seeds_i64(seeds).data_ptr(), out.data_ptr(), seeds.shape[0],
                         samples, blocks4)
        return out.to(torch.int64) & _MASK32


SYNTH_KERNEL = SynthFeaturesKernel()
WORDS_KERNEL = PhiloxWordsKernel()


def synth_features(y: torch.Tensor, means: torch.Tensor, seeds: torch.Tensor, sigma: float,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Features ``[C, S, dim]`` for labels ``y`` ``[C, S]``: the kernel for
    CUDA tensors, the plain version for CPU ones."""
    if y.is_cuda or means.is_cuda or seeds.is_cuda:
        return SYNTH_KERNEL(y, means, seeds, sigma, dtype)
    return synth_features_reference(y, means, seeds, sigma, dtype)
