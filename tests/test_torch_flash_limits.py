"""The flash wrappers past their earlier limits: T past grid y's 65,535
tiles and head dims above 128 (the rows route).

The tensor-core kernels' launch grid folds tiles past grid y's 65,535
into grid x (``tile_grid``, the arithmetic of ``work_grid`` in
``csrc/hopper.cuh``): checked here on its invariants and, through a
Python mirror of the kernels' ``block_work`` at a small grid-y limit,
for handing every (batch x head, tile) to exactly one block. Head dims
129 to 512 dispatch to the rows route (``csrc/flash_attention_rows.cu``),
whose plain versions run on the CPU: held here to the JAX Pallas kernel
(interpret mode) and its ``_bwd``, which take any D. The kernels
themselves run only on the card (``chip_smoke.py``'s kernels phase holds
them to their plain versions at D 192 and 256, and the long sequence at
T 4,194,368). That long-sequence check's rule is rehearsed here at a
smaller T of the same row structure: right outputs pass it, outputs
zeroed or shifted by a tile in the late rows fail it.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops.flash_attention import _bwd, _fwd
from fedml_tpu_torch.ops import flash_attention as tfa
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 2e-5
GRAD_ATOL = 5e-4


def _block_work(lin, gx, gy, n_bh, n_tiles, head_group=16):
    """The kernels' ``block_work``: (bh, rank) of linear block ``lin``,
    or None past the work."""
    del gy
    if lin >= n_bh * n_tiles:
        return None
    g0 = lin // (head_group * n_tiles) * head_group
    size = min(head_group, n_bh - g0)
    r = lin - g0 * n_tiles
    return g0 + r % size, r // size


@pytest.mark.parametrize("bh, T", [(1, 4096), (256, 4096), (1, 64 * 65535),
                                   (1, 64 * 65535 + 1), (1, 64 * 65536 + 64), (7, 64 * 200000),
                                   (3, 64 * 65535 * 3 + 5)])
def test_tile_grid_folds_tiles_past_grid_y(bh, T):
    x, y = tfa.tile_grid(bh, T)
    tiles = -(-T // 64)
    assert y <= 65535 and x % bh == 0
    fold = x // bh
    assert fold == -(-tiles // 65535)  # the least fold that fits
    assert x * y >= bh * tiles > x * (y - 1)  # under one row of blocks left over
    if tiles <= 65535:
        assert (x, y) == (bh, tiles)  # the grid as before


@pytest.mark.parametrize("bh, tiles, limit", [(3, 12, 5), (20, 7, 3), (1, 10, 4), (17, 9, 9)])
def test_block_work_hands_out_every_tile_once_on_a_folded_grid(bh, tiles, limit, monkeypatch):
    monkeypatch.setattr(tfa, "_GRID_Y", limit)
    gx, gy = tfa.tile_grid(bh, tiles * 64)
    assert gy <= limit
    got = [_block_work(lin, gx, gy, bh, tiles) for lin in range(gx * gy)]
    work = [w for w in got if w is not None]
    assert sorted(work) == [(b, r) for b in range(bh) for r in range(tiles)]
    assert all(w is None for w in got[bh * tiles:])  # the leftover blocks return


def test_check_shape_takes_long_sequences_and_wide_heads():
    tfa.check_shape((1, 64 * 65536 + 64, 1, 16), torch.bfloat16)
    for D in (129, 192, 256, 384, 512):
        tfa.check_shape((2, 128, 4, D), torch.float32)
    with pytest.raises(ValueError, match="rows route's 129-512"):
        tfa.check_shape((2, 128, 4, 513), torch.float32)


@pytest.mark.parametrize("D", [513, 640])
def test_head_dims_above_512_raise_with_the_limit(D):
    q = torch.zeros((1, 16, 1, D))
    with pytest.raises(ValueError, match="limit of 512"):
        tfa.flash_attention(q, q, q)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [160, 192, 256])
def test_head_dims_above_128_take_the_rows_route(D, causal):
    """A D above 128 routes to the rows kernels (a D up to 128 to the
    tensor-core ones), and the wrappers compute the JAX kernel's O and
    lse and ``_bwd``'s gradients at that D (on the CPU, through the plain
    versions every D takes there)."""
    assert tfa._route_head_dim(D) and not tfa._route_head_dim(128)
    rng = np.random.default_rng(D)
    B, T, H = 2, 32, 2
    q, k, v, g = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(4))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o, lse = tfa.flash_forward(tq, tk, tv, causal, None, 16, 16)
    grads = torch.autograd.grad(tfa.flash_attention(tq, tk, tv, causal, None, 16, 16),
                                (tq, tk, tv), torch.tensor(g))
    want_o, res = _fwd(*(jnp.asarray(x) for x in (q, k, v)), causal, None, 16, 16)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(res[4]), atol=ATOL)
    for got, want in zip(grads, _bwd(causal, None, 16, 16, res, jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_ATOL)


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_kinds", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def test_every_rows_kernel_counts_as_its_flash_kind():
    """The rows route's ``__global__`` kernels land in chip_smoke.py's
    flash forward and backward kinds, under the name the profiler gives
    them."""
    chip_smoke = _chip_smoke()
    text = (Path(tfa.__file__).resolve().parent / "csrc" / "flash_attention_rows.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                       text)
    assert sorted(names) == ["rows_dkdv_kernel", "rows_dq_kernel", "rows_fwd_kernel"]
    for name in names:
        profiled = f"void (anonymous namespace)::{name}<float, 8>(float const*)"
        want = "flash forward" if name == "rows_fwd_kernel" else "flash backward"
        assert chip_smoke.kernel_kind(profiled, chip_smoke.TRANSFORMER_KINDS) == want, name


def _long_case(cs, tiles: int):
    """chip_smoke's long-sequence rows moved to T = 64 * tiles + 64, and
    bf16 inputs with outputs as a right kernel gives them there: exact
    (float64) values rounded once to bf16 at the rows the check reads."""
    T = 64 * tiles + 64
    cs.LONG_T = T
    cs.LONG_LATE_ROWS = (64 * (tiles - 1) + 5, 64 * tiles + 17, T - 64, T - 1)
    cs.LONG_QUERY_ROWS = cs.LONG_EARLY_ROWS + cs.LONG_LATE_ROWS
    cs.LONG_KEY_ROWS = (64 * (tiles - 1) + 3, T - 64, T - 1)
    gen = torch.Generator().manual_seed(3)
    q, k, v, g = (torch.randn((1, T, 1, 16), generator=gen).to(torch.bfloat16) for _ in range(4))
    scale = 0.25
    qd, kd, vd, gd = (x[0, :, 0].double() for x in (q, k, v, g))
    late = {r - 64 for r in cs.LONG_LATE_ROWS} | set(cs.LONG_QUERY_ROWS)
    o = torch.zeros(T, 16, dtype=torch.float64)
    lse = torch.zeros(T, dtype=torch.float64)
    for i in sorted(late | set(range(min(cs.LONG_KEY_ROWS), T))):
        s = (kd[:i + 1] @ qd[i]) * scale
        lse[i] = torch.logsumexp(s, 0)
        o[i] = torch.exp(s - lse[i]) @ vd[:i + 1]
    o = o.to(torch.bfloat16)
    of = o.double()
    dq, dk, dv = (torch.zeros(T, 16, dtype=torch.float64) for _ in range(3))
    for i in late:
        p = torch.exp((kd[:i + 1] @ qd[i]) * scale - lse[i])
        dq[i] = (p * (vd[:i + 1] @ gd[i] - gd[i] @ of[i]) * scale) @ kd[:i + 1]
    for j in cs.LONG_KEY_ROWS:
        p = torch.exp((qd[j:] @ kd[j]) * scale - lse[j:])
        dk[j] = (p * (gd[j:] @ vd[j] - (gd[j:] * of[j:]).sum(-1)) * scale) @ qd[j:]
        dv[j] = p @ gd[j:]
    outs = {"o": o, "dq": dq, "dk": dk, "dv": dv}
    outs = {name: x.to(torch.bfloat16)[None, :, None] for name, x in outs.items()}
    return (q, k, v, g), outs, lse.float()[None, None], scale


@pytest.mark.parametrize("fault", [None, "o zeroed", "o shifted", "dq zeroed", "dq shifted",
                                   "dk zeroed", "dv zeroed"])
def test_long_sequence_check_fails_faults_in_the_late_rows(fault):
    """chip_smoke.py's ``long_sequence_shares`` at T 8,256 (the late rows'
    |O| ~ 2e-2): a right output stays within its tolerance, and a late
    row (query rows past the early ones, or the last key) left at zero
    or read one tile early fails it."""
    cs = _chip_smoke()
    (q, k, v, g), outs, lse, scale = _long_case(cs, 128)
    if fault is not None:
        name, how = fault.split()
        rows = cs.LONG_LATE_ROWS if name in ("o", "dq") else cs.LONG_KEY_ROWS[-1:]
        x = outs[name].clone()
        for r in rows:
            x[0, r, 0] = 0.0 if how == "zeroed" else outs[name][0, r - 64, 0]
        outs[name] = x
    shares, lse_err = cs.long_sequence_shares(q, k, v, g, outs["o"], lse, outs["dq"],
                                              outs["dk"], outs["dv"], scale)
    assert lse_err <= cs.LONG_LSE_ATOL
    if fault is None:
        assert max(shares.values()) <= 0.5, shares  # bf16 rounding: about 0.15
    else:
        assert shares[fault.split()[0]] > 1.0, shares
