"""The flash wrappers past their earlier limits: T past grid y's 65,535
tiles and head dims above 128 (the rows route).

The tensor-core kernels' launch grid folds tiles past grid y's 65,535
into grid x (``tile_grid``, the arithmetic of ``work_grid`` in
``csrc/hopper.cuh``): checked here on its invariants and, through a
Python mirror of the kernels' ``block_work`` at a small grid-y limit,
for handing every (batch x head, tile) to exactly one block. Head dims
129 to 512 dispatch to the rows route
(``csrc/flash_attention_rows.cu``), whose plain versions run on the CPU:
held here to the JAX Pallas kernel (interpret mode) and its ``_bwd``,
which take any D, and whose host arithmetic (padded head dim, grid z,
the warpgroups' shares of the head dim, the rings' shared memory, the
f32 scratch) is checked here. The kernels themselves run only on the
card (``chip_smoke.py``'s kernels phase holds them to their plain
versions at D 160 to 512 and at [8, 4096, 8, 256], checks that the built
library reports the same rings as ``rows_plan``, and runs the long
sequence at T 4,194,368). That long-sequence check's rule is rehearsed
here at a smaller T of the same row structure: right outputs pass it,
outputs zeroed or shifted by a tile in the late rows fail it.
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
PAD_ATOL = 1e-5


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
@pytest.mark.parametrize("D", [160, 192, 256, 384, 512])
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


# -- the rows route's host arithmetic (csrc/flash_attention_rows.cu) --------


@pytest.mark.parametrize("D, want", [(129, 192), (160, 192), (192, 192), (193, 256), (256, 256),
                                     (300, 320), (384, 384), (449, 512), (512, 512)])
def test_rows_head_dim_pads_to_a_multiple_of_64(D, want):
    assert tfa.rows_head_dim(D) == want


@pytest.mark.parametrize("D", [64, 128, 513, 1024])
def test_rows_head_dim_refuses_outside_129_to_512(D):
    with pytest.raises(ValueError, match="rows route's 129-512"):
        tfa.rows_head_dim(D)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [160, 192, 256, 320, 384, 448, 512])
def test_rows_shares_cover_every_chunk_and_unit_once(D, dtype):
    """Grid z holds four 64-column output units a block; in each block the
    two warpgroups split the head dim's S chunks (the whole head dim
    between them) and own up to two units each, so every unit of the
    padded head dim has exactly one owner."""
    dp = tfa.rows_head_dim(D)
    gx, gy, gz = tfa.rows_grid(3, 200, D)
    assert (gx, gy) == tfa.tile_grid(3, 200)
    assert gz == -(-dp // 256)
    chunk = 64 if dtype == torch.bfloat16 else 32
    units = []
    for z in range(gz):
        chunks = []
        for wg in (0, 1):
            c, u = tfa.rows_share(D, dtype, z, wg)
            assert len(c) >= 1 and len(u) <= 2
            chunks += list(c)
            units += list(u)
        assert chunks == list(range(dp // chunk))
    assert units == list(range(dp // 64))


# the design's rings: (stage bytes, stages a warpgroup) of each kernel
# (the bf16 forward's: a block's one ring, at each head dim it is built for)
RINGS = {
    (torch.bfloat16, "dkdv"): (8192, 4), (torch.bfloat16, "dq"): (8192, 4),
    (torch.float32, "fwd"): (32768, 3), (torch.float32, "dkdv"): (24576, 4),
    (torch.float32, "dq"): (24576, 4),
}
BF16_FWD_RINGS = {192: (24576, 7), 256: (32768, 5), 384: (24576, 5), 512: (32768, 3)}


@pytest.mark.parametrize("dtype, kernel", sorted(RINGS, key=str))
def test_rows_rings_fill_one_block_of_shared_memory(dtype, kernel):
    """Two rings (one a warpgroup), two exchange buffers (a warpgroup's
    partial S, and dP in the backward: 128 threads' f32 accumulators),
    bf16's resident tiles of the backward (K and V, or Q and dO, up to
    four 8 KB boxes each a warpgroup) and 1 KB of barriers fit the 227 KB
    a block may use, and one more stage would not; every stage starts on
    a 1024-byte swizzle boundary."""
    plan = tfa.rows_plan(dtype, kernel)
    stage, stages, x = plan["stage_bytes"], plan["stages"], plan["exchange_bytes"]
    res = 8 * 64 * 128 if dtype == torch.bfloat16 else 0
    assert (stage, stages) == RINGS[dtype, kernel]
    assert plan["smem_bytes"] == 2 * res + 2 * stages * stage + 2 * x + 1024 <= 232448
    assert 2 * res + 2 * (stages + 1) * stage + 2 * x + 1024 > 232448
    assert stages >= 3 and stage % 1024 == 0 and x % 1024 == 0
    rows = 64 if kernel == "fwd" else 32  # keys of a forward tile, a backward step's rows
    assert x == (1 if kernel == "fwd" else 2) * 64 * rows * 4


@pytest.mark.parametrize("D", [160, 192, 200, 256, 300, 384, 449, 512])
def test_rows_bf16_forward_shares_one_ring_with_q_resident(D):
    """The bf16 forward runs 128-query tiles at the next of 192, 256, 384
    and 512: Q resident (128 rows of the head dim), one ring of K tiles
    (64 keys, 32 above 256 columns) that both warpgroups read, grid z 1 up
    to 256 columns and 2 above (a block a half of O's columns)."""
    dp = tfa.rows_head_dim(D, bf16_forward=True)
    assert dp == min(d for d in (192, 256, 384, 512) if d >= D)
    plan = tfa.rows_plan(torch.bfloat16, "fwd", D)
    bk = 64 if dp <= 256 else 32
    assert (plan["stage_bytes"], plan["stages"]) == BF16_FWD_RINGS[dp]
    assert plan["stage_bytes"] == bk * dp * 2 and plan["resident_bytes"] == 128 * dp * 2
    assert plan["smem_bytes"] == plan["resident_bytes"] + plan["stages"] * plan["stage_bytes"] + 1024
    assert plan["smem_bytes"] <= 232448 < plan["smem_bytes"] + plan["stage_bytes"]
    gx, gy, gz = tfa.rows_grid(5, 1000, D, bf16_forward=True)
    assert (gx, gy) == tfa.tile_grid(5, 1000, 128) == (5, 8)
    assert gz == (1 if dp <= 256 else 2)


@pytest.mark.parametrize("D", [193, 200, 256])
def test_rows_bf16_backward_at_256_keeps_128_rows_resident(D):
    """The bf16 backward at a padded 256 (D 193-256) runs 128 rows a
    block: two resident [128, 256] bf16 tiles (K and V, or Q and dO) and
    one shared ring of [32, 256] tiles, in one block's shared memory; at
    other head dims it keeps the two-warpgroup split."""
    assert tfa.rows_head_dim(D) == 256
    for kernel in ("dkdv", "dq"):
        plan = tfa.rows_plan(torch.bfloat16, kernel, D)
        assert plan == {"stage_bytes": 32 * 256 * 2, "stages": 6,
                        "resident_bytes": 2 * 128 * 256 * 2, "smem_bytes": 230400}
        assert plan["smem_bytes"] + plan["stage_bytes"] > 232448
        assert tfa.rows_plan(torch.bfloat16, kernel, 192) == tfa.rows_plan(torch.bfloat16, kernel)


def test_rows_scratch_holds_the_f32_planes():
    """f32: hi and lo planes of Q, K (natural) and V (transposed, rows
    padded to 64) forward; Q, K, V, dO natural and Q, dO, K transposed
    backward. bf16 needs none."""
    B, T, H = 2, 100, 3
    n, nt = B * T * H * 192, B * H * 192 * 128
    assert tfa.rows_scratch(torch.float32, False, B, T, H, 160) == 4 * n + 2 * nt
    assert tfa.rows_scratch(torch.float32, True, B, T, H, 160) == 8 * n + 6 * nt
    assert tfa.rows_scratch(torch.bfloat16, True, B, T, H, 160) == 0
    with pytest.raises(ValueError, match="129-512"):
        tfa.rows_scratch(torch.float32, False, B, T, H, 520)


@pytest.mark.parametrize("D", [160, 200, 449])
def test_rows_padding_leaves_the_function_as_it_was(D):
    """The rows wrappers run a D-wide head zero-padded to rows_head_dim(D)
    and cut back: through the plain versions, the same O, lse and
    gradients as at D itself, to PAD_ATOL (the padded zeros add nothing,
    but the einsums block a wider sum otherwise: f32 rounding, measured
    1.3e-6 at D 449)."""
    rng = np.random.default_rng(D)
    q, k, v, g = (torch.tensor(rng.normal(size=(1, 24, 2, D)).astype(np.float32))
                  for _ in range(4))
    scale = D**-0.5
    o, lse = tfa.padded_forward(tfa.flash_attention_reference, q, k, v, True, scale,
                                head_dim=tfa.rows_head_dim)
    want_o, want_lse = tfa.flash_attention_reference(q, k, v, True, scale)
    assert o.shape == q.shape
    torch.testing.assert_close(o, want_o, atol=PAD_ATOL, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=PAD_ATOL, rtol=0)
    got = tfa.padded_backward(tfa.flash_attention_backward_reference, q, k, v, o, lse, g, True,
                              scale, head_dim=tfa.rows_head_dim)
    want = tfa.flash_attention_backward_reference(q, k, v, o, lse, g, True, scale)
    for a, b in zip(got, want):
        assert a.shape == q.shape
        torch.testing.assert_close(a, b, atol=PAD_ATOL, rtol=0)


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
    assert sorted(names) == ["rows_bwd_split_kernel", "rows_delta_kernel",
                             "rows_dkdv128_kernel", "rows_dkdv_wgmma_kernel",
                             "rows_dq128_kernel", "rows_dq_wgmma_kernel",
                             "rows_fwd_bf16_kernel", "rows_fwd_split_kernel",
                             "rows_fwd_wgmma_kernel"]
    for name in names:
        profiled = f"void (anonymous namespace)::{name}<float>(float const*)"
        want = "flash forward" if name.startswith("rows_fwd_") else "flash backward"
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
