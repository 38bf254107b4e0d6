"""The exact aggregation fold: the port against the JAX package, bitwise.

The JAX package folds uploads through a 3-limb float32 expansion with
Knuth two-sums (``_fold_tree``), pins its mesh aggregation the same way
(``exact_weighted_mean``) and streams uploads through
``StreamingAccumulator``. The port runs the same arithmetic through
``ops/exact_fold.py`` (a hand-written kernel on the card, the plain
version here). Every comparison below is bitwise: the term is rounded
once and every add of the fold is rounded on its own in both packages.
Inputs are seeded numpy with magnitudes spread over 2^-30..2^30 and exact
cancellations, handed to both packages.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core import aggregation as jagg
from fedml_tpu.scale import EdgeAggregationTree as JaxTree
from fedml_tpu_torch.core import aggregation as agg
from fedml_tpu_torch.ops import exact_fold
from fedml_tpu_torch.scale import EdgeAggregationTree
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

CSRC = Path(exact_fold.__file__).resolve().parent / "csrc"


def _spread(rng: np.random.RandomState, shape, cancel: bool = True) -> np.ndarray:
    """f32 values with exponents over [-30, 30] and random signs; with
    ``cancel`` a quarter of the entries of every other row negate the row
    before, so running sums cancel exactly."""
    m = rng.uniform(1.0, 2.0, shape)
    e = rng.randint(-30, 31, shape)
    x = (np.where(rng.rand(*shape) < 0.5, -1.0, 1.0) * m * np.exp2(e)).astype(np.float32)
    if cancel and len(shape) == 2 and shape[0] > 1:
        hit = rng.rand(*shape[1:]) < 0.25
        for r in range(1, shape[0], 2):
            x[r, hit] = -x[r - 1, hit]
    return x


def _same(a, b) -> bool:
    """Bitwise equality of two float arrays (NaN-free)."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_plain_fold_is_bitwise_the_references_fold_tree(k):
    rng = np.random.RandomState(k)
    n = 4099
    start = _spread(rng, (3, n), cancel=False)
    start[1] *= np.float32(2.0**-24)  # a lower limb below the top one's ulp
    start[2] *= np.float32(2.0**-48)
    terms = _spread(rng, (k, n))
    limbs = tuple({"w": jnp.asarray(start[i])} for i in range(3))
    for t in terms:
        limbs = jagg._fold_tree(limbs, {"w": jnp.asarray(t)})
    got = torch.tensor(start)
    agg._fold_tree(got, torch.tensor(terms))
    for i in range(3):
        assert _same(got[i].numpy(), limbs[i]["w"]), i


def test_one_launch_folds_k_terms_as_k_folds():
    rng = np.random.RandomState(7)
    terms = torch.tensor(_spread(rng, (3, 257)))
    one = torch.zeros(3, 257)
    exact_fold.fold(one, terms)
    each = torch.zeros(3, 257)
    for t in terms:
        exact_fold.fold(each, t)
    assert torch.equal(one, each)


@pytest.mark.parametrize("clients", [1, 3, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_weighted_mean_is_bitwise_the_references(clients, dtype):
    rng = np.random.RandomState(clients)
    leaves = {"w": _spread(rng, (clients, 13, 5)), "b": _spread(rng, (clients, 7)),
              "s": _spread(rng, (clients,))}
    w = rng.randint(1, 400, clients).astype(np.float32)
    w = w / w.sum()
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    want = jagg.exact_weighted_mean({k: jnp.asarray(v, jdt) for k, v in leaves.items()},
                                    jnp.asarray(w))
    got = agg.exact_weighted_mean({k: torch.tensor(v).to(tdt) for k, v in leaves.items()},
                                  torch.tensor(w))
    for k in leaves:
        assert got[k].dtype == tdt and tuple(got[k].shape) == leaves[k].shape[1:]
        assert _same(got[k].float().numpy(), np.asarray(want[k].astype(jnp.float32))), k


def _template(dtype: str):
    bf = dtype == "bfloat16"
    return (
        {"kernel": jnp.zeros((13, 5)), "bias": jnp.zeros((7,), jnp.bfloat16 if bf else jnp.float32)},
        {"kernel": torch.zeros(13, 5), "bias": torch.zeros(7, dtype=torch.bfloat16 if bf else
                                                           torch.float32)},
    )


def _uploads(n: int, seed: int = 3):
    rng = np.random.RandomState(seed)
    return [({"kernel": _spread(rng, (13, 5), cancel=False),
              "bias": _spread(rng, (7,), cancel=False)}, float(rng.randint(1, 300)))
            for _ in range(n)]


def _port_tree(theta: dict, like: dict) -> dict:
    return {k: torch.tensor(v).to(like[k].dtype) for k, v in theta.items()}


def _jax_tree(theta: dict, like: dict) -> dict:
    return {k: jnp.asarray(v, like[k].dtype) for k, v in theta.items()}


def _fold_all(acc, uploads, order, like, to_tree):
    for i in order:
        theta, w = uploads[i]
        acc.fold(to_tree(theta, like), w)
    return acc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_finalize_is_bitwise_the_references(dtype):
    jt, tt = _template(dtype)
    uploads = _uploads(12)
    order = list(range(12))
    want = _fold_all(jagg.StreamingAccumulator(jt), uploads, order, jt, _jax_tree).finalize()
    acc = _fold_all(agg.StreamingAccumulator(tt), uploads, order, tt, _port_tree)
    got = acc.finalize()
    for k in jt:
        assert got[k].dtype == tt[k].dtype
        assert _same(got[k].float().numpy(), np.asarray(want[k].astype(jnp.float32))), k
    # the limbs themselves, leaf by leaf, as both export them
    mine, ref = acc.export_state(), _fold_all(jagg.StreamingAccumulator(jt), uploads, order,
                                              jt, _jax_tree).export_state()
    assert mine["total_w"] == ref["total_w"] and mine["count"] == ref["count"] == 12
    for i in range(3):
        for k in jt:
            assert _same(mine["limbs"][i][k], ref["limbs"][i][k]), (i, k)


def test_stream_equals_buffered_in_any_order():
    _, tt = _template("float32")
    uploads = _uploads(16, seed=5)
    buffered = _fold_all(agg.StreamingAccumulator(tt), uploads, range(16), tt,
                         _port_tree).finalize()
    for seed in range(4):
        order = np.random.RandomState(seed).permutation(16)
        stream = _fold_all(agg.StreamingAccumulator(tt), uploads, order, tt,
                           _port_tree).finalize()
        for k in tt:
            assert _same(stream[k].numpy(), buffered[k].numpy()), (seed, k)


def test_export_load_merge_is_bitwise_a_live_merge():
    _, tt = _template("float32")
    uploads = _uploads(10, seed=9)
    edge = _fold_all(agg.StreamingAccumulator(tt), uploads, range(6), tt, _port_tree)
    live = _fold_all(agg.StreamingAccumulator(tt), uploads, range(6, 10), tt, _port_tree)
    shipped = _fold_all(agg.StreamingAccumulator(tt), uploads, range(6, 10), tt, _port_tree)
    shipped.merge(agg.StreamingAccumulator(tt).load_state(edge.export_state()))
    live.merge(edge)
    assert shipped.count == live.count == 10 and shipped.total_w == live.total_w
    assert torch.equal(shipped._limbs, live._limbs)
    flat = _fold_all(agg.StreamingAccumulator(tt), uploads, range(10), tt, _port_tree)
    a, b = live.finalize(), flat.finalize()
    assert all(_same(a[k].numpy(), b[k].numpy()) for k in tt)


def test_merge_and_fold_weighted_term_match_the_reference():
    jt, tt = _template("float32")
    uploads = _uploads(8, seed=11)
    rng = np.random.RandomState(12)
    partial = {"kernel": _spread(rng, (13, 5)), "bias": _spread(rng, (7,))}
    jroot, jedge = jagg.StreamingAccumulator(jt), jagg.StreamingAccumulator(jt)
    root, edge = agg.StreamingAccumulator(tt), agg.StreamingAccumulator(tt)
    _fold_all(jedge, uploads, range(8), jt, _jax_tree)
    _fold_all(edge, uploads, range(8), tt, _port_tree)
    jroot.fold_weighted_term(_jax_tree(partial, jt), 7.0)
    root.fold_weighted_term(_port_tree(partial, tt), 7.0)
    jroot.merge(jedge)
    root.merge(edge)
    want, got = jroot.finalize(), root.finalize()
    assert root.total_w == jroot.total_w and root.count == jroot.count == 9
    for k in jt:
        assert _same(got[k].numpy(), want[k]), k
    mean, jmean = root.running_mean(), jroot.running_mean()
    for k in jt:
        assert _same(mean[k].numpy(), jmean[k]), k
    # a flat [N] term folds as its params dict does
    flat = agg.StreamingAccumulator(tt)
    flat.fold_weighted_term(flat._spec.flatten(_port_tree(partial, tt)), 7.0)
    solo = agg.StreamingAccumulator(tt)
    solo.fold_weighted_term(_port_tree(partial, tt), 7.0)
    assert torch.equal(flat._limbs, solo._limbs)


def test_the_references_errors():
    _, tt = _template("float32")
    acc = agg.StreamingAccumulator(tt)
    assert acc.running_mean() is None
    with pytest.raises(RuntimeError, match="no folded uploads"):
        acc.finalize()
    state = acc.export_state()
    with pytest.raises(ValueError, match="edge fold state carries 2 limbs, expected 3"):
        acc.load_state(dict(state, limbs=state["limbs"][:2]))
    with pytest.raises(ValueError, match="expected a 3-limb expansion, got 2"):
        acc.fold_limbs(state["limbs"][:2], 1.0)
    with pytest.raises(ValueError, match=r"count=-1: a limb-set represents >= 0 uploads"):
        acc.fold_limbs(state["limbs"], 1.0, count=-1)
    # the encoded and clipped folds refuse what they cannot decode or flatten
    for name in ("fold_encoded", "fold_encoded_delta"):
        with pytest.raises(ValueError, match="want an Int8Codec or a TopKCodec"):
            getattr(acc, name)(None, None, None, 1.0)
    for name in ("fold_encoded_clipped", "fold_encoded_delta_clipped"):
        with pytest.raises(ValueError, match="want an Int8Codec or a TopKCodec"):
            getattr(acc, name)(None, None, None, 1.0, 1.0)
    with pytest.raises(ValueError, match="tree holds"):
        acc.fold_clipped({"nope": torch.zeros(1)}, tt, 1.0, 1.0)
    with pytest.raises(ValueError, match="tree holds"):
        acc.fold_delta_clipped({"nope": torch.zeros(1)}, 1.0, 1.0)
    assert acc.count == 0
    with pytest.raises(ValueError, match="staleness must be >= 0"):
        agg.staleness_weight(10, -1, 0.5)
    assert agg.staleness_weight(10, 2, 0.5) == jagg.staleness_weight(10, 2, 0.5) == 2.5


def test_empty_limb_set_merges_as_a_no_op():
    _, tt = _template("float32")
    acc = _fold_all(agg.StreamingAccumulator(tt), _uploads(3), range(3), tt, _port_tree)
    before = acc._limbs.clone()
    acc.merge(agg.StreamingAccumulator(tt))
    assert torch.equal(acc._limbs, before) and acc.count == 3


def test_cpu_tensors_take_the_plain_version_and_the_kernel_refuses_them():
    kernels = (exact_fold.FOLD_KERNEL, exact_fold.MEAN_KERNEL)
    for kernel in kernels:
        kernel.reset_launches()
    limbs, x = torch.zeros(3, 8), torch.ones(2, 8)
    exact_fold.fold(limbs, x)
    assert exact_fold.weighted_mean(x, torch.tensor([0.25, 0.75])).tolist() == [1.0] * 8
    exact_fold.fold_edges(torch.zeros(2, 3, 8), x, 0b11)
    exact_fold.fold_set(limbs, x.reshape(2, 1, 8), 0b10)
    assert all(kernel.launches == 0 for kernel in kernels)
    with pytest.raises(ValueError, match="one CUDA device"):
        exact_fold.FOLD_KERNEL(limbs, x.reshape(1, 2, 8), 1)
    with pytest.raises(ValueError, match="one CUDA device"):
        exact_fold.FOLD_KERNEL(torch.zeros(2, 3, 8), x, 1, per_edge=True)
    with pytest.raises(ValueError, match="one CUDA device"):
        exact_fold.MEAN_KERNEL(x, torch.ones(2))


# -- one launch a group, one for the root merge ---------------------------
def _edge_case(seed: int, edges: int = 5, n: int = 1031):
    rng = np.random.RandomState(seed)
    start = np.stack([_spread(rng, (3, n), cancel=False) for _ in range(edges)])
    start[:, 1] *= np.float32(2.0**-24)
    start[:, 2] *= np.float32(2.0**-48)
    return torch.tensor(start), torch.tensor(_spread(rng, (edges, n)))


@pytest.mark.parametrize("mask", [0b11111, 0b10110, 0b00001, 0])
def test_edge_fold_is_bitwise_a_fold_per_edge_and_skips_the_unmasked(mask):
    start, terms = _edge_case(mask)
    got = start.clone()
    exact_fold.fold_edges(got, terms, mask)
    for e in range(terms.shape[0]):
        want = start[e].clone()
        if mask >> e & 1:
            exact_fold.fold(want, terms[e])
        assert torch.equal(got[e], want), e
    assert exact_fold.edge_mask(e for e in range(5) if mask >> e & 1) == mask


@pytest.mark.parametrize("rows", [1, 3])
def test_set_fold_is_bitwise_the_folds_of_its_rows_in_edge_order(rows):
    start, _ = _edge_case(11, edges=1)
    src, _ = _edge_case(12 + rows)  # [E, 3, N]: a tree's limbs
    src = src[:, :rows]
    mask = 0b11011
    got = start[0].clone()
    exact_fold.fold_set(got, src, mask)
    want = start[0].clone()
    for e in range(src.shape[0]):
        if mask >> e & 1:
            for r in range(rows):
                exact_fold.fold(want, src[e, r])
    assert torch.equal(got, want)


def test_root_merge_in_one_launch_is_bitwise_a_merge_per_edge():
    _, tt = _template("float32")
    uploads = _uploads(9, seed=21)
    tree, bank = EdgeAggregationTree(tt, 4), agg.AccumulatorBank(tt, 4)
    edges = [agg.StreamingAccumulator(tt) for _ in range(4)]
    for i, (theta, w) in enumerate(uploads):
        if i % 4 == 2:  # edge 2 stays empty: the merge skips it
            continue
        for acc in (tree.acc_for(i), bank[i % 4], edges[i % 4]):
            acc.fold(_port_tree(theta, tt), w)
    one = agg.StreamingAccumulator(tt)
    assert bank.merge_into(one) == 3
    each = agg.StreamingAccumulator(tt)
    for acc in edges:
        if acc.count:
            each.merge(acc)
    assert torch.equal(one._limbs, each._limbs)
    assert (one.total_w, one.count) == (each.total_w, each.count)
    got, want = tree.finalize(), each.finalize()
    assert all(torch.equal(got[k], want[k]) for k in tt)


def test_group_folds_in_one_launch_are_bitwise_the_folds_per_edge():
    _, tt = _template("float32")
    rng = np.random.RandomState(31)
    tree, flat = EdgeAggregationTree(tt, 4), agg.StreamingAccumulator(tt)
    ref_tree, ref_flat = EdgeAggregationTree(tt, 4), agg.StreamingAccumulator(tt)
    jtree, jflat = JaxTree(_template("float32")[0], 4), jagg.StreamingAccumulator(
        _template("float32")[0])
    spec = flat._spec
    for group in range(3):
        terms = torch.tensor(_spread(rng, (4, spec.numel)))
        weights = [float(rng.randint(1, 500)) for _ in range(4)]
        weights[group] = 0.0  # an edge with no client in this group
        assert tree.fold_edge_terms(terms, weights) == 3
        assert flat.fold_weighted_terms(terms, weights) == 3
        for e, w in enumerate(weights):
            if w > 0.0:
                ref_tree.acc(e).fold_weighted_term(terms[e], w)
                ref_flat.fold_weighted_term(terms[e], w)
                leaf = {k: jnp.asarray(v.numpy()) for k, v in spec.views(terms[e]).items()}
                jtree.acc(e).fold_weighted_term(leaf, w)
                jflat.fold_weighted_term(leaf, w)
    assert all(torch.equal(tree.acc(e)._limbs, ref_tree.acc(e)._limbs) for e in range(4))
    assert torch.equal(flat._limbs, ref_flat._limbs)
    assert [tree.acc(e).total_w for e in range(4)] == [ref_tree.acc(e).total_w for e in range(4)]
    assert (flat.total_w, flat.count) == (ref_flat.total_w, ref_flat.count) == (
        jflat.total_w, jflat.count)
    got, want, flat_out = tree.finalize(), jtree.finalize(), flat.finalize()
    for k in tt:  # tree == flat, both bitwise the JAX package's
        assert _same(got[k].numpy(), want[k]) and _same(flat_out[k].numpy(), jflat.finalize()[k])
        assert torch.equal(got[k], flat_out[k]), k


def test_view_backed_edges_reset_and_load_in_place():
    _, tt = _template("float32")
    uploads = _uploads(6, seed=41)
    tree = EdgeAggregationTree(tt, 3)
    shared = tree._edges._limbs  # the bank's [E, 3, N] buffer
    storage = shared.data_ptr()
    for i, (theta, w) in enumerate(uploads):
        tree.acc_for(i).fold(_port_tree(theta, tt), w)
    state = tree.acc(1).export_state()
    want = tree.finalize()
    tree.reset()
    assert tree.count == 0 and not shared.any() and shared.data_ptr() == storage
    assert all(tree.acc(e)._limbs.data_ptr() == storage + e * shared[0].numel() * 4
               for e in range(3))
    # round trip: an edge restored from its export lands in the shared buffer
    for i, (theta, w) in enumerate(uploads):
        if i % 3 != 1:
            tree.acc_for(i).fold(_port_tree(theta, tt), w)
    tree.acc(1).load_state(state)
    assert shared.data_ptr() == storage and tree.acc(1).count == 2
    assert torch.equal(shared[1], tree.acc(1)._limbs)
    got = tree.finalize()
    assert all(torch.equal(got[k], want[k]) for k in tt)
    with pytest.raises(ValueError, match="want float32"):
        agg.StreamingAccumulator(tt, limbs=torch.zeros(3, 5))


def test_the_kernel_source_rounds_every_float_operation_on_its_own():
    """nvcc contracts ``a + b * c`` into an FMA unless every operation is
    an explicitly rounded intrinsic: the fold's arithmetic lines carry no
    bare float ``+``, ``-`` or ``*``."""
    text = (CSRC / "exact_fold.cu").read_text()
    body = text[text.index("namespace {"):text.index("int blocks_for")]
    for fn in ("two_sum", "fold_one"):
        src = re.search(rf"void {fn}\(.*?\n}}", body, re.S).group(0)
        code = src[src.index("{"):]
        assert "__fadd_rn" in code and not re.search(r"[^_\w](s|v|a|b|e|t)\s*[-+*]\s*\w", code)
    assert "__fmul_rn(wr, v[j])" in body and "__fadd_rn(__fadd_rn(s0[j], s1[j]), s2[j])" in body
