"""The encoded and clipped terms of the exact fold, and K3's plain version.

Each of the six per-upload terms (``w * (g + delta * s)`` and the
delta-only forms, over raw, int8 and top-k uploads) against the JAX
package's term executables on the same inputs: within 1e-6 of the term's
largest magnitude (f32; XLA may contract ``g + d * s`` into an FMA where
the port rounds each step, and the norms are reduced in another order),
the norms within 1e-6 relative, the clip flags equal. Within the port,
bitwise: K3's plain version against the same formula in numpy f32 (one
rounding a step, in the kernel's order), every encoded and clipped fold
streamed in shuffled orders against the buffered order, and an edge tree
against the flat fold, for int8 uploads among them (the port of
``tests/test_planet_scale.py::test_tree_identical_to_flat_int8``). On the
CPU the wrapper takes the plain version and launches nothing.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core import aggregation as jagg
from fedml_tpu.core import compression as jcomp
from fedml_tpu_torch.core import aggregation as agg
from fedml_tpu_torch.core import compression as comp
from fedml_tpu_torch.ops import robust_term as rt
from fedml_tpu_torch.scale import EdgeAggregationTree
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = {"a_conv": (6, 3, 3), "b_bias": (6,), "c_dense": (33, 7), "d_out": (5,)}
TERM_TOL = 1e-6


def _tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _flat_j(tree):
    return np.concatenate([np.asarray(tree[k]).reshape(-1) for k in SHAPES])


def _close(got: torch.Tensor, want, tol=TERM_TOL):
    want = np.asarray(want, dtype=np.float32)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def _spec():
    return agg._FlatSpec(_t(_tree(0)))


def _codecs(ratio=0.3):
    return {"int8": (comp.Int8Codec(), jcomp.Int8Codec()),
            "topk": (comp.TopKCodec(ratio), jcomp.TopKCodec(ratio))}


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_the_encoded_terms_are_the_references(codec):
    port, ref = _codecs()[codec]
    g, delta = _tree(1), _tree(2, 0.3)
    enc, jenc = port.encode(_t(delta)), ref.encode(_j(delta))
    spec = _spec()
    for w in (1.0, 37.0, 0.25):
        _close(agg._weighted_term_encoded(spec, port, enc, _t(g), w),
               _flat_j(jagg._weighted_term_encoded(ref, jenc, _j(g), jnp.float32(w))))
        _close(agg._weighted_term_decoded(spec, port, enc, w),
               _flat_j(jagg._weighted_term_decoded(ref, jenc, _j(g), jnp.float32(w))))


@pytest.mark.parametrize("bound", [0.5, 3.0, 1e3])
def test_the_clipped_terms_are_the_references(bound):
    g, theta, delta = _tree(1), _tree(3), _tree(4, 0.2)
    spec = _spec()
    for w in (1.0, 12.0):
        term, norm = agg._weighted_term_clipped(spec, _t(theta), _t(g), bound, w)
        jterm, jnorm, jclip = jagg._weighted_term_clipped(_j(theta), _j(g), jnp.float32(bound),
                                                          jnp.float32(w))
        _close(term, _flat_j(jterm))
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=TERM_TOL)
        assert (float(norm) > bound) == bool(jclip)
        term, norm = agg._weighted_delta_term_clipped(spec, _t(delta), bound, w)
        jterm, jnorm, _ = jagg._weighted_delta_term_clipped(_j(delta), jnp.float32(bound),
                                                            jnp.float32(w))
        _close(term, _flat_j(jterm))
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=TERM_TOL)


@pytest.mark.parametrize("codec", ["int8", "topk"])
@pytest.mark.parametrize("bound", [0.5, 1e3])
def test_the_encoded_clipped_terms_are_the_references(codec, bound):
    port, ref = _codecs()[codec]
    g, delta = _tree(1), _tree(5, 0.4)
    enc, jenc = port.encode(_t(delta)), ref.encode(_j(delta))
    spec = _spec()
    w = 9.0
    term, norm = agg._weighted_term_encoded_clipped(spec, port, enc, _t(g), bound, w)
    jterm, jnorm, jclip = jagg._weighted_term_encoded_clipped(
        ref, jenc, _j(g), jnp.float32(bound), jnp.float32(w))
    _close(term, _flat_j(jterm))
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=TERM_TOL)
    assert (float(norm) > bound) == bool(jclip)
    term, norm = agg._weighted_delta_term_decoded_clipped(spec, port, enc, bound, w)
    jterm, jnorm, _ = jagg._weighted_delta_term_decoded_clipped(
        ref, jenc, _j(g), jnp.float32(bound), jnp.float32(w))
    _close(term, _flat_j(jterm))
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=TERM_TOL)


def _f32(x):
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("mode", ["clip", "clipped term", "delta clipped", "delta",
                                  "int8 encoded", "int8 encoded clipped", "int8 delta clipped"])
def test_the_plain_version_is_the_formula_one_rounding_a_step(mode):
    """numpy f32 rounds each operation on its own: the kernel's order,
    d (the clip's theta - g, or q * scale); d * s; g + .; w * ."""
    rng = np.random.RandomState(7)
    R, N, L = 3, 41, 4
    theta, g = _f32(rng.normal(size=(R, N))), _f32(rng.normal(size=N))
    s, w = _f32(rng.rand(R)), _f32(rng.rand(R) * 50)
    q = rng.randint(-127, 128, (R, N)).astype(np.int8)
    off = np.array([0, 5, 6, 30, N], np.int64)
    sc = _f32(rng.rand(R, L) * 0.1)
    scale = np.repeat(sc, np.diff(off), axis=1)
    d = {"clip": theta - g, "clipped term": theta - g, "delta clipped": theta, "delta": theta,
         "int8 encoded": q.astype(np.float32) * scale}
    d["int8 encoded clipped"] = d["int8 delta clipped"] = d["int8 encoded"]
    want = d[mode]
    if "clip" in mode:
        want = want * s[:, None]
    if mode in ("clip", "clipped term", "int8 encoded", "int8 encoded clipped"):
        want = g + want
    if mode != "clip":
        want = w[:, None] * want
    kw = dict(s=torch.tensor(s) if "clip" in mode else None,
              w=None if mode == "clip" else torch.tensor(w))
    if mode.startswith("int8"):
        kw.update(src=torch.tensor(q), leaf_scales=torch.tensor(sc), leaf_offsets=torch.tensor(off),
                  add_g="delta" not in mode, g=torch.tensor(g))
    else:
        kw.update(src=torch.tensor(d[mode]), g=torch.tensor(g),
                  add_g=mode in ("clip", "clipped term"))
    before = rt.TERM_KERNEL.launches
    got = rt.robust_term(**kw)
    assert rt.TERM_KERNEL.launches == before == 0
    assert np.array_equal(got.numpy().view(np.int32), _f32(want).view(np.int32))


def test_the_kernel_refuses_cpu_tensors_and_bad_operands():
    src = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="one CUDA device"):
        rt.TERM_KERNEL(src, w=torch.ones(2))
    assert rt.TERM_KERNEL.launches == 0
    with pytest.raises(ValueError, match="float64; the kernel takes"):
        rt.TERM_KERNEL(src.double())
    with pytest.raises(ValueError, match="an int8 source needs"):
        rt.robust_term(src.to(torch.int8))
    with pytest.raises(ValueError, match="g must be"):
        rt.robust_term(src, add_g=True)
    with pytest.raises(ValueError, match="want torch.float32 \\[2\\]"):
        rt.robust_term(src, s=torch.ones(3))
    with pytest.raises(ValueError, match="from 0 to 8"):
        rt.robust_term(src.to(torch.int8), leaf_scales=torch.ones(2, 1),
                       leaf_offsets=torch.tensor([0, 7]))
    with pytest.raises(ValueError, match="want an Int8Codec or a TopKCodec"):
        agg.StreamingAccumulator(_t(_tree(0))).fold_encoded(object(), {}, _t(_tree(0)), 1.0)
    with pytest.raises(ValueError, match="payload holds"):
        agg.StreamingAccumulator(_t(_tree(0))).fold_encoded(comp.Int8Codec(), {}, _t(_tree(0)), 1.0)


def test_the_kernel_source_rounds_every_float_operation_on_its_own():
    """The elementwise steps of K3 are explicitly rounded intrinsics, in
    the plain version's order, never a bare float ``+``, ``-`` or ``*``
    that nvcc could contract into an FMA."""
    text = (Path(rt.__file__).resolve().parent / "csrc" / "robust_term.cu").read_text()
    body = text[text.index("namespace {"):text.index("bool aligned(")]
    term = re.search(r"float term\(.*?\n}", body, re.S).group(0)
    assert ["__fmul_rn(d, sr)", "__fadd_rn(gv, d)", "__fmul_rn(wr, d)"] == re.findall(
        r"__f\w+_rn\(\w+, \w+\)", term)
    assert "__fsub_rn" not in body
    assert body.count("__fmul_rn(static_cast<float>(") == 2
    for line in body.splitlines():
        code = line.split("//")[0]
        if re.search(r"\b(d|gv|sr|wr)(\[j\])?\s*[-+*]\s*\w", code):
            pytest.fail(f"bare float operation in K3: {line.strip()}")


# -- stream == buffered and tree == flat, within the port -------------------


def _uploads(n=9, seed=11):
    rng = np.random.RandomState(seed)
    g = _tree(100)
    thetas = [{k: v + _f32(rng.normal(size=v.shape) * rng.choice([0.05, 2.0]))
               for k, v in g.items()} for _ in range(n)]
    weights = [float(w) for w in rng.randint(1, 300, n)]
    return g, thetas, weights


def _fold_all(acc_for, kind, g, thetas, weights, order, bound=1.5):
    gt = _t(g)
    for i in order:
        theta, w = _t(thetas[i]), weights[i]
        delta = {k: theta[k] - gt[k] for k in gt}
        acc = acc_for(i)
        if kind == "raw":
            acc.fold(theta, w)
        elif kind == "clipped":
            acc.fold_clipped(theta, gt, bound, w)
        elif kind == "delta clipped":
            acc.fold_delta_clipped(delta, bound, w)
        else:
            codec_name, variant = kind.split(" ", 1)
            codec = comp.Int8Codec() if codec_name == "int8" else comp.TopKCodec(0.4)
            enc = codec.encode(delta)
            if variant == "encoded":
                acc.fold_encoded(codec, enc, gt, w)
            elif variant == "delta":
                acc.fold_encoded_delta(codec, enc, gt, w)
            elif variant == "encoded clipped":
                acc.fold_encoded_clipped(codec, enc, gt, bound, w)
            else:
                acc.fold_encoded_delta_clipped(codec, enc, gt, bound, w)


FOLDS = ["raw", "clipped", "delta clipped", "int8 encoded", "int8 delta",
         "int8 encoded clipped", "int8 delta clipped", "topk encoded", "topk delta",
         "topk encoded clipped", "topk delta clipped"]


def _bits(tree):
    return {k: v.numpy().view(np.int32).copy() for k, v in tree.items()}


@pytest.mark.parametrize("kind", FOLDS)
def test_stream_equals_buffered_and_tree_equals_flat_bitwise(kind):
    g, thetas, weights = _uploads()
    n = len(thetas)
    buffered = agg.StreamingAccumulator(_t(g))
    _fold_all(lambda i: buffered, kind, g, thetas, weights, range(n))
    want = _bits(buffered.finalize())
    for seed in (1, 2):
        order = np.random.RandomState(seed).permutation(n)
        stream = agg.StreamingAccumulator(_t(g))
        _fold_all(lambda i: stream, kind, g, thetas, weights, order)
        got = _bits(stream.finalize())
        assert all(np.array_equal(got[k], want[k]) for k in want), (kind, seed)
        tree = EdgeAggregationTree(_t(g), 4)
        _fold_all(tree.acc_for, kind, g, thetas, weights, order)
        assert tree.count == n
        got = _bits(tree.finalize())
        assert all(np.array_equal(got[k], want[k]) for k in want), (kind, "tree", seed)


@pytest.mark.parametrize("kind", ["clipped", "int8 encoded clipped", "topk encoded clipped"])
def test_a_clipped_fold_reports_the_norm_and_bounds_the_delta(kind):
    g, thetas, weights = _uploads(4)
    bound = 1.5
    for i in range(4):
        acc = agg.StreamingAccumulator(_t(g))
        gt, theta = _t(g), _t(thetas[i])
        delta = {k: theta[k] - gt[k] for k in gt}
        if kind == "clipped":
            norm, clipped = acc.fold_clipped(theta, gt, bound, 1.0)
            want_norm = float(agg.global_norm(delta))
        else:
            codec = comp.Int8Codec() if kind.startswith("int8") else comp.TopKCodec(0.4)
            enc = codec.encode(delta)
            norm, clipped = acc.fold_encoded_clipped(codec, enc, gt, bound, 1.0)
            want_norm = float(agg.global_norm(comp.decode_delta(codec, enc, gt)))
        assert norm == want_norm and clipped == (norm > bound)
        out = acc.finalize()
        moved = float(agg.global_norm({k: out[k] - gt[k] for k in gt}))
        assert moved <= min(norm, bound) * (1 + 1e-6)


# -- the operands' layout and the int8 norm ---------------------------------


def test_the_int8_norm_is_the_decoded_deltas_norm_without_decoding():
    """``||d||^2 = sum_l scale_l^2 * sum q^2`` over the leaves (exact
    integer sums), against the norm of the decoded delta in float64, an
    empty leaf among them."""
    shapes = dict(SHAPES, e_empty=(0,), f_last=(3, 4))
    rng = np.random.RandomState(12)
    tree = {k: torch.tensor(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    spec = agg._FlatSpec(tree)
    enc = comp.Int8Codec().encode(tree)
    src, scales = agg._payload(spec, comp.Int8Codec(), enc)
    decoded = torch.cat([enc[k]["q"].reshape(-1).double() * float(enc[k]["scale"]) for k in shapes])
    got = agg._payload_norm(spec, src, scales)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(decoded.norm()), rtol=1e-7)


def test_operands_off_16_bytes_are_copied_onto_them_and_rows_of_one_are_not():
    on = rt._on_16_bytes
    packed = torch.arange(30.0).reshape(3, 10)  # rows 40 bytes apart
    moved = on(packed)
    assert moved.stride(0) == 12 and torch.equal(moved, packed)
    assert on(moved) is moved
    one = packed[:1]
    assert on(one) is one
    off = torch.arange(12.0)[1:9]  # 4 bytes past the allocation
    assert on(off) is not off and on(off).data_ptr() % 16 == 0 and torch.equal(on(off), off)


def test_the_clip_lays_out_its_deltas_in_one_pass_bitwise_the_difference():
    g, thetas, _ = _uploads(n=5)
    stacked = {k: torch.stack([torch.tensor(t[k]) for t in thetas]) for k in SHAPES}
    spec = agg._FlatSpec(_t(g))
    gf = spec.flatten(_t(g))
    delta = spec.flatten_stacked(stacked, minus=gf)
    assert delta.stride(0) % 4 == 0
    assert torch.equal(delta, spec.flatten_stacked(stacked) - gf)
