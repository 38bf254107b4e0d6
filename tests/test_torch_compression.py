"""Uplink compression: the port's codecs against the JAX package's.

The int8 codec's ``q`` and ``scale`` are bitwise the JAX package's
(``torch.round`` and ``jnp.round`` both round half to even), an all-zero
leaf included, and so are its decodes. Top-k is compared on distinct
magnitudes: there the kept indices, values and decoded deltas are the
same. On tied magnitudes ``jax.lax.top_k`` keeps the lower index and
``torch.topk`` promises no order, so the port keeps k coordinates of the
largest magnitude, not necessarily the same ones. The trees are dicts
in sorted key order, the order in which the JAX package flattens them.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core import compression as jcomp
from fedml_tpu_torch.core import compression as comp
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _tree(seed, zero_leaf=False, halves=False):
    """A sorted-key dict of f32 leaves; ``halves`` puts values on exact
    .5 quantization steps so round-half-to-even decides them."""
    rng = np.random.RandomState(seed)
    out = {"a_conv": rng.normal(size=(4, 3, 3)).astype(np.float32),
           "b_bias": rng.normal(size=(7,)).astype(np.float32) * 1e-3,
           "c_dense": rng.normal(size=(11, 5)).astype(np.float32) * 40}
    if halves:
        out["c_dense"] = (np.round(rng.normal(size=(11, 5)) * 20) + 0.5).astype(np.float32)
        out["c_dense"][0, 0] = 127.0
    if zero_leaf:
        out["b_bias"] = np.zeros((7,), np.float32)
    return out


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _bitwise(a, b):
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("kw", [dict(), dict(zero_leaf=True), dict(halves=True)])
@pytest.mark.parametrize("seed", [0, 1])
def test_int8_is_bitwise_the_references(seed, kw):
    tree = _tree(seed, **kw)
    got = comp.Int8Codec.encode(_t(tree))
    want = jcomp.Int8Codec.encode(_j(tree))
    for k in tree:
        assert got[k]["q"].dtype == torch.int8 and got[k]["scale"].dtype == torch.float32
        _bitwise(got[k]["q"].numpy(), want[k]["q"])
        _bitwise(got[k]["scale"].numpy(), want[k]["scale"])
    dec, jdec = comp.Int8Codec.decode(got), jcomp.Int8Codec.decode(want)
    for k in tree:
        _bitwise(dec[k].numpy(), jdec[k])
    if kw.get("zero_leaf"):
        assert float(got["b_bias"]["scale"]) == 0.0 and not dec["b_bias"].any()


@pytest.mark.parametrize("ratio", [0.05, 0.3, 1.0])
def test_topk_on_distinct_magnitudes_is_the_references(ratio):
    tree = _tree(2)
    codec, jcodec = comp.TopKCodec(ratio), jcomp.TopKCodec(ratio)
    got, want = codec.encode(_t(tree)), jcodec.encode(_j(tree))
    assert got["idx"].dtype == torch.int32
    order = np.argsort(got["idx"].numpy())
    jorder = np.argsort(np.asarray(want["idx"]))
    np.testing.assert_array_equal(got["idx"].numpy()[order], np.asarray(want["idx"])[jorder])
    _bitwise(got["val"].numpy()[order], np.asarray(want["val"])[jorder])
    like_t, like_j = _t(tree), _j(tree)
    dec, jdec = codec.decode(got, like_t), jcodec.decode(want, like_j)
    for k in tree:
        _bitwise(dec[k].numpy(), jdec[k])
    for k, v in comp.reconstruct_from_encoded(codec, got, like_t).items():
        _bitwise(v.numpy(), jcomp.reconstruct_from_encoded(jcodec, want, like_j)[k])


def test_topk_ties_keep_k_coordinates_of_the_largest_magnitude():
    """The tie rule: both keep k coordinates whose magnitude is the k
    largest; which of several equal ones is not promised by torch."""
    x = {"w": torch.tensor([1.0, -3.0, 3.0, 2.0, 3.0, -3.0])}
    enc = comp.TopKCodec(0.5).encode(x)
    assert len(enc["idx"]) == 3 and set(enc["val"].abs().tolist()) == {3.0}
    jenc = jcomp.TopKCodec(0.5).encode({"w": jnp.asarray(x["w"].numpy())})
    assert sorted(np.asarray(jenc["idx"]).tolist()) == [1, 2, 4]  # JAX: the lower indices


def test_error_feedback_is_the_references_over_rounds():
    codec, jcodec = comp.TopKCodec(0.1), jcomp.TopKCodec(0.1)
    state, jstate = comp.EncoderState(codec), jcomp.EncoderState(jcodec)
    for r in range(3):
        delta = _tree(10 + r)
        got, want = state.encode(_t(delta)), jstate.encode(_j(delta))
        order, jorder = np.argsort(got["idx"].numpy()), np.argsort(np.asarray(want["idx"]))
        np.testing.assert_array_equal(got["idx"].numpy()[order], np.asarray(want["idx"])[jorder])
        _bitwise(got["val"].numpy()[order], np.asarray(want["val"])[jorder])
        for k in delta:
            _bitwise(state.residual[k].numpy(), jstate.residual[k])
    int8 = comp.EncoderState(comp.Int8Codec())
    int8.encode(_t(_tree(0)))
    assert int8.residual is None


def test_dispatch_matching_and_sizes_are_the_references():
    class A:
        compression = "none"
        compression_topk_ratio = 0.25

    a = A()
    assert comp.make_codec(a) is None
    for kind, cls in (("int8", comp.Int8Codec), ("topk", comp.TopKCodec)):
        a.compression = kind
        assert isinstance(comp.make_codec(a), cls)
    assert comp.make_codec(a).ratio == 0.25
    a.compression = "zstd"
    with pytest.raises(ValueError, match="unknown compression 'zstd'"):
        comp.make_codec(a)
    with pytest.raises(ValueError, match=r"topk ratio must be in \(0, 1\]"):
        comp.TopKCodec(0.0)
    tree = _tree(4)
    i8, topk = comp.Int8Codec.encode(_t(tree)), comp.TopKCodec(0.2).encode(_t(tree))
    j8, jtopk = jcomp.Int8Codec.encode(_j(tree)), jcomp.TopKCodec(0.2).encode(_j(tree))
    for codec, jcodec in ((comp.Int8Codec(), jcomp.Int8Codec()),
                          (comp.TopKCodec(0.2), jcomp.TopKCodec(0.2))):
        for enc, jenc in ((i8, j8), (topk, jtopk), (dict(topk, meta=1), dict(jtopk, meta=1))):
            assert comp.payload_matches_codec(codec, enc) == \
                jcomp.payload_matches_codec(jcodec, jenc)
    assert comp.encoded_nbytes(i8) == jcomp.encoded_nbytes(j8)
    assert comp.encoded_nbytes(topk) == jcomp.encoded_nbytes(jtopk)
    assert comp.payload_matches_codec(None, i8) is False
