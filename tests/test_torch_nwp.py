"""The next-token data path and loss against the JAX package's.

The Shakespeare-shaped stand-in's token streams, their partition, the
packed federation (int32 tokens), its masks and counts, and the global
and local views must be bitwise the JAX package's: they are numpy in
both. The token loss agrees to f32 rounding. Under ``hetero`` both
packages hand the LDA partition the [N, T] label matrix, so a sequence's
index repeats once per token of each class; the test pins that fault of
the reference at T 16 (ROADMAP.md §C).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.core.losses import token_cross_entropy as jax_token_ce
from fedml_tpu.data import load as jax_load
from fedml_tpu.data import synthetic as jax_synthetic
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.core.losses import LOSSES, token_cross_entropy
from fedml_tpu_torch.data import load, synthetic
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# f32 loss and metrics of the same logits: summation order only
LOSS_ATOL = 1e-6
SEQ_LEN, TRAIN_N, TEST_N, CLIENTS = 16, 48, 16, 4


@pytest.mark.parametrize("n, seq_len, vocab, seed", [(40, 16, 90, 0), (7, 33, 300, 5),
                                                     (2000, 12, 3001, 7), (9, 6, 1, 1)])
def test_synthetic_sequences_bitwise(n, seq_len, vocab, seed):
    want = jax_synthetic.synthetic_sequences(n, seq_len, vocab, seed)
    got = synthetic.synthetic_sequences(n, seq_len, vocab, seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype and g.shape == (n, seq_len)
    np.testing.assert_array_equal(got[0][:, 1:], got[1][:, :-1])  # y is x shifted


def _args(cls, dataset, method, **kw):
    a = cls()
    base = dict(dataset=dataset, seq_len=SEQ_LEN, synthetic_train_size=TRAIN_N,
                synthetic_test_size=TEST_N, client_num_in_total=CLIENTS,
                client_num_per_round=CLIENTS, batch_size=4, partition_method=method,
                partition_alpha=0.5, random_seed=2)
    base.update(kw)
    for k, v in base.items():
        setattr(a, k, v)
    a._validate()
    return a


def _assert_batches_equal(got, want):
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert got.x.dtype == torch.int32 and got.y.dtype == torch.int64


@pytest.mark.parametrize("dataset, method", [("shakespeare", "homo"),
                                             ("fed_shakespeare", "hetero")])
def test_nwp_standin_bitwise(dataset, method):
    want = jax_load(_args(JaxArguments, dataset, method))
    got = load(_args(Arguments, dataset, method), device="cpu")
    for split in ("packed_train", "packed_test", "train_data_global", "test_data_global"):
        _assert_batches_equal(getattr(got, split), getattr(want, split))
    np.testing.assert_array_equal(got.packed_num_samples, want.packed_num_samples)
    assert got.packed_num_samples.dtype == want.packed_num_samples.dtype
    for key in ("train_data_num", "test_data_num", "class_num", "client_num", "task",
                "train_data_local_num_dict"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.task == "nwp" and got.class_num == 90
    _assert_batches_equal(got.train_data_local_dict[1], want.train_data_local_dict[1])
    _assert_batches_equal(got.test_data_local_dict[3], want.test_data_local_dict[3])
    assert len(got.to_list()) == 8


def test_homo_gives_each_client_its_share():
    got = load(_args(Arguments, "shakespeare", "homo"), device="cpu")
    assert got.packed_num_samples.tolist() == [TRAIN_N / CLIENTS] * CLIENTS
    assert tuple(got.packed_train.x.shape) == (CLIENTS, 3, 4, SEQ_LEN)


def test_hetero_repeats_sequences_as_the_reference_does():
    """The reference's LDA partition takes the [N, T] labels, so
    ``np.where(labels == k)[0]`` repeats a sequence's index once per
    token of class k: 48 sequences of 16 tokens pack to 768 "samples"
    (each token of each sequence, once), where ``homo`` packs 48."""
    args = _args(Arguments, "shakespeare", "hetero")
    got = load(args, device="cpu")
    want = jax_load(_args(JaxArguments, "shakespeare", "hetero"))
    assert got.train_data_num == want.train_data_num == TRAIN_N * SEQ_LEN
    np.testing.assert_array_equal(got.packed_num_samples, want.packed_num_samples)


def _sequences(batches) -> set:
    """The real (unmasked) sequences of a packed split, as tuples."""
    x, mask = np.asarray(batches.x), np.asarray(batches.mask).astype(bool)
    return {tuple(row) for row in x[mask]}


def _unseen_bigram_share(train: np.ndarray, test: np.ndarray) -> float:
    """The share of the token bigrams of ``test`` that ``train`` never has."""
    def bigrams(x):
        return {(a, b) for row in x for a, b in zip(row[:-1], row[1:])}

    seen, wanted = bigrams(train), bigrams(test)
    return len(wanted - seen) / len(wanted)


def test_standin_test_split_comes_from_another_chain_as_the_reference_does():
    """Both packages draw the stand-in's train sequences from the Markov
    chain of ``seed`` and its test sequences from the chain of ``seed +
    1`` (``fedml_tpu/data/loader.py:469-470``). ``synthetic_sequences``
    draws its transition matrix from the seed, so the test split follows
    other transitions: 96% of its bigrams never occur in the train split,
    where test sequences from the train chain leave 40% unseen. The
    reference's fault, pinned (ROADMAP.md §C): nothing learned on the
    train split transfers to the test split."""
    seed = 2  # _args' random_seed
    x_tr, _ = synthetic.synthetic_sequences(TRAIN_N, SEQ_LEN, 90, seed)
    x_te, _ = synthetic.synthetic_sequences(TEST_N, SEQ_LEN, 90, seed + 1)
    for got in (load(_args(Arguments, "shakespeare", "homo"), device="cpu"),
                jax_load(_args(JaxArguments, "shakespeare", "homo"))):
        assert _sequences(got.train_data_global) == {tuple(r) for r in x_tr}
        assert _sequences(got.test_data_global) == {tuple(r) for r in x_te}
    assert _unseen_bigram_share(x_tr, x_te) > 0.9
    same_chain, _ = synthetic.synthetic_sequences(TRAIN_N + TEST_N, SEQ_LEN, 90, seed)
    assert _unseen_bigram_share(x_tr, same_chain[TRAIN_N:]) < 0.5


@pytest.mark.parametrize("per_token", [False, True])
def test_token_cross_entropy_matches_jax(per_token):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(5, 12, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(5, 12))
    mask = np.array([1, 1, 0, 1, 0], np.float32)
    if per_token:
        mask = (rng.random((5, 12)) > 0.3).astype(np.float32) * mask[:, None]
    want_loss, want = jax_token_ce(jnp.asarray(logits), jnp.asarray(labels, jnp.int32),
                                   jnp.asarray(mask))
    got_loss, got = token_cross_entropy(torch.tensor(logits), torch.tensor(labels),
                                        torch.tensor(mask))
    np.testing.assert_allclose(float(got_loss), float(want_loss), atol=LOSS_ATOL)
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_allclose(float(got[key]), float(want[key]), atol=LOSS_ATOL,
                                   err_msg=key)
    # counts are in tokens
    assert float(got["count"]) == float(np.broadcast_to(
        mask if per_token else mask[:, None], labels.shape).sum())
    assert LOSSES["nwp"] is token_cross_entropy
