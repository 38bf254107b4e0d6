"""The port's round pipeline (``fedml_tpu_torch/core/round_pipeline.py``).

The port of ``tests/test_round_pipeline.py``'s contract: the bucketing
helpers are bitwise the JAX package's; a bucket-padded cohort trains to
the exact cohort's params; K=4 rounds in flight end bitwise equal to
K=1, with and without a round-indexed LR schedule; the deferred-metrics
ring fetches once per flush; and between flushes the hot loop copies
nothing from a tensor to the host.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fedml_tpu.core import bucketing as jax_bucketing
from fedml_tpu.core.tracking import DeferredMetrics as JaxDeferredMetrics
import fedml_tpu_torch
from fedml_tpu_torch import models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.core.bucketing import bucket_cohort, pad_cohort_idx
from fedml_tpu_torch.core.tracking import DeferredMetrics
from fedml_tpu_torch.data import load
from fedml_tpu_torch.simulation import FedAvgAPI
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# padded and exact cohorts run the same per-client arithmetic; only the
# aggregation's f32 sums see extra zero terms
PADDED_ATOL = 1e-6


def _api(depth=1, **kw):
    base = dict(dataset="mnist", synthetic_train_size=240, synthetic_test_size=60,
                model="lr", partition_method="hetero", client_num_in_total=6,
                client_num_per_round=4, comm_round=5, epochs=1, batch_size=20,
                learning_rate=0.1, frequency_of_the_test=2, shuffle=False,
                pipeline_depth=depth, log_metrics=False)
    base.update(kw)
    args = Arguments()
    for k, v in base.items():
        setattr(args, k, v)
    args._validate()
    args = fedml_tpu_torch.init(args)
    ds = load(args, device="cpu")
    return FedAvgAPI(args, "cpu", ds, models.create(args, ds.class_num, device="cpu"))


def _det_history(api):
    """History minus the wall-clock keys."""
    return [{k: v for k, v in h.items() if k not in ("round_time_s", "train_time_s")}
            for h in api.history]


@pytest.mark.parametrize("policy", ["pow2", "exact"])
@pytest.mark.parametrize("shard_multiple", [1, 2, 3])
@pytest.mark.parametrize("max_size", [None, 6, 16, 100])
def test_bucket_cohort_bitwise_the_reference(policy, shard_multiple, max_size):
    for n in range(0, 70):
        got = bucket_cohort(n, policy, max_size=max_size, shard_multiple=shard_multiple)
        want = jax_bucketing.bucket_cohort(n, policy, max_size=max_size,
                                           shard_multiple=shard_multiple)
        assert got == want, (n, policy, max_size, shard_multiple)
    with pytest.raises(ValueError, match="pipeline_bucket"):
        bucket_cohort(6, policy="bogus")


def test_pad_cohort_idx_bitwise_the_reference():
    rng = np.random.default_rng(0)
    for n in (1, 3, 4, 10, 17):
        idx = rng.permutation(100)[:n].astype(np.int32)
        for bucket in {n, bucket_cohort(n), 32}:
            got, got_valid = pad_cohort_idx(idx, bucket)
            want, want_valid = jax_bucketing.pad_cohort_idx(idx, bucket)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got_valid, want_valid)
            assert got.dtype == want.dtype and got_valid.dtype == want_valid.dtype


@pytest.mark.parametrize("shuffle", [False, True])
def test_padded_bucket_matches_exact_cohort(shuffle):
    """3 clients padded to a bucket of 4 train to the exact cohort's
    params. With the shuffle on too: only the real clients draw."""
    out = {}
    for policy in ("pow2", "exact"):
        api = _api(client_num_in_total=8, client_num_per_round=3, comm_round=3,
                   pipeline_bucket=policy, shuffle=shuffle)
        api.train()
        out[policy] = api
    assert out["pow2"].pipeline_stats["bucket"] == 4
    assert out["exact"].pipeline_stats["bucket"] == 3
    for k, v in out["exact"].global_params.items():
        np.testing.assert_allclose(out["pow2"].global_params[k].numpy(), v.numpy(),
                                   atol=PADDED_ATOL, err_msg=k)
    for hp, he in zip(out["pow2"].history, out["exact"].history):
        assert hp["cohort_samples"] == he["cohort_samples"]


@pytest.mark.parametrize("schedule", [{}, dict(lr_schedule="cosine", lr_total_rounds=6)])
@pytest.mark.parametrize("model", ["lr", "cnn"])
def test_k4_bit_identical_to_k1(model, schedule):
    """Shuffled, 4 of 6 clients, with and without a round-indexed LR
    schedule: the same draws and multipliers reach the same rounds."""
    kw = dict(comm_round=6, shuffle=True, momentum=0.9, **schedule)
    if model == "cnn":
        kw.update(model="cnn", dataset="femnist", synthetic_train_size=180)
    apis = {}
    for depth in (1, 4):
        apis[depth] = _api(depth, **kw)
        apis[depth].train()
    for k, v in apis[1].global_params.items():
        assert torch.equal(apis[4].global_params[k], v), k
    assert _det_history(apis[1]) == _det_history(apis[4])
    assert apis[4].pipeline_stats["depth"] == 4
    assert apis[1].pipeline_stats["depth"] == 1


def test_depth_1_flushes_every_record_at_its_round():
    api = _api(comm_round=5, frequency_of_the_test=2)
    api.train()
    stats = api.pipeline_stats
    assert [h["round"] for h in api.history] == [0, 2, 4]
    assert stats["flushes"] == stats["host_syncs"] == 3
    for h in api.history:
        assert h["round_time_s"] >= h["train_time_s"] > 0


def test_deferred_metrics_ring_contract():
    """The reference's ring contract, on both rings side by side."""
    import jax.numpy as jnp

    for ring, scalar in ((DeferredMetrics(), torch.tensor),
                         (JaxDeferredMetrics(), jnp.float32)):
        ring.push(0, {"a": scalar(1.0)})
        ring.push(2, {"a": scalar(2.0)})
        ring.push(4, {"a": scalar(3.0)})
        out = ring.flush(upto=2)
        assert [r for r, _ in out] == [0, 2]
        assert [float(t["a"]) for _, t in out] == [1.0, 2.0]
        assert len(ring) == 1 and ring.host_syncs == 1
        assert ring.flush(upto=1) == []  # nothing ready: no fetch
        assert ring.host_syncs == 1
        out = ring.flush(None)  # drain
        assert [r for r, _ in out] == [4] and ring.host_syncs == 2
        assert ring.host_syncs == ring.flushes


def test_deferred_metrics_keep_nesting_and_precision():
    ring = DeferredMetrics()
    ring.push(0, {"summed": {"loss_sum": torch.tensor(1 / 3, dtype=torch.float64)},
                  "train": {"count": torch.tensor(7.0)}})
    (r, host), = ring.flush()
    assert r == 0 and host == {"summed": {"loss_sum": 1 / 3}, "train": {"count": 7.0}}


def test_no_fetch_outside_a_flush(monkeypatch):
    """Every copy from a tensor to the host during a K=4 run happens
    inside a deferred-metrics flush, one per flush: ``tolist``,
    ``item``, ``__float__``/``__int__``/``__bool__`` and ``numpy`` are
    counted outside and inside flushes."""
    api = _api(depth=4, comm_round=8, frequency_of_the_test=2, shuffle=True)
    in_flush, stray, inside = [False], [], [0]
    real_flush = DeferredMetrics.flush

    def flagged_flush(self, upto=None):
        in_flush[0] = True
        try:
            return real_flush(self, upto)
        finally:
            in_flush[0] = False

    def counting(name):
        real = getattr(torch.Tensor, name)

        def method(self, *a, **kw):
            if in_flush[0]:
                inside[0] += 1
            else:
                stray.append(name)
            return real(self, *a, **kw)

        return method

    monkeypatch.setattr(DeferredMetrics, "flush", flagged_flush)
    for name in ("tolist", "item", "__float__", "__int__", "__bool__", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, counting(name))
    api.train()
    monkeypatch.undo()
    stats = api.pipeline_stats
    assert stray == [], f"host copies outside a flush: {stray}"
    assert inside[0] == stats["flushes"] == stats["host_syncs"]
    assert stats["host_syncs_per_round"] < 1.0
    assert [h["round"] for h in api.history] == [0, 2, 4, 6, 7]


def test_run_simulation_at_depth_2():
    args = Arguments()
    for k, v in dict(dataset="mnist", synthetic_train_size=240, synthetic_test_size=60,
                     model="lr", client_num_in_total=6, client_num_per_round=3,
                     comm_round=3, batch_size=20, frequency_of_the_test=1,
                     pipeline_depth=2).items():
        setattr(args, k, v)
    args._validate()
    stats = fedml_tpu_torch.run_simulation(device="cpu", args=args)
    assert stats["round"] == 2
    with pytest.raises(ValueError, match="pipeline_bucket"):
        args.pipeline_bucket = "pow3"
        args._validate()
