"""The port's serving plane (``fedml_tpu_torch.serving``) against the JAX
package's, on the CPU.

A paused burst of requests through the port's ``ServingEngine`` answers
as the JAX ``ServingEngine`` does on the same rows and weights (the
slice end to end, flash attention included); the shared bucketing is
bitwise the JAX module's; shedding, swap checks and the device rule
hold.
"""

from __future__ import annotations

import time

import jax
import numpy as np
import pytest
import torch

from fedml_tpu import models as jax_models
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.core import bucketing as jax_bucketing
from fedml_tpu.serving import ModelEndpoint as JaxEndpoint
from fedml_tpu.serving import ServingEngine as JaxEngine
from fedml_tpu_torch import device as torch_device
from fedml_tpu_torch import models as torch_models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.core import bucketing, devtime
from fedml_tpu_torch.core.telemetry import Telemetry
from fedml_tpu_torch.serving import (
    DeadlineExceededError,
    ModelEndpoint,
    QueueFullError,
    ServingEngine,
    ServingShedError,
)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

VOCAB, T = 40, 32
# both engines compute in f32 from the same weights; answers differ by
# summation order only
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    Telemetry.reset()
    devtime.reset()
    yield
    Telemetry.reset()
    devtime.reset()


def _args(cls, **kw):
    a = cls()
    a.model = "transformer"
    a.vocab_size, a.embed_dim, a.num_heads = VOCAB, 32, 2
    a.num_layers, a.seq_len, a.max_len = 1, T, T
    a.attention_impl = "flash"
    a.serve_max_batch = 8
    for k, v in kw.items():
        setattr(a, k, v)
    a._validate()
    return a


def _port_endpoint(**kw):
    args = _args(Arguments, **kw)
    model = torch_models.create(args, 10, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return args, ModelEndpoint(model, params)


def _burst(engine, rows, timeout=60):
    engine.pause()
    futs = engine.submit_many(list(rows), deadline_s=30.0)
    engine.resume()
    return np.stack([f.result(timeout=timeout) for f in futs])


def test_paused_burst_answers_as_the_jax_engine():
    jargs = _args(JaxArguments)
    jmodel = jax_models.create(jargs, 10)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    rows = np.random.default_rng(5).integers(0, VOCAB, size=(3, T))
    with JaxEngine(JaxEndpoint(jmodel, jparams), jargs) as jeng:
        want = _burst(jeng, rows)

    targs = _args(Arguments)
    tmodel = torch_models.create(targs, 10, device="cpu")
    params = params_from_flax(jax.tree.map(np.asarray, jparams))
    with ServingEngine(ModelEndpoint(tmodel, params), targs) as teng:
        got = _burst(teng, rows)
        tel = teng.telemetry
    assert got.shape == want.shape == (3, T, VOCAB)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # three requests, one micro-batch padded to the pow2 bucket 4
    assert tel.get_counter("serving_requests_total") == 3
    assert tel.get_counter("serving_batches_total", bucket=4) == 1
    ring = devtime.ring_snapshot()
    assert [(e["executable"], e["bucket"]) for e in ring] == [("serving.forward", "b4")]
    # the same flight-recorder spans as the JAX engine's timeline
    events = {(e["name"], e["ph"]) for e in tel.recorder.tail()}
    assert {("serve.batch", "B"), ("serve.batch", "E"),
            ("exec.serving.forward", "B"), ("exec.serving.forward", "E")} <= events


@pytest.mark.parametrize("policy", ["pow2", "exact"])
def test_bucketing_is_bitwise_the_jax_module(policy):
    rng = np.random.default_rng(7)
    for n in range(0, 70):
        for max_size in (None, 8, 64):
            for shard in (1, 2, 3):
                want = jax_bucketing.bucket_cohort(n, policy, max_size, shard)
                assert bucketing.bucket_cohort(n, policy, max_size, shard) == want
    for n, bucket in ((3, 4), (5, 8), (8, 8), (1, 16)):
        xs = rng.integers(0, 100, size=(n, 6))
        for got, want in zip(bucketing.pad_batch(xs, bucket),
                             jax_bucketing.pad_batch(xs, bucket)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
        idx = rng.integers(0, 50, size=n)
        for got, want in zip(bucketing.pad_cohort_idx(idx, bucket),
                             jax_bucketing.pad_cohort_idx(idx, bucket)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError):
        bucketing.pad_batch(np.zeros((3, 2)), 2)


def test_queue_full_sheds_typed():
    args, ep = _port_endpoint(serve_queue_size=2)
    eng = ServingEngine(ep, args)  # not started: nothing drains the queue
    row = np.zeros(T, np.int64)
    futs = [eng.submit(row, deadline_s=30.0) for _ in range(3)]
    with pytest.raises(QueueFullError):
        futs[2].result(timeout=5)
    assert eng.telemetry.get_counter("serving_shed_total", reason="queue_full") == 1
    eng.stop()  # fails what is still queued, typed
    for f in futs[:2]:
        with pytest.raises(ServingShedError, match="stopped"):
            f.result(timeout=5)


def test_deadline_sheds_typed():
    args, ep = _port_endpoint()
    with ServingEngine(ep, args) as eng:
        eng.pause()
        late = eng.submit(np.zeros(T, np.int64), deadline_s=0.001)
        live = eng.submit(np.ones(T, np.int64), deadline_s=30.0)
        time.sleep(0.05)
        eng.resume()
        with pytest.raises(DeadlineExceededError):
            late.result(timeout=30)
        assert live.result(timeout=30).shape == (T, VOCAB)
        assert eng.telemetry.get_counter("serving_shed_total", reason="deadline") == 1


def test_submit_rejects_bad_rows():
    args, ep = _port_endpoint()
    eng = ServingEngine(ep, args)
    with pytest.raises(ValueError, match="example shape"):
        eng.submit(np.zeros(T + 1, np.int64))
    with pytest.raises(ValueError, match="ids in"):
        eng.submit(np.full(T, VOCAB, np.int64))
    eng.stop()


def test_swap_rejects_changed_shape_dtype_or_keys():
    args, ep = _port_endpoint()
    params = {k: v.clone() for k, v in ep.params().items()}
    key = "Block_0/Dense_0/weight"
    bad_shape = dict(params, **{key: params[key][:-1]})
    bad_dtype = dict(params, **{key: params[key].double()})
    missing = {k: v for k, v in params.items() if k != key}
    for bad in (bad_shape, bad_dtype, missing):
        with pytest.raises(ValueError, match="hot swap rejected"):
            ep.swap(bad)
    assert ep.version == 0 and ep.swaps == 0
    assert ep.swap({k: v + 1 for k, v in params.items()}) == 1
    assert ep.swap(params, version=7) == 7


def test_hot_swap_changes_answers_and_version():
    args, ep = _port_endpoint()
    rows = np.random.default_rng(9).integers(0, VOCAB, size=(2, T))
    fresh = ep.model.init(torch.Generator().manual_seed(1))
    with ServingEngine(ep, args) as eng:
        before = _burst(eng, rows)
        assert eng.hot_swap(fresh) == 1
        after = _burst(eng, rows)
        tel = eng.telemetry
    assert np.abs(after - before).max() > 1e-3
    assert tel.get_counter("serving_swaps_total") == 1


def test_entry_points_need_an_explicit_cpu_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(Arguments)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_models.create(args, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_device.get_device()
    assert torch_device.get_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        torch_device.get_device("meta")
