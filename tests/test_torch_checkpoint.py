"""Checkpoint and resume of the port's simulation (ports of
``tests/test_tracking_checkpoint.py``'s ``TestCheckpointResume`` and of
``tests/test_round_pipeline.py``'s mid-pipeline restore).

The JAX package holds a resumed run to its straight run at 1e-5; the
port holds it bitwise: params, server state and the generator's state
are saved exactly, and the generator is drawn in dispatch order, so the
resumed run draws what the straight run drew.
"""

from __future__ import annotations

import os

import pytest
import torch

import fedml_tpu_torch
from fedml_tpu_torch import models
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.core import checkpoint
from fedml_tpu_torch.core.checkpoint import RoundCheckpointer
from fedml_tpu_torch.data import load
from fedml_tpu_torch.simulation import FedAvgAPI, FedOptAPI
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

BASE = dict(dataset="mnist", synthetic_train_size=300, synthetic_test_size=60, model="lr",
            partition_method="hetero", client_num_in_total=6, client_num_per_round=3,
            epochs=1, batch_size=16, learning_rate=0.1, frequency_of_the_test=2,
            shuffle=True)
ADAM = dict(federated_optimizer="FedOpt", server_optimizer="adam", server_lr=0.05)


def _api(cls=FedAvgAPI, ckpt_dir=None, **kw):
    args = Arguments()
    for k, v in dict(BASE, checkpoint_dir=ckpt_dir, **kw).items():
        setattr(args, k, v)
    args._validate()
    args = fedml_tpu_torch.init(args)
    ds = load(args, device="cpu")
    return cls(args, "cpu", ds, models.create(args, ds.class_num, device="cpu"))


def _run(cls=FedAvgAPI, ckpt_dir=None, **kw):
    api = _api(cls, ckpt_dir, **kw)
    api.train()
    return api


def _records(api):
    return [{k: v for k, v in h.items() if k not in ("round_time_s", "train_time_s")}
            for h in api.history]


def _assert_bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


class TestCheckpointResume:
    def test_resume_matches_uninterrupted(self, tmp_path):
        """2 rounds, then a resume for 2 more, equals one 4-round run."""
        d = str(tmp_path / "ck")
        _run(ckpt_dir=d, comm_round=2, checkpoint_freq=1)
        resumed = _run(ckpt_dir=d, comm_round=4, checkpoint_freq=1)
        straight = _run(comm_round=4)
        _assert_bitwise(resumed.global_params, straight.global_params)
        assert [h["round"] for h in resumed.history] == [2, 3]

    def test_resume_restores_server_optimizer_state(self, tmp_path):
        """FedOpt with adam: the server's moments survive the restart."""
        d = str(tmp_path / "ck2")
        first = _run(FedOptAPI, ckpt_dir=d, comm_round=2, checkpoint_freq=1, **ADAM)
        resumed_api = _api(FedOptAPI, ckpt_dir=d, comm_round=4, checkpoint_freq=1, **ADAM)
        resumed_api._maybe_restore()
        for a, b in zip(torch.utils._pytree.tree_leaves(first.server_state),
                        torch.utils._pytree.tree_leaves(resumed_api.server_state)):
            assert torch.equal(a, b)
        resumed = _run(FedOptAPI, ckpt_dir=d, comm_round=4, checkpoint_freq=1, **ADAM)
        straight = _run(FedOptAPI, comm_round=4, **ADAM)
        _assert_bitwise(resumed.global_params, straight.global_params)

    def test_completed_run_does_not_retrain(self, tmp_path):
        d = str(tmp_path / "ck3")
        api1 = _run(ckpt_dir=d, comm_round=3, checkpoint_freq=1)
        api2 = _run(ckpt_dir=d, comm_round=3, checkpoint_freq=1)
        assert api2.history == []
        _assert_bitwise(api1.global_params, api2.global_params)


@pytest.mark.parametrize("algorithm", [{}, ADAM], ids=["FedAvg", "FedOpt-adam"])
def test_checkpoint_restore_mid_pipeline(tmp_path, algorithm):
    """A depth-4 run checkpointed at round 2 (the records up to it
    flushed before the save), restored and run to the end, equals a
    straight depth-1 run: params and the records of the rounds it ran."""
    cls = FedOptAPI if algorithm else FedAvgAPI
    d = str(tmp_path / "ck_pipe")
    kw = dict(algorithm, checkpoint_freq=2)
    _run(cls, ckpt_dir=d, comm_round=2, pipeline_depth=4, **kw)
    resumed = _run(cls, ckpt_dir=d, comm_round=6, pipeline_depth=4, **kw)
    straight = _run(cls, comm_round=6, pipeline_depth=1, **algorithm)
    _assert_bitwise(resumed.global_params, straight.global_params)
    resumed_hist = _records(resumed)
    assert [h["round"] for h in resumed_hist] == [2, 4, 5]
    assert resumed_hist == [h for h in _records(straight) if h["round"] >= 2]
    assert resumed.pipeline_stats["rounds"] == 4
    assert resumed.pipeline_stats["checkpoints"] == 2  # rounds 3 and 5
    assert RoundCheckpointer(d).steps() == [1, 3, 5]


def test_sequential_mode_resumes_bitwise(tmp_path):
    d = str(tmp_path / "ck_seq")
    _run(ckpt_dir=d, comm_round=3, checkpoint_freq=3, sim_mode="sequential")
    resumed = _run(ckpt_dir=d, comm_round=5, checkpoint_freq=3, sim_mode="sequential")
    straight = _run(comm_round=5, sim_mode="sequential")
    _assert_bitwise(resumed.global_params, straight.global_params)
    assert RoundCheckpointer(d).steps() == [2, 4]


def test_only_the_newest_three_steps_are_kept(tmp_path):
    ckpt = RoundCheckpointer(str(tmp_path))
    for step in range(5):
        ckpt.save(step, {"params": {"w": torch.full((2,), float(step))}, "round_idx": step})
    assert ckpt.steps() == [2, 3, 4]
    assert sorted(os.listdir(tmp_path)) == ["2", "3", "4"]
    assert ckpt.latest_step() == 4
    assert torch.equal(ckpt.restore()["params"]["w"], torch.full((2,), 4.0))
    assert ckpt.restore(3)["round_idx"] == 3
    with pytest.raises(FileExistsError):
        ckpt.save(4, {"round_idx": 4})


def test_a_leftover_temporary_directory_is_ignored(tmp_path):
    """A publish cut before its rename leaves a temporary directory (and
    perhaps a state file in it): no step, and the next save works."""
    ckpt = RoundCheckpointer(str(tmp_path))
    assert ckpt.latest_step() is None and ckpt.restore() is None
    ckpt.save(0, {"round_idx": 0})
    torn = tmp_path / ".tmp-1-abc"
    torn.mkdir()
    (torn / "state.pt").write_bytes(b"torn")
    (tmp_path / "7").mkdir()  # a step directory without its state file
    assert ckpt.steps() == [0]
    assert ckpt.restore()["round_idx"] == 0
    ckpt.save(1, {"round_idx": 1})
    assert ckpt.steps() == [0, 1]


def test_publish_goes_through_the_io_seam(tmp_path):
    published = []

    class Recording(checkpoint.DurableIO):
        def ckpt_publish(self, save_fn, step, dir_path):
            published.append((step, dir_path))
            save_fn()

    checkpoint.install_io_seam(Recording())
    try:
        RoundCheckpointer(str(tmp_path)).save(5, {"round_idx": 5})
        assert isinstance(checkpoint.current_io(), Recording)
    finally:
        checkpoint.reset_io_seam()
    assert published == [(5, str(tmp_path))]
    assert type(checkpoint.current_io()) is checkpoint.DurableIO


def test_generator_state_round_trips(tmp_path):
    """The saved generator state draws what the live generator draws,
    and the checkpoint loads with ``weights_only=True``."""
    api = _api(ckpt_dir=str(tmp_path), comm_round=1)
    api._shuffle_uniforms(3)
    ckpt = RoundCheckpointer(str(tmp_path))
    api._save_checkpoint(ckpt, 0)
    want = api._shuffle_uniforms(3)
    fresh = _api(ckpt_dir=str(tmp_path), comm_round=2)
    assert fresh._maybe_restore()[1] == 1
    assert torch.equal(fresh._shuffle_uniforms(3), want)
    raw = torch.load(tmp_path / "0" / "state.pt", weights_only=True)
    assert set(raw) == {"params", "server_state", "generator", "round_idx"}
    assert raw["generator"].dtype == torch.uint8


def test_restore_refuses_another_model(tmp_path):
    d = str(tmp_path / "ck")
    _run(ckpt_dir=d, comm_round=1)
    with pytest.raises(ValueError, match="params"):
        _run(ckpt_dir=d, comm_round=2, model="mlp")
