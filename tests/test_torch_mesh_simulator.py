"""The mesh simulator (``run_simulation(backend="MESH")``): the port's
``SimulatorMesh`` over the fed ``(data, fsdp)`` and legacy ``{clients}``
meshes, in spawned gloo worlds (``torch_world.py``), against its own
one-rank world and the JAX package's ``SimulatorMesh`` on the test
process's 8 virtual CPU devices.

The JAX side runs as ``tests/test_mesh_simulator.py`` runs it (the same
knobs: linear model on the MNIST stand-in, 16 clients, 8 a round, 2
rounds, no shuffle); its packed federation and start params are carried
into the port. Against it the tolerance is that test's, 1e-5; between the
port's own mesh shapes the fed mesh is bitwise.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import torch_world
from fedml_tpu import models as jax_models
from fedml_tpu.arguments import Arguments as JaxArguments
from fedml_tpu.data import load as jax_load
from fedml_tpu.parallel import layout as jax_layout
from fedml_tpu.parallel.mesh import pad_federation as jax_pad_federation
from fedml_tpu.simulation import SimulatorMesh as JaxSimulatorMesh
from fedml_tpu_torch.convert import params_from_flax
from fedml_tpu_torch.core.types import Batches
from fedml_tpu_torch.parallel import layout
from fedml_tpu_torch.parallel.mesh import pad_federation
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5  # tests/test_mesh_simulator.py's

BASE = dict(dataset="mnist", synthetic_train_size=600, synthetic_test_size=120, model="lr",
            partition_method="hetero", client_num_in_total=16, client_num_per_round=8,
            comm_round=2, epochs=1, batch_size=16, learning_rate=0.05,
            frequency_of_the_test=1, shuffle=False, log_metrics=False)


def _set(a, **kw):
    for k, v in kw.items():
        setattr(a, k, v)
    a._validate()
    return a


@pytest.fixture
def threefry_restored():
    """The JAX package's init flips ``jax_threefry_partitionable`` for a
    fed mesh; put it back for the rest of the worker's tests."""
    before = jax.config.jax_threefry_partitionable
    yield
    jax.config.update("jax_threefry_partitionable", before)


def _np(b):
    return (np.asarray(b.x), np.asarray(b.y), np.asarray(b.mask))


def jax_mesh_world(knobs: dict, shape: dict) -> dict:
    """The JAX package's SimulatorMesh run: its packed federation and
    start params (numpy, the port's layout) and the end params."""
    args = fedml_tpu.init(_set(JaxArguments(), **dict(knobs, mesh_shape=shape)))
    ds = jax_load(args)
    dataset = {
        "train_data_num": ds.train_data_num, "test_data_num": ds.test_data_num,
        "train_data_global": _np(ds.train_data_global),
        "test_data_global": _np(ds.test_data_global),
        "train_data_local_num_dict": dict(ds.train_data_local_num_dict),
        "class_num": ds.class_num, "packed_train": _np(ds.packed_train),
        "packed_num_samples": np.asarray(ds.packed_num_samples),
        "packed_test": _np(ds.packed_test), "client_num": ds.client_num, "task": ds.task,
    }
    mesh = None
    if not jax_layout.fed_mesh_shape(shape):
        from fedml_tpu.parallel.mesh import build_mesh

        mesh = build_mesh(devices=jax.devices()[:int(np.prod(list(shape.values())))],
                          mesh_shape=shape)
    sim = JaxSimulatorMesh(args, None, ds, jax_models.create(args, ds.class_num), mesh=mesh)
    start = params_from_flax(jax.tree.map(np.asarray, sim.fl_trainer.global_params))
    sim.run()
    end = params_from_flax(jax.tree.map(np.asarray, sim.fl_trainer.global_params))
    return {"dataset": dataset, "start": {k: v.numpy() for k, v in start.items()},
            "end": {k: v.numpy() for k, v in end.items()}, "history": sim.fl_trainer.history}


def _bitwise(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- the fed mesh -----------------------------------------------------------------


@pytest.mark.parametrize("model, extra, bitwise", [
    ("lr", {}, True),
    ("cnn", dict(dataset="femnist", synthetic_train_size=320, synthetic_test_size=80,
                 batch_size=10, shuffle=True), False),
])
def test_fed_mesh_shapes_match_the_one_rank_world(model, extra, bitwise, tmp_path):
    """{data: 4, fsdp: 2} and {data: 8} against the {data: 1, fsdp: 1}
    world: a client's training is never split, every rank draws the whole
    cohort's shuffle uniforms and takes its rows, and every rank folds the
    same gathered cohort through the exact fold in client order. The linear
    model (the reference's identity gate) finalizes to the same bits. The
    CNN, shuffled, agrees to f32 rounding (measured 6e-8): on the CPU a
    vmapped convolution's weight gradient is a grouped convolution whose
    arithmetic depends on how many clients a rank trains at once."""
    knobs = dict(BASE, model=model, **extra)
    (base,) = torch_world.run_world(torch_world.mesh_sim, 1, {"runs": [
        {"args": dict(knobs, mesh_shape={"data": 1, "fsdp": 1})}]}, tmp_path, 60)[0]
    ranks = torch_world.run_world(torch_world.mesh_sim, 8, {"runs": [
        {"args": dict(knobs, mesh_shape={"data": 4, "fsdp": 2})},
        {"args": dict(knobs, mesh_shape={"data": 8})},
    ]}, tmp_path, 120)
    for runs in ranks:
        for got in runs:
            if bitwise:
                _bitwise(got["params"], base["params"])
            else:
                for k, v in base["params"].items():
                    np.testing.assert_allclose(got["params"][k], v, atol=1e-6, err_msg=k)
    assert ranks[0][0]["stats"]["test_loss"] == pytest.approx(base["stats"]["test_loss"],
                                                              rel=1e-5)


def test_params_rest_fsdp_sharded(tmp_path):
    """{data: 2, fsdp: 4}: each rank holds a quarter of the dense kernel's
    input rows (the reference shards the kernel's leading axis, [in, out];
    the port's weight is [out, in]), the bias whole."""
    ranks = torch_world.run_world(torch_world.mesh_sim, 8, {"runs": [
        {"args": dict(BASE, mesh_shape={"data": 2, "fsdp": 4}, comm_round=1)}]}, tmp_path, 90)
    for (got,) in ranks:
        assert got["local_shapes"] == {"Dense_0/weight": (10, 196), "Dense_0/bias": (10,)}
        assert got["params"]["Dense_0/weight"].shape == (10, 784)


def test_fed_mesh_matches_jax_simulator_mesh(threefry_restored, tmp_path):
    """{data: 4, fsdp: 2} on both sides, from the JAX run's federation and
    start params: final params within the reference test's 1e-5, the same
    accuracies every round."""
    want = jax_mesh_world(BASE, {"data": 4, "fsdp": 2})
    got = torch_world.run_world(torch_world.mesh_sim, 8, {"runs": [
        {"args": dict(BASE, mesh_shape={"data": 4, "fsdp": 2}), "dataset": want["dataset"],
         "params": want["start"]}]}, tmp_path, 90)[0][0]
    moved = max(float(np.abs(want["end"][k] - want["start"][k]).max()) for k in want["end"])
    assert moved > 1e-2
    for k, v in want["end"].items():
        np.testing.assert_allclose(got["params"][k], v, atol=ATOL, err_msg=k)
    assert [h["round"] for h in got["history"]] == [h["round"] for h in want["history"]]
    for g, w in zip(got["history"], want["history"]):
        for key in ("train_acc", "test_acc", "train_loss", "test_loss"):
            np.testing.assert_allclose(g[key], w[key], atol=ATOL, rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("shape", [{"clients": 4}, {"clients": 2, "data": 2}])
def test_legacy_meshes(shape, threefry_restored, tmp_path):
    """The legacy vocabulary: the cohort over the clients axis, the params
    whole on every rank, the weighted average; a data axis splits each
    batch's examples over its ranks (a client's gradient summed over
    them). Within 1e-5 of the JAX package's same mesh and of the port's
    one-process run; without a data axis bitwise the latter."""
    want = jax_mesh_world(BASE, shape)
    ranks = torch_world.run_world(torch_world.mesh_sim, 4, {"runs": [
        {"args": dict(BASE, mesh_shape=shape), "dataset": want["dataset"],
         "params": want["start"]}]}, tmp_path, 90)
    (single,) = torch_world.run_world(torch_world.mesh_sim, 1, {"runs": [
        {"args": BASE, "dataset": want["dataset"], "params": want["start"], "single": True}]},
        tmp_path, 60)[0]
    for (got,) in ranks:
        for k, v in want["end"].items():
            np.testing.assert_allclose(got["params"][k], v, atol=ATOL, err_msg=k)
            np.testing.assert_allclose(got["params"][k], single["params"][k], atol=ATOL,
                                       err_msg=k)
        if "data" not in shape:
            _bitwise(got["params"], single["params"])
        assert got["local_shapes"]["Dense_0/weight"] == (10, 784)
        for key in ("train_loss", "test_loss", "test_acc"):
            np.testing.assert_allclose(got["stats"][key], single["stats"][key], rtol=1e-5,
                                       err_msg=key)


@pytest.mark.parametrize("extra", [
    dict(model="cnn", dataset="femnist", synthetic_train_size=320, synthetic_test_size=80,
         batch_size=10, shuffle=True),
    dict(federated_optimizer="FedProx", fedprox_mu=0.5, client_optimizer="adam",
         learning_rate=0.01, batch_size=15),
])
def test_legacy_data_axis_matches_one_process(extra, tmp_path):
    """{clients: 2, data: 2} against the one-process run: the CNN shuffled
    (every data rank shuffles the client's examples with the same draws,
    then takes its share of each batch), and FedProx under adam with a
    batch of 15 the data axis splits 7 / 8 (the prox term's gradient
    added once, after the all-reduce)."""
    knobs = dict(BASE, **extra)
    ranks = torch_world.run_world(torch_world.mesh_sim, 4, {"runs": [
        {"args": dict(knobs, mesh_shape={"clients": 2, "data": 2})}]}, tmp_path, 90)
    (single,) = torch_world.run_world(torch_world.mesh_sim, 1, {"runs": [
        {"args": knobs, "single": True}]}, tmp_path, 60)[0]
    for (got,) in ranks:  # every rank ends with the same params
        for k, v in single["params"].items():
            np.testing.assert_allclose(got["params"][k], v, atol=ATOL, err_msg=k)
        _bitwise(got["params"], ranks[0][0]["params"])
    assert np.isfinite(ranks[0][0]["stats"]["test_loss"])


def test_legacy_data_axis_trains_a_custom_trainer_whole(tmp_path):
    """A custom client trainer's per-client function cannot be split over
    the data axis: each data rank trains its lane's clients whole, so the
    run is bitwise the one-process run with the same trainer."""
    knobs = dict(BASE, comm_round=1)
    (got,) = torch_world.run_world(torch_world.mesh_sim, 4, {"runs": [
        {"args": dict(knobs, mesh_shape={"clients": 2, "data": 2}), "custom_trainer": True}]},
        tmp_path, 90)[0]
    (single,) = torch_world.run_world(torch_world.mesh_sim, 1, {"runs": [
        {"args": knobs, "single": True, "custom_trainer": True}]}, tmp_path, 60)[0]
    _bitwise(got["params"], single["params"])


def test_federation_padding(tmp_path):
    """13 clients over {data: 4}: padded with 3 zero-sample dummies (the
    JAX package's pad_federation, bitwise), never sampled, invisible: the
    mesh world is bitwise the one-rank world, and its one-process run to
    the exact fold's rounding."""
    rng = np.random.RandomState(0)
    x = rng.randn(13, 2, 3, 5).astype(np.float32)
    y = rng.randint(0, 4, size=(13, 2, 3)).astype(np.int64)
    m = (rng.rand(13, 2, 3) > 0.3).astype(np.float32)
    ns = m.sum(axis=(1, 2))
    from fedml_tpu.core.types import Batches as JaxBatches

    jp, jns = jax_pad_federation(JaxBatches(x=x, y=y, mask=m), ns, 4)
    tp, tns = pad_federation(Batches(x=torch.tensor(x), y=torch.tensor(y), mask=torch.tensor(m)),
                             ns, 4)
    for a, b in ((jp.x, tp.x), (jp.y, tp.y), (jp.mask, tp.mask), (jns, tns)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert tp.mask.shape[0] == 16 and not tp.mask[13:].any()

    knobs = dict(BASE, client_num_in_total=13, client_num_per_round=8)
    (base,) = torch_world.run_world(torch_world.mesh_sim, 1, {"runs": [
        {"args": dict(knobs, mesh_shape={"data": 1}), "dataset": None},
        ]}, tmp_path, 60)[0]
    ranks = torch_world.run_world(torch_world.mesh_sim, 4, {"runs": [
        {"args": dict(knobs, mesh_shape={"data": 4})}]}, tmp_path, 90)
    (single,) = torch_world.run_world(torch_world.mesh_sim, 1, {"runs": [
        {"args": knobs, "single": True}]}, tmp_path, 60)[0]
    for (got,) in ranks:
        _bitwise(got["params"], base["params"])
        for k, v in single["params"].items():
            np.testing.assert_allclose(got["params"][k], v, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("shape", [
    {"data": 4, "xx": 2},
    {"fsdp": 0},
    {"fsdp": 16},
    {"data": 8, "fsdp": 2},
    {"fsdp": 3},
])
def test_fed_mesh_refusals_match_jax_word_for_word(shape, eight_devices):
    """Unknown axes, a zero axis, fsdp beyond the world, a shape needing
    more ranks, a shape that does not tile the world (8 here, the JAX
    side's 8 CPU devices)."""
    with pytest.raises(ValueError) as want:
        jax_layout.build_fed_mesh(mesh_shape=shape, warn_nonpartitionable=False)
    with pytest.raises(ValueError) as got:
        layout.build_fed_mesh(shape, 8, "cpu")
    assert str(got.value) == str(want.value)


def test_layout_classes_and_refusals_match_jax():
    """The port's leaves fall in the reference's classes (a Linear weight
    is a dense kernel, a Conv2d's a conv kernel, an Embed_ table an
    embedding); an unknown family fails with the reference's words; a
    sharded dim fsdp does not divide is replicated; a smaller explicit
    shape than the world is refused (the reference serves it from a
    device prefix; the port runs a process a rank)."""
    for port, jax_name, ndim, cls in [
        ("Dense_0/weight", "kernel", 2, "dense_kernel"),
        ("Conv2d_0/weight", "kernel", 4, "conv_kernel"),
        ("Embed_0/weight", "embedding", 2, "embedding"),
        ("Dense_0/bias", "bias", 1, "vector"),
        ("count", "count", 0, "scalar"),
    ]:
        assert layout.classify_param(port, ndim) == jax_layout.classify_param(jax_name, ndim) == cls
    with pytest.raises(ValueError) as want:
        jax_layout.classify_param("wi", 3)
    with pytest.raises(ValueError) as got:
        layout.classify_param("Block_1/SwitchFFN_0/wi", 3)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jax_layout.SpecLayout().spec_for("matrix", 2)
    with pytest.raises(ValueError) as got:
        layout.SpecLayout().sharded_dim("matrix", 2)
    assert str(got.value) == str(want.value)
    lay = layout.SpecLayout()
    assert layout.param_spec(lay, "Dense_0/weight", (10, 784), 4).dim == 1
    assert layout.param_spec(lay, "Dense_0/weight", (10, 786), 4) is None  # 786 % 4
    assert layout.param_spec(lay, "Conv2d_0/weight", (32, 1, 5, 5), 2).dim == 0
    assert layout.param_spec(lay, "ConvTranspose_0/weight", (8, 4, 4, 4), 2).dim == 1
    assert layout.param_spec(lay, "Embed_0/weight", (90, 16), 2).dim == 0
    with pytest.raises(ValueError, match="must span the world"):
        layout.build_fed_mesh({"data": 1, "fsdp": 1}, 8, "cpu")
    assert layout.fed_mesh_shape({"data": 2}) and not layout.fed_mesh_shape({"clients": 2, "data": 2})


def test_mesh_refusals_in_a_world(threefry_restored, tmp_path, eight_devices):
    """The cohort that does not tile the data axis, DSGD on a mesh, and a
    legacy shape that does not span the world: the reference's words."""
    wants = []
    for knobs, shape in ((dict(BASE, client_num_per_round=3), {"data": 2}),
                         (dict(BASE, federated_optimizer="DSGD"), {"data": 2})):
        args = fedml_tpu.init(_set(JaxArguments(), **dict(knobs, mesh_shape=shape)))
        ds = jax_load(args)
        mesh = jax_layout.build_fed_mesh(devices=jax.devices()[:2], mesh_shape=shape)
        with pytest.raises(ValueError) as want:
            JaxSimulatorMesh(args, None, ds, jax_models.create(args, ds.class_num), mesh=mesh)
        wants.append(f"ValueError: {want.value}")
    got = torch_world.run_world(torch_world.mesh_sim, 2, {"runs": [
        {"args": dict(BASE, client_num_per_round=3, mesh_shape={"data": 2})},
        {"args": dict(BASE, federated_optimizer="DSGD", mesh_shape={"data": 2})},
        {"args": dict(BASE, mesh_shape={"clients": 4})},
    ]}, tmp_path, 60)[0]
    assert [g["error"] for g in got[:2]] == wants
    assert got[2]["error"] == "ValueError: mesh shape {'clients': 4} != 2 devices"


@pytest.mark.parametrize("knobs", [
    dict(federated_optimizer="FedProx", fedprox_mu=0.1),
    dict(federated_optimizer="FedOpt", server_optimizer="adam", server_lr=0.01),
    dict(federated_optimizer="FedNova"),
    dict(defense_type="norm_diff_clipping", norm_bound=0.5),
    dict(defense_type="median"),
    dict(federated_optimizer="HSFedAvg", hs_L=0.1),
    dict(sim_mode="sequential"),
])
def test_algorithms_on_the_fed_mesh(knobs, tmp_path):
    """FedProx and the sequential mode (the exact fold: bitwise across
    shapes), FedOpt, FedNova (the cohort's masks gathered for it),
    clipping, the median and HS-FedAvg (its amplitude spectrum summed over
    the lanes) on {data: 2, fsdp: 2}: within 1e-5 of the one-process run;
    every aggregation but the exact fold warns, in the reference's words,
    that it is not bitwise across mesh shapes."""
    run = dict(BASE, client_num_in_total=8, comm_round=2, **knobs)
    ranks = torch_world.run_world(torch_world.mesh_sim, 4, {"runs": [
        {"args": dict(run, mesh_shape={"data": 2, "fsdp": 2})}]}, tmp_path, 90)
    (single,) = torch_world.run_world(torch_world.mesh_sim, 1, {"runs": [
        {"args": run, "single": True}]}, tmp_path, 60)[0]
    warned = "NOT bitwise identical across mesh shapes"
    exact_fold = (knobs.get("federated_optimizer", "FedAvg") in ("FedAvg", "FedProx", "HSFedAvg")
                  and "defense_type" not in knobs)
    plain = exact_fold and knobs.get("federated_optimizer") != "HSFedAvg"
    for (got,) in ranks:
        for k, v in single["params"].items():
            np.testing.assert_allclose(got["params"][k], v, atol=ATOL, err_msg=k)
        assert any(warned in w for w in got["warned"]) == (not exact_fold)
    if plain:
        (one,) = torch_world.run_world(torch_world.mesh_sim, 1, {"runs": [
            {"args": dict(run, mesh_shape={"data": 1})}]}, tmp_path, 60)[0]
        _bitwise(ranks[0][0]["params"], one["params"])


def test_a_rank_receives_its_lane_of_the_cohort(tmp_path):
    """``gather_lane`` over {data: 4}, 16 clients (4 a rank): every rank's
    rows are its lane of the cohort taken from the whole federation, for
    a cohort that tiles the lanes, one that does not (7: lanes of 1 and
    2), one with an empty lane (3) and one whose clients all live on one
    rank."""
    rng = np.random.RandomState(3)
    fed = {"x": rng.randn(16, 2, 3, 5).astype(np.float32),
           "y": rng.randint(0, 9, size=(16, 2, 3)).astype(np.int64),
           "mask": (rng.rand(16, 2, 3) > 0.3).astype(np.float32)}
    cohorts = [rng.permutation(16)[:8], rng.permutation(16)[:7], np.array([15, 0, 9]),
               np.array([5, 4, 6, 7])]
    ranks = torch_world.run_world(torch_world.lane_gather, 4,
                                  dict(fed, idx=[c.tolist() for c in cohorts]), tmp_path, 60)
    for r, got in enumerate(ranks):
        for idx, lane in zip(cohorts, got):
            lo, hi = lane["span"]
            assert (lo, hi) == (r * len(idx) // 4, (r + 1) * len(idx) // 4)
            for k in ("x", "y", "mask"):
                np.testing.assert_array_equal(lane[k], fed[k][idx[lo:hi]], err_msg=k)


def test_streaming_fold_and_fold_limbs_on_sharded_params(tmp_path):
    """Over {data: 1, fsdp: 2}, each rank folding its at-rest shards: the
    fold is order-independent, handing part of it on by fold_limbs is the
    direct fold, and both are bitwise the one-rank folds of the whole
    trees (the fold is elementwise); exact_weighted_mean likewise."""
    rng = np.random.RandomState(11)
    trees = [{"Dense_0/weight": rng.randn(6, 8).astype(np.float32),
              "Dense_0/bias": rng.randn(6).astype(np.float32)} for _ in range(4)]
    ws = [float(w) for w in rng.randint(1, 9, size=4)]
    two = torch_world.run_world(torch_world.mesh_folds, 2, {"trees": trees, "ws": ws},
                                tmp_path, 60)
    (one,) = torch_world.run_world(torch_world.mesh_folds, 1, {"trees": trees, "ws": ws},
                                   tmp_path, 60)
    assert two[0]["sharded"] == ["Dense_0/weight"]  # the bias (6) is replicated
    for got in two:
        for key in ("forward", "reverse", "limbs", "mean"):
            _bitwise(got[key], one[key])
        _bitwise(got["forward"], got["reverse"])
        _bitwise(got["limbs"], got["forward"])
        assert got["count"] == 4


def test_planet_on_the_fed_mesh_matches_the_flat_run(tmp_path):
    """The registry loop on {data: 2, fsdp: 2}: every rank makes and
    trains its lane of each group, the terms are the whole group's, and
    the run ends within 1e-5 of the one-rank flat run."""
    args = dict(dataset="synthetic", model="lr", client_registry_size=512,
                client_num_in_total=512, cohort_size=32, client_num_per_round=32, epochs=1,
                batch_size=16, learning_rate=0.1, frequency_of_the_test=10**9,
                synthetic_train_size=256, synthetic_test_size=64, comm_round=2, shuffle=True,
                log_metrics=False)
    mesh = torch_world.run_world(torch_world.planet_mesh, 4, {
        "args": args, "mesh_shape": {"data": 2, "fsdp": 2}}, tmp_path, 120)
    (flat,) = torch_world.run_world(torch_world.planet_mesh, 1, {"args": args}, tmp_path, 90)
    for got in mesh:
        for k, v in flat["params"].items():
            np.testing.assert_allclose(got["params"][k], v, atol=1e-5, err_msg=k)
        assert got["stats"]["trace_count"] == len(got["stats"]["shape_keys"])
        assert got["stats"]["round_folds"] == flat["stats"]["round_folds"]
    assert mesh[0]["local_shapes"] != flat["local_shapes"]  # at rest: fsdp shards


def test_run_simulation_mesh_entry(tmp_path):
    """``run_simulation(backend="MESH")`` and ``"NCCL"`` in a world of 2
    (its ranks agree), and alone as a world of one rank."""
    knobs = dict(BASE, mesh_shape={"data": 2}, comm_round=1)
    for backend in ("MESH", "NCCL"):
        stats = torch_world.run_world(torch_world.mesh_api, 2,
                                      {"args": knobs, "backend": backend}, tmp_path, 90)
        assert stats[0]["test_loss"] == stats[1]["test_loss"]
        assert np.isfinite(stats[0]["test_loss"])
    import torch.distributed as dist

    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import Arguments

    alone = fedml_tpu_torch.run_simulation(
        backend="MESH", device="cpu",
        args=_set(Arguments(), **dict(knobs, mesh_shape={"data": 1, "fsdp": 1})))
    assert np.isfinite(alone["test_loss"]) and not dist.is_initialized()

