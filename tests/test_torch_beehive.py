"""The Beehive check-in plane of the port (``fedml_tpu_torch/cross_device/
gateway.py``, ``device.py``, ``protocol.py``, ``driver.py``) against the
JAX package's (``fedml_tpu/cross_device/``).

- the protocol's payloads (the int8 offer, the roster, the reveals) are
  the JAX module's arrays; the mask algebra of ``tests/test_beehive.py``
  holds on the port's ``core/secure_agg.py``;
- one round of the device plane: ``_train_cohort``'s per-device deltas
  within ``DELTA_ATOL`` of the JAX package's, sample counts, shape keys
  and the (tier, bucket) census equal;
- whole worlds (registry 2,000, cohorts of 16, the JAX tests' sizes):
  clean, 30% vanishing at upload (masked and unmasked), ``after_close``
  stragglers folded with the staleness discount, an unreachable target
  closing on the window, and a poisoned Shamir share. In each the round
  records, the census and the device counters equal the JAX world's,
  the final params are within ``FLAT_ATOL``, the masked world equals its
  unmasked twin bitwise, and the four device invariants of
  docs/cross_device.md, checked here on the port's WAL records and
  counters by hand and by the port's ``InvariantChecker`` over the
  world's exported artifacts, flag exactly what the JAX package's
  ``InvariantChecker`` flags.

The port makes its features with its own keyed generator (K2's plain
version here); these tests hand it the JAX generator's features, as
``tests/test_torch_planet_scale.py`` does, so both planes train on the
same data.
"""

from __future__ import annotations

import tempfile

import numpy as np
import pytest
import torch

import fedml_tpu_torch
from fedml_tpu_torch import constants
from fedml_tpu_torch.arguments import Arguments
from fedml_tpu_torch.core import secure_agg as sa
from fedml_tpu_torch.core.chaos import reset_chaos
from fedml_tpu_torch.core.checkpoint import RoundWAL
from fedml_tpu_torch.core.telemetry import Telemetry
from fedml_tpu_torch.cross_device import DeviceHost, run_beehive_world
from fedml_tpu_torch.cross_device import protocol
from fedml_tpu_torch.scale import ClientRegistry
from fedml_tpu_torch.scale import registry as registry_module
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

REG_SIZE = 2_000
COHORT = 16
P = sa.FIELD_PRIME
# one device's delta after up to 3 epochs of 13 SGD steps of a linear
# model, f32 on both sides: the two packages' products and softmax round
# differently (measured 6.0e-8 on deltas up to 0.59)
DELTA_ATOL = 1e-6
# the final params: a delta that rounds differently moves a field integer
# by one (1/65536 before the weighted mean); measured 1.6e-8 to 4.2e-8
FLAT_ATOL = 1e-6
COUNTERS = ("device_checkins_total", "device_uploads_folded_total",
            "device_uploads_late_total", "device_mask_recoveries_total",
            "device_mask_recovery_failures_total")
DEVICE_INVARIANTS = ("device_fold_requires_checkin", "device_masked_folds_balance",
                     "device_round_close_accounted", "device_mask_recovery_verified")


def _jax_features(y, feature_shape, num_classes, client_seeds, sigma=1.0, means_seed=1234,
                  dtype=None, device="cpu"):
    """The JAX package's per-client features for the same labels and
    seeds, handed to the port in place of its own generator."""
    from fedml_tpu.data.synthetic import synthetic_classification_device_per_client

    x = synthetic_classification_device_per_client(
        np.asarray(y), tuple(feature_shape), num_classes, np.asarray(client_seeds),
        sigma=sigma, means_seed=means_seed)
    return torch.tensor(np.asarray(x), device=device).to(dtype or torch.float32)


@pytest.fixture
def jax_features(monkeypatch):
    monkeypatch.setattr(registry_module, "synthetic_classification_device_per_client",
                        _jax_features)


def vanish_schedule(rounds, frac=0.3, fault=None):
    """``frac`` of each round's cohort vanishes at upload
    (``tests/test_beehive.py``'s schedule)."""
    reg = ClientRegistry(REG_SIZE, seed=0, duty_hours=14)
    steps = []
    for r in range(rounds):
        ids = reg.sample_available_cohort(r, COHORT)
        for d in ids[:max(1, int(frac * len(ids)))]:
            steps.append({"at": {"event": "device.upload", "device": int(d), "round": r},
                          "fault": dict(fault or {"kind": "vanish"})})
    return steps


def bad_share_schedule():
    """Round 0: the first device vanishes and every other one reveals a
    poisoned share."""
    ids = ClientRegistry(REG_SIZE, seed=0, duty_hours=14).sample_available_cohort(0, COHORT)
    return [{"at": {"event": "device.upload", "device": int(ids[0]), "round": 0},
             "fault": {"kind": "vanish"}}] + [
        {"at": {"event": "device.upload", "device": int(d), "round": 0},
         "fault": {"kind": "bad_share"}} for d in ids[1:]]


WORLDS = {
    "clean": dict(comm_round=3),
    "vanish_masked": dict(comm_round=3, chaos_schedule=vanish_schedule(3)),
    "vanish_unmasked": dict(comm_round=3, chaos_schedule=vanish_schedule(3),
                            crossdevice_secure_agg=False),
    "after_close": dict(comm_round=2, chaos_schedule=vanish_schedule(
        1, frac=0.2, fault={"kind": "vanish", "after_close": True})),
    "window": dict(comm_round=1, chaos_schedule=vanish_schedule(1, frac=0.05),
                   crossdevice_fold_target_frac=1.0),
    "bad_share": dict(comm_round=1, chaos_schedule=bad_share_schedule()),
}


def _knobs(name):
    return dict(training_type="simulation", client_registry_size=REG_SIZE,
                crossdevice_cohort=COHORT, checkpoint_dir=tempfile.mkdtemp(prefix="bh_ck_"),
                run_id=f"bh-{name}", **WORLDS[name])


def _counters(tel):
    out = {k: tel.get_counter(k) for k in COUNTERS}
    out["closed_window"] = tel.get_counter("device_rounds_closed_total", reason="window")
    out["closed_target"] = tel.get_counter("device_rounds_closed_total", reason="target")
    return out


def run_jax_world(name):
    import fedml_tpu
    from fedml_tpu.core.chaos import reset_chaos as jax_reset_chaos
    from fedml_tpu.core.invariants import InvariantChecker
    from fedml_tpu.core.telemetry import Telemetry as JaxTelemetry
    from fedml_tpu.cross_device import run_beehive_world as jax_world
    from tests.conftest import make_args

    a = make_args(telemetry_dir=tempfile.mkdtemp(prefix="bh_td_"), **_knobs(name))
    fedml_tpu.init(a)
    JaxTelemetry.reset()
    jax_reset_chaos()
    out = jax_world(a, feature_dim=8, class_num=4)
    out["counters"] = _counters(JaxTelemetry.get_instance())
    rep = InvariantChecker(telemetry_dir=a.telemetry_dir, checkpoint_dir=a.checkpoint_dir).check()
    out["violated"] = {v["invariant"] for v in rep.to_dict()["violations"]} & set(
        DEVICE_INVARIANTS)
    out["checked"] = set(rep.to_dict()["checked"])
    return out


def run_port_world(name):
    from fedml_tpu_torch.core.invariants import InvariantChecker as PortChecker

    a = Arguments()
    for k, v in dict(_knobs(name), telemetry_dir=tempfile.mkdtemp(prefix="bh_td_")).items():
        setattr(a, k, v)
    a._validate()
    fedml_tpu_torch.init(a)
    Telemetry.reset()
    reset_chaos()
    saved = registry_module.synthetic_classification_device_per_client
    registry_module.synthetic_classification_device_per_client = _jax_features
    try:
        out = run_beehive_world(a, feature_dim=8, class_num=4, device="cpu")
    finally:
        registry_module.synthetic_classification_device_per_client = saved
    out["counters"] = _counters(Telemetry.get_instance())
    out["wal"] = [r for r in RoundWAL(a.checkpoint_dir).records() if r.get("kind") == "crossdevice"]
    rep = PortChecker(telemetry_dir=a.telemetry_dir, checkpoint_dir=a.checkpoint_dir).check()
    out["violated"] = {v["invariant"] for v in rep.to_dict()["violations"]} & set(
        DEVICE_INVARIANTS)
    out["checked"] = set(rep.to_dict()["checked"])
    return out


def device_violations(records, counters) -> set:
    """The four device invariants of docs/cross_device.md on a world's
    ``crossdevice`` WAL records and counters, as the JAX package's
    ``InvariantChecker._check_crossdevice`` checks them."""
    bad, total = set(), 0
    for rec in records:
        checkins, folded = set(rec["checkins"]), list(rec["folded"])
        total += len(folded)
        if not checkins <= set(rec["cohort"]) or not set(folded) <= checkins:
            bad.add("device_fold_requires_checkin")
        reason = rec["close_reason"]
        if reason not in ("target", "window") or (
                reason == "target" and len(folded) < int(rec["fold_target"])):
            bad.add("device_round_close_accounted")
        if rec["masked"]:
            ups = sum(int(v) for v in rec["upload_checksums"].values())
            corrs = sum(int(v) for v in rec["correction_checksums"].values())
            if int(rec["field_checksum"]) != (ups - corrs) % P:
                bad.add("device_masked_folds_balance")
    if counters["device_uploads_folded_total"] != total:
        bad.add("device_round_close_accounted")
    if counters["device_mask_recovery_failures_total"] > 0:
        bad.add("device_mask_recovery_verified")
    return bad


_CACHE = {}


def world(name, pkg):
    key = (name, pkg)
    if key not in _CACHE:
        _CACHE[key] = (run_jax_world if pkg == "jax" else run_port_world)(name)
    return _CACHE[key]


# -- the protocol ----------------------------------------------------------

class TestMaskAlgebra:
    """``tests/test_beehive.py``'s algebra on the port's primitives."""

    def test_pairwise_masks_cancel_bitwise_over_full_set(self):
        rng = np.random.default_rng(0)
        ids = [3, 11, 42, 99]
        secrets = {i: sa.derive_mask_secret(i * 7 + 1, 0) for i in ids}
        pubs = {i: sa.mask_public_key(secrets[i]) for i in ids}
        dim = 24
        qs = {i: rng.integers(0, P, size=dim, dtype=np.int64) for i in ids}
        masked_sum = np.zeros(dim, dtype=np.int64)
        plain_sum = np.zeros(dim, dtype=np.int64)
        for i in ids:
            m = sa.pairwise_mask_vector(i, secrets[i], pubs, dim)
            masked_sum = np.mod(masked_sum + qs[i] + m, P)
            plain_sum = np.mod(plain_sum + qs[i], P)
        assert np.array_equal(masked_sum, plain_sum)

    def test_dropout_residue_equals_unmask_correction(self):
        ids = [1, 5, 8, 13, 21]
        secrets = {i: sa.derive_mask_secret(i * 31 + 5, 2) for i in ids}
        pubs = {i: sa.mask_public_key(secrets[i]) for i in ids}
        dim, vanished = 10, 8
        folded = [i for i in ids if i != vanished]
        acc = np.zeros(dim, dtype=np.int64)
        for i in folded:
            acc = np.mod(acc + sa.pairwise_mask_vector(i, secrets[i], pubs, dim), P)
        corr = sa.unmask_correction(vanished, secrets[vanished],
                                    {i: pubs[i] for i in folded}, dim)
        assert np.array_equal(np.mod(acc - corr, P), np.zeros(dim))

    def test_shamir_recovers_mask_secret_and_poison_breaks_pubkey(self):
        secret = sa.derive_mask_secret(12345, 7)
        pub = sa.mask_public_key(secret)
        shares = sa.shamir_share(np.int64(secret), 5, 2, np.random.default_rng(3))
        back = int(sa.shamir_reconstruct(shares[:3], [1, 2, 3]))
        assert back == secret and sa.mask_public_key(back) == pub
        bad = int(sa.shamir_reconstruct(np.mod(shares[:3] + 1, P), [1, 2, 3]))
        assert bad == (secret + 1) % P
        assert sa.mask_public_key(bad) != pub


class TestProtocol:
    def test_offer_codec_equals_jax(self):
        from fedml_tpu.cross_device import protocol as jp

        rng = np.random.default_rng(5)
        params = protocol.linear_template(8, 4)
        params = {k: (v + rng.normal(size=v.shape)).astype(np.float32) for k, v in params.items()}
        params["zero"] = np.zeros((3,), np.float32)
        enc, jenc = protocol.encode_offer_params(params), jp.encode_offer_params(params)
        assert list(enc) == list(jenc) == sorted(params)
        for k in params:
            assert enc[k]["q"].dtype == np.int8
            assert np.array_equal(enc[k]["q"], np.asarray(jenc[k]["q"]))
            assert enc[k]["scale"].tobytes() == np.asarray(jenc[k]["scale"]).tobytes()
        dec, jdec = protocol.decode_offer_params(enc), jp.decode_offer_params(jenc)
        for k in params:
            assert dec[k].dtype == np.float32
            assert dec[k].tobytes() == np.asarray(jdec[k]).tobytes()
        assert protocol.flat_dim(6, 3) == jp.flat_dim(6, 3) == 6 * 3 + 3
        for k, v in protocol.linear_template(6, 3).items():
            assert np.array_equal(v, jp.linear_template(6, 3)[k])

    def test_roster_and_reveals_equal_jax(self):
        from fedml_tpu.cross_device import protocol as jp

        roster = {42: 7, 3: 99, 17: 1}
        packed, jpacked = protocol.pack_participants(roster), jp.pack_participants(roster)
        assert list(packed["ids"]) == [3, 17, 42]
        for k in ("ids", "pubs"):
            assert packed[k].dtype == np.int64 and np.array_equal(packed[k], jpacked[k])
        assert protocol.unpack_participants(packed) == roster
        reveals = {8: [(1, 100), (3, 200)], 2: [(2, 50)]}
        table = protocol.pack_reveals(reveals)["table"]
        assert np.array_equal(table, jp.pack_reveals(reveals)["table"])
        assert protocol.unpack_reveals({"table": table}) == reveals
        assert protocol.pack_reveals({})["table"].shape == (0, 3)


# -- one round of the device plane -----------------------------------------

def test_train_cohort_matches_jax(jax_features):
    import fedml_tpu
    from fedml_tpu.cross_device import protocol as jp
    from fedml_tpu.cross_device.device import DeviceHost as JaxHost
    from fedml_tpu.scale.registry import ClientRegistry as JaxRegistry
    from tests.conftest import make_args

    knobs = dict(client_registry_size=REG_SIZE, crossdevice_cohort=32, comm_round=1,
                 run_id="bh-one-round", learning_rate=0.1, batch_size=16)
    ja = fedml_tpu.init(make_args(**knobs))
    ta = Arguments()
    for k, v in knobs.items():
        setattr(ta, k, v)
    ta._validate()
    jreg, treg = JaxRegistry(REG_SIZE, seed=0), ClientRegistry(REG_SIZE, seed=0)
    part_ids = np.sort(treg.sample_available_cohort(0, 32)).astype(np.int64)
    rng = np.random.default_rng(1)
    start = {k: (0.1 * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in protocol.linear_template(8, 4).items()}
    offer = jp.decode_offer_params(jp.encode_offer_params(start))

    jhost = JaxHost(ja, jreg, 8, 4, 1, 32)
    thost = DeviceHost(ta, treg, 8, 4, 1, 32, device="cpu")
    want, wn = jhost._train_cohort(offer, part_ids)
    got, gn = thost._train_cohort(protocol.decode_offer_params(protocol.encode_offer_params(start)),
                                  part_ids)
    assert sorted(got) == sorted(want) == sorted(int(d) for d in part_ids)
    assert gn == wn
    worst = max(float(np.abs(got[d] - want[d]).max()) for d in want)
    assert worst <= DELTA_ATOL, worst
    assert max(float(np.abs(d).max()) for d in got.values()) > 1e-3  # it trained
    assert all(g.dtype == np.float64 and g.shape == (protocol.flat_dim(8, 4),)
               for g in got.values())
    assert sorted(thost.shape_keys) == sorted(jhost.shape_keys)
    assert thost.trace_count == jhost.trace_count == len(thost.shape_keys)
    assert thost.groups_trained == len(thost.shape_keys)
    tiers = treg.speed_tier[part_ids]
    assert {t for t, _ in thost.shape_keys} == {int(t) for t in np.unique(tiers)}
    for tier, bucket in thost.shape_keys:
        n = int((tiers == tier).sum())
        assert bucket >= n and bucket & (bucket - 1) == 0 and bucket < 2 * n


# -- whole worlds, port against JAX ------------------------------------------

WORLD_NAMES = list(WORLDS)


@pytest.mark.parametrize("name", WORLD_NAMES)
def test_round_records_and_census_equal_jax(name):
    port, jax_out = world(name, "port"), world(name, "jax")
    assert port["round_records"] == jax_out["round_records"]
    assert len(port["round_records"]) == WORLDS[name]["comm_round"]
    assert port["shape_keys"] == [tuple(k) for k in jax_out["shape_keys"]]
    assert port["trace_count"] == jax_out["trace_count"] == len(port["shape_keys"])
    assert port["registry_size"] == REG_SIZE


@pytest.mark.parametrize("name", WORLD_NAMES)
def test_final_params_near_jax(name):
    port, jax_out = world(name, "port"), world(name, "jax")
    assert port["final_flat"].dtype == np.float64
    moved = float(np.abs(port["final_flat"]).max())
    assert moved > 1e-3
    err = float(np.abs(port["final_flat"] - jax_out["final_flat"]).max())
    assert err <= FLAT_ATOL, err
    flat = np.concatenate([port["final_params"][k].numpy().reshape(-1) for k in ("b", "w")])
    assert np.array_equal(flat, port["final_flat"].astype(np.float32))


@pytest.mark.parametrize("name", WORLD_NAMES)
def test_counters_equal_jax(name):
    assert world(name, "port")["counters"] == world(name, "jax")["counters"]


@pytest.mark.parametrize("name", WORLD_NAMES)
def test_device_invariants_flag_as_the_checker_does(name):
    port, jax_out = world(name, "port"), world(name, "jax")
    assert set(DEVICE_INVARIANTS) <= jax_out["checked"]
    assert device_violations(port["wal"], port["counters"]) == jax_out["violated"]
    assert (jax_out["violated"] == {"device_mask_recovery_verified"}) == (name == "bad_share")
    # the port's checker over the port world's exported artifacts says the same
    assert set(DEVICE_INVARIANTS) <= port["checked"]
    assert port["violated"] == jax_out["violated"]


@pytest.mark.parametrize("name", WORLD_NAMES)
def test_wal_fold_ledger_matches_counters_and_checkins(name):
    port = world(name, "port")
    recs = port["wal"]
    assert len(recs) == WORLDS[name]["comm_round"]
    assert port["counters"]["device_uploads_folded_total"] == sum(len(r["folded"]) for r in recs)
    for r, rec in zip(recs, port["round_records"]):
        assert set(r["folded"]) <= set(r["checkins"]) <= set(r["cohort"])
        assert r["close_reason"] == rec["close_reason"] and len(r["folded"]) == rec["folds"]
        if r["masked"]:
            ups = sum(int(v) for v in r["upload_checksums"].values())
            corrs = sum(int(v) for v in r["correction_checksums"].values())
            assert int(r["field_checksum"]) == (ups - corrs) % P


def test_masked_equals_unmasked_bitwise_under_churn():
    m, u = world("vanish_masked", "port"), world("vanish_unmasked", "port")
    assert any(r["recovered"] > 0 for r in m["round_records"])
    assert all(r["recovered"] == 0 for r in u["round_records"])
    assert m["final_flat"].tobytes() == u["final_flat"].tobytes()


def test_churn_closes_on_target_window_and_late_folds():
    for name in ("clean", "vanish_masked", "vanish_unmasked"):
        for rec in world(name, "port")["round_records"]:
            assert rec["close_reason"] == "target" and rec["folds"] >= rec["fold_target"]
    rec = world("window", "port")["round_records"][0]
    assert rec["close_reason"] == "window" and rec["folds"] < rec["fold_target"]
    assert world("window", "port")["counters"]["closed_window"] == 1.0
    late = world("after_close", "port")
    assert late["round_records"][1]["late_folded"] >= 1
    assert late["counters"]["device_uploads_late_total"] >= 1.0
    assert world("bad_share", "port")["counters"]["device_mask_recovery_failures_total"] >= 1.0


# -- knobs, devices, refusals -------------------------------------------------

@pytest.mark.parametrize("knob, value", [
    ("crossdevice_fold_target_frac", 0.0), ("crossdevice_fold_target_frac", 1.5),
    ("crossdevice_report_window_s", -1), ("crossdevice_quant_scale", 0),
    ("crossdevice_mask_threshold", 0), ("crossdevice_duty_hours", 25),
    ("crossdevice_cohort", "nope"), ("crossdevice_cohort", -1),
])
def test_knob_validation_word_for_word(knob, value):
    from tests.conftest import make_args

    with pytest.raises(ValueError) as want:
        make_args(**{knob: value})
    a = Arguments()
    setattr(a, knob, value)
    with pytest.raises(ValueError) as got:
        a._validate()
    assert str(got.value) == str(want.value)


def test_defaults_validate():
    a = Arguments()
    assert a.crossdevice_fold_target_frac == 0.6
    assert a.crossdevice_secure_agg is True and a.crossdevice_verify_pubkey is True
    assert a.crossdevice_mask_threshold == 2 and a.crossdevice_cohort == 0
    assert a.cross_device_backend == constants.COMM_BACKEND_MQTT


def test_needs_a_card_unless_told_and_refuses_telemetry_dir(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = Arguments()
    a.client_registry_size, a.crossdevice_cohort, a.comm_round = 200, 8, 1
    a.checkpoint_dir, a.run_id = tempfile.mkdtemp(prefix="bh_ck_"), "bh-refuse"
    a._validate()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_beehive_world(a)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceHost(a, ClientRegistry(200, seed=0), 8, 4, 1, 8)
    # telemetry_dir exports the world's artifacts (it was refused before
    # the exporters were ported)
    a.telemetry_dir = tempfile.mkdtemp(prefix="bh_td_")
    run_beehive_world(a, device="cpu")
    import os

    assert {"trace.json", "metrics.prom", "telemetry.jsonl"} <= set(os.listdir(a.telemetry_dir))
