"""The port's ``Arguments`` schema and ``core/devtime.py`` ring against
the JAX package's, on the CPU.

- the knob table: an ``Arguments()`` of each package, with no config,
  has the same keys apart from the port's three process-group keys and
  the same values apart from ``device_type`` (``"cuda"`` in the port,
  ``"tpu"`` in the JAX package); one YAML sets the same values, of the
  same types, in both; ``get`` and ``to_dict`` agree;
- ``devtime_ring_size``: the same knob and the same ten ``measure``
  calls leave rings of the same size and executables in both, and an
  out-of-range size raises the same ``ValueError``.
"""

from __future__ import annotations

import argparse

import pytest

from fedml_tpu import arguments as jax_arguments
from fedml_tpu.core import devtime as jax_devtime
from fedml_tpu.core.telemetry import Telemetry as JaxTelemetry
from fedml_tpu_torch import arguments as port_arguments
from fedml_tpu_torch.core import devtime as port_devtime
from fedml_tpu_torch.core.telemetry import Telemetry as PortTelemetry

# keys the port declares for its silo process groups, which the JAX
# package treats as runtime attributes
PORT_ONLY_KEYS = {"distributed_coordinator", "n_proc_in_silo", "proc_rank_in_silo"}
# the one default that differs: the device kind the configuration targets
DEFAULT_EXCEPTIONS = {"device_type": ("tpu", "cuda")}
# the nine knobs the port lacked until now (fedml_tpu/arguments.py:35,
# :122-129, :296, :389, :473-474)
RESTORED = ("compile_cache_dir", "devtime_ring_size", "server_beta1", "server_beta2",
            "scenario", "enable_tracking", "using_gpu", "device_type", "gpu_mapping_file")

PAIRS = (
    (jax_arguments, jax_devtime, JaxTelemetry),
    (port_arguments, port_devtime, PortTelemetry),
)


@pytest.fixture(autouse=True)
def _reset():
    yield
    for _, devtime, telemetry in PAIRS:
        devtime.reset()
        telemetry.reset()


def _args(module, **knobs):
    a = module.Arguments()
    for k, v in knobs.items():
        setattr(a, k, v)
    a._validate()
    return a


def test_default_tables_agree_but_for_the_stated_exceptions():
    jax_table = jax_arguments.Arguments().to_dict()
    port_table = port_arguments.Arguments().to_dict()
    assert set(port_table) - set(jax_table) == PORT_ONLY_KEYS
    assert set(jax_table) <= set(port_table)
    differing = {k: (jax_table[k], port_table[k]) for k in jax_table
                 if jax_table[k] != port_table[k] or type(jax_table[k]) is not type(port_table[k])}
    assert differing == DEFAULT_EXCEPTIONS
    for key in RESTORED:
        assert key in port_arguments._DEFAULTS
    for module in (jax_arguments, port_arguments):
        a = module.Arguments()
        assert (a.server_beta1, a.server_beta2, a.scenario) == (0.9, 0.999, "horizontal")


def test_one_yaml_sets_the_same_values_and_types(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text(
        "common_args: {scenario: hierarchical}\n"
        "train_args: {server_optimizer: adam, server_beta1: '0.95', server_beta2: 0.99}\n"
        f"device_args: {{using_gpu: false, device_type: cpu, gpu_mapping_file: {tmp_path}/m.yaml}}\n"
        "tracking_args: {enable_tracking: true, devtime_ring_size: '7', "
        f"compile_cache_dir: {tmp_path}/cache}}\n"
    )
    read = [module.Arguments(argparse.Namespace(yaml_config_file=str(cfg)))
            for module in (jax_arguments, port_arguments)]
    for key in RESTORED:
        values = [getattr(a, key) for a in read]
        assert values[0] == values[1] and type(values[0]) is type(values[1]), key
    # no generic coercion in either package: a quoted beta stays a string
    assert read[1].server_beta1 == "0.95" and read[1].devtime_ring_size == 7


def test_get_and_to_dict_agree():
    jax_a, port_a = jax_arguments.Arguments(), port_arguments.Arguments()
    for key in ("scenario", "server_beta2", "comm_round", "not_a_knob"):
        assert jax_a.get(key, 5) == port_a.get(key, 5)
    jax_d, port_d = jax_a.to_dict(), port_a.to_dict()
    assert not any(k.startswith("_") for k in port_d)
    port_d = {k: v for k, v in port_d.items() if k not in PORT_ONLY_KEYS}
    assert {k: v for k, v in port_d.items() if k not in DEFAULT_EXCEPTIONS} == {
        k: v for k, v in jax_d.items() if k not in DEFAULT_EXCEPTIONS}


def test_devtime_ring_size_is_adopted_as_in_jax():
    rings, names = [], []
    for arguments, devtime, telemetry in PAIRS:
        devtime.reset()
        telemetry.reset()
        telemetry.get_instance(_args(arguments, devtime_ring_size=3))
        for _ in range(10):
            with devtime.measure("simulation.round_fn", bucket="b8"):
                pass
        ring = devtime.ring_snapshot()
        rings.append([(e["executable"], e["bucket"]) for e in ring])
        names.append(devtime.measured_executables())
    assert len(rings[0]) == 3
    assert rings[0] == rings[1]
    assert names[0] == names[1] == ["simulation.round_fn"]


@pytest.mark.parametrize("size", [0, -2])
def test_devtime_ring_size_below_one_raises_the_same_error(size):
    errors = []
    for module in (jax_arguments, port_arguments):
        with pytest.raises(ValueError) as e:
            _args(module, devtime_ring_size=size)
        errors.append(str(e.value))
    assert errors[0] == errors[1] == f"devtime_ring_size={size}: must be >= 1"
