"""The port's kernel build cache (``fedml_tpu_torch/core/compile_cache.py``)
against the JAX package's ``core/compile_cache.py``, on the CPU (no
``nvcc`` here: a hit needs none, and a miss runs a stand-in compiler).

- ``compile_cache_dir`` is validated with the JAX package's words;
- the same calls give the same answers in both packages: disabled by
  default, the first directory wins, a different one warns once and is
  ignored;
- with the knob set, ``ops/_build`` builds into the directory, counts a
  library it finds there as a hit and one it compiles as a miss, and the
  entries gauge counts libraries, not their ``.log`` reports; nothing is
  counted with the knob unset;
- the engines enable it, as the JAX package's do.
"""

from __future__ import annotations

import logging
import os
import stat
import sys

import jax
import pytest
import torch

from fedml_tpu import arguments as jax_arguments
from fedml_tpu.core import compile_cache as jax_cache
from fedml_tpu_torch import arguments as port_arguments
from fedml_tpu_torch.core import compile_cache as port_cache
from fedml_tpu_torch.core.telemetry import Telemetry
from fedml_tpu_torch.ops import _build

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

KERNEL = "flash_attention_fwd"


@pytest.fixture(autouse=True)
def _reset_caches():
    """Both modules are process-scoped on purpose; tests reset their
    bookkeeping (and jax's cache directory and the port's build root, so
    no later test builds into a deleted tmpdir)."""
    Telemetry.reset()
    yield
    if jax_cache._enabled_dir is not None:
        jax.config.update("jax_compilation_cache_dir", None)
        from jax._src import compilation_cache as _jcc

        _jcc.reset_cache()
    jax_cache._enabled_dir = None
    jax_cache._warned_conflict = False
    port_cache._enabled_dir = None
    port_cache._warned_conflict = False
    _build.BUILD_DIR = _build.DEFAULT_BUILD_DIR
    Telemetry.reset()


def _args(module, **knobs):
    a = module.Arguments()
    for k, v in knobs.items():
        setattr(a, k, v)
    a._validate()
    return a


@pytest.mark.parametrize("value", [3, 2.5, ["a"]])
def test_compile_cache_dir_is_validated_as_in_jax(value):
    errors = []
    for module in (jax_arguments, port_arguments):
        with pytest.raises(ValueError) as e:
            _args(module, compile_cache_dir=value)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert errors[1].startswith(f"compile_cache_dir={value!r}: must be a directory path")
    assert _args(port_arguments, compile_cache_dir=None).compile_cache_dir is None


def _sequence(module, arguments, root, caplog):
    """The same calls on one package: (answers, enabled dir relative to
    ``root``, warnings logged)."""
    caplog.clear()
    answers = [module.maybe_enable_compile_cache(_args(arguments))]
    answers.append(module.enabled_dir())
    with caplog.at_level(logging.WARNING):
        for name in ("a", "a", "b", "c"):
            answers.append(module.maybe_enable_compile_cache(
                _args(arguments, compile_cache_dir=str(root / name))))
    answers.append(module.maybe_enable_compile_cache(_args(arguments)))
    warned = [r.getMessage() for r in caplog.records if "ignored" in r.getMessage()]
    return answers, os.path.relpath(module.enabled_dir(), root), warned


def test_first_caller_wins_and_warns_once_as_in_jax(tmp_path, caplog):
    jax_answers, jax_dir, jax_warned = _sequence(jax_cache, jax_arguments,
                                                 tmp_path / "jax", caplog)
    port_answers, port_dir, port_warned = _sequence(port_cache, port_arguments,
                                                    tmp_path / "port", caplog)
    assert port_answers == jax_answers == [False, None, True, True, True, True, True]
    assert port_dir == jax_dir == "a"
    assert len(port_warned) == len(jax_warned) == 1
    assert port_warned[0].startswith(f"compile_cache_dir={tmp_path / 'port' / 'b'} ignored")
    assert _build.BUILD_DIR == tmp_path / "port" / "a"


def test_cache_entries_counts_libraries_only(tmp_path):
    d = tmp_path / "cache"
    d.mkdir()
    for name in ("libflash_attention_fwd-0123456789abcdef.so",
                 "libexact_fold-fedcba9876543210.so"):
        (d / name).write_bytes(b"\x7fELF")
        (d / f"{name}.log").write_text("ptxas info")
    (d / "libx-1.so.4242.tmp").write_bytes(b"")
    (d / ".hidden.so").write_bytes(b"")
    assert port_cache.cache_entries(str(d)) == 2
    assert port_cache.cache_entries() == 0  # disabled: no directory
    assert port_cache.cache_entries(str(tmp_path / "absent")) == 0


def test_a_library_in_the_enabled_directory_is_a_hit(tmp_path):
    d = tmp_path / "cache"
    assert port_cache.maybe_enable_compile_cache(_args(port_arguments, compile_cache_dir=str(d)))
    lib = _build.library_path(KERNEL)
    assert lib.parent == d
    lib.write_bytes(b"\x7fELF")
    assert _build.build([KERNEL]) == {KERNEL: lib}
    tel = Telemetry.get_instance()
    assert tel.get_counter("compile_cache_hits_total") == 1
    assert tel.get_counter("compile_cache_misses_total") == 0
    assert port_cache.cache_entries() == 1


def _gauge(name):
    return Telemetry.get_instance().snapshot()["gauges"].get(name)


def _fake_nvcc(tmp_path):
    """A stand-in compiler: writes a file at its ``-o`` argument."""
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'built')\n"
        "print('ptxas info : stand-in')\n"
    )
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    return str(script)


def test_a_compiled_library_is_a_miss_then_a_hit(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: _fake_nvcc(tmp_path))
    d = tmp_path / "cache"
    port_cache.maybe_enable_compile_cache(_args(port_arguments, compile_cache_dir=str(d)))
    tel = Telemetry.get_instance()
    _build.build([KERNEL, "exact_fold"])
    assert tel.get_counter("compile_cache_misses_total") == 2
    assert tel.get_counter("compile_cache_hits_total") == 0
    assert _gauge("compile_cache_entries") == 2
    assert sorted(p.suffix for p in d.iterdir()) == [".log", ".log", ".so", ".so"]
    _build.build([KERNEL])
    assert tel.get_counter("compile_cache_hits_total") == 1
    assert tel.get_counter("compile_cache_misses_total") == 2


def test_nothing_is_counted_with_the_knob_unset(tmp_path, monkeypatch):
    assert not port_cache.maybe_enable_compile_cache(_args(port_arguments))
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: _fake_nvcc(tmp_path))
    _build.build([KERNEL])  # compiled
    _build.build([KERNEL])  # found
    tel = Telemetry.get_instance()
    assert tel.get_counter("compile_cache_hits_total") == 0
    assert tel.get_counter("compile_cache_misses_total") == 0
    assert _gauge("compile_cache_entries") is None


def test_the_engines_enable_it(tmp_path):
    """The serving engine and ``FedAvgAPI`` call it at construction, as
    the JAX package's do (the module is reset between the two)."""
    import fedml_tpu_torch
    from fedml_tpu_torch import models
    from fedml_tpu_torch.data import load
    from fedml_tpu_torch.serving import ModelEndpoint, ServingEngine
    from fedml_tpu_torch.simulation import FedAvgAPI

    args = _args(port_arguments, compile_cache_dir=str(tmp_path / "serve"))
    model = models.create(args, 10, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    ServingEngine(ModelEndpoint(model, params), args)
    assert port_cache.enabled_dir() == str(tmp_path / "serve")
    port_cache._enabled_dir = None
    args = fedml_tpu_torch.init(_args(
        port_arguments, compile_cache_dir=str(tmp_path / "fedavg"), dataset="mnist",
        synthetic_train_size=80, synthetic_test_size=20, model="lr",
        client_num_in_total=2, client_num_per_round=2, comm_round=1, batch_size=20))
    ds = load(args, device="cpu")
    FedAvgAPI(args, "cpu", ds, models.create(args, ds.class_num, device="cpu"))
    assert port_cache.enabled_dir() == str(tmp_path / "fedavg")
    assert _build.BUILD_DIR == tmp_path / "fedavg"
