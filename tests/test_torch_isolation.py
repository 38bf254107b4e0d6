"""The PyTorch port stands alone: no JAX, nothing of ``fedml_tpu``.

Every module of ``fedml_tpu_torch`` and ``chip_smoke.py`` is scanned for
imports of ``jax``/``flax``/``optax``/``fedml_tpu``, and a fresh
interpreter that imports the whole port must not load any of them
(``fedml_tpu/core/__init__.py`` loads JAX on any ``fedml_tpu.core``
import, so one stray import would pull JAX in). ``chip_smoke.py`` copied
alone into an empty directory, or run without a card, exits non-zero
and prints no result.
"""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

import pytest

from fedml_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "fedml_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fedml_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for base, dirs, names in os.walk(PORT):
        dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", "build"))
        files += [os.path.join(base, n) for n in sorted(names) if n.endswith(".py")]
    return files


def _imports(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_no_source_imports_jax_or_the_jax_package():
    # with the card-side scripts beside chip_smoke.py
    files = _port_sources() + [os.path.join(REPO, n) for n in ("kernels_ab.py",
                                                                "profiler_probe.py")]
    assert len(files) > 15
    bad = [
        f"{os.path.relpath(path, REPO)}:{line}: {name}"
        for path in files
        for line, name in _imports(path)
        if _forbidden(name)
    ]
    assert not bad, bad


def _run(code_or_args, cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run(
        [sys.executable, *code_or_args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "fedml_tpu_torch." + os.path.relpath(p, PORT)[:-3].replace(os.sep, ".")
        for p in _port_sources()[1:]
        if not p.endswith("__init__.py")
    )
    code = (
        "import sys\n"
        f"for m in {mods!r}: __import__(m)\n"
        f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + '.') "
        f"for f in {FORBIDDEN!r})]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = _run(["-c", code], REPO, {"PYTHONPATH": REPO})
    assert out.returncode == 0, out.stdout + out.stderr


def test_serving_and_comm_load_neither_msgpack_nor_grpc():
    """The port writes the wire format itself and imports ``grpc`` only
    when a GRPC manager is built."""
    mods = ["fedml_tpu_torch.serving", "fedml_tpu_torch.core.comm",
            "fedml_tpu_torch.core.managers", "fedml_tpu_torch.cli",
            "fedml_tpu_torch.core.comm.tensor_rpc", "fedml_tpu_torch.core.comm.grpc_backend",
            "fedml_tpu_torch.core.comm.mqtt_backend", "fedml_tpu_torch.core.comm.payload_store"]
    code = (
        "import sys\n"
        f"for m in {mods!r}: __import__(m)\n"
        "from fedml_tpu_torch.arguments import Arguments\n"
        "from fedml_tpu_torch.core.managers import build_comm_stack\n"
        "build_comm_stack(Arguments(), 0, 1, 'LOCAL')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('msgpack', 'grpc'))\n"
        "assert not bad, bad\n"
        "from fedml_tpu_torch.core.comm.grpc_backend import import_grpc\n"
        "import_grpc()\n"
        "assert 'grpc' in sys.modules\n"
    )
    out = _run(["-c", code], REPO, {"PYTHONPATH": REPO})
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("alone", [True, False])
def test_chip_smoke_fails_without_card_or_port(tmp_path, alone):
    """Alone in a directory the smoke run has no port to import; beside
    the port, with no card visible, it refuses to run. Either way it
    exits non-zero and prints no result."""
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    else:
        script, cwd = os.path.join(REPO, "chip_smoke.py"), REPO
    out = _run([script], cwd, {"PYTHONPATH": "", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""
    assert ("not beside this script" if alone else "needs a CUDA card") in out.stderr


def test_kernel_build_names_a_missing_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    # the library name follows the source's content
    path = _build.library_path("flash_attention_fwd")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libflash_attention_fwd-")
    assert _build.build([]) == {}
