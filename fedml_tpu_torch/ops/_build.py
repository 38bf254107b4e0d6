"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which the
kernel's wrapper loads with ``ctypes``. Nothing here includes PyTorch's
headers, so a build takes seconds, not minutes.

The library's file name carries a hash of its source, the shared
headers and the flags, so an edited source is rebuilt and an unchanged
one is reused. Several
sources build in parallel (one ``nvcc`` each, all started together).
The output lands in ``ops/build/``, which git ignores; it is written to
a temporary name first and renamed, so concurrent builders never load a
half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # per-kernel registers, shared memory and spills, kept in the build log
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME/bin``, else from
    the toolkit's default install prefix. Raises when none exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found on PATH, in $CUDA_HOME/bin or the default CUDA "
            "prefix: the port's CUDA kernels need the CUDA toolkit to build"
        )
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source whose library is missing, all in
    parallel; returns ``{name: library path}``. Raises ``RuntimeError``
    with nvcc's output when any build fails. The compiler's report
    (``-Xptxas -v``) is kept beside each library as ``<lib>.log``."""
    targets = {n: library_path(n) for n in names}
    todo = {n: p for n, p in targets.items() if not p.is_file()}
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out = todo[name]
        Path(f"{out}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return targets


def build_log(name: str) -> str:
    """The compiler's report for the built library (empty if absent)."""
    log = Path(f"{library_path(name)}.log")
    return log.read_text() if log.is_file() else ""


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library once per
    process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build([name])[name]
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
