"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which the
kernel's wrapper loads with ``ctypes``. Nothing here includes PyTorch's
headers, so a build takes seconds, not minutes.

The library's file name carries a hash of its source, the shared
headers and the flags, so an edited source is rebuilt and an unchanged
one is reused. Several
sources build in parallel (one ``nvcc`` each, all started together).
The output lands in ``ops/build/``, which git ignores, or in the
directory ``compile_cache_dir`` names (``core/compile_cache.py``, which
also counts each library found built as a hit and each ``nvcc`` run as
a miss); it is written to a temporary name first and renamed, so
concurrent builders never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable

from ..core import compile_cache

CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent / "build"
# where libraries build to; compile_cache.maybe_enable_compile_cache
# re-roots it at the compile_cache_dir knob
BUILD_DIR = DEFAULT_BUILD_DIR

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
        compile_cache.record_build(len(targets), 0)
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
    compile_cache.record_build(len(targets) - len(todo), len(todo))
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


_fake_type = None  # torch's FakeTensor class, looked up at the first call


def faked(*tensors) -> bool:
    """True when one of ``tensors`` is a fake tensor (``FakeTensorMode``):
    the audit's trace (``analysis/compiled.py``), where a wrapper records
    its kernel's call and launches nothing. An ``isinstance`` test, so
    that a launch pays well under a microsecond for it."""
    global _fake_type
    if _fake_type is None:
        from torch._subclasses.fake_tensor import FakeTensor

        _fake_type = FakeTensor
    return any(isinstance(t, _fake_type) for t in tensors)


# the audit trace's sink of kernel calls on fake tensors (``tracing``)
_trace_sink = None


@contextmanager
def tracing(sink):
    """While the block runs, a wrapper called on fake tensors hands
    ``sink(name, flops, bytes)`` its kernel's cost in place of a launch."""
    global _trace_sink
    prev, _trace_sink = _trace_sink, sink
    try:
        yield
    finally:
        _trace_sink = prev


def cuda_device(name: str, **tensors):
    """The one CUDA device all ``tensors`` share (or, in the audit's
    trace, the fake tensors' one device); raises ``ValueError`` naming
    the kernel and the operands' devices otherwise."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or (any(not t.is_cuda for t in tensors.values())
                             and not faked(*tensors.values())):
        raise ValueError(
            f"{name}: operands on {({k: str(t.device) for k, t in tensors.items()})}; "
            "the kernel takes tensors on one CUDA device"
        )
    return devices.pop()


class Kernel:
    """A ctypes binding of one entry point of ``csrc/<library>.cu``
    (``library`` defaults to the entry's ``name``) plus its launch
    count.

    ``launches`` rises by one each time the kernel is launched, and
    nowhere else; callers reset it with ``reset_launches``. The entry
    point returns 0 or an error code, which ``error_string`` (a
    function of the same library) turns into a message."""

    name = ""
    library = ""
    # the C entry point's argument types, the stream last
    argtypes: tuple = ()
    # the library's error-code-to-message function
    error_string = ""

    def __init__(self) -> None:
        self.launches = 0
        self._lock = threading.Lock()
        self._fn = None
        self._err = None

    def reset_launches(self) -> None:
        with self._lock:
            self.launches = 0

    def _bind(self):
        if self._fn is None:
            lib = load(self.library or self.name)
            fn = getattr(lib, self.name)
            fn.argtypes = list(self.argtypes)
            fn.restype = ctypes.c_int
            err = getattr(lib, self.error_string)
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def trace(self, flops: float, nbytes: float) -> None:
        """A call on fake tensors, recorded in the audit's trace in place
        of a launch: ``flops`` and ``nbytes`` are the call's work by the
        kernel's bound formulas. Nothing launches and ``launches`` does
        not move; outside a trace a fake tensor raises."""
        if _trace_sink is None:
            raise RuntimeError(f"{self.name}: fake tensors outside the audit's trace; the "
                               "kernel launches only on real CUDA tensors")
        _trace_sink(self.name, flops, nbytes)

    def _launch(self, device, *args) -> None:
        """Call the entry point on ``device``'s current stream; raises on
        a nonzero return, else counts the launch."""
        import torch

        fn = self._bind()
        stream = torch.cuda.current_stream(device).cuda_stream
        if device.index is None or device.index == torch.cuda.current_device():
            rc = fn(*args, stream)
        else:  # a launch goes to the current device: make it the tensors'
            with torch.cuda.device(device):
                rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(
                f"{self.name} launch failed: CUDA error {rc} ({self._err(rc).decode()})"
            )
        with self._lock:
            self.launches += 1

