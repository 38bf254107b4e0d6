#!/usr/bin/env python3
"""Static SASS instruction counts of the port's CUDA kernels.

Compiles each given ``.cu`` source for Hopper with the port's own nvcc
flags (``fedml_tpu_torch/ops/_build.py``'s, as a cubin), disassembles it
with ``cuobjdump -sass`` and prints one JSON line per kernel function:

- ``total``: every instruction of the function, its subroutines included;
- ``loops``: for each loop (a backward branch), the instructions of its
  body, and the same plus the instructions of the subroutines the body
  calls (``CALL.REL``; a 64-bit integer division is one) -- the most a
  pass of the loop can execute, slow paths counted;
- ``by_opcode``: the function's instructions by opcode (modifiers cut).

Run on a machine with the CUDA toolkit (``nvcc`` and ``cuobjdump`` on
``PATH`` or under ``$CUDA_HOME``)::

    python3 sass_count.py fedml_tpu_torch/ops/csrc/synth_features.cu [more.cu ...] \
        [--match synth_kernel] [--keep DIR]

``--match`` keeps the functions whose (mangled) name contains the
string; ``--keep`` writes each source's SASS listing there as
``<stem>.sass``. ``--sass FILE`` parses a listing written before,
without building.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parent

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")


def toolkit(tool: str) -> str:
    """``tool`` from the CUDA toolkit: ``PATH``, ``$CUDA_HOME/bin``, or
    the default prefix."""
    for path in [*(os.path.join(d, tool) for d in os.environ.get("PATH", "").split(os.pathsep)),
                 os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", tool)]:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise SystemExit(f"sass_count: {tool} not found (the CUDA toolkit is needed)")


def disassemble(source: Path) -> str:
    """The SASS listing of ``source`` built with the port's flags."""
    sys.path.insert(0, str(REPO))
    from fedml_tpu_torch.ops._build import NVCC_FLAGS

    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / f"{source.stem}.cubin"
        subprocess.run([toolkit("nvcc"), *flags, "-cubin", "-o", str(cubin), str(source)],
                       check=True)
        return subprocess.run([toolkit("cuobjdump"), "-sass", str(cubin)], check=True,
                              capture_output=True, text=True).stdout


def parse(listing: str) -> dict:
    """``{function: [(address, opcode, text), ...]}`` and each function's
    labels as ``{label: address}``."""
    funcs, labels = {}, {}
    name, pending = None, []
    for line in listing.splitlines():
        m = _FUNC.match(line)
        if m:
            name = m.group(1)
            funcs[name], labels[name], pending = [], {}, []
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr, text = int(m.group(1), 16), m.group(2).strip()
            for label in pending:
                labels[name][label] = addr
            pending = []
            words = text.split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                funcs[name].append((addr, words[0].split(".")[0], text))
    return {n: (insns, labels[n]) for n, insns in funcs.items()}


def _target(text: str, labels: dict):
    m = _TARGET.search(text)
    if not m:
        return None
    return labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)


def count(insns, labels) -> dict:
    """The counts described in the module docstring, for one function."""
    index = {addr: i for i, (addr, _, _) in enumerate(insns)}

    def routine(start):  # a subroutine's instructions: from its entry to its first RET
        i = index.get(start)
        if i is None:
            return 0
        n = 0
        for _, op, _ in insns[i:]:
            n += 1
            if op == "RET":
                break
        return n

    loops = []
    for addr, op, text in insns:
        if op != "BRA":
            continue
        target = _target(text, labels)
        if target is None or target > addr or target not in index:
            continue
        body = insns[index[target]:index[addr] + 1]
        calls = {_target(t, labels) for _, o, t in body if o == "CALL"}
        loops.append({"from": hex(target), "to": hex(addr), "body": len(body),
                      "body_and_callees": len(body) + sum(routine(c) for c in calls if c)})
    return {"total": len(insns), "loops": loops,
            "by_opcode": dict(Counter(op for _, op, _ in insns).most_common())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", type=Path)
    ap.add_argument("--sass", type=Path, action="append", default=[],
                    help="a SASS listing to parse instead of building a source")
    ap.add_argument("--match", default="", help="keep functions whose name contains this")
    ap.add_argument("--keep", type=Path, help="write each listing here as <stem>.sass")
    a = ap.parse_args(argv)
    listings = [(p, p.read_text()) for p in a.sass]
    for src in a.sources:
        listing = disassemble(src.resolve())
        if a.keep:
            a.keep.mkdir(parents=True, exist_ok=True)
            (a.keep / f"{src.stem}.sass").write_text(listing)
        listings.append((src, listing))
    for path, listing in listings:
        for name, (insns, labels) in parse(listing).items():
            if a.match in name:
                print(json.dumps({"source": str(path), "function": name, **count(insns, labels)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
