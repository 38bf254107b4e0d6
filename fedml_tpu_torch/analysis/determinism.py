"""Rule ``determinism`` — unseeded randomness / wall clocks in paths
that promise seeded reproducibility (port of
``fedml_tpu/analysis/determinism.py``, meaning kept).

The round path (sampling, aggregation, defenses), the chaos plane
("an identical (schedule, seed) pair reproduces the identical fault
trace") and the data/poison synthesis all document bit-level or
draw-level determinism. A single ``np.random.rand()`` or
``random.random()`` against the *global* RNG breaks that silently —
and ``np.random.seed()`` / ``random.seed()`` is worse: it clobbers
every other component's stream. ``time.time()`` in these modules is
flagged too: wall clocks leak into decisions that replays cannot
reproduce (telemetry / tracing modules are deliberately off this list
— timestamps are their job).

The port promises explicit ``torch.Generator`` objects, so torch's
global generator is the counterpart of the global NumPy RNG:
``torch.manual_seed`` / ``torch.cuda.manual_seed[_all]`` reseed it, and
a ``torch.rand*`` / ``randperm`` / ``normal`` / ``bernoulli`` /
``multinomial`` / ``poisson`` call without ``generator=`` draws from it.

Allowed and never flagged: ``np.random.RandomState(seed)`` /
``np.random.default_rng(seed)`` / ``random.Random(seed)`` instances,
``np.random.SeedSequence``/``Generator`` type references, and torch
draws that name their ``generator=``.
"""

from __future__ import annotations

import ast
from typing import List

from .engine import Finding, ModuleSource

RULE = "determinism"

# modules (files or directory prefixes ending in /) that document
# seeded reproducibility
SEEDED_PATHS = (
    "fedml_tpu_torch/core/aggregation.py",
    "fedml_tpu_torch/core/defense.py",
    "fedml_tpu_torch/core/round_pipeline.py",
    "fedml_tpu_torch/core/chaos.py",
    "fedml_tpu_torch/core/secure_agg.py",
    "fedml_tpu_torch/core/partition.py",
    "fedml_tpu_torch/core/scheduler.py",
    "fedml_tpu_torch/scale/",
    "fedml_tpu_torch/data/",
    "fedml_tpu_torch/simulation/",
    "fedml_tpu_torch/cross_silo/",
    "fedml_tpu_torch/cross_device/",
)

# np.random.<attr> that are constructors/types for locally-seeded
# streams, not draws from the global RNG
_SEEDED_FACTORIES = {
    "RandomState", "default_rng", "Generator", "SeedSequence",
    "PCG64", "Philox",
}

# torch.<attr> draws that take (or, for the *_like forms, lack) a
# generator= argument
_TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "normal", "bernoulli", "multinomial", "poisson",
}
_TORCH_RESEEDS = {"manual_seed", "seed"}


def _in_seeded_path(path: str) -> bool:
    return any(
        path == p or (p.endswith("/") and path.startswith(p))
        for p in SEEDED_PATHS
    )


def _torch_owner(node: ast.AST) -> str:
    """"torch" / "torch.cuda" for those owner expressions, else ""."""
    if isinstance(node, ast.Name) and node.id == "torch":
        return "torch"
    if (
        isinstance(node, ast.Attribute)
        and node.attr == "cuda"
        and isinstance(node.value, ast.Name)
        and node.value.id == "torch"
    ):
        return "torch.cuda"
    return ""


def _torch_findings(mod: ModuleSource) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
            continue
        fn = node.func
        owner = _torch_owner(fn.value)
        if not owner:
            continue
        if fn.attr in _TORCH_RESEEDS or (owner == "torch.cuda" and fn.attr == "manual_seed_all"):
            findings.append(Finding(
                path=mod.path, line=node.lineno, rule=RULE,
                message=(
                    f"{owner}.{fn.attr}() reseeds torch's GLOBAL generator "
                    "and clobbers every other component's stream; derive a "
                    "local torch.Generator instead"
                ),
            ))
        elif owner == "torch" and fn.attr in _TORCH_DRAWS and not any(
            kw.arg == "generator" for kw in node.keywords
        ):
            findings.append(Finding(
                path=mod.path, line=node.lineno, rule=RULE,
                message=(
                    f"torch.{fn.attr} without generator= draws from torch's "
                    "global generator in a seeded path; pass a local "
                    "torch.Generator"
                ),
            ))
    return findings


def check_determinism(mod: ModuleSource, force: bool = False) -> List[Finding]:
    """``force=True`` applies the rule regardless of the module-set
    gate — the relaxed ``tests/`` profile (engine.py) uses it: a test
    drawing from the global RNG is exactly how order-dependent flakes
    are born, even though tests/ is not a shipped seeded path."""
    if not force and not _in_seeded_path(mod.path):
        return []
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Attribute):
            continue
        # time.time()
        if (
            node.attr == "time"
            and isinstance(node.value, ast.Name)
            and node.value.id in ("time", "_time")
        ):
            findings.append(Finding(
                path=mod.path, line=node.lineno, rule=RULE,
                message=(
                    "time.time() in a seeded/deterministic path — wall "
                    "clocks are unreplayable; use a monotonic clock for "
                    "durations or thread a timestamp in"
                ),
            ))
            continue
        # np.random.<draw> on the GLOBAL stream
        v = node.value
        if (
            isinstance(v, ast.Attribute)
            and v.attr == "random"
            and isinstance(v.value, ast.Name)
            and v.value.id in ("np", "numpy", "onp")
        ):
            if node.attr in _SEEDED_FACTORIES:
                continue
            what = (
                "np.random.seed() reseeds the GLOBAL NumPy RNG and "
                "clobbers every other component's stream"
                if node.attr == "seed"
                else f"np.random.{node.attr} draws from the global NumPy "
                     "RNG in a seeded path"
            )
            findings.append(Finding(
                path=mod.path, line=node.lineno, rule=RULE,
                message=f"{what}; derive a local RandomState/key instead",
            ))
            continue
        # random.<draw> on the stdlib global stream
        if (
            isinstance(v, ast.Name)
            and v.id == "random"
            and node.attr not in ("Random", "SystemRandom")
        ):
            what = (
                "random.seed() reseeds the GLOBAL stdlib RNG"
                if node.attr == "seed"
                else f"random.{node.attr} draws from the global stdlib "
                     "RNG in a seeded path"
            )
            findings.append(Finding(
                path=mod.path, line=node.lineno, rule=RULE,
                message=f"{what}; derive a local random.Random(seed) instead",
            ))
    return findings + _torch_findings(mod)
