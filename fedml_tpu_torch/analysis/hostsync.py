"""Rule ``host-sync`` — hidden device->host synchronisation on a round
or serving hot path (port of ``fedml_tpu/analysis/hostsync.py``,
re-aimed at torch).

One stray ``float(device_value)`` per round serialises the pipeline:
the host waits for the card to drain before it can queue the next
launch. This checker flags, **in the hot-path modules only**, the
calls that wait for the card:

- ``float(x)`` / ``int(x)`` / ``bool(x)`` on a non-trivial expression
  (a name, attribute, subscript or call result — the shapes a tensor
  arrives in);
- ``.item()``, ``.cpu()``, ``.tolist()`` and ``.numpy()`` anywhere;
- ``np.asarray`` / ``np.array`` — explicit materialisation of a tensor
  on the host;
- ``torch.cuda.synchronize()`` and any ``.synchronize()`` (an event's,
  a stream's).

Deliberate syncs (a deferred-metrics flush, the pipeline's
back-pressure wait) are *named* with ``# lint: host-sync-ok`` on the
line — the allowlist is visible in the diff, never ambient.

Host-side arithmetic is not flagged: arguments that mention ``args``
/ ``getattr`` (knob coercion), ``.shape`` / ``len()`` (metadata), or
plain constants never touch the device; ``__init__`` bodies are
construction, before any hot loop exists.
"""

from __future__ import annotations

import ast
from typing import List

from .engine import Finding, ModuleSource

RULE = "host-sync"

# the per-round / per-upload / per-request hot paths; everything else
# may sync freely (setup, teardown, tests, CLIs)
HOT_PATH_MODULES = {
    "fedml_tpu_torch/core/round_pipeline.py",
    "fedml_tpu_torch/core/aggregation.py",
    "fedml_tpu_torch/core/defense.py",
    "fedml_tpu_torch/scale/engine.py",
    "fedml_tpu_torch/scale/tree.py",
    "fedml_tpu_torch/serving/engine.py",
    "fedml_tpu_torch/serving/endpoint.py",
    "fedml_tpu_torch/serving/batcher.py",
    "fedml_tpu_torch/cross_silo/horizontal/fedml_aggregator.py",
    "fedml_tpu_torch/simulation/fedavg_api.py",
}

_CONVERTERS = {"float", "int", "bool"}
# tensor methods that copy to the host (and so wait for the card)
_FETCH_METHODS = {"item", "cpu", "tolist", "numpy"}
_MATERIALIZERS = {"asarray", "array"}
# host-only sources a conversion may safely wrap. BUILTIN names apply
# to bare-Name calls only: `sum(host_list)` is host-side, but
# `x.sum()` / `torch.sum(x)` reduce ON DEVICE — treating those as safe
# would wave through the exact per-round `float(torch.sum(losses))`
# fetch this rule exists for. Attribute calls are safe only for clocks.
_SAFE_BUILTIN_CALLS = {
    "getattr", "len", "round", "min", "max", "abs", "sum", "str",
    "float", "int", "bool",
}
_SAFE_CLOCK_ATTRS = {"perf_counter", "monotonic", "time", "time_ns"}
_SAFE_ATTR_MENTIONS = {"shape", "size", "ndim", "dtype", "args"}


def _mentions_safe_host_source(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == "args":
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in _SAFE_ATTR_MENTIONS:
            return True
        if isinstance(sub, ast.Call):
            fn = sub.func
            if isinstance(fn, ast.Name) and fn.id in _SAFE_BUILTIN_CALLS:
                return True
            if isinstance(fn, ast.Attribute) and fn.attr in _SAFE_CLOCK_ATTRS:
                return True
    return False


def _is_trivial(node: ast.AST) -> bool:
    """Constants and pure-constant arithmetic never touch the device."""
    return all(
        isinstance(
            sub,
            (ast.Constant, ast.UnaryOp, ast.BinOp, ast.operator, ast.unaryop,
             ast.Tuple, ast.List, ast.Load),
        )
        for sub in ast.walk(node)
    )


_CONSTRUCTION_FUNCS = {"__init__", "__post_init__"}


def _nodes_outside_construction(tree: ast.AST):
    """Walk the tree skipping ``__init__``/``__post_init__`` bodies —
    construction happens once, before any hot loop exists."""
    stack = [tree]
    while stack:
        node = stack.pop()
        if (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name in _CONSTRUCTION_FUNCS
        ):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def check_host_sync(mod: ModuleSource) -> List[Finding]:
    if mod.path not in HOT_PATH_MODULES:
        return []
    findings: List[Finding] = []

    for node in _nodes_outside_construction(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if (
            isinstance(fn, ast.Name)
            and fn.id in _CONVERTERS
            and len(node.args) == 1
            and not node.keywords
        ):
            arg = node.args[0]
            if _is_trivial(arg) or _mentions_safe_host_source(arg):
                continue
            findings.append(Finding(
                path=mod.path, line=node.lineno, rule=RULE,
                message=(
                    f"{fn.id}() forces a device fetch on a hot path; "
                    "defer it (DeferredMetrics) or mark the line "
                    "`# lint: host-sync-ok`"
                ),
            ))
        elif isinstance(fn, ast.Attribute) and fn.attr in _FETCH_METHODS and not node.args:
            findings.append(Finding(
                path=mod.path, line=node.lineno, rule=RULE,
                message=(
                    f".{fn.attr}() forces a device fetch on a hot path; "
                    "defer it or mark the line `# lint: host-sync-ok`"
                ),
            ))
        elif isinstance(fn, ast.Attribute) and fn.attr == "synchronize":
            owner = ast.unparse(fn.value)
            findings.append(Finding(
                path=mod.path, line=node.lineno, rule=RULE,
                message=(
                    f"{owner}.synchronize() blocks the host until the card "
                    "drains on a hot path; mark `# lint: host-sync-ok` if "
                    "it is a deliberate sync point"
                ),
            ))
        elif isinstance(fn, ast.Attribute) and fn.attr in _MATERIALIZERS:
            owner = fn.value
            owner_name = owner.id if isinstance(owner, ast.Name) else None
            if owner_name not in ("np", "numpy", "onp"):
                continue  # torch.asarray stays on device
            findings.append(Finding(
                path=mod.path, line=node.lineno, rule=RULE,
                message=(
                    f"{owner_name}.{fn.attr}() "
                    "materialises device values on a hot path; mark "
                    "`# lint: host-sync-ok` if it is a deliberate sync "
                    "point"
                ),
            ))
    return sorted(findings)
