"""Rule ``thread-lock`` — cross-thread attribute access without the
owning lock (port of ``fedml_tpu/analysis/threads.py``, meaning kept).

The ~15 threaded modules (reliable channel, heartbeat detector,
serving engine, chaos timers, telemetry watchdog, checkpoint watcher)
all follow the same discipline: state a worker thread writes is either
(a) guarded by ``with self._lock`` at *every* access, (b) an
intrinsically thread-safe object (``queue.Queue``, ``threading.Event``,
a one-shot handle), or (c) funneled onto the single dispatch thread by
a loopback message. This checker enforces (a) mechanically:

  an attribute assigned inside a ``threading.Thread``/``Timer``
  **target method** (or a Thread subclass's ``run``) and *also*
  accessed in another method, where any of those accesses is outside
  every ``with self.<lock>`` block, is a finding at the unguarded
  site.

Heuristics that keep it honest rather than noisy:

- lock-ish context managers: any ``with self.<attr>`` where the attr
  name contains ``lock`` / ``cond`` / ``mutex``;
- attributes whose *names* mark them thread-safe-by-type (``*_lock``,
  ``*_cond``, ``*_event``, ``*_queue``, ``*_q``, ``*_thread``,
  ``*_timer``, ``*_stop``) are exempt, as is everything only ever
  touched inside one method (thread-private state);
- ``__init__`` is construction-time (the thread does not exist yet)
  and never counts as an access site.

Suppress a deliberately unguarded site (e.g. a monotonic counter read
where staleness is acceptable) with ``# lint: thread-lock-ok``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .engine import Finding, ModuleSource

RULE = "thread-lock"

_LOCKISH = ("lock", "cond", "mutex")
_SAFE_NAME_TOKENS = (
    "lock", "cond", "mutex", "event", "queue", "thread", "timer", "stop",
)


def _is_safe_attr_name(name: str) -> bool:
    low = name.lower()
    return any(tok in low for tok in _SAFE_NAME_TOKENS)


def _is_lockish_ctx(expr: ast.AST) -> bool:
    """`with self.<lock>` / `with self.<x>.lock` — anything on self
    whose final attribute name smells like a lock."""
    if isinstance(expr, ast.Call):  # e.g. self._lock.acquire_timeout()
        expr = expr.func
    if isinstance(expr, ast.Attribute):
        return any(tok in expr.attr.lower() for tok in _LOCKISH)
    return False


def _self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


class _MethodScan(ast.NodeVisitor):
    """Per-method scan: every `self.X` access site with its guard
    state (inside/outside a lock-ish `with`). ``skip`` holds nested
    FunctionDef nodes scanned separately (closures handed to a
    Thread/Timer run on the *other* thread, not this method's)."""

    def __init__(self, skip=()) -> None:
        self.guard_depth = 0
        self.skip = set(id(n) for n in skip)
        # attr -> list of (line, is_store, guarded)
        self.sites: Dict[str, List[Tuple[int, bool, bool]]] = {}

    def visit_FunctionDef(self, node):  # noqa: N802
        if id(node) in self.skip:
            return
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef  # noqa: N815

    def visit_With(self, node):  # noqa: N802
        lockish = any(_is_lockish_ctx(item.context_expr) for item in node.items)
        if lockish:
            self.guard_depth += 1
        self.generic_visit(node)
        if lockish:
            self.guard_depth -= 1

    def visit_Attribute(self, node):  # noqa: N802
        attr = _self_attr(node)
        if attr is not None:
            is_store = isinstance(node.ctx, (ast.Store, ast.Del))
            self.sites.setdefault(attr, []).append(
                (node.lineno, is_store, self.guard_depth > 0)
            )
        self.generic_visit(node)

    # nested defs run in whatever thread calls them; keep scanning
    # (a closure handed to a Timer from this method shares the state)


def _target_exprs(node: ast.Call) -> List[ast.AST]:
    """The callable expressions a Thread/Timer creation runs."""
    fn = node.func
    callee = (
        fn.id if isinstance(fn, ast.Name)
        else fn.attr if isinstance(fn, ast.Attribute) else None
    )
    if callee not in ("Thread", "Timer"):
        return []
    out = []
    for kw in node.keywords:
        if kw.arg in ("target", "function"):
            out.append(kw.value)
    if callee == "Timer" and len(node.args) >= 2:
        out.append(node.args[1])
    return out


def _thread_target_names(cls: ast.ClassDef) -> Set[str]:
    """Method names run on another thread: `target=self.<m>` /
    `Timer(_, self.<m>)` creations anywhere in the class, plus `run`
    for Thread subclasses."""
    targets: Set[str] = set()
    for base in cls.bases:
        name = (
            base.id if isinstance(base, ast.Name)
            else base.attr if isinstance(base, ast.Attribute) else None
        )
        if name == "Thread":
            targets.add("run")
    for node in ast.walk(cls):
        if isinstance(node, ast.Call):
            for expr in _target_exprs(node):
                attr = _self_attr(expr)
                if attr:
                    targets.add(attr)
    return targets


def _closure_targets(
    method: ast.FunctionDef,
) -> List[ast.FunctionDef]:
    """Nested functions this method hands to a Thread/Timer — they run
    on the other thread and are scanned as targets of their own."""
    local_defs = {
        n.name: n for n in ast.walk(method)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        and n is not method
    }
    out = []
    for node in ast.walk(method):
        if isinstance(node, ast.Call):
            for expr in _target_exprs(node):
                if isinstance(expr, ast.Name) and expr.id in local_defs:
                    fn = local_defs[expr.id]
                    if fn not in out:
                        out.append(fn)
    return out


def check_thread_shared_state(mod: ModuleSource) -> List[Finding]:
    findings: List[Finding] = []
    for cls in ast.walk(mod.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        targets = _thread_target_names(cls)
        methods = {
            m.name: m for m in cls.body
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        if not targets and not any(
            _closure_targets(m) for m in methods.values()
        ):
            continue
        scans: Dict[str, _MethodScan] = {}
        for name, m in methods.items():
            closures = _closure_targets(m)
            scan = _MethodScan(skip=closures)
            for stmt in m.body:
                scan.visit(stmt)
            scans[name] = scan
            # closures handed to a Thread/Timer are targets of their
            # own — their accesses happen on the spawned thread
            for fn in closures:
                cname = f"{name}.<{fn.name}>"
                cscan = _MethodScan()
                for stmt in fn.body:
                    cscan.visit(stmt)
                scans[cname] = cscan
                targets = targets | {cname}

        # attrs written from a thread target
        written_in_target: Set[str] = set()
        for t in targets & set(scans):
            for attr, sites in scans[t].sites.items():
                if any(is_store for (_, is_store, _) in sites):
                    written_in_target.add(attr)

        for attr in sorted(written_in_target):
            if _is_safe_attr_name(attr):
                continue
            accessed_in = {
                mname for mname, scan in scans.items()
                if attr in scan.sites and mname != "__init__"
            }
            in_target = accessed_in & targets
            outside_target = accessed_in - targets
            if not in_target or not outside_target:
                continue  # thread-private (or init-only): not shared
            for mname in sorted(accessed_in):
                for line, _is_store, guarded in scans[mname].sites[attr]:
                    if guarded:
                        continue
                    findings.append(Finding(
                        path=mod.path, line=line, rule=RULE,
                        message=(
                            f"self.{attr} is written from thread target "
                            f"'{sorted(in_target)[0]}' and accessed in "
                            f"'{mname}' without holding a lock — guard "
                            "every access with the owning lock or mark "
                            "the site `# lint: thread-lock-ok`"
                        ),
                    ))
    return findings
