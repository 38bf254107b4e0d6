"""Rule ``except`` — exception hygiene, package-wide (port of
``fedml_tpu/analysis/exceptions.py``, meaning kept).

Two shapes:

- **bare ``except:``** — catches ``SystemExit`` / ``KeyboardInterrupt``
  / ``ProcessKilled`` (the chaos plane's in-process kill -9, which
  MUST propagate), turning deliberate crashes into silent hangs;
- **swallow-without-evidence** — a handler whose entire body is
  ``pass`` / ``continue`` / ``break``: the failure leaves no log line
  and no counter, so a chaos run cannot distinguish "nothing broke"
  from "everything broke quietly". The fix pattern is a
  ``logging.debug(..., exc_info=True)`` plus a
  ``*_internal_errors_total`` counter tag, or a comment-suppression
  naming why silence is correct.
"""

from __future__ import annotations

import ast
from typing import List

from .engine import Finding, ModuleSource

RULE = "except"


def _is_noop(stmt: ast.stmt) -> bool:
    # `continue`/`break` in a handler is exception-as-control-flow
    # (queue.Empty, shutdown races) — observable behaviour, not a
    # swallow; only a pure `pass` body hides the failure entirely
    if isinstance(stmt, ast.Pass):
        return True
    # a bare docstring/Ellipsis expression
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Constant):
        return True
    return False


def check_exceptions(mod: ModuleSource) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            findings.append(Finding(
                path=mod.path, line=node.lineno, rule=RULE,
                message=(
                    "bare `except:` catches SystemExit/KeyboardInterrupt/"
                    "ProcessKilled — name the exception types"
                ),
            ))
        if node.body and all(_is_noop(s) for s in node.body):
            findings.append(Finding(
                path=mod.path, line=node.lineno, rule=RULE,
                message=(
                    "exception swallowed without a log or counter — add "
                    "logging.debug(..., exc_info=True) and/or a "
                    "*_internal_errors_total tag, or mark the line "
                    "`# lint: except-ok` naming why silence is correct"
                ),
            ))
    return findings
