"""`fedml_tpu_torch.cli lint` — the AST engine of the port's
static-analysis suite (port of ``fedml_tpu/analysis/engine.py``; the
rule catalog is ``docs/static_analysis.md``).

Why a purpose-built linter instead of flake8 plugins: the defect
classes that keep recurring in review (hidden host syncs in round hot
paths, non-derived RNG in seeded paths, swallowed exceptions, unlocked
cross-thread state, and drift between MSG_TYPE/telemetry/knob
registries and their docs) are all *semantic to this codebase* — they
need to know which modules are hot paths, what the telemetry naming
convention is, and where the knob schema lives. Generic linters cannot
say any of that.

Design:

- pure stdlib (``ast`` + ``re`` + ``json``). Importing this package
  must never import torch — the gate runs the whole pass in seconds on
  a bare checkout.
- the corpus is ``fedml_tpu_torch/**`` under the strict profile plus
  the port's tests (``tests/test_torch_*.py``, ``tests/torch_world.py``)
  under the relaxed one; the baseline is ``lint_baseline_torch.json``
  at the repo root (``lint_baseline.json`` is the JAX package's).
- checkers are functions. *Module* checkers take one
  :class:`ModuleSource` and return findings; *project* checkers take
  the whole corpus (plus the docs text) — registry-consistency checks
  are cross-file by nature.
- suppression is per-line and per-rule: ``# lint: <rule>-ok`` on the
  offending line (or the line above, for wrapped statements) —
  mirroring the DeferredMetrics discipline where a deliberate host
  sync is *named*, never silent.
- the baseline (:func:`load_baseline` / :func:`diff_baseline`) is a
  **ratchet**: pre-existing findings are keyed by
  ``path:rule:message`` with a count; CI fails on any NEW finding
  *and* on any stale entry (a fixed finding must shrink the baseline
  in the same change — suppressions can only burn down).
"""

from __future__ import annotations

import ast
import fnmatch
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

BASELINE_NAME = "lint_baseline_torch.json"

# one id per checker; docs/static_analysis.md is the rule catalog. The
# JAX rules ``retrace`` and ``donation`` (jit retraces, donated buffers)
# have no PyTorch meaning and are left out, not emulated.
RULES = (
    "host-sync",
    "determinism",
    "except",
    "thread-lock",
    "registry",
)

_SUPPRESS_RE = re.compile(r"#\s*lint:\s*([a-z-]+(?:\s*,\s*[a-z-]+)*)-ok\b")
_SUPPRESS_SPLIT_RE = re.compile(r"-ok\b[\s,]*")


@dataclass(frozen=True, order=True)
class Finding:
    """One defect at one site. ``message`` is line-number-free on
    purpose: the baseline keys on ``path:rule:message`` (+ count), so
    unrelated edits that shift lines never churn the ratchet."""

    path: str  # repo-relative, posix separators
    line: int
    rule: str
    message: str

    def key(self) -> str:
        return f"{self.path}:{self.rule}:{self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> Dict[str, object]:
        return {
            "path": self.path,
            "line": self.line,
            "rule": self.rule,
            "message": self.message,
        }


@dataclass
class ModuleSource:
    """One parsed module: source text, AST, and the per-line rule
    suppressions the engine honours for every checker."""

    path: str  # repo-relative
    text: str
    tree: ast.AST
    lines: List[str] = field(default_factory=list)
    # line number (1-based) -> set of suppressed rule ids
    suppressions: Dict[int, set] = field(default_factory=dict)
    # lines that are ONLY a suppression comment — these also cover the
    # following line (for wrapped statements); inline ones cover only
    # their own line
    standalone_suppressions: set = field(default_factory=set)

    @classmethod
    def parse(cls, path: str, text: str) -> "ModuleSource":
        tree = ast.parse(text, filename=path)
        lines = text.splitlines()
        suppressions: Dict[int, set] = {}
        standalone = set()
        for i, line in enumerate(lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            chunk = line[m.start(1):]
            rules = {
                tok.strip() for tok in _SUPPRESS_SPLIT_RE.split(chunk)
                if tok.strip()
            }
            suppressions[i] = rules
            if line.lstrip().startswith("#"):
                standalone.add(i)
        return cls(
            path=path, text=text, tree=tree, lines=lines,
            suppressions=suppressions, standalone_suppressions=standalone,
        )

    def is_suppressed(self, rule: str, line: int) -> bool:
        """The finding's own line always; the line above only when it
        is a standalone suppression comment (an inline suppression
        covers its own statement, not its neighbour)."""
        if rule in self.suppressions.get(line, set()):
            return True
        prev = line - 1
        return prev in self.standalone_suppressions and rule in (
            self.suppressions.get(prev, set())
        )


# -- corpus ------------------------------------------------------------

_SKIP_DIRS = {"__pycache__"}

PACKAGE = "fedml_tpu_torch"

# files linted under the RELAXED profile: the port's tests are not
# shipped hot paths, but a bare `except:` still eats ProcessKilled
# mid-chaos and a global-RNG draw is exactly how order-dependent flakes
# are born — so the exception + determinism rules apply there (nothing
# else), baselined and ratcheted like the main corpus. The other files
# of tests/ are the JAX package's, linted by its own gate
RELAXED_DIRS = ("tests",)
RELAXED_PREFIXES = tuple(d + "/" for d in RELAXED_DIRS)
RELAXED_GLOBS = ("test_torch_*.py", "torch_world.py")

# a series only the port emits is documented here: never under docs/,
# whose every *.md the JAX package's own gate reads
PORT_SERIES_DOC = "fedml_tpu_torch/analysis/series.md"


def is_relaxed_path(path: str) -> bool:
    return path.startswith(RELAXED_PREFIXES)


def find_repo_root(start: Optional[str] = None) -> str:
    """The directory holding ``fedml_tpu_torch/`` and ``pyproject.toml`` —
    walked up from ``start`` (default: this file's grandparent, which
    is correct for an in-tree checkout; ``--root`` overrides)."""
    here = os.path.dirname(os.path.abspath(__file__))
    candidates = []
    if start:
        candidates.append(os.path.abspath(start))
    candidates.append(os.path.abspath(os.path.join(here, "..", "..")))
    candidates.append(os.getcwd())
    for cand in candidates:
        d = cand
        for _ in range(6):
            if os.path.isdir(os.path.join(d, PACKAGE)) and os.path.isfile(
                os.path.join(d, "pyproject.toml")
            ):
                return d
            parent = os.path.dirname(d)
            if parent == d:
                break
            d = parent
    raise FileNotFoundError(
        "could not locate the repo root (a directory containing both "
        "fedml_tpu_torch/ and pyproject.toml); pass --root explicitly"
    )


def load_corpus(
    root: str, rel_paths: Optional[Sequence[str]] = None
) -> List[ModuleSource]:
    """Parse every ``fedml_tpu_torch/**/*.py`` and the port's tests
    under ``root`` (or an explicit subset). Unparseable files raise — a
    syntax error is not a lint finding, it is a broken tree nothing
    downstream could run."""
    if rel_paths:
        files = sorted(os.path.normpath(p).replace(os.sep, "/") for p in rel_paths)
    else:
        files = []
        pkg = os.path.join(root, PACKAGE)
        for base, dirs, names in os.walk(pkg):
            dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
            for name in sorted(names):
                if name.endswith(".py"):
                    rel = os.path.relpath(os.path.join(base, name), root)
                    files.append(rel.replace(os.sep, "/"))
        for top in RELAXED_DIRS:
            d = os.path.join(root, top)
            if not os.path.isdir(d):
                continue
            for name in sorted(os.listdir(d)):
                if any(fnmatch.fnmatchcase(name, g) for g in RELAXED_GLOBS):
                    files.append(f"{top}/{name}")
    corpus = []
    for rel in files:
        with open(os.path.join(root, rel), "r", encoding="utf-8") as fh:
            text = fh.read()
        corpus.append(ModuleSource.parse(rel, text))
    return corpus


def load_docs_text(root: str) -> str:
    """Concatenated ``docs/*.md`` (read, never written: the port emits
    the JAX package's series names) and the port's own series file —
    the registry checker's documentation source of truth."""
    paths = []
    docs = os.path.join(root, "docs")
    if os.path.isdir(docs):
        paths += [os.path.join(docs, n) for n in sorted(os.listdir(docs)) if n.endswith(".md")]
    port_doc = os.path.join(root, PORT_SERIES_DOC)
    if os.path.isfile(port_doc):
        paths.append(port_doc)
    chunks = []
    for path in paths:
        with open(path, "r", encoding="utf-8") as fh:
            chunks.append(fh.read())
    return "\n".join(chunks)


# -- checker registry --------------------------------------------------

ModuleChecker = Callable[[ModuleSource], List[Finding]]


def _module_checkers() -> List[ModuleChecker]:
    from . import determinism, exceptions, hostsync, threads

    return [
        hostsync.check_host_sync,
        determinism.check_determinism,
        exceptions.check_exceptions,
        threads.check_thread_shared_state,
    ]


def _relaxed_checkers() -> List[ModuleChecker]:
    """The tests/ profile: exception hygiene + determinism only. Hot-
    path rules (host-sync/thread-lock) are shipped-
    code contracts — they do not apply to test harness code."""
    from . import determinism, exceptions

    return [
        lambda mod: determinism.check_determinism(mod, force=True),
        exceptions.check_exceptions,
    ]


def run_lint(
    root: str,
    rel_paths: Optional[Sequence[str]] = None,
    corpus: Optional[List[ModuleSource]] = None,
    docs_text: Optional[str] = None,
) -> List[Finding]:
    """Run every checker over the corpus, apply suppressions, return
    sorted findings. ``corpus``/``docs_text`` are injectable for tests."""
    from .registry import check_registry

    if corpus is None:
        corpus = load_corpus(root, rel_paths)
    if docs_text is None:
        docs_text = load_docs_text(root)
    by_path = {m.path: m for m in corpus}
    findings: List[Finding] = []
    for mod in corpus:
        checkers = (
            _relaxed_checkers() if is_relaxed_path(mod.path)
            else _module_checkers()
        )
        for checker in checkers:
            findings.extend(checker(mod))
    # the project checker only makes sense over the full package —
    # a path-subset run would report every registry entry as missing.
    # The relaxed corpus (tests/) is excluded: its args are fixtures,
    # its series names are assertions, not emissions. The registry
    # checker's own defaults name the port's constants and arguments
    if not rel_paths:
        findings.extend(check_registry(
            [m for m in corpus if not is_relaxed_path(m.path)], docs_text
        ))
    kept = []
    for f in findings:
        mod = by_path.get(f.path)
        if mod is not None and mod.is_suppressed(f.rule, f.line):
            continue
        kept.append(f)
    return sorted(kept)


# -- baseline ratchet --------------------------------------------------

def findings_to_counts(findings: Iterable[Finding]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.key()] = counts.get(f.key(), 0) + 1
    return counts


def load_baseline(path: str) -> Dict[str, int]:
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if not isinstance(data, dict) or "entries" not in data:
        raise ValueError(
            f"{path}: not a lint baseline (expected an object with an "
            "'entries' map)"
        )
    entries = data["entries"]
    return {str(k): int(v) for k, v in entries.items()}


def save_baseline(
    path: str, findings: Iterable[Finding], comment: Optional[str] = None
) -> None:
    """Write a ratchet ledger (``comment`` overrides the default
    header)."""
    counts = findings_to_counts(findings)
    payload = {
        "comment": comment or (
            "Ratchet-only suppression ledger for `python -m "
            "fedml_tpu_torch.cli lint` (docs/static_analysis.md). Entries "
            "may only be REMOVED (by fixing the finding); CI fails on new "
            "findings AND on stale entries. Regenerate with `python -m "
            "fedml_tpu_torch.cli lint --update-baseline` after a burn-down."
        ),
        "version": 1,
        "entries": {k: counts[k] for k in sorted(counts)},
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1, sort_keys=False)
        fh.write("\n")


def diff_baseline(
    findings: Sequence[Finding], baseline: Dict[str, int]
) -> Tuple[List[Finding], List[str]]:
    """(new findings, stale baseline keys). New = beyond the
    baselined count for that key; stale = the baseline grants more
    suppressions than findings exist (the fix must also shrink the
    baseline — that is the ratchet)."""
    counts = findings_to_counts(findings)
    new: List[Finding] = []
    budget = dict(baseline)
    for f in sorted(findings):
        if budget.get(f.key(), 0) > 0:
            budget[f.key()] -= 1
        else:
            new.append(f)
    stale = sorted(
        k for k, v in baseline.items() if counts.get(k, 0) < v
    )
    return new, stale


# -- CLI surface (shared by fedml_tpu_torch.cli and the bare entry point)

def run_ratchet_cli(
    prog: str,
    args,
    findings: Sequence[Finding],
    baseline_path: str,
    baseline_filter: Optional[Callable[[Dict[str, int]], Dict[str, int]]] = None,
    save_comment: Optional[str] = None,
    json_extra: Optional[Dict[str, object]] = None,
    summary_prefix: str = "",
    summary_suffix: str = "",
) -> int:
    """THE ratchet gate ladder: rewrite on --update-baseline, raw on
    --no-baseline, diff against the (optionally subset-filtered)
    baseline when it exists, refuse --ci without one — then render text
    or JSON and return the exit code."""
    import sys

    if args.ci and args.no_baseline:
        print(
            f"{prog}: --ci and --no-baseline are mutually exclusive "
            "(the CI gate IS the ratchet — a raw run silently drops "
            "the stale-entry check)", file=sys.stderr,
        )
        return 2
    if args.update_baseline:
        save_baseline(baseline_path, findings, comment=save_comment)
        print(
            f"{prog}: baseline rewritten with {len(findings)} finding(s) "
            f"-> {baseline_path}"
        )
        return 0

    if args.no_baseline:
        new, stale = list(findings), []
        baselined = 0
    elif os.path.isfile(baseline_path):
        baseline = load_baseline(baseline_path)
        if baseline_filter is not None:
            baseline = baseline_filter(baseline)
        new, stale = diff_baseline(findings, baseline)
        baselined = len(findings) - len(new)
    elif args.ci:
        print(
            f"{prog}: --ci requires the checked-in baseline "
            f"({baseline_path}); refusing to run raw", file=sys.stderr,
        )
        return 2
    else:
        new, stale = list(findings), []
        baselined = 0

    ok = not new and not stale
    if args.as_json:
        payload: Dict[str, object] = {"ok": ok}
        payload.update(json_extra or {})
        payload.update({
            "total": len(findings),
            "baselined": baselined,
            "new": [f.to_dict() for f in new],
            "stale": stale,
            "findings": [f.to_dict() for f in findings],
        })
        print(json.dumps(payload))
    else:
        for f in new:
            print(f.render())
        for key in stale:
            print(
                f"stale baseline entry (finding fixed — remove it from "
                f"the baseline): {key}"
            )
        print(
            f"{prog}: {summary_prefix}{len(findings)} finding(s) — "
            f"{len(new)} new, {baselined} baselined, {len(stale)} stale "
            f"baseline entr{'y' if len(stale) == 1 else 'ies'}"
            f"{summary_suffix}"
        )
    return 0 if ok else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="fedml-tpu-torch-lint")
    add_lint_arguments(p)
    return run_cli(p.parse_args(argv))


def add_lint_arguments(p) -> None:
    p.add_argument(
        "paths", nargs="*",
        help="repo-relative .py files to lint (default: all of "
             "fedml_tpu_torch/ and the port's tests; a subset run skips "
             "the project-wide registry checker)",
    )
    p.add_argument(
        "--root", default=None,
        help="repo root (default: auto-detected from the package "
             "location / cwd)",
    )
    p.add_argument(
        "--baseline", default=None,
        help=f"baseline path (default: <root>/{BASELINE_NAME})",
    )
    p.add_argument(
        "--json", dest="as_json", action="store_true",
        help="machine-readable output (one JSON object)",
    )
    p.add_argument(
        "--ci", action="store_true",
        help="CI gate mode: the baseline file MUST exist (a deleted "
             "baseline must fail the gate, not silently pass a raw "
             "run) and --update-baseline is rejected",
    )
    p.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline from the current findings "
             "(burn-down workflow; never valid under --ci)",
    )
    p.add_argument(
        "--no-baseline", action="store_true",
        help="report raw findings without ratcheting (exit 1 if any)",
    )


def run_cli(args) -> int:
    import sys

    try:
        root = find_repo_root(args.root)
    except FileNotFoundError as e:
        print(f"lint: {e}", file=sys.stderr)
        return 2
    if args.ci and args.update_baseline:
        print(
            "lint: --ci and --update-baseline are mutually exclusive "
            "(the CI gate ratchets; it never rewrites)", file=sys.stderr,
        )
        return 2
    if args.paths and args.update_baseline:
        print(
            "lint: --update-baseline needs a FULL run — a subset run "
            "skips the registry checker and would overwrite the "
            "ledger with only the subset's findings", file=sys.stderr,
        )
        return 2
    findings = run_lint(root, rel_paths=args.paths or None)
    baseline_path = args.baseline or os.path.join(root, BASELINE_NAME)

    def subset_filter(baseline: Dict[str, int]) -> Dict[str, int]:
        # a subset run can only judge the files it linted — other
        # files' baseline entries are neither new nor stale here.
        # Registry entries are dropped too: the project-wide registry
        # checker does not run on subsets, so its baselined findings
        # would all read as falsely stale
        linted = {
            os.path.normpath(p).replace(os.sep, "/") for p in args.paths
        }
        return {
            k: v for k, v in baseline.items()
            if k.split(":", 1)[0] in linted
            and k.split(":", 2)[1] != "registry"
        }

    return run_ratchet_cli(
        "lint", args, findings, baseline_path,
        baseline_filter=subset_filter if args.paths else None,
        json_extra={"root": root},
    )


if __name__ == "__main__":
    import sys

    sys.exit(main())
