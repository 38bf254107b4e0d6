"""``python -m fedml_tpu_torch.cli audit``: the compiled-artifact audit
over the :mod:`fedml_tpu_torch.analysis.compiled` registry (port of
``fedml_tpu/analysis/audit.py``).

Three checkers over each registered executable's fake-tensor trace (the
trace records every op; **nothing executes**, no data exists, and a
CPU-only box finishes the whole census in seconds):

- ``aot-host-transfer``: no op in a hot executable that makes the card
  wait for the host: a scalar read (``.item()``, ``float(t)``,
  ``bool(t)``), a copy from the card to the host, or an op whose output
  shape depends on the values (``nonzero``, ``masked_select``,
  ``unique``). The traced counterpart of the lint suite's source-level
  host-sync rule.
- ``aot-census``: traced shape keys per executable must fit the pow2
  bucket budget.
- ``aot-constant``: no large non-splat host data made into a tensor
  inside the body (``torch.tensor`` of a list and the like: it crosses
  to the card on every call; pass it as an argument).

The JAX package's fourth rule, ``aot-donation`` (input-output aliasing
must cover every buffer the docstrings claim donated), is left out:
PyTorch has no input-output aliasing contract to check, as ``cli lint``
leaves out the JAX ``donation`` rule. The report says so under
``rules_left_out``.

A static cost (FLOPs and bytes, by the rules of XLA's cost analysis:
products by ``torch.utils.flop_counter``'s formulas, one FLOP an output
element of elementwise arithmetic, one an input element of a reduction,
bytes as every op's inputs and outputs with no fusion) is written into
``audit_report_torch.json``: the denominator ``cli perf`` joins measured
seconds to.

Findings ride the lint suite's count-keyed baseline and ratchet
(``engine.run_ratchet_cli``) against the port's own
``audit_baseline_torch.json`` (``audit_baseline.json`` is the JAX
package's): ``--ci`` fails on any NEW finding and on any STALE entry.

Import discipline: importing this module must not import torch, as the
JAX module does not import JAX: the CLI builds its parser from here.
torch loads inside :func:`run_audit`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .compiled import (
    FAKE_DEVICE,
    LOWERING,
    AuditContext,
    AuditableSpec,
    load_registry,
    lower_case,
)
from .engine import (
    Finding,
    find_repo_root,
    run_ratchet_cli,
)

AUDIT_BASELINE_NAME = "audit_baseline_torch.json"
# never the JAX package's audit_report.json, which its own tests read
AUDIT_REPORT_NAME = "audit_report_torch.json"

RULE_HOST = "aot-host-transfer"
RULE_CENSUS = "aot-census"
RULE_CONSTANT = "aot-constant"

AUDIT_RULES = (RULE_HOST, RULE_CENSUS, RULE_CONSTANT)

# the JAX rule the port leaves out, and why (the report carries it)
RULES_LEFT_OUT = {
    "aot-donation": (
        "PyTorch has no input-output aliasing contract (no donate_argnums): "
        "nothing in a traced executable says a buffer is donated, so there is "
        "nothing to hold the docstrings to; cli lint leaves out the JAX "
        "'donation' rule for the same reason"
    ),
}

_BASELINE_COMMENT = (
    "Ratchet-only suppression ledger for `python -m fedml_tpu_torch.cli "
    "audit` (the port's compiled-artifact audit). Entries are traced "
    "contract violations accepted as known TODOs; they may only be REMOVED "
    "(by fixing the executable). CI fails on new findings AND on stale "
    "entries. Regenerate with `python -m fedml_tpu_torch.cli audit "
    "--update-baseline` after a burn-down."
)


def audit_spec(
    spec: AuditableSpec, ctx: AuditContext
) -> Tuple[List[Finding], List[Dict[str, Any]]]:
    """Trace one spec's census and run the three checkers. Returns
    (findings, per-case report entries)."""
    findings: List[Finding] = []
    entries: List[Dict[str, Any]] = []
    try:
        cases = spec.provider(ctx)
    except Exception as e:
        raise RuntimeError(
            f"auditable '{spec.name}' ({spec.path}): provider failed to "
            f"build its census: {e}"
        ) from e
    budget = spec.census_budget
    if callable(budget):
        budget = budget(ctx)
    if budget is not None and len(cases) > int(budget):
        findings.append(Finding(
            path=spec.path, line=0, rule=RULE_CENSUS,
            message=(
                f"executable '{spec.name}': {len(cases)} traced shape "
                f"keys exceed the pow2 census budget of {int(budget)} — "
                "a census overflow is a shape-key storm built into the "
                "executable set"
            ),
        ))
    for case in cases:
        try:
            art = lower_case(spec, case)
        except Exception as e:
            raise RuntimeError(
                f"auditable '{spec.name}' case '{case.key}' "
                f"({spec.path}): the fake-tensor trace failed: {e}"
            ) from e
        if spec.hot and art.host_transfers:
            findings.append(Finding(
                path=spec.path, line=0, rule=RULE_HOST,
                message=(
                    f"executable '{spec.name}': hot executable traces "
                    "host-transfer ops "
                    f"({', '.join(art.host_transfers)}) — every call "
                    "stalls the device on the host"
                ),
            ))
        if art.max_constant_bytes > spec.constant_budget_bytes:
            findings.append(Finding(
                path=spec.path, line=0, rule=RULE_CONSTANT,
                message=(
                    f"executable '{spec.name}': host constant of "
                    f"{art.max_constant_bytes} bytes exceeds the "
                    f"{spec.constant_budget_bytes}-byte budget — host "
                    "data made into a tensor in the body crosses to the "
                    "card on every call; pass it as an argument"
                ),
            ))
        entry: Dict[str, Any] = {
            "executable": spec.name,
            "case": case.key,
            "path": spec.path,
            "round_shaped": spec.round_shaped,
            "hot": spec.hot,
            "claimed_donated_leaves": art.claimed_donated_leaves,
            "aliased_inputs": art.aliased_inputs,
            "host_transfers": art.host_transfers,
            "max_constant_bytes": art.max_constant_bytes,
            "flops": art.flops,
            "bytes_accessed": art.bytes_accessed,
            "kernels": art.kernels,
            "real_inputs": len(art.real_inputs),
        }
        if art.flops and art.bytes_accessed:
            # arithmetic intensity (FLOPs/byte): where this executable
            # sits on the roofline
            entry["arithmetic_intensity"] = art.flops / art.bytes_accessed
        entries.append(entry)
    return findings, entries


def run_audit(
    ctx: Optional[AuditContext] = None,
    only: Optional[Sequence[str]] = None,
    registry: Optional[Dict[str, AuditableSpec]] = None,
) -> Tuple[List[Finding], Dict[str, Any]]:
    """Trace and check every registered executable. ``registry`` is
    injectable for tests; ``only`` filters by executable name."""
    import torch

    ctx = ctx or AuditContext()
    specs = registry if registry is not None else load_registry()
    names = sorted(specs)
    if only:
        missing = sorted(set(only) - set(names))
        if missing:
            raise KeyError(
                f"unknown auditable(s) {missing}; registered: {names}"
            )
        names = [n for n in names if n in set(only)]
    findings: List[Finding] = []
    executables: List[Dict[str, Any]] = []
    try:
        for name in names:
            f, entries = audit_spec(specs[name], ctx)
            findings.extend(f)
            executables.extend(entries)
    finally:
        ctx.close()
    report = {
        "version": 1,
        "tool": "fedml-tpu-torch audit",
        # the device the fake tensors stand for: the runtime's card
        "platform": "cuda",
        "fake_device": FAKE_DEVICE,
        "torch_version": torch.__version__,
        "lowering": LOWERING,
        "rules_left_out": dict(RULES_LEFT_OUT),
        "census": ctx.to_dict(),
        "executables": executables,
        # per round-shaped executable and census case, the static FLOPs a
        # run's measured seconds are divided into (cli perf)
        "roofline": [
            {
                "executable": e["executable"],
                "case": e["case"],
                "flops": e["flops"],
                "bytes_accessed": e["bytes_accessed"],
                "arithmetic_intensity": e.get("arithmetic_intensity"),
            }
            for e in executables
            if e["round_shaped"] and e["flops"] is not None
        ],
    }
    return sorted(findings), report


# -- CLI surface (shared by fedml_tpu_torch.cli and the bare entry point)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="fedml-tpu-torch-audit")
    add_audit_arguments(p)
    return run_cli(p.parse_args(argv))


def add_audit_arguments(p) -> None:
    p.add_argument(
        "--root", default=None,
        help="repo root (default: auto-detected from the package "
             "location / cwd)",
    )
    p.add_argument(
        "--baseline", default=None,
        help=f"baseline path (default: <root>/{AUDIT_BASELINE_NAME})",
    )
    p.add_argument(
        "--report", default=None,
        help=f"where to write the static-cost report (default: "
             f"<root>/{AUDIT_REPORT_NAME})",
    )
    p.add_argument(
        "--only", action="append", default=None, metavar="NAME",
        help="audit only this registered executable (repeatable). The "
             "ratchet still applies, filtered to the selected "
             "executables' baseline entries — other entries are "
             "neither new nor stale in a subset run",
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
        print(f"audit: {e}", file=sys.stderr)
        return 2
    if args.ci and args.update_baseline:
        print(
            "audit: --ci and --update-baseline are mutually exclusive "
            "(the CI gate ratchets; it never rewrites)", file=sys.stderr,
        )
        return 2
    if args.only and args.update_baseline:
        print(
            "audit: --update-baseline needs a FULL run — an --only "
            "subset would overwrite the ledger with only the subset's "
            "findings", file=sys.stderr,
        )
        return 2
    try:
        findings, report = run_audit(only=args.only)
    except (RuntimeError, KeyError) as e:
        print(f"audit: {e}", file=sys.stderr)
        return 2
    baseline_path = args.baseline or os.path.join(root, AUDIT_BASELINE_NAME)

    if not args.only:
        report_path = args.report or os.path.join(root, AUDIT_REPORT_NAME)
        with open(report_path, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=1)
            fh.write("\n")
    else:
        report_path = None

    def only_filter(baseline):
        # a subset run can only judge the executables it traced — other
        # specs' baseline entries are neither new nor stale here. Every
        # audit message embeds "executable '<name>'", so filtering by
        # that tag keeps exactly the selected specs' accepted TODOs
        tags = tuple(f"executable '{n}'" for n in args.only)
        return {
            k: v for k, v in baseline.items()
            if any(t in k for t in tags)
        }

    return run_ratchet_cli(
        "audit", args, findings, baseline_path,
        baseline_filter=only_filter if args.only else None,
        save_comment=_BASELINE_COMMENT,
        json_extra={
            "root": root,
            "report": report_path,
            "executables": len(report["executables"]),
        },
        summary_prefix=f"{len(report['executables'])} traced case(s), ",
        summary_suffix=(f"; report -> {report_path}" if report_path else ""),
    )


if __name__ == "__main__":
    import sys

    sys.exit(main())
