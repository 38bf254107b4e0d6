"""``python -m fedml_tpu_torch.cli perf``: the performance-attribution
plane (port of ``fedml_tpu/analysis/perf.py``).

Closes the loop between what the audit *traced*
(``audit_report_torch.json``: static FLOPs / bytes / arithmetic
intensity per registered executable, ``cli audit``) and what a run
*measured* (``exec_device_seconds{executable,bucket}`` histograms from
``core/devtime.py``, ``round.ledger`` instants from the cross-silo
server). Three outputs, as in the JAX package:

* **roofline join**: per measured executable series, achieved FLOP/s =
  audit FLOPs x calls / measured seconds, ``mfu_vs_bf16_peak`` against
  the per-device-kind peak table in ``constants.py`` and a compute- or
  memory-bound verdict from arithmetic intensity against the device's
  ridge point. The audit traces small shapes, so the joined MFU
  *attributes* time across executables consistently; it is not the
  card's efficiency.
* **idle-time ledger**: per round, the measured segments plus the
  ``round_idle_seconds{gap=...}`` gaps; segments + intra-round idle
  reconcile to ``round_wall_seconds`` (the CLI reports the
  reconciliation fraction; the tests hold it within 5%).
* **bench ratchet**: ``--ratchet BENCH_*.json`` groups records by
  (phase, device_kind, smoke) through their meta blocks and fails when
  the newest record regresses beyond ``--tolerance`` against the best
  prior record of the SAME group.

**The seconds are not the card's.** The port's ``exec_device_seconds``
keeps the JAX series name, so either package's ``perf`` reads either
package's telemetry, but it is host wall time around an asynchronous
launch (``serving.forward``'s also holds the fetch of its result). The
roofline says so (``seconds_clock``) and the table heads the column
``wall_s``.

Pure stdlib (the ``analysis`` package contract): no torch, no numpy.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import constants
from .engine import find_repo_root

# the port's report (the JAX package's is audit_report.json)
AUDIT_REPORT_NAME = "audit_report_torch.json"
PERF_REPORT_NAME = "perf_report.json"

# ratchet tolerance: relative regression allowed before the gate trips.
# 10% rides out benchmark jitter on shared/CI hosts (the checked-in
# trajectory's worst benign wobble is ~6%) while catching the 2x-class
# regressions the gate exists for.
DEFAULT_TOLERANCE = 0.10

# what the port's exec_device_seconds measure (core/devtime.py)
SECONDS_CLOCK = "host wall clock around the call"

# roofline-join coverage gate: fraction of measured device seconds that
# joined to an audit row (the acceptance bar for instrumented runs)
DEFAULT_MIN_COVERAGE = 0.9


# -- series-key parsing ------------------------------------------------

_SERIES_RE = re.compile(r"^(?P<name>[^{]+)(?:\{(?P<tags>.*)\})?$")


def parse_series_key(key: str) -> Tuple[str, Dict[str, str]]:
    """``"name{k=v,k2=v2}"`` (Telemetry._fmt) -> (name, tags)."""
    m = _SERIES_RE.match(key)
    if not m:
        return key, {}
    tags: Dict[str, str] = {}
    raw = m.group("tags")
    if raw:
        for part in raw.split(","):
            k, _, v = part.partition("=")
            tags[k.strip()] = v.strip()
    return m.group("name"), tags


# -- telemetry.jsonl / trace.json loaders ------------------------------


def load_snapshots(telemetry_dir: str) -> List[Dict[str, Any]]:
    """Last ``telemetry_snapshot`` line per (run_id, rank) from
    ``telemetry.jsonl`` — the registry state at export time (cumulative
    since process start, so the last snapshot per process wins)."""
    path = os.path.join(telemetry_dir, "telemetry.jsonl")
    if not os.path.isfile(path):
        return []
    last: Dict[Tuple[str, int], Dict[str, Any]] = {}
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("kind") != "telemetry_snapshot":
                continue
            key = (str(rec.get("run_id")), int(rec.get("rank", 0) or 0))
            last[key] = rec
    return [last[k] for k in sorted(last)]


def exec_seconds_from_snapshots(
    snapshots: Sequence[Dict[str, Any]],
) -> Dict[Tuple[str, str], Dict[str, float]]:
    """Merge ``exec_device_seconds`` histograms across processes:
    (executable, bucket) -> {count, sum, min, max}. Bucket ``""`` means
    the series carried no bucket tag (the untagged agg folds)."""
    merged: Dict[Tuple[str, str], Dict[str, float]] = {}
    for snap in snapshots:
        for key, h in (snap.get("histograms") or {}).items():
            name, tags = parse_series_key(key)
            if name != "exec_device_seconds":
                continue
            k = (tags.get("executable", ""), tags.get("bucket", ""))
            cur = merged.get(k)
            if cur is None:
                merged[k] = {
                    "count": float(h.get("count", 0.0)),
                    "sum": float(h.get("sum", 0.0)),
                    "min": float(h.get("min", 0.0)),
                    "max": float(h.get("max", 0.0)),
                }
            else:
                cur["count"] += float(h.get("count", 0.0))
                cur["sum"] += float(h.get("sum", 0.0))
                cur["min"] = min(cur["min"], float(h.get("min", 0.0)))
                cur["max"] = max(cur["max"], float(h.get("max", 0.0)))
    return merged


def load_ledgers(telemetry_dir: str) -> List[Dict[str, Any]]:
    """``round.ledger`` instant args from every trace shard in the
    run directory (``trace.json`` / ``trace_rank*.json``), ordered by
    (shard, round)."""
    ledgers: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(telemetry_dir, "trace*.json"))):
        if os.path.basename(path).startswith("trace_merged"):
            continue  # the stitcher's output duplicates the shards
        try:
            with open(path, encoding="utf-8") as fh:
                payload = json.load(fh)
        except (json.JSONDecodeError, OSError):
            continue
        for ev in payload.get("traceEvents", []):
            if ev.get("name") == "round.ledger" and ev.get("ph") == "i":
                args = dict(ev.get("args") or {})
                if "wall_s" in args:
                    ledgers.append(args)
    return ledgers


# -- idle-gap attribution (shared with the live server) ---------------


def attribute_idle(
    *,
    now: float,
    bcast_t0: float,
    last_arrival: float,
    aggregate_s: float,
    prev_close: Optional[float] = None,
) -> Dict[str, float]:
    """The idle-gap arithmetic, in one place: the cross-silo server
    calls this live per round and the oracle tests call it with
    synthetic timelines. ``arrival_to_aggregate`` is intra-round (last
    upload in hand -> aggregate start) and reconciles with the
    measured segments to the round wall; ``close_to_broadcast`` is the
    server's idle BETWEEN rounds (previous ledger close -> this
    broadcast) and is excluded from intra-round reconciliation."""
    agg_start = now - max(aggregate_s, 0.0)
    idle = {"arrival_to_aggregate": max(agg_start - last_arrival, 0.0)}
    if prev_close is not None:
        idle["close_to_broadcast"] = max(bcast_t0 - prev_close, 0.0)
    return idle


def summarize_ledger(ledgers: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-round reconciliation + run totals from ``round.ledger``
    instants. ``recon_frac`` = (segments + intra-round idle) / wall —
    1.0 means the ledger accounts for every second of the round."""
    rounds: List[Dict[str, Any]] = []
    total_wall = 0.0
    idle_totals: Dict[str, float] = {}
    wire_fracs: List[float] = []
    for led in ledgers:
        wall = float(led.get("wall_s", 0.0))
        segs = {k: float(v) for k, v in (led.get("segments") or {}).items()}
        idle = {k: float(v) for k, v in (led.get("idle") or {}).items()}
        intra_idle = idle.get("arrival_to_aggregate", 0.0)
        accounted = sum(segs.values()) + intra_idle
        rounds.append(
            {
                "round": led.get("round"),
                "wall_s": wall,
                "segments": segs,
                "idle": idle,
                "accounted_s": round(accounted, 6),
                "recon_frac": round(accounted / wall, 4) if wall > 0 else None,
                "wire_utilization_frac": led.get("wire_utilization_frac"),
            }
        )
        total_wall += wall
        for k, v in idle.items():
            idle_totals[k] = idle_totals.get(k, 0.0) + v
        wf = led.get("wire_utilization_frac")
        if wf is not None:
            wire_fracs.append(float(wf))
    return {
        "rounds": rounds,
        "total_wall_s": round(total_wall, 6),
        "idle_totals_s": {k: round(v, 6) for k, v in sorted(idle_totals.items())},
        "mean_wire_utilization_frac": (
            round(sum(wire_fracs) / len(wire_fracs), 4) if wire_fracs else None
        ),
    }


# -- roofline join -----------------------------------------------------


def load_audit_report(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def _pick_audit_row(
    rows: List[Dict[str, Any]], bucket: str
) -> Tuple[Optional[Dict[str, Any]], bool]:
    """Case match for one measured series: exact ``case == bucket``
    wins; otherwise fall back to the hot row with the largest FLOPs
    (flagged ``case_matched=False`` so the table is honest about it)."""
    for row in rows:
        if bucket and row.get("case") == bucket:
            return row, True
    with_flops = [r for r in rows if r.get("flops")]
    if not with_flops:
        return (rows[0], False) if rows else (None, False)
    hot = [r for r in with_flops if r.get("hot")]
    pool = hot or with_flops
    return max(pool, key=lambda r: float(r.get("flops") or 0.0)), False


def join_roofline(
    audit: Dict[str, Any],
    measured: Dict[Tuple[str, str], Dict[str, float]],
    device_kind: str,
    n_chips: int = 1,
) -> Dict[str, Any]:
    """Join measured seconds onto audit FLOPs. Coverage is
    seconds-weighted: the fraction of measured time that joined to an
    audit row (the acceptance gate), plus the plain series-count rate
    and the registered-executable coverage for context. The rows are
    the JAX package's, key for key (``device_seconds`` is the series'
    name); ``seconds_clock`` says what clock measured them."""
    by_name: Dict[str, List[Dict[str, Any]]] = {}
    for row in audit.get("executables", []):
        by_name.setdefault(row["executable"], []).append(row)
    peak = constants.peak_bf16_flops(device_kind) * max(int(n_chips), 1)
    bw = constants.hbm_bandwidth_bytes(device_kind) * max(int(n_chips), 1)
    ridge = (peak / bw) if (peak > 0 and bw > 0) else None

    rows: List[Dict[str, Any]] = []
    joined_s = total_s = 0.0
    joined_series = 0
    for (exe, bucket), h in sorted(measured.items()):
        total_s += h["sum"]
        entry: Dict[str, Any] = {
            "executable": exe,
            "bucket": bucket or None,
            "calls": int(h["count"]),
            "device_seconds": round(h["sum"], 6),
            "mean_seconds": round(h["sum"] / h["count"], 6)
            if h["count"]
            else None,
            "joined": False,
        }
        cand = by_name.get(exe, [])
        row, matched = _pick_audit_row(cand, bucket)
        if row is not None and row.get("flops") and h["sum"] > 0:
            flops = float(row["flops"])
            achieved = flops * h["count"] / h["sum"]
            ai = row.get("arithmetic_intensity")
            if ai is None and row.get("bytes_accessed"):
                ai = flops / float(row["bytes_accessed"])
            entry.update(
                joined=True,
                case=row.get("case"),
                case_matched=matched,
                flops_per_call=flops,
                achieved_flops_per_sec=round(achieved, 1),
                arithmetic_intensity=round(float(ai), 4)
                if ai is not None
                else None,
            )
            if peak > 0:
                entry["mfu_vs_bf16_peak"] = round(achieved / peak, 6)
            if ridge is not None and ai is not None:
                entry["bound"] = (
                    "compute" if float(ai) >= ridge else "memory"
                )
            joined_s += h["sum"]
            joined_series += 1
        rows.append(entry)

    registered = sorted(by_name)
    measured_names = {exe for (exe, _b) in measured}
    return {
        "seconds_clock": SECONDS_CLOCK,
        "device_kind": constants.normalize_device_kind(device_kind),
        "n_chips": int(n_chips),
        "peak_bf16_flops": peak or None,
        "hbm_bytes_per_sec": bw or None,
        "ridge_flops_per_byte": round(ridge, 2) if ridge else None,
        "rows": rows,
        "coverage": round(joined_s / total_s, 4) if total_s > 0 else None,
        "series_join_rate": (
            round(joined_series / len(measured), 4) if measured else None
        ),
        "registered_executables": len(registered),
        "registered_measured": sorted(measured_names & set(registered)),
        "registered_unmeasured": sorted(set(registered) - measured_names),
    }


# -- bench-trajectory ratchet ------------------------------------------

_ROUND_RE = re.compile(r"r(\d+)")

# units whose metric improves downward (everything else: up is better)
_LOWER_BETTER_HINTS = ("second", "latency", "_ms", " ms")


def _lower_is_better(unit: str, metric: str) -> bool:
    text = f"{unit} {metric}".lower()
    if "per_sec" in text or "/s" in text:
        return False
    return any(h in text for h in _LOWER_BETTER_HINTS)


def _record_order_key(path: str) -> Tuple[int, str]:
    """Chronology of the checked-in trajectory: the rNN round number in
    the filename, then the name (driver record before same-round
    sidecar captures sorts fine — groups rarely span both)."""
    base = os.path.basename(path)
    m = _ROUND_RE.search(base)
    return (int(m.group(1)) if m else 0, base)


def _walk_metas(node: Any, out: List[Dict[str, Any]]) -> None:
    if isinstance(node, dict):
        meta = node.get("meta")
        if (
            isinstance(meta, dict)
            and "device_kind" in meta
            and "phase" in meta
        ):
            out.append(meta)
        for v in node.values():
            _walk_metas(v, out)
    elif isinstance(node, list):
        for v in node:
            _walk_metas(v, out)


def _record_is_skippable(rec: Any) -> Optional[str]:
    """Crashed / error records carry no benchmark result to ratchet —
    skipped with a note instead of failing the gate."""
    if not isinstance(rec, dict):
        return "not a JSON object"
    if "error" in rec:
        return f"error record: {rec['error']!r}"
    if "parsed" in rec and rec.get("parsed") is None:
        rc = rec.get("rc")
        return f"crashed driver record (rc={rc}, parsed=null)"
    return None


def extract_bench_metas(path: str) -> Tuple[List[Dict[str, Any]], Optional[str]]:
    """All meta blocks in one BENCH record file -> (metas, skip_note).
    A readable record with NO meta block is a contract violation (the
    ratchet cannot group it) — the caller fails loudly."""
    with open(path, encoding="utf-8") as fh:
        rec = json.load(fh)
    skip = _record_is_skippable(rec)
    if skip is not None:
        return [], skip
    metas: List[Dict[str, Any]] = []
    _walk_metas(rec, metas)
    return metas, None


def run_ratchet(
    paths: Sequence[str], tolerance: float = DEFAULT_TOLERANCE
) -> Dict[str, Any]:
    """Compare the newest record per (phase, device_kind, smoke) group
    against the best prior record of the same group. Returns a report
    dict; ``report["ok"]`` is the gate. Exit-2-class contract
    violations (no meta on a live record, unreadable file) are in
    ``report["violations"]``."""
    entries: List[Dict[str, Any]] = []
    skipped: List[str] = []
    violations: List[str] = []
    for path in sorted(paths, key=_record_order_key):
        try:
            metas, skip = extract_bench_metas(path)
        except (OSError, json.JSONDecodeError) as e:
            violations.append(f"{path}: unreadable ({e})")
            continue
        if skip is not None:
            skipped.append(f"{path}: {skip}")
            continue
        if not metas:
            violations.append(
                f"{path}: no meta block on any phase record — run "
                "scripts/backfill_bench_meta.py (new records get one "
                "from bench.py automatically)"
            )
            continue
        for meta in metas:
            value = meta.get("value")
            if not isinstance(value, (int, float)) or isinstance(value, bool):
                continue  # info-only meta (e.g. a phase with no headline)
            entries.append(
                {
                    "file": os.path.basename(path),
                    "order": _record_order_key(path),
                    "phase": str(meta.get("phase")),
                    "device_kind": constants.normalize_device_kind(
                        str(meta.get("device_kind"))
                    ),
                    "smoke": bool(meta.get("smoke", False)),
                    "value": float(value),
                    "unit": str(meta.get("unit", "")),
                    "metric": str(meta.get("metric", "")),
                    "mfu": meta.get("mfu"),
                }
            )

    groups: Dict[Tuple[str, str, bool], List[Dict[str, Any]]] = {}
    for e in entries:
        groups.setdefault((e["phase"], e["device_kind"], e["smoke"]), []).append(e)

    results: List[Dict[str, Any]] = []
    regressions = 0
    for key in sorted(groups):
        phase, kind, smoke = key
        seq = groups[key]  # already in trajectory order (sorted paths)
        current = seq[-1]
        prior = seq[:-1]
        res: Dict[str, Any] = {
            "phase": phase,
            "device_kind": kind,
            "smoke": smoke,
            "current": current["value"],
            "unit": current["unit"],
            "file": current["file"],
            "n_records": len(seq),
        }
        if not prior:
            res["verdict"] = "seeded"
        else:
            lower = _lower_is_better(current["unit"], current["metric"])
            best = (
                min(prior, key=lambda e: e["value"])
                if lower
                else max(prior, key=lambda e: e["value"])
            )
            res["best_prior"] = best["value"]
            res["best_prior_file"] = best["file"]
            if lower:
                regressed = current["value"] > best["value"] * (1.0 + tolerance)
                res["delta_frac"] = round(
                    current["value"] / best["value"] - 1.0, 4
                ) if best["value"] else None
            else:
                regressed = current["value"] < best["value"] * (1.0 - tolerance)
                res["delta_frac"] = round(
                    current["value"] / best["value"] - 1.0, 4
                ) if best["value"] else None
            res["verdict"] = "REGRESSION" if regressed else "ok"
            regressions += int(regressed)
        results.append(res)

    return {
        "tool": "fedml-tpu-torch perf --ratchet",
        "tolerance": tolerance,
        "groups": results,
        "regressions": regressions,
        "skipped": skipped,
        "violations": violations,
        "ok": regressions == 0 and not violations,
    }


# -- CLI ---------------------------------------------------------------


def add_perf_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--telemetry-dir", default=None,
        help="run directory holding telemetry.jsonl / trace*.json "
             "(report mode: roofline join + idle ledger)",
    )
    p.add_argument(
        "--audit-report", default=None,
        help=f"the audit report to join against (default: "
             f"<root>/{AUDIT_REPORT_NAME})",
    )
    p.add_argument(
        "--device-kind", default=None,
        help="MFU denominator device kind, e.g. torch.cuda.get_device_name(0) "
             "(default: the audit report's platform, 'cuda': an unknown "
             "kind, so seconds without MFU)",
    )
    p.add_argument("--n-chips", type=int, default=1)
    p.add_argument(
        "--min-coverage", type=float, default=DEFAULT_MIN_COVERAGE,
        help="fail (exit 1) when less than this fraction of measured "
             "device seconds joined to an audit row",
    )
    p.add_argument(
        "--ratchet", nargs="+", default=None, metavar="BENCH_JSON",
        help="ratchet mode: compare the newest BENCH record per "
             "(phase, device_kind, smoke) group against the best "
             "prior record; exit 1 on regression, 2 on contract "
             "violations (missing meta)",
    )
    p.add_argument(
        "--tolerance", type=float, default=DEFAULT_TOLERANCE,
        help="relative regression allowed before the ratchet trips",
    )
    p.add_argument(
        "--out", default=None,
        help=f"write the JSON report here (report mode default: "
             f"<telemetry-dir>/{PERF_REPORT_NAME}; ratchet: stdout only)",
    )
    p.add_argument("--root", default=None, help="repo root override")
    p.add_argument(
        "--quiet", action="store_true",
        help="suppress the human-readable table (JSON line only)",
    )


def _print_roofline_table(report: Dict[str, Any]) -> None:
    print(
        f"perf: device_kind={report['device_kind']} "
        f"n_chips={report['n_chips']} "
        f"coverage={report['coverage']} (seconds: {report['seconds_clock']})",
        file=sys.stderr,
    )
    hdr = (
        f"{'executable':<36} {'bucket':>10} {'calls':>7} "
        f"{'wall_s':>10} {'FLOP/s':>12} {'MFU':>9} {'bound':>8}"
    )
    print(hdr, file=sys.stderr)
    for row in report["rows"]:
        mfu = row.get("mfu_vs_bf16_peak")
        print(
            f"{row['executable']:<36} {str(row.get('bucket') or '-'):>10} "
            f"{row['calls']:>7} {row['device_seconds']:>10.4f} "
            f"{row.get('achieved_flops_per_sec') or '-':>12} "
            f"{(f'{mfu:.2%}' if mfu is not None else '-'):>9} "
            f"{row.get('bound') or '-':>8}",
            file=sys.stderr,
        )


def _print_ledger_table(ledger: Dict[str, Any]) -> None:
    print(
        f"idle ledger: {len(ledger['rounds'])} round(s), "
        f"wall {ledger['total_wall_s']:.3f}s, idle "
        f"{json.dumps(ledger['idle_totals_s'])}, mean wire util "
        f"{ledger['mean_wire_utilization_frac']}",
        file=sys.stderr,
    )
    for r in ledger["rounds"]:
        print(
            f"  round {r['round']}: wall {r['wall_s']:.4f}s "
            f"accounted {r['accounted_s']:.4f}s "
            f"(recon {r['recon_frac']}) idle {json.dumps(r['idle'])}",
            file=sys.stderr,
        )


def run_cli(args) -> int:
    if args.ratchet:
        report = run_ratchet(args.ratchet, tolerance=args.tolerance)
        print(json.dumps(report))
        if not args.quiet:
            for g in report["groups"]:
                prior = (
                    f" best_prior={g.get('best_prior')} "
                    f"({g.get('best_prior_file')})"
                    if "best_prior" in g
                    else ""
                )
                print(
                    f"ratchet: {g['verdict']:>10}  {g['phase']}"
                    f"[{g['device_kind']}, smoke={g['smoke']}] "
                    f"current={g['current']} {g['unit']}{prior}",
                    file=sys.stderr,
                )
            for s in report["skipped"]:
                print(f"ratchet: skipped {s}", file=sys.stderr)
        for v in report["violations"]:
            print(f"ratchet: VIOLATION {v}", file=sys.stderr)
        if report["violations"]:
            return 2
        return 0 if report["ok"] else 1

    if not args.telemetry_dir:
        print(
            "perf: pass --telemetry-dir (report mode) or --ratchet "
            "BENCH_*.json (gate mode)",
            file=sys.stderr,
        )
        return 2
    if not os.path.isdir(args.telemetry_dir):
        print(f"perf: {args.telemetry_dir!r} not found", file=sys.stderr)
        return 2
    root = find_repo_root(args.root)
    audit_path = args.audit_report or os.path.join(root, AUDIT_REPORT_NAME)
    if not os.path.isfile(audit_path):
        print(
            f"perf: no audit report at {audit_path!r} — run "
            "`python -m fedml_tpu_torch.cli audit` first (it writes the "
            "FLOPs denominator)",
            file=sys.stderr,
        )
        return 2
    audit = load_audit_report(audit_path)
    snapshots = load_snapshots(args.telemetry_dir)
    measured = exec_seconds_from_snapshots(snapshots)
    device_kind = args.device_kind or str(audit.get("platform", "cpu"))
    roofline = join_roofline(
        audit, measured, device_kind, n_chips=args.n_chips
    )
    ledger = summarize_ledger(load_ledgers(args.telemetry_dir))
    report = {
        "tool": "fedml-tpu-torch perf",
        "version": 1,
        "telemetry_dir": args.telemetry_dir,
        "audit_report": audit_path,
        "roofline": roofline,
        "ledger": ledger,
    }
    out_path = args.out or os.path.join(args.telemetry_dir, PERF_REPORT_NAME)
    with open(out_path, "w", encoding="utf-8") as fh:
        json.dump(report, fh, indent=1)
    if not args.quiet:
        _print_roofline_table(roofline)
        _print_ledger_table(ledger)
    print(
        json.dumps(
            {
                "ok": True,
                "series": len(roofline["rows"]),
                "coverage": roofline["coverage"],
                "rounds": len(ledger["rounds"]),
                "report": out_path,
            }
        )
    )
    cov = roofline["coverage"]
    if measured and cov is not None and cov < args.min_coverage:
        print(
            f"perf: coverage {cov} < --min-coverage {args.min_coverage} "
            "— measured executables missing from the audit registry?",
            file=sys.stderr,
        )
        return 1
    return 0
