"""Post-hoc invariant checking over a finished run's artifacts (port of
``fedml_tpu/core/invariants.py``).

The one reusable checker of the federation's exactly-once and recovery
guarantees: it replays a run's durable
artifacts — ``round_wal.jsonl`` (the server's completed-round /
publish ledger, ``core/checkpoint.py``), ``telemetry.jsonl`` (final
counter snapshots, ``core/telemetry.py``) and ``trace.json`` (the
flight record) — and verifies the federation's safety invariants from
evidence, not from in-process state:

======================  =======================  =========================
invariant               artifact source          checked against
======================  =======================  =========================
wal_well_formed         round_wal.jsonl          record schema
cohort_accounting       round_wal.jsonl          folded ⊆ cohort, no dup rank
partial_closes_
  accounted             round_wal + telemetry    quorum/deadline/death/leave/
                                                 quarantine counters
round_monotone          round_wal.jsonl          backward jumps land on a
                                                 durable ckpt_step
ckpt_step_monotone      round_wal.jsonl          non-decreasing steps
version_monotone        round_wal.jsonl          async publish versions
                                                 strictly increasing
no_reissued_seqs        round_wal.jsonl          max_seq non-decreasing;
                                                 pair seq <= its record's
exactly_once_folds      round_wal.jsonl          (rank, seq) pairs globally
                                                 distinct; whole-record
                                                 re-carries allowed up to the
                                                 counted append failures
fold_ledger_consistent  round_wal.jsonl          folds_total covers the
                                                 cumulative pair count
ledger_counter_match    round_wal + telemetry    wal_rounds/folds_logged_total
                                                 == records (± crashes +
                                                 append failures)
published_counter_match round_wal + telemetry    agg_folds_published_total
                                                 == distinct pairs (± crashes
                                                 + append failures)
no_lost_unreported      telemetry.jsonl          folds accepted - published
  _folds                                         == reported lost (clean
                                                 finish only)
counters_cover_ledger   round_wal + telemetry    agg_folds_total >= ledger
chaos_trace_consistent  trace.json + telemetry   chaos.fault instants ==
                                                 chaos_faults_injected_total
edge_partition          round_wal.jsonl          per-edge fold sets are
                                                 disjoint and union to the
                                                 round's folded set
edge_merge_exactly_once round_wal + telemetry    hier_edge_merges_total ==
                                                 WAL (edge, round) entries
                                                 (± crashes + failures)
edge_subledger_         round_wal + edge_*/      every merged edge set has a
  consistent            round_wal.jsonl          matching write-ahead record
                                                 in that edge's sub-ledger
preempt_paired_with_    round_wal.jsonl          every kind="preempt" record
  checkpoint                                     names a durable ckpt_step
                                                 and is answered by a
                                                 kind="resume" on the same
                                                 step (a trailing preempt —
                                                 not yet resumed — is legal)
preempt_resume_         round_wal.jsonl          resume continues at exactly
  continuity                                     preempt.round_idx + 1 (no
                                                 round retrained or lost
                                                 across the mesh reshape);
                                                 no resume without a preempt
======================  =======================  =========================

Counter-based invariants read the final snapshot per rank; in a LOCAL
world (one shared registry across server incarnations) they are exact.
A multi-process run whose server restarted resets its counters — that
reset is detected from the artifacts themselves (counters are
monotonic, so ANY decrease across a rank's successive snapshots proves
a registry reset) and every counter-balanced invariant is then skipped
(noted in the report), while the WAL-internal invariants always apply.

Exposed as ``python -m fedml_tpu_torch.cli check --telemetry-dir``. It
reads nothing but the files, so it checks a run of either package: the
artifacts are the JAX package's in meaning, and the two checkers give
the same report on the same directory.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional

__all__ = ["InvariantChecker", "InvariantReport"]


class InvariantReport:
    """Outcome of one check run: which invariants were checked, which
    were skipped (artifact missing / not applicable) and every
    violation found, most severe first in insertion order."""

    def __init__(self) -> None:
        self.checked: List[str] = []
        self.skipped: Dict[str, str] = {}
        self.violations: List[Dict[str, Any]] = []

    @property
    def ok(self) -> bool:
        return not self.violations

    def note_checked(self, name: str) -> None:
        if name not in self.checked:
            self.checked.append(name)

    def skip(self, name: str, why: str) -> None:
        self.skipped[name] = why

    def fail(self, name: str, detail: str, **ctx: Any) -> None:
        self.note_checked(name)
        self.violations.append({"invariant": name, "detail": detail, **ctx})

    def to_dict(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "checked": list(self.checked),
            "skipped": dict(self.skipped),
            "violations": list(self.violations),
        }


def _load_jsonl(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                # torn final line: same tolerance as RoundWAL.records
                logging.warning(
                    "invariants: skipping torn line in %s: %r", path, line[:80]
                )
    return out


def _counter_total(counters: Dict[str, float], name: str) -> float:
    """Sum every tag-series of one counter from a snapshot's rendered
    ``name{k=v}`` keys."""
    total = 0.0
    for key, v in counters.items():
        if key == name or key.startswith(name + "{"):
            total += float(v)
    return total


def _counter_tagged(
    counters: Dict[str, float], name: str, tag: str, values
) -> float:
    """Sum the series of one counter whose rendered ``tag=value`` is in
    ``values`` (tags render sorted, ``name{k=v,k2=v2}``)."""
    total = 0.0
    prefix = name + "{"
    for key, v in counters.items():
        if not key.startswith(prefix) or not key.endswith("}"):
            continue
        tags = dict(
            kv.split("=", 1)
            for kv in key[len(prefix):-1].split(",")
            if "=" in kv
        )
        if tags.get(tag) in values:
            total += float(v)
    return total


class InvariantChecker:
    """Replay a run's artifacts and verify the safety invariants.

    ``telemetry_dir`` holds ``telemetry.jsonl`` / ``trace*.json``;
    ``checkpoint_dir`` holds ``round_wal.jsonl`` (defaults to the
    telemetry dir — a world that points both at the same directory
    needs only one argument).
    """

    def __init__(
        self,
        telemetry_dir: Optional[str] = None,
        checkpoint_dir: Optional[str] = None,
    ) -> None:
        self.telemetry_dir = telemetry_dir
        self.checkpoint_dir = checkpoint_dir or telemetry_dir
        self.wal_records: List[dict] = []
        self.wal_path: Optional[str] = None
        # hierarchical server plane: per-edge WAL sub-ledgers live in
        # {checkpoint_dir}/edge_{rank}/round_wal.jsonl
        self.edge_ledgers: Dict[int, List[dict]] = {}
        self.counters: Dict[str, float] = {}
        self.counters_reset = False
        self.snapshots: List[dict] = []
        self.trace_events: List[dict] = []
        self._load()

    # -- artifact loading ---------------------------------------------
    def _load(self) -> None:
        from .checkpoint import RoundWAL

        if self.checkpoint_dir:
            path = os.path.join(self.checkpoint_dir, RoundWAL.FILENAME)
            if os.path.exists(path):
                self.wal_path = path
                self.wal_records = RoundWAL(self.checkpoint_dir).records()
            if os.path.isdir(self.checkpoint_dir):
                for name in sorted(os.listdir(self.checkpoint_dir)):
                    if not name.startswith("edge_"):
                        continue
                    sub = os.path.join(
                        self.checkpoint_dir, name, RoundWAL.FILENAME
                    )
                    if not os.path.exists(sub):
                        continue
                    try:
                        edge = int(name.split("_", 1)[1])
                    except ValueError:
                        continue
                    self.edge_ledgers[edge] = RoundWAL(
                        os.path.join(self.checkpoint_dir, name)
                    ).records()
        if self.telemetry_dir:
            tpath = os.path.join(self.telemetry_dir, "telemetry.jsonl")
            if os.path.exists(tpath):
                self.snapshots = _load_jsonl(tpath)
                # final snapshot per rank; counters summed across ranks
                # (fold/ledger counters only exist on the server, so
                # the sum is the server's final view). Counters are
                # monotonic by construction, so ANY decrease across a
                # rank's successive snapshots proves its registry was
                # reset (a multi-process server restart) — the final
                # snapshot then under-counts the run and every
                # counter-balanced invariant must be skipped, not
                # failed.
                last_by_rank: Dict[Any, dict] = {}
                for snap in self.snapshots:
                    rank = snap.get("rank", 0)
                    cur = snap.get("counters") or {}
                    prev = (last_by_rank.get(rank) or {}).get("counters") or {}
                    for k, v in cur.items():
                        if k in prev and float(v) < float(prev[k]) - 1e-9:
                            self.counters_reset = True
                    last_by_rank[rank] = snap
                for snap in last_by_rank.values():
                    for k, v in (snap.get("counters") or {}).items():
                        self.counters[k] = self.counters.get(k, 0.0) + float(v)
            for name in ("trace.json",):
                path = os.path.join(self.telemetry_dir, name)
                if os.path.exists(path):
                    try:
                        with open(path) as f:
                            self.trace_events.extend(
                                json.load(f).get("traceEvents") or []
                            )
                    except ValueError:
                        logging.warning("invariants: unreadable %s", path)

    def _ctr(self, name: str) -> float:
        return _counter_total(self.counters, name)

    # -- the check ----------------------------------------------------
    def check(self) -> InvariantReport:
        rep = InvariantReport()
        # cross-device rounds close on a fold TARGET by design — they
        # must not flow into the sync-cohort accounting (where a
        # partial close is a bug unless excused) but into their own
        # masked-fold balance checks
        xdev = [
            r for r in self.wal_records if r.get("kind") == "crossdevice"
        ]
        sync = [
            r
            for r in self.wal_records
            if r.get("kind") not in ("publish", "crossdevice")
        ]
        publishes = [r for r in self.wal_records if r.get("kind") == "publish"]
        if not self.wal_records:
            rep.skip("wal_well_formed", "no round_wal.jsonl found")
        else:
            self._check_wal_shape(rep, sync, publishes)
            self._check_cohorts(rep, sync)
            self._check_round_monotone(rep, sync)
            self._check_preempt(rep, sync)
            self._check_async(rep, publishes)
        self._check_counters(rep, sync, publishes)
        self._check_chaos_trace(rep)
        self._check_edge_tier(rep, sync)
        self._check_crossdevice(rep, xdev)
        return rep

    # -- multi-tier invariants (hierarchical server plane) ------------
    def _check_edge_tier(self, rep, sync) -> None:
        """The hierarchical plane's exactly-once story, from artifacts:
        every round's per-edge fold sets must PARTITION the round's
        folded set (an upload folds at exactly one edge and reaches the
        root exactly once), the root's merge counter must balance the
        WAL's (edge, round) entries, and each merged set must have its
        write-ahead twin in that edge's sub-ledger."""
        hier = [r for r in sync if r.get("edge_folds")]
        if not hier:
            for n in (
                "edge_partition", "edge_merge_exactly_once",
                "edge_subledger_consistent",
            ):
                rep.skip(n, "no hierarchical (edge_folds) records")
            return
        rep.note_checked("edge_partition")
        wal_merges = 0
        for i, rec in enumerate(hier):
            folded = set(rec.get("folded") or [])
            seen: set = set()
            union: set = set()
            for edge, ranks in sorted((rec.get("edge_folds") or {}).items()):
                wal_merges += 1
                rset = set(int(r) for r in ranks)
                overlap = seen & rset
                if overlap:
                    rep.fail(
                        "edge_partition",
                        f"record {i} (round {rec['round_idx']}): rank(s) "
                        f"{sorted(overlap)} folded at more than one edge — "
                        "an upload was double-merged",
                        edge=edge,
                    )
                seen |= rset
                union |= rset
            if union != folded:
                rep.fail(
                    "edge_partition",
                    f"record {i} (round {rec['round_idx']}): the per-edge "
                    f"fold sets union to {sorted(union)} but the round "
                    f"folded {sorted(folded)} — the sub-ledgers do not "
                    "partition the root's folded set",
                )
        # merge counter balance (same crash tolerances as the other
        # counter-matched invariants: a kill between the merge and the
        # round's WAL append strands up to one record's merges)
        merges_ctr = self._ctr("hier_edge_merges_total")
        if not self.counters or not merges_ctr:
            rep.skip("edge_merge_exactly_once", "no merge counters in snapshot")
        elif self.counters_reset:
            rep.skip(
                "edge_merge_exactly_once",
                "counters reset by a restart; the final snapshot "
                "under-counts the run",
            )
        else:
            rep.note_checked("edge_merge_exactly_once")
            kills = _counter_tagged(
                self.counters, "chaos_faults_injected_total",
                "fault", ("kill_server", "kill_client", "torn_write"),
            )
            failures = self._ctr("wal_append_failures_total")
            max_edges = max(
                (len(r.get("edge_folds") or {}) for r in hier), default=0
            )
            gap = merges_ctr - wal_merges
            if gap < 0:
                rep.fail(
                    "edge_merge_exactly_once",
                    f"the WAL holds {wal_merges} per-edge merge entries but "
                    f"only {merges_ctr:g} merges were counted — a merged "
                    "limb-set entered the ledger twice",
                )
            elif gap > (kills + failures) * max(max_edges, 1):
                rep.fail(
                    "edge_merge_exactly_once",
                    f"{gap:g} counted merge(s) never reached the WAL — "
                    f"beyond what {kills:g} crash(es) and {failures:g} "
                    "append failure(s) can explain (a duplicate report "
                    "was merged instead of dropped)",
                )
        # write-ahead sub-ledger twins (only checkable when the edge
        # kept one — the sub-ledger dir rides checkpoint_dir)
        if not self.edge_ledgers:
            rep.skip(
                "edge_subledger_consistent", "no edge_*/ sub-ledgers found"
            )
            return
        by_edge_round: Dict[tuple, List[List[int]]] = {}
        for edge, records in self.edge_ledgers.items():
            for rec in records:
                key = (int(edge), int(rec["round_idx"]))
                by_edge_round.setdefault(key, []).append(
                    sorted(int(r) for r in rec.get("folded") or [])
                )
        misses = []
        for i, rec in enumerate(hier):
            for edge_s, ranks in sorted((rec.get("edge_folds") or {}).items()):
                edge = int(edge_s)
                if edge not in self.edge_ledgers:
                    continue  # that edge ran without a sub-ledger dir
                attempts = by_edge_round.get((edge, int(rec["round_idx"])), [])
                if sorted(int(r) for r in ranks) not in attempts:
                    misses.append((i, rec, edge, ranks, attempts))
        # a refused/failed sub-ledger append is a fault the edge
        # deliberately survives (logged + counted, the report still
        # ships) — counted append failures grant the same allowance
        # the other counter-balanced invariants give
        append_failures = self._ctr("wal_append_failures_total")
        if misses and len(misses) <= append_failures:
            rep.skip(
                "edge_subledger_consistent",
                f"{len(misses)} merged set(s) without a write-ahead twin "
                f"are covered by {append_failures:g} counted WAL append "
                "failure(s) (degraded durability, not a ledger bug)",
            )
            return
        rep.note_checked("edge_subledger_consistent")
        for i, rec, edge, ranks, attempts in misses:
            rep.fail(
                "edge_subledger_consistent",
                f"record {i} (round {rec['round_idx']}): the root "
                f"merged {sorted(ranks)} from edge {edge} but that "
                "edge's sub-ledger has no matching write-ahead "
                f"record (attempts: {attempts})",
                edge=edge,
            )

    # -- WAL-internal invariants --------------------------------------
    def _check_wal_shape(self, rep, sync, publishes) -> None:
        rep.note_checked("wal_well_formed")
        for i, rec in enumerate(self.wal_records):
            if not isinstance(rec.get("round_idx"), int):
                rep.fail(
                    "wal_well_formed", f"record {i} has no round_idx", rec=rec
                )
            cohort = rec.get("cohort")
            if not isinstance(cohort, list):
                rep.fail(
                    "wal_well_formed", f"record {i} has no cohort list", rec=rec
                )

    def _check_cohorts(self, rep, sync) -> None:
        rep.note_checked("cohort_accounting")
        partial = 0
        for i, rec in enumerate(sync):
            cohort = set(rec.get("cohort") or [])
            folded = rec.get("folded")
            if folded is None:
                continue
            if len(folded) != len(set(folded)):
                rep.fail(
                    "cohort_accounting",
                    f"sync record {i} (round {rec['round_idx']}) folds a "
                    "rank twice",
                    folded=folded,
                )
            extra = set(folded) - cohort
            if extra:
                rep.fail(
                    "cohort_accounting",
                    f"sync record {i} (round {rec['round_idx']}) folded "
                    f"ranks {sorted(extra)} outside its cohort",
                    cohort=sorted(cohort),
                )
            if len(set(folded)) < len(cohort):
                partial += 1
        # partial closes need an explanation in the counters: quorum
        # grace, deadline drop, declared death, elastic leave or
        # quarantine — a silently shrunken round is a lost-fold bug
        if partial:
            if not self.counters:
                rep.skip(
                    "partial_closes_accounted", "no telemetry.jsonl found"
                )
                return
            if self.counters_reset:
                rep.skip(
                    "partial_closes_accounted",
                    "counters reset by a server restart; evidence may "
                    "predate the final snapshot",
                )
                return
            rep.note_checked("partial_closes_accounted")
            explained = (
                self._ctr("agg_quorum_closes_total")
                + self._ctr("cross_silo_clients_declared_dead_total")
                + self._ctr("cross_silo_client_leaves_total")
                + self._ctr("cross_silo_stragglers_dropped_total")
                + self._ctr("defense_quarantined_total")
            )
            # gauge fallback: stragglers_dropped predates the counter
            explained += _counter_total(
                self.counters, "cross_silo_stragglers_dropped"
            )
            if explained <= 0:
                rep.fail(
                    "partial_closes_accounted",
                    f"{partial} round(s) closed over a partial cohort with "
                    "no quorum/deadline/death/leave/quarantine evidence in "
                    "the counters",
                    partial_rounds=partial,
                )

    def _check_round_monotone(self, rep, sync) -> None:
        rep.note_checked("round_monotone")
        rep.note_checked("ckpt_step_monotone")
        durable_steps = set()
        prev_round = None
        prev_step = None
        for i, rec in enumerate(sync):
            r = int(rec["round_idx"])
            step = rec.get("ckpt_step")
            if prev_round is not None and r < prev_round:
                # a backward jump is a resume: legal only onto a round
                # some earlier checkpoint made durable
                if r not in durable_steps:
                    rep.fail(
                        "round_monotone",
                        f"sync record {i} jumps back to round {r} which no "
                        "earlier checkpoint made durable "
                        f"(durable steps: {sorted(durable_steps)})",
                    )
            prev_round = r
            if step is not None:
                if prev_step is not None and int(step) < prev_step:
                    rep.fail(
                        "ckpt_step_monotone",
                        f"sync record {i} checkpoint step {step} < previous "
                        f"{prev_step}",
                    )
                prev_step = int(step)
                durable_steps.add(int(step))

    def _check_preempt(self, rep, sync) -> None:
        """The elastic plane's durable-exit contract, from artifacts
        (``parallel/elastic.py``): a ``kind="preempt"`` record is a
        PROMISE — "round R drained, checkpoint step S holds it" — and
        the paired ``kind="resume"`` record is the evidence the promise
        was kept: some later incarnation restored that step (possibly
        onto a reshaped mesh) and continued at exactly round R + 1, so
        no round was retrained or lost across the device loss. A
        trailing preempt (the final WAL word) is legal — the run is
        simply still down — but a preempt answered by anything other
        than its resume, or a resume with no preempt to answer, is a
        ledger bug."""
        preempts = [
            (i, r) for i, r in enumerate(sync) if r.get("kind") == "preempt"
        ]
        resumes = [
            (i, r) for i, r in enumerate(sync) if r.get("kind") == "resume"
        ]
        if not preempts and not resumes:
            rep.skip(
                "preempt_paired_with_checkpoint", "no preempt/resume records"
            )
            rep.skip("preempt_resume_continuity", "no preempt/resume records")
            return
        rep.note_checked("preempt_paired_with_checkpoint")
        rep.note_checked("preempt_resume_continuity")
        answered: set = set()
        for i, rec in preempts:
            step = rec.get("ckpt_step")
            if not isinstance(step, int):
                rep.fail(
                    "preempt_paired_with_checkpoint",
                    f"preempt record {i} (round {rec['round_idx']}) names "
                    "no checkpoint step — the forced save never made the "
                    "drained round durable",
                )
                continue
            if i == len(sync) - 1:
                continue  # trailing preempt: resume hasn't happened yet
            nxt = sync[i + 1]
            if nxt.get("kind") != "resume":
                rep.fail(
                    "preempt_paired_with_checkpoint",
                    f"preempt record {i} (round {rec['round_idx']}) is "
                    f"followed by a {nxt.get('kind') or 'round'} record, "
                    "not its resume — the run continued without restoring "
                    "the preemption checkpoint",
                )
                continue
            answered.add(i + 1)
            if int(nxt.get("ckpt_step") or -1) != step:
                rep.fail(
                    "preempt_paired_with_checkpoint",
                    f"resume record {i + 1} restored step "
                    f"{nxt.get('ckpt_step')} but the preempt promised "
                    f"step {step}",
                )
            if int(nxt["round_idx"]) != int(rec["round_idx"]) + 1:
                rep.fail(
                    "preempt_resume_continuity",
                    f"resume record {i + 1} continues at round "
                    f"{nxt['round_idx']} but the preempt drained round "
                    f"{rec['round_idx']} — round "
                    f"{int(rec['round_idx']) + 1} was "
                    + (
                        "retrained"
                        if int(nxt["round_idx"]) <= int(rec["round_idx"])
                        else "skipped"
                    ),
                )
        for i, rec in resumes:
            if i in answered:
                continue
            if i == 0 or sync[i - 1].get("kind") != "preempt":
                rep.fail(
                    "preempt_resume_continuity",
                    f"resume record {i} (round {rec['round_idx']}) answers "
                    "no preempt record — a resume out of nowhere",
                )

    def _check_async(self, rep, publishes) -> None:
        if not publishes:
            for name in (
                "version_monotone", "no_reissued_seqs", "exactly_once_folds",
                "fold_ledger_consistent",
            ):
                rep.skip(name, "no async publish records")
            return
        rep.note_checked("version_monotone")
        rep.note_checked("no_reissued_seqs")
        rep.note_checked("exactly_once_folds")
        rep.note_checked("fold_ledger_consistent")
        # a failed-but-durable append (fsync refused after the bytes
        # landed) legitimately double-books: the server cannot know the
        # record survived, so it re-carries the WHOLE record's folds
        # into the next successful record (the write-ahead invariant
        # demands it; the WAL stores fold sets sorted, so order carries
        # no evidence). A legal carry therefore repeats exactly the
        # preceding record's complete pair set, and the number of
        # carrying records is bounded by the counted append failures —
        # a partial repeat, or more carries than failures, is a real
        # double-fold.
        failures = self._ctr("wal_append_failures_total")
        carry_records = 0
        prev_version = None
        prev_max_seq = None
        prev_pairs: set = set()
        seen_pairs = set()
        for i, rec in enumerate(publishes):
            version = int(rec.get("version", rec["round_idx"]))
            if prev_version is not None and version <= prev_version:
                rep.fail(
                    "version_monotone",
                    f"publish record {i} version {version} <= previous "
                    f"{prev_version} — the model went backward",
                )
            prev_version = version
            max_seq = int(rec.get("max_seq", 0))
            if prev_max_seq is not None and max_seq < prev_max_seq:
                rep.fail(
                    "no_reissued_seqs",
                    f"publish record {i} max_seq {max_seq} < previous "
                    f"{prev_max_seq} — the dispatch high-water mark went "
                    "backward",
                )
            prev_max_seq = max_seq
            pairs = [
                tuple(int(x) for x in p)
                for p in (rec.get("folded") or [])
                if isinstance(p, (list, tuple)) and len(p) == 2
            ]
            if len(pairs) != len(set(pairs)):
                rep.fail(
                    "exactly_once_folds",
                    f"publish record {i} folds a (rank, seq) pair twice "
                    "within one record",
                )
            repeated = {p for p in pairs if p in seen_pairs}
            if repeated:
                if repeated != prev_pairs:
                    # a carry re-writes the preceding (failed) record
                    # wholesale; repeating only SOME of it — or pairs
                    # from older records — is a refold, not a carry
                    rep.fail(
                        "exactly_once_folds",
                        f"publish record {i} re-folds {sorted(repeated)} "
                        "which is not a whole-record carry of the "
                        "preceding record — an upload entered the "
                        "durable ledger twice",
                    )
                else:
                    carry_records += 1
            prev_pairs = set(pairs)
            for rank, seq in pairs:
                seen_pairs.add((rank, seq))
                if seq > max_seq:
                    rep.fail(
                        "no_reissued_seqs",
                        f"publish record {i} folds seq {seq} above its own "
                        f"dispatch high-water mark {max_seq}",
                    )
            folds_total = int(rec.get("folds_total", 0))
            if folds_total < len(seen_pairs):
                rep.fail(
                    "fold_ledger_consistent",
                    f"publish record {i} claims {folds_total} total folds "
                    f"but the ledger already holds {len(seen_pairs)} "
                    "distinct pairs",
                )
        if carry_records > failures and self.counters and not self.counters_reset:
            # with NO counters (telemetry disabled) or reset counters
            # (multi-process restart) the failure count may
            # under-report, so only the structural rules (whole-record
            # carry, no partial repeats) apply — every other
            # counter-balanced invariant skips in those cases too
            rep.fail(
                "exactly_once_folds",
                f"{carry_records} publish record(s) re-carry earlier "
                f"pairs but only {failures:g} WAL append failure(s) were "
                "counted — an upload entered the durable ledger twice",
            )

    # -- counter cross-checks (telemetry.jsonl) -----------------------
    def _check_counters(self, rep, sync, publishes) -> None:
        names = (
            "ledger_counter_match", "published_counter_match",
            "no_lost_unreported_folds", "counters_cover_ledger",
        )
        if not self.counters:
            for n in names:
                rep.skip(n, "no telemetry.jsonl found")
            return
        if self.counters_reset:
            # the docstring's promised tolerance: a multi-process
            # restart reset the registry, so the final snapshot is
            # plainly behind the WAL — the WAL-internal invariants
            # still apply, the counter balances cannot
            for n in names:
                rep.skip(
                    n,
                    "counters reset by a server restart; the final "
                    "snapshot under-counts the run",
                )
            return
        # upper bounds on counter/ledger divergence: each injected
        # CRASH (kill or torn write — not a delay, skew or refused
        # fsync) can strand at most one durable record without its
        # counter increment, and each counted append FAILURE may have
        # left a durable record (fsync refused after the bytes landed)
        # the counters never acknowledged. With neither, the gap must
        # be exactly zero.
        kills = _counter_tagged(
            self.counters, "chaos_faults_injected_total",
            "fault", ("kill_server", "kill_client", "torn_write"),
        )
        failures = self._ctr("wal_append_failures_total")
        sync_with_folds = [r for r in sync if r.get("folded") is not None]
        wal_sync_folds = sum(len(r["folded"]) for r in sync_with_folds)
        logged_rounds = self._ctr("wal_rounds_logged_total")
        logged_folds = self._ctr("wal_folds_logged_total")
        if sync_with_folds and (logged_rounds or logged_folds):
            rep.note_checked("ledger_counter_match")
            rec_gap = len(sync_with_folds) - logged_rounds
            fold_gap = wal_sync_folds - logged_folds
            max_folds = max(
                (len(r["folded"]) for r in sync_with_folds), default=0
            )
            if rec_gap < 0 or fold_gap < 0:
                rep.fail(
                    "ledger_counter_match",
                    "the server counted more WAL appends than the log "
                    "holds — records were lost after acknowledgement",
                    records=len(sync_with_folds),
                    counted=logged_rounds,
                )
            elif (
                rec_gap > kills + failures
                or fold_gap > (kills + failures) * max_folds
            ):
                rep.fail(
                    "ledger_counter_match",
                    f"{rec_gap:g} durable WAL record(s) / {fold_gap:g} "
                    "fold(s) were never counted — beyond what "
                    f"{kills:g} injected crash(es) and {failures:g} "
                    "append failure(s) can explain",
                )
        elif sync_with_folds:
            rep.skip("ledger_counter_match", "run predates the ledger counters")
        pairs = set()
        for rec in publishes:
            for p in rec.get("folded") or []:
                if isinstance(p, (list, tuple)) and len(p) == 2:
                    pairs.add((int(p[0]), int(p[1])))
        published_ctr = self._ctr("agg_folds_published_total")
        if publishes and published_ctr:
            rep.note_checked("published_counter_match")
            gap = len(pairs) - published_ctr
            max_pub_folds = max(
                (
                    len(rec.get("folded") or [])
                    for rec in publishes
                ),
                default=0,
            )
            if gap < 0:
                rep.fail(
                    "published_counter_match",
                    "more folds counted as published than the WAL ledger "
                    "holds — the ledger under-covers the checkpoints",
                    ledger=len(pairs),
                    counted=published_ctr,
                )
            elif gap > (kills + failures) * max_pub_folds:
                # a kill after the append — or a failed-but-durable
                # final append — strands its whole record's pairs
                # uncounted (a later success re-counts a carry), so
                # each crash or failure explains up to one record's
                # worth of pairs
                rep.fail(
                    "published_counter_match",
                    f"{gap:g} ledgered fold(s) never counted as published "
                    f"— beyond what {kills:g} injected crash(es) and "
                    f"{failures:g} append failure(s) can explain",
                )
        elif publishes:
            rep.skip(
                "published_counter_match", "run predates the ledger counters"
            )
        # no-lost-unreported: only provable on a cleanly finished run
        # (the finish path flushes every accepted fold to the ledger)
        async_folds = _counter_total(self.counters, "agg_folds_total{mode=async}")
        if publishes and async_folds:
            if self._ctr("cross_silo_finish_total") < 1:
                rep.skip(
                    "no_lost_unreported_folds",
                    "run did not finish cleanly; in-flight folds at the "
                    "final crash are legitimately unaccounted",
                )
            else:
                lost = self._ctr("agg_folds_lost_total")
                unaccounted = async_folds - len(pairs) - lost
                if unaccounted > 1e-9 and failures > 0:
                    # a failed FINAL append (disk-full on the flush)
                    # leaves accepted folds unledgered by the
                    # documented degraded-durability contract — the
                    # counted failures grant the same allowance the
                    # ledger/published balances give
                    rep.skip(
                        "no_lost_unreported_folds",
                        f"{failures:g} counted append failure(s) may have "
                        f"left the {unaccounted:g} unledgered fold(s) "
                        "behind (degraded durability, not a loss bug)",
                    )
                else:
                    rep.note_checked("no_lost_unreported_folds")
                    if abs(unaccounted) > 1e-9:
                        rep.fail(
                            "no_lost_unreported_folds",
                            f"{unaccounted:g} accepted fold(s) neither "
                            "reached the durable ledger nor were reported "
                            f"lost (accepted {async_folds:g}, ledgered "
                            f"{len(pairs)}, reported lost {lost:g})",
                        )
        total_ledger = wal_sync_folds + len(pairs)
        folds_ctr = self._ctr("agg_folds_total")
        if total_ledger and folds_ctr:
            rep.note_checked("counters_cover_ledger")
            if folds_ctr + 1e-9 < total_ledger:
                rep.fail(
                    "counters_cover_ledger",
                    f"the durable ledger holds {total_ledger} fold(s) but "
                    f"only {folds_ctr:g} were ever counted at fold time — "
                    "either counters were reset (multi-process restart) or "
                    "the ledger double-books",
                )
        elif total_ledger:
            rep.skip("counters_cover_ledger", "no fold counters in snapshot")

    # -- cross-device Beehive plane (cross_device/gateway.py) ---------
    def _check_crossdevice(self, rep, xdev) -> None:
        """The check-in plane's ledger discipline, re-proven offline.

        ``device_fold_requires_checkin``: every folded device appears
        in its round's check-in list (no fold without a ledgered
        check-in). ``device_masked_folds_balance``: the round's field
        checksum equals the sum of its upload checksums minus its
        correction checksums mod p — the pairwise masks cancelled, in
        the durable record, not just in memory.
        ``device_round_close_accounted``: every close carries a legal
        reason, a target close really met its target, and the ledger's
        fold count matches the fold counter exactly (at-most-once
        fold). ``device_mask_recovery_verified``: no reconstructed
        mask secret ever contradicted its published key.
        """
        if not xdev:
            for name in (
                "device_fold_requires_checkin",
                "device_masked_folds_balance",
                "device_round_close_accounted",
                "device_mask_recovery_verified",
            ):
                rep.skip(name, "no crossdevice records in the WAL")
            return
        prime = 2**31 - 1  # core.secure_agg.FIELD_PRIME
        rep.note_checked("device_fold_requires_checkin")
        rep.note_checked("device_masked_folds_balance")
        rep.note_checked("device_round_close_accounted")
        total_folds = 0
        for i, rec in enumerate(xdev):
            r = rec.get("round_idx")
            checkins = set(rec.get("checkins") or [])
            folded = list(rec.get("folded") or [])
            total_folds += len(folded)
            cohort = set(rec.get("cohort") or [])
            if not checkins <= cohort:
                rep.fail(
                    "device_fold_requires_checkin",
                    f"crossdevice record {i} (round {r}) checked in devices "
                    "outside the sampled cohort",
                    extra=sorted(checkins - cohort),
                )
            if not set(folded) <= checkins:
                rep.fail(
                    "device_fold_requires_checkin",
                    f"crossdevice record {i} (round {r}) folded devices "
                    "that never checked in",
                    unledgered=sorted(set(folded) - checkins),
                )
            reason = rec.get("close_reason")
            if reason not in ("target", "window"):
                rep.fail(
                    "device_round_close_accounted",
                    f"crossdevice record {i} (round {r}) closed for "
                    f"unknown reason {reason!r}",
                )
            elif reason == "target" and len(folded) < int(
                rec.get("fold_target") or 0
            ):
                rep.fail(
                    "device_round_close_accounted",
                    f"crossdevice record {i} (round {r}) claims a target "
                    f"close with {len(folded)} fold(s) under its target "
                    f"{rec.get('fold_target')}",
                )
            if rec.get("masked"):
                ups = sum(
                    int(v) for v in (rec.get("upload_checksums") or {}).values()
                )
                corrs = sum(
                    int(v)
                    for v in (rec.get("correction_checksums") or {}).values()
                )
                want = (ups - corrs) % prime
                got = int(rec.get("field_checksum") or 0)
                if got != want:
                    rep.fail(
                        "device_masked_folds_balance",
                        f"crossdevice record {i} (round {r}) field checksum "
                        f"{got} != uploads-minus-corrections balance {want} "
                        "— a mask survived the fold or a correction was "
                        "misapplied",
                    )
        if not self.counters:
            rep.skip(
                "device_mask_recovery_verified", "no telemetry.jsonl found"
            )
            return
        if self.counters_reset:
            rep.skip(
                "device_mask_recovery_verified",
                "counters reset by a server restart; evidence may predate "
                "the final snapshot",
            )
            return
        folded_ctr = self._ctr("device_uploads_folded_total")
        if folded_ctr and abs(folded_ctr - total_folds) > 1e-9:
            rep.fail(
                "device_round_close_accounted",
                f"the WAL ledgers {total_folds} fold(s) but the fold "
                f"counter saw {folded_ctr:g} — the at-most-once fold "
                "ledger and the telemetry disagree",
            )
        rep.note_checked("device_mask_recovery_verified")
        failures = self._ctr("device_mask_recovery_failures_total")
        if failures > 0:
            rep.fail(
                "device_mask_recovery_verified",
                f"{failures:g} reconstructed mask secret(s) contradicted "
                "their published keys — a revealed share was bad, and the "
                "round folded without that correction",
            )

    # -- trace cross-check --------------------------------------------
    def _check_chaos_trace(self, rep) -> None:
        fault_ctr = self._ctr("chaos_faults_injected_total")
        fault_events = [
            e for e in self.trace_events if e.get("name") == "chaos.fault"
        ]
        if not fault_ctr and not fault_events:
            rep.skip("chaos_trace_consistent", "no chaos faults in this run")
            return
        if not self.trace_events:
            rep.skip("chaos_trace_consistent", "no trace.json found")
            return
        if self.counters_reset:
            rep.skip(
                "chaos_trace_consistent",
                "counters reset by a server restart; the final snapshot "
                "under-counts the injected faults",
            )
            return
        rep.note_checked("chaos_trace_consistent")
        if len(fault_events) != int(fault_ctr):
            rep.fail(
                "chaos_trace_consistent",
                f"trace holds {len(fault_events)} chaos.fault instant(s) "
                f"but counters say {fault_ctr:g} were injected — one "
                "artifact lost fault evidence",
            )

    # -- convenience --------------------------------------------------
    @staticmethod
    def fault_signature(trace_events: List[dict]) -> List[tuple]:
        """The determinism fingerprint of a run: its chaos.fault
        instants as (fault, event) tuples, sorted — two runs of the
        same (schedule, seed) must produce identical signatures."""
        return sorted(
            (
                (e.get("args") or {}).get("fault"),
                (e.get("args") or {}).get("event"),
            )
            for e in trace_events
            if e.get("name") == "chaos.fault"
        )
