"""Root of the hierarchical server plane: edges are its "clients" (port of
``fedml_tpu/cross_silo/hierarchical/root_server_manager.py``).

Rank 0 of the root fabric. Per round it runs the SAME selection as the
flat server (``FedMLAggregator.client_selection`` /
``data_silo_selection`` over the global client ids — which is what
keeps hierarchical training bit-comparable to the flat world), then
ships each live edge its slice of the assignment plus the current
quarantine decision. Each edge folds its clients' uploads on arrival
and ships back ONE merged limb-set; the root merges the limb-sets
through ``StreamingAccumulator.merge`` (one launch of the exact fold
kernel K1 a report: tree finalize bitwise identical to flat) and finalizes at close.

Decision plane (root decides, edges enforce):

- **quarantine** — edges report anomaly-screen trips as evidence; the
  root holds the authoritative quarantine set with
  ``defense_quarantine_rounds`` probation ticked per round close, and
  every round broadcast carries the current list;
- **death/leave** — client deaths are detected AT THE EDGE (heartbeats
  route client→edge only) and reported up; the root excludes reported-
  dead clients from future assignments until an ONLINE event clears
  them. A dead EDGE is detected HERE (edges beat root-ward): its whole
  partition leaves the current round — quorum denominators are summed
  over LIVE edges, so a dead edge can never stall the grace window —
  and a federation with no live edges left finishes loudly;
- **recovery** — a reconnecting edge is RESYNCed with the current
  round + params + its client assignment; the root WAL's per-round
  records carry an ``edge_folds`` sub-ledger (which edge contributed
  which folded ranks) and merges are deduped per (edge, round), so a
  restarted edge re-running an in-flight round can never double-merge.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Dict, List, Optional, Set

from ... import constants
from ...core.aggregation import StreamingAccumulator
from ...core.chaos import chaos_barrier
from ...core.managers import ServerManager
from ...core.message import Message

__all__ = ["RootServerManager"]


class RootServerManager(ServerManager):
    def __init__(
        self,
        args,
        aggregator,
        partition: Dict[int, int],
        comm=None,
        backend=constants.COMM_BACKEND_LOCAL,
    ) -> None:
        from .plane import edge_clients

        self.partition = {int(r): int(e) for r, e in partition.items()}
        self.edge_client_map = edge_clients(self.partition)
        self.edge_num = max(self.edge_client_map) if self.edge_client_map else 0
        super().__init__(args, comm, 0, self.edge_num + 1, backend)
        self.aggregator = aggregator
        self.round_num = int(args.comm_round)
        self.round_idx = 0
        self.is_initialized = False
        from ...core.tracking import MetricsReporter, ProfilerEvent

        self.profiler = ProfilerEvent(args)
        self.metrics_reporter = MetricsReporter(args)
        self.telemetry.attach_profiler(self.profiler)
        # -- membership state ------------------------------------------
        self.edge_online: Dict[int, bool] = {}
        self._dead_edges: Set[int] = set()
        self.edge_deaths = 0
        self._dead_clients: Set[int] = set()
        self._left_clients: Set[int] = set()
        # client rank -> remaining probation closes (root's decision)
        self._quarantine: Dict[int, int] = {}
        self.quarantine_rounds = int(
            getattr(args, "defense_quarantine_rounds", 2) or 2
        )
        # -- per-round state -------------------------------------------
        self._round_assignment: Dict[int, int] = {}
        self._expected_edges: Set[int] = set()
        self._reports: Dict[int, Dict] = {}
        self._root_acc: Optional[StreamingAccumulator] = None
        self._last_broadcast_type = None
        self._round_t0 = None
        self.round_walls: List[float] = []  # each closed round's wall time
        self.stragglers_dropped = 0
        self.quorum_closes = 0
        # quorum over CLIENTS, denominators summed over live edges
        self.quorum_frac = float(getattr(args, "round_quorum_frac", 0.0) or 0.0)
        self.round_grace_s = float(getattr(args, "round_grace_s", 0.0) or 0.0)
        self._quorum_timer = None
        self._quorum_armed_round = None
        # -- edge liveness (edges beat root-ward) ----------------------
        self._failure_detector = None
        timeout_s = float(getattr(args, "heartbeat_timeout_s", 0.0) or 0.0)
        if timeout_s > 0:
            from ...core.comm.heartbeat import FailureDetector

            self._failure_detector = FailureDetector(
                timeout_s, self._post_edge_dead
            ).start()
        # -- crash recovery (root checkpoint + WAL with edge_folds) ----
        self._ckpt = None
        self._wal = None
        self._resumed = False
        ckpt_dir = getattr(args, "checkpoint_dir", None)
        if ckpt_dir:
            from ...core.checkpoint import RoundCheckpointer, RoundWAL

            self._ckpt = RoundCheckpointer(ckpt_dir)
            self._wal = RoundWAL(ckpt_dir)
            self._ckpt_freq = max(
                1, int(getattr(args, "checkpoint_freq", None) or 1)
            )
            state = self._ckpt.restore(
                target={"params": self.aggregator.get_global_model_params()}
            )
            if state is not None:
                self.round_idx = int(state["round_idx"])
                self.aggregator.set_global_model_params(state["params"])
                self.aggregator._agg_round = int(
                    state.get("agg_round", self.round_idx)
                )
                self._resumed = True
                logging.info(
                    "hier root resumed at round %d from %s",
                    self.round_idx, ckpt_dir,
                )
                if self._failure_detector is not None:
                    for e in self.edge_client_map:
                        self._failure_detector.watch(e)

    # -- handlers ------------------------------------------------------
    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            constants.MSG_TYPE_C2S_CLIENT_STATUS,
            self.handle_message_edge_status,
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_E2R_EDGE_REPORT, self.handle_message_edge_report
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_E2R_CLIENT_EVENT,
            self.handle_message_client_event,
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_C2S_HEARTBEAT, self.handle_message_heartbeat
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_S2S_CLIENT_DEAD, self.handle_message_edge_dead
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_S2S_QUORUM_GRACE,
            self.handle_message_quorum_grace,
        )

    def receive_message(self, msg_type: int, msg_params: Message) -> None:
        if self._failure_detector is not None:
            sender = int(msg_params.get_sender_id())
            if sender != self.rank:
                self._failure_detector.note_alive(sender)
        super().receive_message(msg_type, msg_params)

    # -- presence / liveness of edges ----------------------------------
    def handle_message_edge_status(self, msg: Message) -> None:
        status = msg.get(constants.MSG_ARG_KEY_CLIENT_STATUS)
        sender = int(msg.get_sender_id())
        if status != constants.CLIENT_STATUS_ONLINE:
            return
        if sender not in self.edge_client_map:
            logging.warning("ONLINE from unknown edge rank %d ignored", sender)
            return
        self.edge_online[sender] = True
        self._dead_edges.discard(sender)
        if self._failure_detector is not None:
            self._failure_detector.watch(sender)
        if self.is_initialized:
            self._maybe_resync_edge(sender)
            return
        if all(
            self.edge_online.get(e, False)
            for e in self.edge_client_map
            if e not in self._dead_edges
        ):
            self.is_initialized = True
            self.send_init_msg()

    def handle_message_heartbeat(self, msg: Message) -> None:
        sender = int(msg.get_sender_id())
        if not self.edge_online.get(sender, False):
            synth = Message(constants.MSG_TYPE_C2S_CLIENT_STATUS, sender, 0)
            synth.add_params(
                constants.MSG_ARG_KEY_CLIENT_STATUS,
                constants.CLIENT_STATUS_ONLINE,
            )
            logging.info(
                "root: heartbeat from offline edge %d — treating as "
                "(re)connect", sender,
            )
            self.handle_message_edge_status(synth)

    def _post_edge_dead(self, rank: int) -> None:
        msg = Message(constants.MSG_TYPE_S2S_CLIENT_DEAD, 0, 0)
        msg.add_params(constants.MSG_ARG_KEY_RANK, int(rank))
        try:
            self.send_message(msg)
        except Exception:  # noqa: BLE001 — transport tearing down
            logging.warning(
                "root: death notice for edge %d could not be posted",
                rank, exc_info=True,
            )
            if self._failure_detector is not None:
                self._failure_detector.watch(rank)

    def handle_message_edge_dead(self, msg: Message) -> None:
        """A whole EDGE went silent: the root must not stall its grace
        window on a dead aggregator tier. Its
        entire client partition leaves the current round — the quorum
        denominator shrinks by the edge's live cohort — and with no
        live edge left the federation finishes loudly. The partition
        itself stays assigned: clients are wired to their edge's
        fabric, so they rejoin when the edge restarts and is RESYNCed."""
        rank = int(msg.get(constants.MSG_ARG_KEY_RANK, -1))
        if (
            self._failure_detector is not None
            and self._failure_detector.seen_recently(rank)
        ):
            self._failure_detector.watch(rank)
            return
        if not self.edge_online.get(rank, False):
            return
        self.edge_online[rank] = False
        self._dead_edges.add(rank)
        self.edge_deaths += 1
        self.telemetry.inc("hier_edges_declared_dead_total")
        logging.warning(
            "root: edge %d declared DEAD at round %d (%d client slots "
            "leave the round); dropping it until it reconnects",
            rank, self.round_idx, len(self.edge_client_map.get(rank, [])),
        )
        if not self.is_initialized:
            return
        self._expected_edges.discard(rank)
        live = [
            e
            for e in self.edge_client_map
            if self.edge_online.get(e, False)
        ]
        if not live:
            logging.error(
                "root: no live edge aggregators remain; finishing loudly "
                "instead of stalling the grace window"
            )
            self.send_finish()
            self.finish()
            return
        if self._expected_edges <= set(self._reports):
            # the dead edge was the only report the round still waited
            # on (a zero-report round closes too: the global model is
            # unchanged and the survivors get the next broadcast)
            self._finish_round()
        else:
            self._maybe_arm_quorum()

    def _maybe_resync_edge(self, edge: int) -> None:
        """Ship a reconnecting edge the CURRENT round (params +
        assignment + quarantine) so a restarted edge resumes instead of
        stalling its partition until the next broadcast."""
        if edge in self._reports:
            return  # already contributed; the next broadcast picks it up
        self._expected_edges.add(edge)
        logging.info("root: RESYNC edge %d into round %d", edge, self.round_idx)
        self.telemetry.inc("cross_silo_resyncs_total")
        self._send_round_to_edge(
            edge, constants.MSG_TYPE_S2C_RESYNC, self._round_assignment
        )

    # -- client events forwarded by edges ------------------------------
    def handle_message_client_event(self, msg: Message) -> None:
        kind = msg.get(constants.MSG_ARG_KEY_EVENT_KIND)
        rank = int(msg.get(constants.MSG_ARG_KEY_RANK, -1))
        edge = int(msg.get_sender_id())
        self.telemetry.inc("hier_client_events_total", kind=str(kind))
        if kind == constants.HIER_EVENT_DEAD:
            self._dead_clients.add(rank)
            self.telemetry.inc("cross_silo_clients_declared_dead_total")
        elif kind == constants.HIER_EVENT_LEAVE:
            self._left_clients.add(rank)
            self._dead_clients.add(rank)
            self.telemetry.inc("cross_silo_client_leaves_total")
        elif kind == constants.HIER_EVENT_ONLINE:
            self._dead_clients.discard(rank)
            self._left_clients.discard(rank)
        elif kind == constants.HIER_EVENT_QUARANTINE:
            # the ROOT decision: federation-wide exclusion for the
            # probation window, enforced by every edge from the next
            # broadcast's quarantine list
            if rank not in self._quarantine:
                self.telemetry.inc("defense_quarantined_total", rank=rank)
            self._quarantine[rank] = self.quarantine_rounds
            logging.warning(
                "root: quarantining rank %d for %d round close(s) on edge "
                "%d screen evidence", rank, self.quarantine_rounds, edge,
            )
        else:
            logging.warning("root: unknown client event %r ignored", kind)
        # a mid-round death/quarantine shrinks the quorum denominator
        self._maybe_arm_quorum()

    # -- round lifecycle ----------------------------------------------
    def send_init_msg(self) -> None:
        if self.round_idx >= self.round_num:
            logging.info(
                "resumed at round %d >= comm_round %d; finishing",
                self.round_idx, self.round_num,
            )
            self.aggregator.test_on_server_for_all_clients(self.round_num - 1)
            self.send_finish()
            self.finish()
            return
        self._broadcast_round(
            constants.MSG_TYPE_S2C_RESYNC
            if self._resumed
            else constants.MSG_TYPE_S2C_INIT_CONFIG
        )

    def _live_edges(self) -> List[int]:
        return sorted(
            e
            for e in self.edge_client_map
            if self.edge_online.get(e, False) and e not in self._dead_edges
        )

    def _broadcast_round(self, msg_type) -> None:
        chaos_barrier("server.broadcast", round=self.round_idx, rank=self.rank)
        quarantined = sorted(self._quarantine)
        self.telemetry.set_gauge("defense_quarantined_now", len(quarantined))
        # SAME selection as the flat server over the same candidate
        # order — the bit-identity anchor: every client trains the same
        # (silo, round) it would have trained in the flat world
        candidates = [
            r
            for r in sorted(self.partition)
            if r not in self._dead_clients and r not in quarantined
        ]
        live_edges = self._live_edges()
        if not candidates or not live_edges:
            logging.error(
                "round %d: no live clients/edges to broadcast to; finishing",
                self.round_idx,
            )
            self.send_finish()
            self.finish()
            return
        selected = self.aggregator.client_selection(
            self.round_idx, candidates, len(candidates)
        )
        silos = self.aggregator.data_silo_selection(
            self.round_idx,
            int(self.args.client_num_in_total),
            len(selected),
        )
        self._round_assignment = dict(zip(selected, silos))
        self._reports = {}
        self._expected_edges = set(live_edges)
        self._root_acc = StreamingAccumulator(
            self.aggregator.get_global_model_params()
        )
        self._last_broadcast_type = msg_type
        self._round_t0 = time.perf_counter()
        self.telemetry.recorder.begin(
            "cross_silo.round", cat="round", round=self.round_idx
        )
        for e in live_edges:
            self._send_round_to_edge(e, msg_type, self._round_assignment)

    def _send_round_to_edge(self, edge, msg_type, assignment) -> None:
        mine = {
            str(r): int(s)
            for r, s in assignment.items()
            if self.partition.get(r) == edge
        }
        msg = Message(msg_type, self.rank, edge)
        msg.add_params(
            constants.MSG_ARG_KEY_MODEL_PARAMS,
            self.aggregator.get_global_model_params(),
        )
        msg.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, self.round_idx)
        msg.add_params(constants.MSG_ARG_KEY_HIER_ASSIGNMENT, mine)
        msg.add_params(
            constants.MSG_ARG_KEY_QUARANTINED, sorted(self._quarantine)
        )
        self.send_message(msg)

    def handle_message_edge_report(self, msg: Message) -> None:
        sender = int(msg.get_sender_id())
        report_round = int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX, -1))
        if report_round != self.round_idx or not self.is_initialized:
            self.telemetry.inc("hier_edge_merge_dups_total", reason="stale")
            logging.warning(
                "root: discarding stale edge %d report for round %d (now %d)",
                sender, report_round, self.round_idx,
            )
            return
        if sender in self._reports:
            # a restarted edge re-ran the round, or the wire duplicated
            # past the channel dedup (fresh incarnation = fresh channel
            # id): merges are exactly-once per (edge, round) HERE
            self.telemetry.inc("hier_edge_merge_dups_total", reason="dup")
            logging.warning(
                "root: duplicate report from edge %d for round %d dropped",
                sender, report_round,
            )
            return
        state = msg.get(constants.MSG_ARG_KEY_EDGE_STATE) or {}
        folded = [int(r) for r in msg.get(constants.MSG_ARG_KEY_FOLDED) or []]
        cohort = [int(r) for r in msg.get(constants.MSG_ARG_KEY_COHORT) or []]
        with self.profiler.span(
            "root_fold", round=self.round_idx, edge=sender
        ):
            if int(state.get("count", 0)):
                shell = StreamingAccumulator(
                    self.aggregator.get_global_model_params()
                ).load_state(state)
                self._root_acc.merge(shell)
        self._reports[sender] = {"folded": folded, "cohort": cohort}
        self._expected_edges.add(sender)  # a resynced straggler counts
        self.telemetry.inc("hier_edge_merges_total", edge=sender)
        if self._expected_edges <= set(self._reports):
            self._finish_round()
        else:
            self._maybe_arm_quorum()

    # -- quorum over clients, denominators summed over edges ----------
    def _quorum_progress(self):
        """(folded_so_far, denominator): folds counted from received
        reports; the denominator adds each still-missing LIVE edge's
        live assigned cohort — a dead edge's clients leave it, which is
        what keeps a grace window from waiting on a corpse tier."""
        folded = sum(len(r["folded"]) for r in self._reports.values())
        den = folded
        for e in self._expected_edges:
            if e in self._reports:
                continue
            den += sum(
                1
                for r in self._round_assignment
                if self.partition.get(r) == e and r not in self._dead_clients
            )
        return folded, den

    def _maybe_arm_quorum(self) -> None:
        if (
            self.quorum_frac <= 0
            or not self.is_initialized
            or self._quorum_armed_round == self.round_idx
            or not self._reports
        ):
            return
        folded, den = self._quorum_progress()
        target = max(1, math.ceil(self.quorum_frac * max(den, 1)))
        if folded < target:
            return
        self._quorum_armed_round = self.round_idx
        round_idx = self.round_idx
        logging.info(
            "root: round %d quorum reached (%d/%d folds over %d edges); "
            "grace %.2fs for the remaining edge reports",
            round_idx, folded, den, len(self._expected_edges),
            self.round_grace_s,
        )

        def fire() -> None:
            out = Message(constants.MSG_TYPE_S2S_QUORUM_GRACE, 0, 0)
            out.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, round_idx)
            try:
                self.send_message(out)
            except Exception:  # noqa: BLE001 — transport tearing down
                logging.warning(
                    "root: quorum grace post failed", exc_info=True
                )

        self._quorum_timer = threading.Timer(self.round_grace_s, fire)
        self._quorum_timer.daemon = True
        self._quorum_timer.start()

    def handle_message_quorum_grace(self, msg: Message) -> None:
        fired_round = int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX, -1))
        if fired_round != self.round_idx or not self._reports:
            return
        missing = sorted(self._expected_edges - set(self._reports))
        if missing:
            dropped = sum(
                1
                for r in self._round_assignment
                if self.partition.get(r) in missing
            )
            self.stragglers_dropped += dropped
            self.quorum_closes += 1
            self.telemetry.inc("agg_quorum_closes_total")
            logging.warning(
                "root: round %d quorum close — aggregating %d edge "
                "report(s) after %.2fs grace (edge(s) %s dropped, %d "
                "client slot(s))",
                self.round_idx, len(self._reports), self.round_grace_s,
                missing, dropped,
            )
        self._finish_round()

    # -- round close ---------------------------------------------------
    def _cancel_quorum(self) -> None:
        if self._quorum_timer is not None:
            self._quorum_timer.cancel()
            self._quorum_timer = None
        self._quorum_armed_round = None

    def _finish_round(self) -> None:
        chaos_barrier(
            "server.round_close", round=self.round_idx, rank=self.rank
        )
        self._cancel_quorum()
        folded_all: List[int] = []
        edge_folds = {}
        for e, rep in sorted(self._reports.items()):
            folded_all.extend(rep["folded"])
            edge_folds[str(e)] = sorted(rep["folded"])
        n_aggregated = len(folded_all)
        eval_round = self.round_idx
        cohort_ranks = sorted(self._round_assignment)
        t_agg0 = time.perf_counter()
        if n_aggregated:
            with self.profiler.span("aggregate", round=self.round_idx):
                params = self._root_acc.finalize()
                params = self.aggregator._apply_weak_dp(params)
                self.aggregator.set_global_model_params(params)
            # reset_window advances _agg_round exactly like the flat
            # aggregate() — weak-DP keys and custom-aggregator rng
            # streams stay bit-comparable across topologies
            self.aggregator.reset_window()
        else:
            logging.warning(
                "root: round %d closed with no contributions; global "
                "model unchanged", self.round_idx,
            )
        # probation ticks per round close; released ranks re-enter the
        # next broadcast's candidate list (and its quarantine list
        # shrinks — the edges enforce whatever the root now says)
        released = [
            r for r, left in self._quarantine.items() if left - 1 <= 0
        ]
        self._quarantine = {
            r: left - 1
            for r, left in self._quarantine.items()
            if left - 1 > 0
        }
        if released:
            logging.info(
                "root: quarantine probation expired for rank(s) %s",
                sorted(released),
            )
        if self._round_t0 is not None:
            wall = time.perf_counter() - self._round_t0
            self.round_walls.append(wall)
            self.telemetry.observe("round_wall_seconds", wall)
            self.telemetry.observe(
                "round_segment_seconds",
                max(time.perf_counter() - t_agg0, 0.0),
                segment="aggregate",
            )
        self.telemetry.recorder.end(
            "cross_silo.round", cat="round", round=eval_round
        )
        self.round_idx += 1
        ckpt_due = (
            self._ckpt is not None
            and n_aggregated
            and (
                self.round_idx % self._ckpt_freq == 0
                or self.round_idx >= self.round_num
            )
        )
        if self.round_idx >= self.round_num:
            if ckpt_due:
                self._save_checkpoint()
            self._wal_append(eval_round, ckpt_due, cohort_ranks, folded_all, edge_folds)
            if n_aggregated:
                self.aggregator.test_on_server_for_all_clients(eval_round)
            self._report_round(eval_round, len(cohort_ranks), n_aggregated)
            self.send_finish()
            self.finish()
            return
        # overlap like the flat server: next broadcast FIRST, then the
        # durable writes and the eval ride the training window
        self._broadcast_round(constants.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT)
        if ckpt_due:
            self._save_checkpoint()
        self._wal_append(eval_round, ckpt_due, cohort_ranks, folded_all, edge_folds)
        if n_aggregated:
            with self.profiler.span("server_eval_overlapped"):
                self.aggregator.test_on_server_for_all_clients(eval_round)
        self._report_round(eval_round, len(cohort_ranks), n_aggregated)

    def _save_checkpoint(self) -> None:
        self._ckpt.save(
            self.round_idx,
            {
                "params": self.aggregator.get_global_model_params(),
                "round_idx": self.round_idx,
                "agg_round": self.aggregator._agg_round,
            },
        )

    def _wal_append(
        self, eval_round, ckpt_saved, cohort_ranks, folded_ranks, edge_folds
    ) -> None:
        """One record per completed round, like the flat server's, PLUS
        the per-edge fold sub-ledger: ``edge_folds`` maps each merged
        edge to the client ranks its limb-set folded — the multi-tier
        invariants (edge sets partition the root's folded set; one
        merge per (edge, round)) check it from artifacts alone."""
        if self._wal is None:
            return
        try:
            self._wal.append(
                eval_round,
                self.round_idx if ckpt_saved else None,
                cohort_ranks,
                folded=folded_ranks,
                extra={"edge_folds": edge_folds},
            )
            self.telemetry.inc("wal_rounds_logged_total")
            self.telemetry.inc(
                "wal_folds_logged_total", len(folded_ranks or [])
            )
        except OSError:
            logging.exception(
                "root: WAL append failed for round %d", eval_round
            )
            self.telemetry.inc("wal_append_failures_total")

    def _report_round(self, round_idx, cohort, n_aggregated) -> None:
        self.metrics_reporter.report(
            {
                "kind": "round_info",
                "round": round_idx,
                "clients": cohort,
                "clients_aggregated": n_aggregated,
                "edges": len(self._live_edges()),
            }
        )
        self.telemetry.heartbeat("cross_silo.round", round_idx)
        self.telemetry.inc("cross_silo_rounds_total")
        self.telemetry.inc("cross_silo_clients_aggregated_total", n_aggregated)
        if self.stragglers_dropped:
            self.telemetry.set_gauge(
                "cross_silo_stragglers_dropped", self.stragglers_dropped
            )

    def send_finish(self) -> None:
        self.telemetry.inc("cross_silo_finish_total")
        for e in self.edge_client_map:
            self.send_message(Message(constants.MSG_TYPE_S2C_FINISH, 0, e))
        logging.info(
            "root: federation finished after %d rounds over %d edges",
            self.round_idx, len(self.edge_client_map),
        )
        if self._failure_detector is not None:
            self._failure_detector.stop()
