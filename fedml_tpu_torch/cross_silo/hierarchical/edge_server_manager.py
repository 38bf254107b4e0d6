"""Edge aggregator rank: a real process between clients and root (port of
``fedml_tpu/cross_silo/hierarchical/edge_server_manager.py``).

One ``EdgeServerManager`` is TWO comm endpoints in one process:

- **downlink** — rank 0 ("the server") of its own edge fabric, where
  its assigned clients run the stock ``FedMLClientManager`` completely
  unchanged: they announce ONLINE here, beat here (heartbeats route
  client→edge only — the root never sees client liveness directly),
  and upload here;
- **uplink** — client-side rank E of the root fabric
  (``core.managers.build_comm_stack``: instrumentation, fault
  injection and the ReliableChannel stack EXACTLY as on the downlink,
  channel outermost), where it announces ONLINE, beats, ships one
  merged limb-set per round close, and forwards client death/leave/
  anomaly evidence as CLIENT_EVENTs.

Per round: the root's broadcast carries this edge's client→silo
assignment plus the root's quarantine decision; the edge re-broadcasts
to its live clients, folds each upload ON ARRIVAL through the
``StreamingAccumulator`` (via the stock ``FedMLAggregator`` in
streaming mode: one K1 launch an upload, clipping defenses in the term's
K3 launch, the anomaly screen scoring before the fold), and at close ships the
accumulator's exact 3-limb expansion upstream
(``FedMLAggregator.export_fold_state``). The root merges limb-sets
through the same exact fold (one K1 launch a report), so the federation's finalize is
**bitwise identical** to the flat single-server world — the tree
contract of ``scale/tree.py``, now across processes.

Failure model: a dead client is detected HERE
(edge-local ``FailureDetector``), dropped from the edge's expected set
(the report ships without it) and reported upstream — the root
decides membership, the edges enforce. A dead EDGE is the root's
detector's job. An edge restart resumes from its WAL sub-ledger
(``{checkpoint_dir}/edge_{rank}/round_wal.jsonl``): the ledger names
the rounds this edge already folded+shipped; a re-run of an in-flight
round is idempotent because the root dedups merges per (edge, round).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional, Set

from ... import constants
from ...core.chaos import chaos_barrier
from ...core.managers import ServerManager, _build_com_manager, build_comm_stack
from ...core.message import Message
from ...core.tracing import continue_context
from .plane import edge_fabric_run_id, edge_port_base

__all__ = ["EdgeServerManager"]


class EdgeServerManager(ServerManager):
    def __init__(
        self,
        args,
        aggregator,
        edge_rank: int,
        client_ranks,
        comm=None,
        uplink=None,
        backend=constants.COMM_BACKEND_LOCAL,
    ) -> None:
        import copy

        self.edge_rank = int(edge_rank)
        self.client_ranks = sorted(int(r) for r in client_ranks)
        # downlink fabric: this edge is rank 0 of run_{run_id}_edge{E};
        # clients join as their GLOBAL ranks, so "size" only needs to
        # exceed the largest of them (LOCAL inboxes are a dict; gRPC
        # binds port_base + rank inside this edge's port block)
        down_size = (max(self.client_ranks) if self.client_ranks else 0) + 1
        down_args = copy.copy(args)
        down_args.run_id = edge_fabric_run_id(
            getattr(args, "run_id", "0"), self.edge_rank
        )
        if str(backend).upper() == constants.COMM_BACKEND_GRPC:
            down_args.grpc_port_base = edge_port_base(args, self.edge_rank)
        raw_down = comm if comm is not None else _build_com_manager(
            down_args, 0, down_size, backend
        )
        super().__init__(args, raw_down, 0, down_size, backend)
        # uplink: a full comm stack (reliable outermost) toward the root
        edge_num = int(getattr(args, "edge_num", 1) or 1)
        self.uplink = uplink if uplink is not None else build_comm_stack(
            args, rank=self.edge_rank, size=edge_num + 1, backend=backend
        )
        self.uplink.add_observer(_UplinkObserver(self))
        self.aggregator = aggregator
        from ...core.tracking import ProfilerEvent

        self.profiler = ProfilerEvent(args)
        self.telemetry.attach_profiler(self.profiler)
        # -- per-round state (assigned by the root's broadcast) --------
        self.round_idx = -1
        self._round_open = False
        self._round_msg: Optional[Message] = None
        self._pending_round: Optional[Message] = None
        self._assignment: Dict[int, int] = {}  # client rank -> silo idx
        self._quarantined: Set[int] = set()  # root's decision, enforced here
        self.client_online: Dict[int, bool] = {}
        self._dead_clients: Set[int] = set()
        self.reports_shipped = 0
        self.uploads_folded = 0
        self._finished = False
        # -- client liveness (heartbeats route client->edge ONLY) ------
        self._failure_detector = None
        timeout_s = float(getattr(args, "heartbeat_timeout_s", 0.0) or 0.0)
        if timeout_s > 0:
            from ...core.comm.heartbeat import FailureDetector

            self._failure_detector = FailureDetector(
                timeout_s, self._post_client_dead
            ).start()
        # edge->root beats feed the ROOT's failure detector
        self._heartbeat = None
        self._heartbeat_interval_s = float(
            getattr(args, "heartbeat_interval_s", 0.0) or 0.0
        )
        # -- WAL sub-ledger (crash recovery evidence) ------------------
        # one RoundWAL per edge under the federation's checkpoint dir:
        # {round_idx, cohort, folded, kind="edge_fold"} appended
        # WRITE-AHEAD of the upstream ship, so the root's per-round
        # merge records and the edge sub-ledgers cross-check
        self._wal = None
        self.completed_through = -1
        ckpt_dir = getattr(args, "checkpoint_dir", None)
        if ckpt_dir:
            import os

            from ...core.checkpoint import RoundWAL

            self._wal = RoundWAL(
                os.path.join(ckpt_dir, f"edge_{self.edge_rank}")
            )
            last = self._wal.last()
            if last is not None:
                self.completed_through = int(last["round_idx"])
                logging.info(
                    "edge %d resumed: WAL sub-ledger shows rounds through "
                    "%d folded+shipped (an in-flight round re-runs; the "
                    "root dedups per (edge, round))",
                    self.edge_rank, self.completed_through,
                )

    # -- lifecycle -----------------------------------------------------
    def run(self) -> None:
        self.register_message_receive_handlers()
        self._uplink_thread = threading.Thread(
            target=self.uplink.handle_receive_message,
            daemon=True,
            name=f"edge{self.edge_rank}-uplink",
        )
        self._uplink_thread.start()
        self._announce_online()
        self.com_manager.handle_receive_message()
        logging.info("edge %d manager loop exited", self.edge_rank)

    def _announce_online(self) -> None:
        msg = Message(constants.MSG_TYPE_C2S_CLIENT_STATUS, self.edge_rank, 0)
        msg.add_params(
            constants.MSG_ARG_KEY_CLIENT_STATUS, constants.CLIENT_STATUS_ONLINE
        )
        self.uplink.send_message(msg)
        if self._heartbeat_interval_s > 0 and self._heartbeat is None:
            from ...core.comm.heartbeat import HeartbeatEmitter

            self._heartbeat = HeartbeatEmitter(
                self._send_uplink_heartbeat, self._heartbeat_interval_s
            ).start()

    def _send_uplink_heartbeat(self) -> None:
        self.uplink.send_message(
            Message(constants.MSG_TYPE_C2S_HEARTBEAT, self.edge_rank, 0)
        )

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        if self._heartbeat is not None:
            self._heartbeat.stop()
            self._heartbeat = None
        if self._failure_detector is not None:
            self._failure_detector.stop()
        self.telemetry.export_run_artifacts(getattr(self.args, "telemetry_dir", None))
        self.uplink.stop_receive_message()
        super().finish()

    # -- handler registry ---------------------------------------------
    def register_message_receive_handlers(self) -> None:
        # root -> edge (arrive via the uplink observer)
        for t in (
            constants.MSG_TYPE_S2C_INIT_CONFIG,
            constants.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
            constants.MSG_TYPE_S2C_RESYNC,
        ):
            self.register_message_receive_handler(t, self.handle_message_round)
        self.register_message_receive_handler(
            constants.MSG_TYPE_S2C_FINISH, self.handle_message_finish
        )
        # client -> edge (downlink)
        self.register_message_receive_handler(
            constants.MSG_TYPE_C2S_CLIENT_STATUS,
            self.handle_message_client_status,
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
            self.handle_message_upload,
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_C2S_HEARTBEAT, self.handle_message_heartbeat
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_S2S_CLIENT_DEAD, self.handle_message_client_dead
        )

    def receive_message(self, msg_type: int, msg_params: Message) -> None:
        # any downlink traffic proves its client alive (uplink messages
        # come from the root — rank 0 — and are not detector-watched)
        if self._failure_detector is not None:
            sender = int(msg_params.get_sender_id())
            if sender in self.client_ranks:
                self._failure_detector.note_alive(sender)
        super().receive_message(msg_type, msg_params)

    # -- root -> edge: round lifecycle --------------------------------
    def handle_message_round(self, msg: Message) -> None:
        """A round broadcast (init/sync/resync) from the root: hold it
        until every expected client is online (the flat server's
        presence handshake, per edge), then fan out."""
        self._pending_round = msg
        self._maybe_start_round()

    def _pending_assignment(self) -> Dict[int, int]:
        raw = self._pending_round.get(constants.MSG_ARG_KEY_HIER_ASSIGNMENT) or {}
        return {int(k): int(v) for k, v in raw.items()}

    def _maybe_start_round(self) -> None:
        if self._pending_round is None:
            return
        assignment = self._pending_assignment()
        waiting = [
            r
            for r in assignment
            if r not in self._dead_clients
            and not self.client_online.get(r, False)
        ]
        if waiting:
            logging.info(
                "edge %d: holding round %s until rank(s) %s are online",
                self.edge_rank,
                self._pending_round.get(constants.MSG_ARG_KEY_ROUND_INDEX),
                waiting,
            )
            return
        msg, self._pending_round = self._pending_round, None
        self._start_round(msg, assignment)

    def _start_round(self, msg: Message, assignment: Dict[int, int]) -> None:
        if self._round_open:
            # the root advanced without this edge's report (quorum
            # close over the other edges, or a RESYNC re-running the
            # round): the abandoned window's partial folds must never
            # mix into the new round's accumulator
            logging.warning(
                "edge %d: abandoning open round %d (%d partial fold(s)) "
                "for the root's round %s",
                self.edge_rank, self.round_idx,
                self.aggregator.num_received(),
                msg.get(constants.MSG_ARG_KEY_ROUND_INDEX),
            )
            self.telemetry.inc("hier_edge_rounds_abandoned_total")
            self.aggregator.reset_window()
        self.round_idx = int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX, 0))
        self._round_msg = msg
        self._assignment = assignment
        self._quarantined = {
            int(r) for r in (msg.get(constants.MSG_ARG_KEY_QUARANTINED) or [])
        }
        params = msg.get(constants.MSG_ARG_KEY_MODEL_PARAMS)
        # the broadcast global is BOTH the fold template and the clip
        # reference — same object the flat server would use
        self.aggregator.set_global_model_params(params)
        expected = [
            r for r in sorted(assignment) if r not in self._dead_clients
        ]
        self.aggregator.begin_round([r - 1 for r in expected])
        self._round_open = True
        if self.round_idx <= self.completed_through:
            logging.warning(
                "edge %d: re-running round %d (sub-ledger says it was "
                "already folded+shipped — the ship may not have landed; "
                "the root drops a duplicate merge)",
                self.edge_rank, self.round_idx,
            )
        for rank in expected:
            out = Message(msg.get_type(), 0, rank)
            continue_context(msg, out)
            out.add_params(constants.MSG_ARG_KEY_MODEL_PARAMS, params)
            out.add_params(
                constants.MSG_ARG_KEY_CLIENT_INDEX, assignment[rank]
            )
            out.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, self.round_idx)
            self.send_message(out)
        if not expected:
            # the root still expects a report from an edge whose whole
            # partition is dead/quarantined — ship an empty one
            self._close_round()

    def handle_message_finish(self, msg: Message) -> None:
        logging.info("edge %d: finish", self.edge_rank)
        for rank in self.client_ranks:
            self.send_message(Message(constants.MSG_TYPE_S2C_FINISH, 0, rank))
        self.finish()

    # -- client -> edge: presence + liveness --------------------------
    def handle_message_client_status(self, msg: Message) -> None:
        status = msg.get(constants.MSG_ARG_KEY_CLIENT_STATUS)
        sender = int(msg.get_sender_id())
        if status == constants.CLIENT_STATUS_ONLINE:
            was_online = self.client_online.get(sender, False)
            self.client_online[sender] = True
            self._dead_clients.discard(sender)
            if self._failure_detector is not None:
                self._failure_detector.watch(sender)
            if not was_online:
                self._report_event(constants.HIER_EVENT_ONLINE, sender)
            if self._pending_round is not None:
                # a HELD round outranks the open one: the root has
                # already advanced, and this ONLINE may be exactly what
                # the hold was waiting for (_start_round abandons the
                # stale window)
                self._maybe_start_round()
                return
            if self._round_open:
                self._maybe_resync(sender)
                return
            self._maybe_start_round()
        elif status == constants.CLIENT_STATUS_OFFLINE:
            if not self.client_online.get(sender, False):
                return
            self.client_online[sender] = False
            # a leaver must not be awaited by this OR any HELD/future
            # round (same exclusion as a detector death; an ONLINE
            # re-admits) — without this a round assigned before the
            # root learned of the leave would hold forever
            self._dead_clients.add(sender)
            if self._failure_detector is not None:
                self._failure_detector.unwatch(sender)
            self.telemetry.inc("cross_silo_client_leaves_total")
            self._report_event(constants.HIER_EVENT_LEAVE, sender)
            self._drop_pending_slot(sender)

    def handle_message_heartbeat(self, msg: Message) -> None:
        sender = int(msg.get_sender_id())
        if not self.client_online.get(sender, False):
            synth = Message(constants.MSG_TYPE_C2S_CLIENT_STATUS, sender, 0)
            synth.add_params(
                constants.MSG_ARG_KEY_CLIENT_STATUS,
                constants.CLIENT_STATUS_ONLINE,
            )
            logging.info(
                "edge %d: heartbeat from offline rank %d — treating as "
                "(re)connect", self.edge_rank, sender,
            )
            self.handle_message_client_status(synth)

    def _post_client_dead(self, rank: int) -> None:
        """Detector thread -> own inbox (the flat server's loopback
        pattern): membership mutation stays on the dispatch thread."""
        msg = Message(constants.MSG_TYPE_S2S_CLIENT_DEAD, 0, 0)
        msg.add_params(constants.MSG_ARG_KEY_RANK, int(rank))
        try:
            self.send_message(msg)
        except Exception:  # noqa: BLE001 — transport tearing down
            logging.warning(
                "edge %d: death notice for rank %d could not be posted",
                self.edge_rank, rank, exc_info=True,
            )
            if self._failure_detector is not None:
                self._failure_detector.watch(rank)

    def handle_message_client_dead(self, msg: Message) -> None:
        rank = int(msg.get(constants.MSG_ARG_KEY_RANK, -1))
        if (
            self._failure_detector is not None
            and self._failure_detector.seen_recently(rank)
        ):
            self._failure_detector.watch(rank)
            return
        if not self.client_online.get(rank, False):
            return
        self.client_online[rank] = False
        self._dead_clients.add(rank)
        self.telemetry.inc("cross_silo_clients_declared_dead_total")
        logging.warning(
            "edge %d: rank %d declared DEAD at round %d; dropping its "
            "slot and reporting upstream (the root decides membership)",
            self.edge_rank, rank, self.round_idx,
        )
        self._report_event(constants.HIER_EVENT_DEAD, rank)
        self._drop_pending_slot(rank)

    def _drop_pending_slot(self, rank: int) -> None:
        if not self._round_open:
            self._maybe_start_round()  # a held round may now be startable
            return
        if self.aggregator.drop_expected(rank - 1):
            if self.aggregator.check_whether_all_receive():
                self._close_round()

    def _maybe_resync(self, rank: int) -> None:
        """A client (re)appeared mid-round: ship it the current round +
        params + its pending silo (the flat server's RESYNC, one hop
        down)."""
        silo = self._assignment.get(rank)
        if silo is None or rank in self._quarantined:
            return
        if self.aggregator.flag_client_model_uploaded_dict.get(
            rank - 1, False
        ):
            return
        logging.info(
            "edge %d: RESYNC rank %d into round %d (silo %d)",
            self.edge_rank, rank, self.round_idx, silo,
        )
        self.telemetry.inc("cross_silo_resyncs_total")
        out = Message(constants.MSG_TYPE_S2C_RESYNC, 0, rank)
        if self._round_msg is not None:
            continue_context(self._round_msg, out)
        out.add_params(
            constants.MSG_ARG_KEY_MODEL_PARAMS,
            self.aggregator.get_global_model_params(),
        )
        out.add_params(constants.MSG_ARG_KEY_CLIENT_INDEX, silo)
        out.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, self.round_idx)
        self.send_message(out)

    # -- client -> edge: uploads (fold on arrival) --------------------
    def handle_message_upload(self, msg: Message) -> None:
        sender = int(msg.get_sender_id())
        upload_round = int(
            msg.get(constants.MSG_ARG_KEY_ROUND_INDEX, self.round_idx)
        )
        if not self._round_open or upload_round != self.round_idx:
            self.telemetry.inc("agg_late_uploads_total")
            logging.warning(
                "edge %d: discarding stale upload from rank %d (round %d, "
                "now %d)", self.edge_rank, sender, upload_round, self.round_idx,
            )
            return
        if sender in self._quarantined:
            # root-decided quarantine, enforced here: rejected BEFORE
            # the fold, and the slot drops so the round cannot stall
            self.telemetry.inc("defense_quarantined_rejected_total")
            logging.warning(
                "edge %d: rejecting upload from quarantined rank %d",
                self.edge_rank, sender,
            )
            self._drop_pending_slot(sender)
            return
        # named chaos barrier: the per-upload ingestion boundary — a
        # scheduled kill here models an edge dying mid-fold
        self._chaos_barrier(
            "edge.fold", round=self.round_idx, rank=self.edge_rank
        )
        model_params = msg.get(constants.MSG_ARG_KEY_MODEL_PARAMS)
        encoded = msg.get(constants.MSG_ARG_KEY_MODEL_DELTA)
        if model_params is None and encoded is None:
            logging.error(
                "edge %d: upload from rank %d carries neither model_params "
                "nor model_delta; dropping", self.edge_rank, sender,
            )
            return
        n = msg.get(constants.MSG_ARG_KEY_NUM_SAMPLES)
        status = self.aggregator.receive_upload(
            sender - 1, n, model_params=model_params, encoded=encoded
        )
        if status == "quarantined":
            # the LOCAL screen tripped: evidence goes up (the root
            # decides whether the whole federation excludes the rank);
            # this edge already rejected the upload and drops the slot
            self._report_event(
                constants.HIER_EVENT_QUARANTINE, sender,
                score=self.aggregator.screen.reputation(sender - 1),
            )
            self._drop_pending_slot(sender)
            return
        if status == "folded":
            self.uploads_folded += 1
            self.telemetry.inc(
                "hier_uploads_folded_total", edge=self.edge_rank
            )
        if self.aggregator.check_whether_all_receive():
            self._close_round()

    def _chaos_barrier(self, name: str, **ctx) -> None:
        """A scheduled kill at an edge barrier is the kill -9 analog
        for a thread-world edge: every liveness corpse (heartbeat
        emitter, failure detector, uplink receive loop) dies with the
        "process" — a beating corpse would defeat the root's failure
        detector, and a zombie uplink loop would shadow a restarted
        edge on the same fabric inbox."""
        from ...core.chaos import ProcessKilled

        try:
            chaos_barrier(name, **ctx)
        except ProcessKilled:
            if self._heartbeat is not None:
                self._heartbeat.stop()
                self._heartbeat = None
            if self._failure_detector is not None:
                self._failure_detector.stop()
            self.uplink.stop_receive_message()
            raise

    def _report_event(self, kind: str, rank: int, **extra) -> None:
        """Evidence upstream: the root decides, edges enforce."""
        out = Message(constants.MSG_TYPE_E2R_CLIENT_EVENT, self.edge_rank, 0)
        out.add_params(constants.MSG_ARG_KEY_EVENT_KIND, kind)
        out.add_params(constants.MSG_ARG_KEY_RANK, int(rank))
        for k, v in extra.items():
            out.add_params(k, v)
        self.uplink.send_message(out)

    # -- round close: ship ONE merged limb-set upstream ---------------
    def _close_round(self) -> None:
        # named chaos barrier: a scheduled kill here models an edge
        # dying between its last fold and its upstream ship — the WAL
        # sub-ledger record may or may not exist, the merge never
        # half-applies (the root takes whole reports only)
        self._chaos_barrier(
            "edge.merge_upload", round=self.round_idx, rank=self.edge_rank
        )
        folded_ranks = [i + 1 for i in self.aggregator.folded_indexes()]
        cohort_ranks = sorted(self._assignment)
        with self.profiler.span(
            "edge_merge", round=self.round_idx, rank=self.edge_rank
        ):
            state = self.aggregator.export_fold_state()
        if self._wal is not None:
            try:
                # WRITE-AHEAD of the ship: the sub-ledger must cover
                # every merge the root might hold (multi-tier
                # exactly-once evidence)
                self._wal.append(
                    self.round_idx,
                    None,
                    cohort_ranks,
                    folded=folded_ranks,
                    kind="edge_fold",
                    extra={"edge": self.edge_rank},
                )
            except OSError:
                logging.exception(
                    "edge %d: WAL sub-ledger append failed for round %d",
                    self.edge_rank, self.round_idx,
                )
                self.telemetry.inc("wal_append_failures_total")
        out = Message(constants.MSG_TYPE_E2R_EDGE_REPORT, self.edge_rank, 0)
        if self._round_msg is not None:
            continue_context(self._round_msg, out)
        out.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, self.round_idx)
        out.add_params(constants.MSG_ARG_KEY_EDGE_STATE, state)
        out.add_params(constants.MSG_ARG_KEY_FOLDED, folded_ranks)
        out.add_params(constants.MSG_ARG_KEY_COHORT, cohort_ranks)
        self.uplink.send_message(out)
        self.reports_shipped += 1
        self.completed_through = max(self.completed_through, self.round_idx)
        self.telemetry.inc("hier_edge_reports_total", edge=self.edge_rank)
        logging.info(
            "edge %d: round %d closed — %d/%d fold(s) shipped upstream "
            "as one limb-set",
            self.edge_rank, self.round_idx, len(folded_ranks),
            len(cohort_ranks),
        )
        self.aggregator.reset_window()
        self._round_open = False
        # a round held while this one was open (root quorum-advanced)
        # can start the moment the window closes
        self._maybe_start_round()


class _UplinkObserver:
    """Re-posts root->edge traffic into the edge's OWN downlink inbox
    (the managers' loopback idiom): every piece of edge state then
    mutates on the single downlink dispatch thread — the same
    single-thread invariant the flat managers keep — instead of racing
    the uplink receive thread against client uploads. The uplink
    channel already consumed its ACK/dedup bookkeeping, so the hop's
    comm seq/chan params are stripped before the re-post."""

    def __init__(self, manager: EdgeServerManager) -> None:
        self.manager = manager

    def receive_message(self, msg_type: int, msg_params: Message) -> None:
        for key in (
            constants.MSG_ARG_KEY_COMM_SEQ,
            constants.MSG_ARG_KEY_COMM_CHAN,
        ):
            msg_params.msg_params.pop(key, None)
        # self-addressed on the downlink fabric: receiver becomes this
        # edge's rank-0 inbox (the wrappers treat loopback as untracked)
        msg_params.msg_params[constants.MSG_ARG_KEY_SENDER] = 0
        msg_params.msg_params[constants.MSG_ARG_KEY_RECEIVER] = 0
        self.manager.com_manager.send_message(msg_params)
