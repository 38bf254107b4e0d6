"""Cross-silo server manager: presence handshake + round loop +
deadline cohort (straggler handling). Port of
``fedml_tpu/cross_silo/horizontal/fedml_server_manager.py``.

Parity with ``python/fedml/cross_silo/horizontal/fedml_server_manager.py:11-235``:

- clients announce ONLINE (``MSG_TYPE_C2S_CLIENT_STATUS``); the server
  waits for ALL before ``send_init_msg`` (:95-119) — the handshake the
  simulation scenario doesn't need;
- round loop: on every client model received -> aggregate -> silo/client
  selection -> sync (:121-207);
- client-id indirection: messages go to ranks 1..N, training assignments
  are silo indices (``data_silo_selection``).

The terminal round sends ``MSG_TYPE_S2C_FINISH`` so clients exit their
receive loops cleanly (the reference relies on ``finish()`` +
sys.exit, fedml_server_manager.py:209-213).

**Beyond the reference — deadline cohort**: the reference's server
waits for EVERY selected client, so one straggler stalls the whole
federation. With ``args.aggregation_deadline_s`` set, the server arms a
timer per round; when it fires it aggregates whoever reported by then
(weights renormalize over the subset) and moves on. Late uploads carry
their round tag and are discarded with a log line. The timer thread
never touches state directly — it posts a message to the server's own
inbox, so all mutation stays on the single dispatch thread.

**Beyond the reference — elastic membership**: with
``args.elastic_membership`` the federation starts as soon as
``client_num_per_round`` clients are ONLINE, accepts late joins (a new
rank's ONLINE registers it; it trains from the next round), and
handles OFFLINE leaves mid-round (the leaver's slot is dropped from
the round's expected set so the federation never stalls on it). The
reference blocks round 0 until every configured client appears and has
no membership changes after that (fedml_server_manager.py:95-119).

**Beyond the reference — failure detection**: a client killed WITHOUT
sending OFFLINE (kill -9) stalls any non-deadline world forever. With
``args.heartbeat_timeout_s`` the server runs a ``FailureDetector``
(core/comm/heartbeat.py): any traffic from a rank counts as liveness
(clients additionally beat every ``heartbeat_interval_s``), and a rank
silent past the timeout is declared dead via a self-addressed
``MSG_TYPE_S2S_CLIENT_DEAD`` message — all membership mutation stays
on the dispatch thread — which folds into the same drop-expected path
as an OFFLINE leave, so the round completes over the survivors.

**Beyond the reference — streaming aggregate-on-arrival**: with
``agg_mode: stream`` (default) every upload is folded into the
aggregator's O(model) running accumulator the moment it lands
(``core/aggregation.py``; quantized uplinks decode and weight in one
launch of the robust term kernel before the fold), so the post-barrier
"aggregate" is a finalize and
server memory stops scaling with the cohort. On top of the fold,
``round_quorum_frac`` + ``round_grace_s`` give a **quorum close**:
once the quorum has folded, a grace timer arms (loopback message
pattern, like the deadline); when it fires the round closes over the
partial cohort with weights renormalized, and ranks the
``FailureDetector`` declares dead leave the quorum denominator — a
kill -9'd client shrinks the round instead of stalling the grace.
Late uploads are discarded by round tag and counted
(``agg_late_uploads_total``).

**Beyond the reference — async staleness-weighted aggregation**
(``agg_mode: async``, FedBuff-style): no round barrier exists at all.
Each downlink carries a dispatch seq (in ``ROUND_INDEX``) and the
publish ``MODEL_VERSION`` it shipped; clients upload update DELTAS
which fold immediately with weight ``n * staleness_decay^staleness``
(hard cap ``staleness_max``), and every ``async_publish_every`` folds
the server publishes ``global += weighted-mean delta`` — through the
checkpoint dir when one is set, so the serving plane's
``CheckpointWatcher`` can hot-swap each publish. The WAL records the folded ``(rank, seq)`` set per
publish; a restarted server seeds its dedup ledger from it, so a
retransmitted pre-crash upload can neither double-fold nor be
silently half-applied.

**Beyond the reference — Byzantine defense on every path**
: ``norm_diff_clipping`` / ``weak_dp`` ride the streaming fold itself
(the clip in each upload's term, the noise at finalize: the
aggregator's job), and this manager wires the
quarantine half: an upload the anomaly screen rejects drops its
rank's slot through the SAME drop-expected path a failure-detector
death uses (the quorum denominator shrinks — a quarantined rank never
stalls ``round_grace_s``), quarantined ranks are excluded from
subsequent broadcasts/dispatches until their probation expires (ticked
per round close in sync modes, per publish in async, where released
ranks are re-dispatched immediately), and an async federation whose
every online rank is quarantined finishes loudly instead of waiting
for a fold that can never arrive.

**Beyond the reference — crash recovery**: with ``checkpoint_dir`` the
server keeps a ``RoundWAL`` (round idx + checkpoint step + sampled
cohort + folded set per completed round) next to its
``torch.save`` checkpoint steps (``core/checkpoint.py``). A restarted
server restores the newest checkpoint, cross-checks the WAL (loudly
reporting rounds lost to ``checkpoint_freq > 1``), and releases
reconnecting clients with ``MSG_TYPE_S2C_RESYNC`` — current round +
params — instead of a stale round-0 init. Client heartbeats double as
the reconnect probe: a beat or ONLINE from a rank the server doesn't
know (it just restarted) re-registers that rank, and a rank that
reappears mid-round is resynced into its still-pending assignment.
"""

from __future__ import annotations

import logging
from typing import Dict

from ... import constants
from ...core.chaos import chaos_barrier
from ...core.managers import ServerManager
from ...core.message import Message

# Async dispatch-seq epoch: each server incarnation issues seqs from
# its own epoch band, so a seq handed out after the last durable
# publish (and therefore unknown to the restored high-water mark) can
# never be reissued by the next incarnation — the (rank, seq) fold
# ledger stays collision-free without persisting every dispatch.
_SEQ_EPOCH = 1 << 32


def _resolve_client_real_ids(args, size: int):
    """Client-id indirection (fedml_server_manager.py:33): edge devices
    carry real ids from ``args.client_id_list`` (JSON string or list);
    without one, ids default to the transport ranks 1..size-1."""
    raw = getattr(args, "client_id_list", None)
    if raw:
        if isinstance(raw, str):
            import json

            raw = json.loads(raw)
        ids = [int(i) for i in raw]
        if size and len(ids) != size - 1:
            raise ValueError(
                f"client_id_list has {len(ids)} entries but comm world has "
                f"{size - 1} clients"
            )
        return ids
    return list(range(1, size))


def attribute_idle(*, now: float, bcast_t0: float, last_arrival: float,
                   aggregate_s: float, prev_close=None) -> Dict[str, float]:
    """The round's idle gaps (the JAX package's ``analysis/perf.py``
    ``attribute_idle``): ``arrival_to_aggregate`` is intra-round (last
    upload in hand -> aggregate start); ``close_to_broadcast`` the
    server's idle between rounds (previous close -> this broadcast)."""
    agg_start = now - max(aggregate_s, 0.0)
    idle = {"arrival_to_aggregate": max(agg_start - last_arrival, 0.0)}
    if prev_close is not None:
        idle["close_to_broadcast"] = max(bcast_t0 - prev_close, 0.0)
    return idle


class FedMLServerManager(ServerManager):
    def __init__(
        self,
        args,
        aggregator,
        comm=None,
        rank=0,
        size=0,
        backend=constants.COMM_BACKEND_LOCAL,
    ) -> None:
        super().__init__(args, comm, rank, size, backend)
        self.aggregator = aggregator
        self.round_num = int(args.comm_round)
        self.round_idx = 0
        self.client_online_status: Dict[int, bool] = {}
        # Identity vs address: ``client_real_ids`` are edge-device
        # IDENTITIES (selection, reporting); transport ADDRESSES are
        # ranks 1..size-1. Position p in the list <-> rank p+1 (the
        # reference's rank<->real-id convention, fedml_server_manager.py:33).
        self.client_real_ids = _resolve_client_real_ids(args, size)
        self._rank_of_real_id = {
            rid: pos + 1 for pos, rid in enumerate(self.client_real_ids)
        }
        self.is_initialized = False
        from ...core.tracking import MetricsReporter, ProfilerEvent

        # reference instrumentation points (fedml_server_manager.py:
        # 71-74, :123-150: server.wait / aggregate spans + round info)
        self.profiler = ProfilerEvent(args)
        self.metrics_reporter = MetricsReporter(args)
        # flight recorder (core/telemetry.py): spans on the shared
        # timeline (self.telemetry comes from _ManagerBase)
        self.telemetry.attach_profiler(self.profiler)
        # on-demand per-round device profiling (core/tracing.py)
        from ...core.tracing import RoundProfiler

        self._round_profiler = RoundProfiler(args, device=aggregator.device)
        # live critical-path attribution (docs/observability.md): per
        # round the server observes broadcast/wait/aggregate segments,
        # straggler slack (who held the round and by how much), and SLO
        # violations against round_deadline_s — the offline analyzer
        # (cli trace) computes the precise cross-process version
        self.round_deadline_s = float(
            getattr(args, "round_deadline_s", 0) or 0
        )
        self._bcast_t0 = None  # perf_counter at round broadcast start
        self._bcast_done_t = None
        # perf_counter at the previous round's ledger close: the
        # close->broadcast gap is the server's inter-round idle
        # (round_idle_seconds{gap=close_to_broadcast})
        self._last_round_close_t = None
        self._upload_arrivals: Dict[int, float] = {}
        self._upload_train_s: Dict[int, float] = {}
        self._round_span_open = False
        self._wait_open = False
        self.deadline_s = float(getattr(args, "aggregation_deadline_s", 0) or 0)
        self._deadline_timer = None
        self.stragglers_dropped = 0
        # streaming-aggregation round close (beyond the reference):
        # quorum + grace; timers post loopback messages, never mutate
        self.agg_mode = str(getattr(args, "agg_mode", "stream"))
        self.quorum_frac = float(getattr(args, "round_quorum_frac", 0.0) or 0.0)
        self.round_grace_s = float(getattr(args, "round_grace_s", 0.0) or 0.0)
        self._quorum_timer = None
        self._quorum_armed_round = None
        self.quorum_closes = 0
        # async (FedBuff-style) state — see the class docstring
        self.staleness_decay = float(getattr(args, "staleness_decay", 0.5))
        self.staleness_max = int(getattr(args, "staleness_max", 10))
        self.async_publish_every = int(getattr(args, "async_publish_every", 4))
        self.version = 0  # publish counter (the model version clients see)
        self._dispatch_seq = 0  # monotone per-dispatch id, never reused
        # folded pairs whose WAL record could not be written (disk
        # error): carried into the next successful record so the
        # ledger never under-covers the checkpointed params
        self._unwaled_folds = []
        # rank -> (seq, base_version, silo_idx) of its in-flight dispatch
        self._outstanding: Dict[int, tuple] = {}
        self._folded_ids = set()  # (rank, seq) ever folded (WAL-seeded)
        self._folded_since_publish = []
        self.async_folds = 0  # folds across incarnations (target counter)
        # (rank, seq, staleness, sample_num, weight): what a test holds
        # against the staleness_weight oracle
        self.async_weight_log = []
        # zero-upload deadline handling: rebroadcast (the downlink may
        # have been lost) at most this many times per round, then shut
        # down instead of extending forever
        _max_ext = getattr(args, "aggregation_deadline_max_extensions", None)
        self.deadline_max_extensions = 3 if _max_ext is None else int(_max_ext)
        self._empty_deadline_fires = 0
        self._last_broadcast_type = None
        self.elastic = bool(getattr(args, "elastic_membership", False))
        if self.elastic and getattr(args, "client_id_list", None):
            raise ValueError(
                "elastic_membership assigns real ids dynamically (rank = "
                "id); it cannot be combined with a fixed client_id_list"
            )
        self.joins = 0
        self.leaves = 0
        # failure detector (core/comm/heartbeat.py): declared-dead
        # ranks are excluded from broadcasts until they reconnect
        self.deaths = 0
        self._dead_ranks = set()
        # rank -> silo index of the CURRENT round's broadcast; the
        # reconnect path resyncs a reappearing rank into its pending slot
        self._round_assignment: Dict[int, int] = {}
        self._failure_detector = None
        timeout_s = float(getattr(args, "heartbeat_timeout_s", 0.0) or 0.0)
        if timeout_s > 0:
            from ...core.comm.heartbeat import FailureDetector

            self._failure_detector = FailureDetector(
                timeout_s, self._post_client_dead
            ).start()
        from ...core.compression import make_codec

        # compressed-uplink decode (core/compression.py): clients ship
        # encoded deltas; reconstruct against the pre-round global tree
        self._codec = make_codec(args)
        # checkpoint/resume (core/checkpoint.py — beyond the reference,
        # which loses the whole federation when the server dies): save
        # {params, round} after aggregation; on construction, restore
        # the latest state so a restarted server resumes mid-federation.
        # Clients are stateless between rounds (they receive the model
        # with every broadcast), so server-side state is sufficient.
        self._ckpt = None
        self._wal = None
        self._resumed = False
        ckpt_dir = getattr(args, "checkpoint_dir", None)
        if ckpt_dir:
            from ...core.checkpoint import RoundCheckpointer, RoundWAL

            self._ckpt = RoundCheckpointer(ckpt_dir)
            self._wal = RoundWAL(ckpt_dir)
            # None = this scenario's historical cadence (every round)
            self._ckpt_freq = max(
                1, int(getattr(args, "checkpoint_freq", None) or 1)
            )
            state = self._ckpt.restore(
                target={"params": self.aggregator.get_global_model_params()}
            )
            if state is not None:
                self.round_idx = int(state["round_idx"])
                self.aggregator.set_global_model_params(state["params"])
                # the aggregation counter seeds the L3 server
                # aggregator's per-round rng stream — without it a
                # resumed custom aggregator would silently replay
                # round 0's randomness
                self.aggregator._agg_round = int(
                    state.get("agg_round", self.round_idx)
                )
                self._resumed = True
                logging.info(
                    "cross-silo server resumed at round %d from %s",
                    self.round_idx, ckpt_dir,
                )
                # init must not wait for ALL ranks to re-announce: a
                # client killed BEFORE the server crash never will — its
                # heartbeats died with it. Arm the failure detector over every
                # expected rank NOW: survivors' beats/ONLINEs refresh
                # the watch; a rank silent past heartbeat_timeout_s is
                # declared dead pre-init and leaves the awaited set
                # (_ready_to_init). Without a detector the resumed
                # server keeps the reference behavior (wait for all).
                if self._failure_detector is not None:
                    for r in range(1, len(self.client_real_ids) + 1):
                        self._failure_detector.watch(r)
                if self.agg_mode == "async":
                    # version/seq/fold counters ride the checkpoint;
                    # the WAL's publish records are the exactly-once
                    # fold ledger a restart must not forget (the
                    # sync-mode retrain cross-check below does not
                    # apply — async never retrains; lost publishes are
                    # reported by _seed_async_ledger_from_wal instead)
                    self.version = int(state.get("version", self.round_idx))
                    self._dispatch_seq = int(state.get("dispatch_seq", 0))
                    self.async_folds = int(state.get("async_folds", 0))
                    self._seed_async_ledger_from_wal()
                else:
                    # WAL cross-check: with checkpoint_freq > 1 the
                    # last COMPLETED round can be ahead of the newest
                    # restorable params — those rounds retrain after
                    # the restart; say so loudly instead of silently
                    # repeating work
                    last = self._wal.last()
                    if (
                        last is not None
                        and int(last["round_idx"]) + 1 > self.round_idx
                    ):
                        logging.warning(
                            "round WAL shows round %d completed but newest "
                            "checkpoint resumes at round %d — %d round(s) "
                            "will retrain (checkpoint_freq=%d)",
                            int(last["round_idx"]), self.round_idx,
                            int(last["round_idx"]) + 1 - self.round_idx,
                            self._ckpt_freq,
                        )

    # -- handlers ------------------------------------------------------
    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            constants.MSG_TYPE_C2S_CLIENT_STATUS,
            self.handle_message_client_status_update,
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
            self.handle_message_receive_model_from_client,
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_S2S_AGG_DEADLINE,
            self.handle_message_deadline,
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_S2S_QUORUM_GRACE,
            self.handle_message_quorum_grace,
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_C2S_HEARTBEAT,
            self.handle_message_heartbeat,
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_S2S_CLIENT_DEAD,
            self.handle_message_client_dead,
        )

    def receive_message(self, msg_type: int, msg_params: Message) -> None:
        # ANY inbound traffic proves the sender alive — uploads and
        # status changes carry liveness as well as heartbeats do
        if self._failure_detector is not None:
            sender = int(msg_params.get_sender_id())
            if sender != self.rank:
                self._failure_detector.note_alive(sender)
        super().receive_message(msg_type, msg_params)

    def _active_ranks(self):
        return [r for r, on in sorted(self.client_online_status.items()) if on]

    def handle_message_client_status_update(self, msg: Message) -> None:
        """(fedml_server_manager.py:95-119) + elastic join/leave."""
        status = msg.get(constants.MSG_ARG_KEY_CLIENT_STATUS)
        sender = int(msg.get_sender_id())
        if status == constants.CLIENT_STATUS_ONLINE:
            known = 1 <= sender <= len(self.client_real_ids)
            if not known:
                if not self.elastic:
                    logging.warning(
                        "ONLINE from unknown rank %d ignored (set "
                        "elastic_membership to accept joins)", sender,
                    )
                    return
                max_clients = int(getattr(self.args, "max_clients", 4096))
                if sender < 1 or sender > max_clients:
                    # one misconfigured hello must not bloat server
                    # state with ghost ranks
                    logging.error(
                        "ONLINE from rank %d rejected (max_clients=%d)",
                        sender, max_clients,
                    )
                    return
                # register ranks up to the newcomer (real id = rank)
                for r in range(len(self.client_real_ids) + 1, sender + 1):
                    self.client_real_ids.append(r)
                    self._rank_of_real_id[r] = r
            was_online = self.client_online_status.get(sender, False)
            self.client_online_status[sender] = True
            self._dead_ranks.discard(sender)
            if self._failure_detector is not None:
                self._failure_detector.watch(sender)
            if self.is_initialized:
                if self.elastic and not was_online:
                    self.joins += 1
                    logging.info(
                        "elastic join: rank %d online at round %d "
                        "(participates from the next broadcast)",
                        sender, self.round_idx,
                    )
                # resync regardless of was_online: a kill -9'd client's
                # replacement re-announces ONLINE while the server may
                # not yet have noticed the death — if its slot in the
                # current round is still pending, ship it the round
                # (re-training a slot whose upload later turns out to
                # have landed is idempotent by design)
                self._maybe_resync(sender)
                return
            self._maybe_init()
        elif status == constants.CLIENT_STATUS_OFFLINE:
            if not self.elastic:
                logging.warning("OFFLINE from rank %d ignored (non-elastic)", sender)
                return
            if not self.client_online_status.get(sender, False):
                return  # duplicated/stale OFFLINE: already gone, count once
            self.client_online_status[sender] = False
            if self._failure_detector is not None:
                self._failure_detector.unwatch(sender)
            self.leaves += 1
            # counted so the invariant checker can account a partial
            # round close to a voluntary leave from artifacts alone
            self.telemetry.inc("cross_silo_client_leaves_total")
            logging.info(
                "elastic leave: rank %d offline at round %d", sender, self.round_idx
            )
            if self.agg_mode == "async":
                self._async_client_gone(sender)
                return
            if self.is_initialized and self.aggregator.drop_expected(sender - 1):
                # the round was only waiting on the leaver
                if self.aggregator.check_whether_all_receive():
                    self._finish_round()
                else:
                    # the leaver also shrank the quorum denominator
                    self._maybe_arm_quorum()

    def _ready_to_init(self) -> bool:
        """The presence handshake's readiness predicate. Non-elastic:
        every expected rank must be online — EXCEPT ranks the failure
        detector has declared dead (a client killed before a server
        crash never re-announces; a resumed server must not await a
        corpse). An all-dead world is
        vacuously ready: init falls through to the loud
        no-online-clients finish instead of blocking forever."""
        if self.elastic:
            return len(self._active_ranks()) >= int(
                self.args.client_num_per_round
            )
        return all(
            self.client_online_status.get(rank, False)
            for rank in range(1, len(self.client_real_ids) + 1)
            if rank not in self._dead_ranks
        )

    def _maybe_init(self) -> None:
        if not self.is_initialized and self._ready_to_init():
            self.is_initialized = True
            self.send_init_msg()

    # -- liveness / failure detection (beyond the reference) ----------
    def handle_message_heartbeat(self, msg: Message) -> None:
        """A beat from an unknown-or-offline rank is an implicit ONLINE:
        after a server restart the clients' ONLINE messages are long
        gone, and their periodic beats are what re-announces presence
        (liveness itself was already noted in ``receive_message``)."""
        sender = int(msg.get_sender_id())
        if not self.client_online_status.get(sender, False):
            synth = Message(
                constants.MSG_TYPE_C2S_CLIENT_STATUS, sender, self.rank
            )
            synth.add_params(
                constants.MSG_ARG_KEY_CLIENT_STATUS,
                constants.CLIENT_STATUS_ONLINE,
            )
            logging.info(
                "heartbeat from rank %d not currently online: treating "
                "as (re)connect", sender,
            )
            self.handle_message_client_status_update(synth)

    def _post_loopback(self, msg: Message, what: str, stale=None) -> bool:
        """Post a self-addressed control message with bounded retry —
        shared by every timer/detector thread that must reach the
        dispatch thread (a silently lost control signal re-creates the
        stall these features exist to prevent). ``stale()`` aborts the
        retry when the signal is no longer needed. True = delivered
        (or stale); False = the caller must arrange a re-fire."""
        import time as _time

        for attempt in range(3):
            try:
                self.send_message(msg)
                return True
            except Exception:  # noqa: BLE001 — transport may be flaky/tearing down
                if stale is not None and stale():
                    return True
                logging.warning(
                    "%s send failed (attempt %d/3)",
                    what, attempt + 1, exc_info=True,
                )
                _time.sleep(1.0)
        return False

    def _post_client_dead(self, rank: int) -> None:
        """FailureDetector ``on_dead`` callback (detector thread): post
        to our own inbox so membership mutation stays on the dispatch
        thread — the deadline-timer pattern, including its retry: the
        declaration is one-shot (the detector unwatches before firing).
        If the send ultimately fails, re-watch the rank so the detector
        re-fires after another timeout instead of never."""
        msg = Message(constants.MSG_TYPE_S2S_CLIENT_DEAD, self.rank, self.rank)
        msg.add_params(constants.MSG_ARG_KEY_RANK, int(rank))
        if not self._post_loopback(msg, f"death notice for rank {rank}"):
            logging.error(
                "failure detector: could not post death of rank %d; "
                "re-arming the watch so it is re-declared", rank,
            )
            if self._failure_detector is not None:
                self._failure_detector.watch(rank)

    def handle_message_client_dead(self, msg: Message) -> None:
        rank = int(msg.get(constants.MSG_ARG_KEY_RANK, -1))
        if (
            self._failure_detector is not None
            and self._failure_detector.seen_recently(rank)
        ):
            # raced: a message from this rank was queued behind the
            # death notice — it is alive after all
            self._failure_detector.watch(rank)
            return
        if not self.client_online_status.get(rank, False):
            if self.is_initialized or rank in self._dead_ranks:
                return  # already offline/dead; stale declaration
            # pre-init death on a RESUMED server (__init__ armed the
            # detector over every expected rank): this rank was killed
            # before the crash and will never re-announce — stop
            # awaiting it, and re-check whether the survivors complete
            # the handshake (the async-restart race)
            self._dead_ranks.add(rank)
            self.deaths += 1
            self.telemetry.inc("cross_silo_clients_declared_dead_total")
            logging.warning(
                "rank %d declared DEAD before init (no reconnect since "
                "the server restart); init proceeds without it", rank,
            )
            self._maybe_init()
            return
        self.client_online_status[rank] = False
        self._dead_ranks.add(rank)
        self.deaths += 1
        self.telemetry.inc("cross_silo_clients_declared_dead_total")
        logging.warning(
            "rank %d declared DEAD at round %d (no traffic for %.1fs); "
            "dropping from the current round and future broadcasts "
            "until it reconnects",
            rank, self.round_idx,
            self._failure_detector.timeout_s if self._failure_detector else 0.0,
        )
        if self.agg_mode == "async":
            self._async_client_gone(rank)
            return
        # same unstall path as an elastic OFFLINE leave — works with or
        # without elastic membership (a crash is not a voluntary leave)
        if self.is_initialized and self.aggregator.drop_expected(rank - 1):
            if self.aggregator.check_whether_all_receive():
                self._finish_round()
            else:
                # quorum accounting consults the failure detector: a
                # dead rank leaves the denominator, so a quorum that
                # was one corpse short arms its grace timer now
                self._maybe_arm_quorum()
        elif not self.is_initialized:
            # an announced-then-killed rank must not stall the
            # handshake either: the survivors may now complete it
            self._maybe_init()

    def _async_client_gone(self, rank: int) -> None:
        """A dead/left rank in async mode: retire its in-flight
        dispatch (a reconnect gets fresh work via RESYNC), and if
        NOBODY is left to fold from, shut down loudly — async's only
        finish path is an upload, so an empty federation would
        otherwise hang forever (the sync path's empty-broadcast
        shutdown has no async equivalent)."""
        self._outstanding.pop(rank, None)
        if self.is_initialized and not self._active_ranks():
            logging.error(
                "async: no online clients remain (%d/%d folds done); "
                "finishing", self.async_folds, self._async_target_folds(),
            )
            # accepted-but-unpublished folds must reach the model and
            # the WAL ledger before the shutdown (the fold-target
            # finish path flushes the same way)
            self._async_publish()
            self.send_finish()
            self.finish()
            return
        # the death may have left only QUARANTINED ranks online — no
        # fold (and therefore no publish, no probation tick) can ever
        # arrive, so the stall check must run here too
        self._async_check_quarantine_stall()

    def _async_check_quarantine_stall(self) -> None:
        """Async liveness under quarantine: folds are the only progress
        signal, and probation ticks ride publishes (which ride folds).
        If every online rank is quarantined and nothing is outstanding,
        no fold can ever arrive — finish loudly instead of hanging (the
        sync path has no analog: its rounds close via drop_expected)."""
        online = set(self._active_ranks())
        quarantined = self.aggregator.quarantined_ranks()
        if (
            self.is_initialized
            and online
            and not (online - quarantined)
            and not self._outstanding
        ):
            logging.error(
                "async: every online client is quarantined (%s) with no "
                "work outstanding (%d/%d folds done); finishing",
                sorted(quarantined), self.async_folds,
                self._async_target_folds(),
            )
            # flush accepted-but-unpublished folds, then record the
            # terminal eval like the fold-target done path does. The
            # publish's probation tick may hand a just-released rank
            # one dispatch the FINISH right behind it abandons — a
            # wasted local round, never wrong state.
            self._async_publish()
            self.aggregator.test_on_server_for_all_clients(self.version)
            self.send_finish()
            self.finish()

    def _maybe_resync(self, rank: int) -> None:
        """Ship the CURRENT round + params + pending assignment to a
        rank that (re)appeared mid-round — a restarted client resumes
        the round instead of stalling it until detector/deadline."""
        if self.agg_mode == "async":
            if self.aggregator.screen.is_quarantined(rank - 1):
                # no fresh work for a quarantined rank; if it is now
                # the ONLY rank left, the federation must finish loudly
                # rather than wait for a fold that cannot come
                self._async_check_quarantine_stall()
                return
            # async reconnect: hand the rank fresh work at the current
            # version (a fresh seq supersedes any pre-crash dispatch,
            # so its in-flight upload — if any — discards cleanly)
            logging.info("RESYNC (async): dispatching rank %d fresh work", rank)
            self.telemetry.inc("cross_silo_resyncs_total")
            self._async_dispatch(rank, constants.MSG_TYPE_S2C_RESYNC)
            return
        silo_idx = self._round_assignment.get(rank)
        if silo_idx is None:
            return  # not part of the current round; next broadcast picks it up
        if self.aggregator.flag_client_model_uploaded_dict.get(rank - 1, False):
            return  # its upload already landed; nothing to redo
        logging.info(
            "RESYNC: rank %d rejoins round %d (silo %d)",
            rank, self.round_idx, silo_idx,
        )
        self.telemetry.inc("cross_silo_resyncs_total")
        msg = Message(constants.MSG_TYPE_S2C_RESYNC, self.rank, rank)
        msg.add_params(
            constants.MSG_ARG_KEY_MODEL_PARAMS,
            self.aggregator.get_global_model_params(),
        )
        msg.add_params(constants.MSG_ARG_KEY_CLIENT_INDEX, silo_idx)
        msg.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, self.round_idx)
        self.send_message(msg)

    def send_init_msg(self) -> None:
        """(fedml_server_manager.py:47-69)"""
        if self.agg_mode == "async":
            if self.async_folds >= self._async_target_folds():
                # resumed past the fold target: release clients cleanly
                logging.info(
                    "async resume: %d folds already done (target %d); "
                    "finishing", self.async_folds, self._async_target_folds(),
                )
                self.aggregator.test_on_server_for_all_clients(self.version)
                self.send_finish()
                self.finish()
                return
            self._async_begin(
                constants.MSG_TYPE_S2C_RESYNC
                if self._resumed
                else constants.MSG_TYPE_S2C_INIT_CONFIG
            )
            return
        if self.round_idx >= self.round_num:
            # resumed from a checkpoint taken at/after the final round:
            # nothing left to train, release the freshly-connected
            # clients instead of broadcasting a round past the end. The
            # pre-crash process may have died between its final save
            # and its final eval, so produce the terminal eval here.
            logging.info(
                "resumed at round %d >= comm_round %d; finishing",
                self.round_idx, self.round_num,
            )
            self.aggregator.test_on_server_for_all_clients(self.round_num - 1)
            self.send_finish()
            self.finish()
            return
        if self._resumed:
            # crash recovery: reconnecting clients get the CURRENT
            # round + params as a RESYNC — same payload as an init, but
            # the type says "mid-federation", not "round 0"
            logging.info(
                "resumed server releasing clients with RESYNC at round %d",
                self.round_idx,
            )
            self._broadcast_model(constants.MSG_TYPE_S2C_RESYNC)
            return
        self._broadcast_model(constants.MSG_TYPE_S2C_INIT_CONFIG)

    def _broadcast_model(self, msg_type: str) -> None:
        """Selection + model broadcast shared by init and per-round sync
        (fedml_server_manager.py:47-69 and :167-207): pick which edge
        ranks participate (``client_selection``), map them onto data-silo
        indices (``data_silo_selection``), send the global model."""
        # quarantined ranks sit out entire cohorts until their
        # probation expires (docs/robustness.md quarantine lifecycle) —
        # excluded here exactly like detector-declared-dead ranks
        quarantined = self.aggregator.quarantined_ranks()
        self.telemetry.set_gauge("defense_quarantined_now", len(quarantined))
        if self.elastic:
            # membership is whoever is online right now; selection caps
            # at client_num_per_round of them
            candidate_ids = [
                self.client_real_ids[r - 1]
                for r in self._active_ranks()
                if r not in quarantined
            ]
            n_select = min(
                int(self.args.client_num_per_round), len(candidate_ids)
            )
        else:
            # fixed membership still excludes detector-declared-dead
            # ranks: broadcasting to a corpse re-stalls every round
            # (a reconnect clears the rank from the dead set)
            candidate_ids = [
                rid
                for rid in self.client_real_ids
                if self._rank_of_real_id[rid] not in self._dead_ranks
                and self._rank_of_real_id[rid] not in quarantined
            ]
            n_select = len(candidate_ids)
        # named chaos barrier: a scheduled kill_server here models a
        # death between round close and the next broadcast
        chaos_barrier("server.broadcast", round=self.round_idx, rank=self.rank)
        selected_real_ids = self.aggregator.client_selection(
            self.round_idx, candidate_ids, n_select
        )
        silo_indexes = self.aggregator.data_silo_selection(
            self.round_idx,
            int(self.args.client_num_in_total),
            len(selected_real_ids),
        )
        if not selected_real_ids:
            # an empty federation cannot progress; shut down loudly
            # instead of blocking forever on an inbox nobody feeds
            logging.error(
                "round %d: no online clients to broadcast to; finishing",
                self.round_idx,
            )
            self.send_finish()
            self.finish()
            return
        self._last_broadcast_type = msg_type
        global_params = self.aggregator.get_global_model_params()
        import time as _time

        self._round_profiler.tick(self.round_idx)
        if not self._round_span_open:
            # one flight-recorder span per round, broadcast -> aggregate
            # end (a zero-upload rebroadcast extends the same round)
            self.telemetry.recorder.begin(
                "cross_silo.round", cat="round", round=self.round_idx
            )
            self._round_span_open = True
        self._bcast_t0 = _time.perf_counter()
        self._upload_arrivals = {}
        self._upload_train_s = {}
        expected = []
        self._round_assignment = {}
        for real_id, silo_idx in zip(selected_real_ids, silo_indexes):
            rank = self._rank_of_real_id[real_id]
            expected.append(rank - 1)
            self._round_assignment[rank] = silo_idx
            msg = Message(msg_type, self.rank, rank)
            msg.add_params(constants.MSG_ARG_KEY_MODEL_PARAMS, global_params)
            msg.add_params(constants.MSG_ARG_KEY_CLIENT_INDEX, silo_idx)
            msg.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, self.round_idx)
            self.send_message(msg)
        self._bcast_done_t = _time.perf_counter()
        self.aggregator.begin_round(expected)
        self._arm_deadline()

    # -- deadline cohort (beyond the reference) -----------------------
    def _arm_deadline(self) -> None:
        if self.deadline_s <= 0:
            return
        import threading

        round_idx = self.round_idx

        def fire() -> None:
            # post to our own inbox; never mutate from the timer thread.
            # A lost deadline message re-creates the straggler hang this
            # feature exists to prevent, so transient send failures are
            # retried (shared _post_loopback policy) and logged loudly.
            msg = Message(constants.MSG_TYPE_S2S_AGG_DEADLINE, self.rank, self.rank)
            msg.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, round_idx)
            if not self._post_loopback(
                msg, "deadline message",
                stale=lambda: round_idx != self.round_idx,
            ):
                logging.error(
                    "deadline for round %d could not be delivered; the round "
                    "will only advance when all clients report", round_idx,
                )

        self._deadline_timer = threading.Timer(self.deadline_s, fire)
        self._deadline_timer.daemon = True
        self._deadline_timer.start()

    def _cancel_deadline(self) -> None:
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
            self._deadline_timer = None

    def handle_message_deadline(self, msg: Message) -> None:
        fired_round = int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX, -1))
        if fired_round != self.round_idx:
            return  # the round completed in time; stale timer
        n = self.aggregator.num_received()
        if n == 0:
            # There is nothing to aggregate, so extending alone can
            # livelock (e.g. a correlated fault ate every uplink, or
            # the downlink itself was lost and nobody is training).
            # Rebroadcast the round — _broadcast_model re-runs
            # selection, resends the model and re-arms the deadline —
            # a bounded number of times, then shut down loudly.
            self._empty_deadline_fires += 1
            if self._empty_deadline_fires > self.deadline_max_extensions:
                logging.error(
                    "round %d: %d deadline(s) of %.1fs elapsed with ZERO "
                    "uploads; giving up (aggregation_deadline_max_extensions=%d)",
                    self.round_idx, self._empty_deadline_fires - 1,
                    self.deadline_s, self.deadline_max_extensions,
                )
                self.send_finish()
                self.finish()
                return
            logging.warning(
                "round %d deadline (%.1fs) with ZERO uploads; rebroadcasting "
                "(extension %d/%d)",
                self.round_idx, self.deadline_s,
                self._empty_deadline_fires, self.deadline_max_extensions,
            )
            self._broadcast_model(self._last_broadcast_type)
            return
        self._empty_deadline_fires = 0
        expected = self.aggregator.client_num  # per-round cohort size
        missing = max(expected - n, 0)
        self.stragglers_dropped += missing
        logging.warning(
            "round %d deadline: aggregating %d/%d clients (%d straggler(s) dropped)",
            self.round_idx, n, expected, missing,
        )
        self._finish_round()

    def _extract_upload_payload(self, msg: Message, sender_rank: int):
        """Validate an upload's payload against the server codec and
        return ``(model_params, encoded)`` (exactly one set), or None
        after shutting the federation down on a fatal config mismatch.
        Neither is decoded here: the streaming fold decodes in its term
        (one K3 launch); the buffered path decodes at aggregate."""
        model_params = msg.get(constants.MSG_ARG_KEY_MODEL_PARAMS)
        if model_params is not None:
            if self._codec is not None:
                logging.warning(
                    "server has compression=%s but rank %d uploaded full "
                    "model_params; aggregating it, but the uplink is NOT "
                    "compressed — check the client config",
                    self.args.compression,
                    sender_rank,
                )
            return model_params, None
        encoded = msg.get(constants.MSG_ARG_KEY_MODEL_DELTA)
        if encoded is None:
            mismatch = "carries neither model_params nor model_delta"
        elif self._codec is None:
            mismatch = "is compressed but server has compression=none"
        else:
            mismatch = self._codec_mismatch(encoded)
        if mismatch:
            self._fatal_payload_mismatch(sender_rank, mismatch)
            return None
        return None, encoded

    def _codec_mismatch(self, encoded) -> "str | None":
        """Does this wire payload fit the server codec? (shared by the
        sync and async upload paths)."""
        from ...core.compression import payload_matches_codec

        if not payload_matches_codec(self._codec, encoded):
            return (
                f"payload does not match server codec "
                f"'{self._codec.name}' (int8 vs topk skew)"
            )
        return None

    def _fatal_payload_mismatch(self, sender_rank: int, mismatch: str) -> None:
        """Config mismatch is fatal but must not strand clients: shut
        the federation down cleanly (same pattern as the
        no-online-clients path in _broadcast_model)."""
        logging.error(
            "rank %d upload %s; configure args.compression (and agg_mode) "
            "identically on server and clients — finishing run",
            sender_rank,
            mismatch,
        )
        self.send_finish()
        self.finish()

    def handle_message_receive_model_from_client(self, msg: Message) -> None:
        """(fedml_server_manager.py:121-207)"""
        sender_rank = int(msg.get_sender_id())
        if self.agg_mode == "async":
            self._handle_async_upload(msg, sender_rank)
            return
        upload_round = int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX, self.round_idx))
        if upload_round != self.round_idx:
            logging.warning(
                "discarding straggler upload from rank %d for round %d "
                "(now on round %d)", sender_rank, upload_round, self.round_idx,
            )
            self.telemetry.inc("agg_late_uploads_total")
            return
        import time as _time

        # straggler analytics: when each upload landed and how much of
        # that was the client's own training (self-reported). FIRST
        # arrival wins — a network-duplicated copy of a fast client's
        # upload landing late must not rename the straggler (the same
        # rule the offline analyzer applies to duplicate flows)
        if sender_rank not in self._upload_arrivals:
            self._upload_arrivals[sender_rank] = _time.perf_counter()
            reported_train_s = msg.get(constants.MSG_ARG_KEY_TRAIN_SECONDS)
            if reported_train_s is not None:
                self._upload_train_s[sender_rank] = float(reported_train_s)
        payload = self._extract_upload_payload(msg, sender_rank)
        if payload is None:
            return
        model_params, encoded = payload
        local_sample_num = msg.get(constants.MSG_ARG_KEY_NUM_SAMPLES)
        # streaming (agg_mode=stream): folded into the running
        # accumulator RIGHT NOW — the straggler-wait window does the
        # aggregation work, and quantized payloads decode inside the
        # fold's term. Buffered/fallback: stored until close.
        status = self.aggregator.receive_upload(
            sender_rank - 1,
            local_sample_num,
            model_params=model_params,
            encoded=encoded,
        )
        if status == "quarantined":
            # the anomaly screen rejected this upload BEFORE folding.
            # The rank must not stall the round either: drop its
            # pending slot exactly like a failure-detector death, so
            # the quorum denominator shrinks and the grace timer can
            # arm/close over the survivors.
            logging.warning(
                "round %d: upload from quarantined rank %d rejected; "
                "dropping its slot from the round",
                self.round_idx, sender_rank,
            )
            if self.is_initialized and self.aggregator.drop_expected(
                sender_rank - 1
            ):
                if self.aggregator.check_whether_all_receive():
                    self._finish_round()
                    return
                self._maybe_arm_quorum()
            return
        # post-restart in-flight uploads: the PREVIOUS incarnation
        # broadcast this round, so a just-restarted server can receive
        # (and fold) round-tagged uploads before it ever re-broadcasts.
        # Record the sender into the round's cohort — the WAL's
        # folded ⊆ cohort invariant is about membership, not about
        # which incarnation did the broadcasting. Recorded only once
        # the upload is ACCEPTED (past the payload and quarantine
        # rejections): a rejected sender must stay resync-eligible,
        # and a silo of -1 here is safe because the accept sets the
        # rank's uploaded flag, which short-circuits _maybe_resync
        self._round_assignment.setdefault(sender_rank, -1)
        if not self._wait_open:
            self.profiler.log_event_started("server.wait")
            self._wait_open = True
        if self.aggregator.check_whether_all_receive():
            self._finish_round()
            return
        self._maybe_arm_quorum()

    # -- quorum round close (streaming tentpole) ----------------------
    def _maybe_arm_quorum(self) -> None:
        """Arm the grace timer the first time the current round's
        folded count reaches quorum. The denominator is the LIVE
        cohort: ``drop_expected`` (elastic leaves, failure-detector
        deaths) shrinks it, so this is re-checked from those paths too
        — a declared-dead rank can tip an already-arrived quorum into
        arming instead of waiting on a corpse."""
        if (
            self.quorum_frac <= 0
            or not self.is_initialized
            or self._quorum_armed_round == self.round_idx
            or not self.aggregator.quorum_met(self.quorum_frac)
        ):
            return
        import threading

        self._quorum_armed_round = self.round_idx
        round_idx = self.round_idx
        n = self.aggregator.num_received()
        logging.info(
            "round %d: quorum reached (%d/%d folded >= target %d); "
            "grace %.2fs for the rest",
            round_idx, n, self.aggregator.client_num,
            self.aggregator.quorum_target(self.quorum_frac),
            self.round_grace_s,
        )

        def fire() -> None:
            msg = Message(
                constants.MSG_TYPE_S2S_QUORUM_GRACE, self.rank, self.rank
            )
            msg.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, round_idx)
            self._post_loopback(
                msg, "quorum grace message",
                stale=lambda: round_idx != self.round_idx,
            )

        self._quorum_timer = threading.Timer(self.round_grace_s, fire)
        self._quorum_timer.daemon = True
        self._quorum_timer.start()

    def _cancel_quorum(self) -> None:
        if self._quorum_timer is not None:
            self._quorum_timer.cancel()
            self._quorum_timer = None
        self._quorum_armed_round = None

    def handle_message_quorum_grace(self, msg: Message) -> None:
        fired_round = int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX, -1))
        if fired_round != self.round_idx:
            return  # the round completed in time; stale timer
        n = self.aggregator.num_received()
        expected = self.aggregator.client_num
        missing = max(expected - n, 0)
        if n == 0:
            return  # cannot happen (armed only after a fold) — guard anyway
        if missing:
            ages = {}
            for idx in self.aggregator.missing_indexes():
                rank = idx + 1
                age = (
                    self._failure_detector.last_seen_age_s(rank)
                    if self._failure_detector is not None
                    else None
                )
                ages[rank] = None if age is None else round(age, 2)
            self.stragglers_dropped += missing
            self.quorum_closes += 1
            self.telemetry.inc("agg_quorum_closes_total")
            logging.warning(
                "round %d quorum close: aggregating %d/%d clients after "
                "%.2fs grace (%d straggler(s) dropped; last seen ages %s)",
                self.round_idx, n, expected, self.round_grace_s, missing, ages,
            )
        self._finish_round()

    # -- async (FedBuff-style) aggregation (agg_mode=async) -----------
    def _async_target_folds(self) -> int:
        """Run length in folds: the async analog of comm_round — the
        federation finishes once comm_round x client_num_per_round
        updates have been accepted (discarded-stale ones don't count)."""
        return int(self.args.comm_round) * int(self.args.client_num_per_round)

    def _seed_async_ledger_from_wal(self) -> None:
        """Rebuild the exactly-once fold ledger after a restart: every
        WAL publish record's ``folded`` (rank, seq) pairs are already
        inside (or superseded with) the restored params, so a
        retransmitted pre-crash upload must never fold again. The WAL
        is written BEFORE the checkpoint (write-ahead), so the ledger
        can only over-cover — an upload may be dropped after a badly
        timed crash (its sender gets fresh work), but never folded
        twice. Publishes that made the WAL but not the checkpoint
        (every publish checkpoints, so that window is one publish) are
        reported LOUDLY: their folds' contributions are gone from the
        params and are not replayable."""
        ckpt_version = self.version  # what the restored params contain
        publishes = 0
        lost_folds = []
        for rec in self._wal.records():
            if rec.get("kind") != "publish":
                continue
            publishes += 1
            rec_version = int(rec.get("version", 0))
            for pair in rec.get("folded") or []:
                if isinstance(pair, (list, tuple)) and len(pair) == 2:
                    self._folded_ids.add((int(pair[0]), int(pair[1])))
                    if rec_version > ckpt_version:
                        lost_folds.append((int(pair[0]), int(pair[1])))
            self._dispatch_seq = max(
                self._dispatch_seq, int(rec.get("max_seq", 0))
            )
            self.async_folds = max(
                self.async_folds, int(rec.get("folds_total", 0))
            )
            self.version = max(self.version, rec_version)
        self.round_idx = self.version
        # new incarnation = new seq epoch: dispatches issued between
        # the last durable publish and the crash carried seqs above the
        # restored high-water mark; stepping to the next epoch band
        # guarantees none of them is ever reissued
        self._dispatch_seq = (self._dispatch_seq // _SEQ_EPOCH + 1) * _SEQ_EPOCH
        if lost_folds:
            # reported-lost counter: the InvariantChecker's
            # "no lost-but-unreported folds" invariant balances
            # accepted folds against ledgered + reported-lost
            self.telemetry.inc("agg_folds_lost_total", len(lost_folds))
            logging.warning(
                "async resume: %d fold(s) %s from publish(es) > version %d "
                "were write-ahead logged but their checkpoint never landed "
                "— those contributions are LOST (not replayable; their "
                "senders get fresh work). They stay in the dedup ledger so "
                "retransmits cannot half-apply them.",
                len(lost_folds), sorted(lost_folds), ckpt_version,
            )
        if publishes:
            logging.info(
                "async resume: %d publish record(s) seed a %d-entry fold "
                "ledger; version %d, %d/%d folds done, dispatch seq > %d",
                publishes, len(self._folded_ids), self.version,
                self.async_folds, self._async_target_folds(),
                self._dispatch_seq,
            )

    def _async_begin(self, msg_type: str) -> None:
        """Initial (or post-restart) dispatch: every online rank gets
        the current model + a fresh seq. No barrier ever forms — each
        upload triggers that rank's next dispatch."""
        ranks = self._active_ranks()
        if not ranks:
            logging.error("async: no online clients to dispatch; finishing")
            self.send_finish()
            self.finish()
            return
        silos = self.aggregator.data_silo_selection(
            0, int(self.args.client_num_in_total), len(ranks)
        )
        for r, s in zip(ranks, silos):
            self._round_assignment.setdefault(r, s)
        logging.info(
            "async federation: dispatching %d clients (target %d folds, "
            "publish every %d, staleness decay %.3g cap %d)",
            len(ranks), self._async_target_folds(), self.async_publish_every,
            self.staleness_decay, self.staleness_max,
        )
        for r in ranks:
            self._async_dispatch(r, msg_type)

    def _async_dispatch(
        self,
        rank: int,
        msg_type: str = constants.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
    ) -> None:
        if not self.client_online_status.get(rank, False):
            return  # nothing to hand a rank that is not there
        self._dispatch_seq += 1
        seq = self._dispatch_seq
        silo = self._round_assignment.get(
            rank, (rank - 1) % max(int(self.args.client_num_in_total), 1)
        )
        self._round_assignment[rank] = silo
        # one outstanding dispatch per rank; overwriting supersedes any
        # in-flight predecessor (its upload will fail the seq check)
        self._outstanding[rank] = (seq, self.version, silo)
        msg = Message(msg_type, self.rank, rank)
        msg.add_params(
            constants.MSG_ARG_KEY_MODEL_PARAMS,
            self.aggregator.get_global_model_params(),
        )
        msg.add_params(constants.MSG_ARG_KEY_CLIENT_INDEX, silo)
        msg.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, seq)
        msg.add_params(constants.MSG_ARG_KEY_MODEL_VERSION, self.version)
        self.send_message(msg)

    def _handle_async_upload(self, msg: Message, sender_rank: int) -> None:
        seq = int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX, -1))
        if (sender_rank, seq) in self._folded_ids:
            # retransmit of an upload that already folded (possibly
            # before a server restart — the WAL ledger remembers)
            self.telemetry.inc("agg_async_superseded_total", reason="dup")
            return
        out = self._outstanding.get(sender_rank)
        if out is None or out[0] != seq:
            # not this rank's in-flight dispatch: a duplicate raced its
            # redispatch, or a pre-crash upload whose work was reissued
            self.telemetry.inc("agg_async_superseded_total", reason="superseded")
            logging.info(
                "async: discarding superseded upload from rank %d (seq %d)",
                sender_rank, seq,
            )
            return
        _seq, base_version, _silo = out
        payload = msg.get(constants.MSG_ARG_KEY_MODEL_DELTA)
        if payload is None:
            self._fatal_payload_mismatch(
                sender_rank,
                "carries no model_delta (async clients ship update "
                "deltas; set agg_mode=async on every process)",
            )
            return
        raw, enc = (payload, None) if self._codec is None else (None, payload)
        if enc is not None:
            mismatch = self._codec_mismatch(enc)
            if mismatch:
                self._fatal_payload_mismatch(sender_rank, mismatch)
                return
        del self._outstanding[sender_rank]
        staleness = max(self.version - int(base_version), 0)
        n = float(msg.get(constants.MSG_ARG_KEY_NUM_SAMPLES))
        if staleness > self.staleness_max:
            self.telemetry.inc("agg_stale_discarded_total")
            logging.warning(
                "async: rank %d update is %d publishes stale "
                "(> staleness_max=%d); discarded",
                sender_rank, staleness, self.staleness_max,
            )
        else:
            scale = float(self.staleness_decay) ** staleness
            status = self.aggregator.fold_delta(
                n, delta=raw, encoded=enc, weight_scale=scale,
                index=sender_rank - 1, staleness=staleness,
            )
            if status == "quarantined":
                # rejected before folding; no fresh work until the
                # probation (ticked per publish) releases the rank —
                # _async_publish redispatches released ranks
                logging.warning(
                    "async: upload from quarantined rank %d rejected "
                    "(seq %d); rank sits out until probation expires",
                    sender_rank, seq,
                )
                self._async_check_quarantine_stall()
                return
            self._folded_ids.add((sender_rank, seq))
            self._folded_since_publish.append((sender_rank, seq))
            self.async_folds += 1
            self.async_weight_log.append(
                {
                    "rank": sender_rank,
                    "seq": seq,
                    "staleness": staleness,
                    "sample_num": n,
                    "weight": n * scale,
                }
            )
            self.telemetry.observe(
                "agg_staleness_rounds", staleness, buckets=(0, 1, 2, 4, 8, 16)
            )
            if len(self._folded_since_publish) >= self.async_publish_every:
                self._async_publish()
        if self.async_folds >= self._async_target_folds():
            self._async_publish()  # flush the partial buffer
            logging.info(
                "async federation done: %d folds, %d publishes",
                self.async_folds, self.version,
            )
            self.aggregator.test_on_server_for_all_clients(self.version)
            self.send_finish()
            self.finish()
            return
        self._async_dispatch(sender_rank)

    def _async_publish(self) -> None:
        """Fold buffer -> global model -> durable publish. WAL first
        (write-ahead: the fold ledger must cover everything the params
        might contain), then the checkpoint — which is also the serving
        plane's hot-swap feed (``CheckpointWatcher`` polls the same
        dir, so every publish can go live without a restart)."""
        folded = self._folded_since_publish
        if not folded:
            return
        chaos_barrier("server.publish", round=self.version, rank=self.rank)
        with self.profiler.span("async_publish", version=self.version + 1):
            self.aggregator.publish_async()
        self.version += 1
        self.round_idx = self.version
        self._folded_since_publish = []
        # EVERY publish checkpoints (checkpoint_freq does not apply in
        # async): the publish cadence IS the durability cadence — folds
        # applied to an uncheckpointed publish are unreplayable, so a
        # sparser checkpoint would turn every crash into silent update
        # loss. Tune async_publish_every to trade checkpoint I/O for
        # freshness instead.
        ckpt_due = self._ckpt is not None
        if self._wal is not None:
            try:
                written = self._unwaled_folds + folded
                self._wal.append(
                    self.version,
                    self.version if ckpt_due else None,
                    sorted(self._outstanding),
                    # include any folds orphaned by an earlier failed
                    # append: the ledger must cover everything the
                    # about-to-be-checkpointed params contain
                    folded=written,
                    kind="publish",
                    extra={
                        "version": self.version,
                        "max_seq": self._dispatch_seq,
                        "folds_total": self.async_folds,
                    },
                )
                self._unwaled_folds = []
                # durable-ledger counter: folds that reached the WAL —
                # the InvariantChecker's "WAL ledger == fold counters"
                # evidence (incremented only on a successful append, so
                # it can never over-count the log)
                self.telemetry.inc("agg_folds_published_total", len(written))
            except OSError:
                # write-ahead invariant: the ledger must cover every
                # fold a checkpoint might contain. If the WAL cannot be
                # written, SKIP this publish's checkpoint too — a
                # checkpoint whose folds are missing from the ledger
                # would let a retransmit double-fold after a restart.
                # The params stay live in memory; the next successful
                # publish carries them.
                logging.exception(
                    "async WAL append failed for publish %d; skipping its "
                    "checkpoint (durability degraded until the WAL "
                    "recovers)", self.version,
                )
                # counted as InvariantChecker evidence: a failed append
                # whose bytes nonetheless landed (fsync refused) leaves
                # a durable record the counters never acknowledged, and
                # its folds re-appear carried in the next successful
                # record — both gaps are bounded by this counter
                self.telemetry.inc("wal_append_failures_total")
                self._unwaled_folds.extend(folded)
                ckpt_due = False
        if ckpt_due:
            self._save_checkpoint()
        # async probation ticks per publish; a released rank gets fresh
        # work immediately (nothing else would re-engage it — async has
        # no per-round broadcast to pick it back up)
        for idx in self.aggregator.tick_defense():
            rank = idx + 1
            if self.client_online_status.get(rank, False):
                self._async_dispatch(rank)
        self.telemetry.set_gauge(
            "defense_quarantined_now",
            len(self.aggregator.quarantined_ranks()),
        )
        self.telemetry.inc("agg_publish_total")
        self.telemetry.heartbeat("cross_silo.round", self.version)
        self.telemetry.inc("cross_silo_rounds_total")
        self.metrics_reporter.report(
            {
                "kind": "async_publish",
                "version": self.version,
                "folds": len(folded),
                "folds_total": self.async_folds,
            }
        )
        logging.info(
            "async publish %d: %d fold(s) applied (%d/%d total)",
            self.version, len(folded), self.async_folds,
            self._async_target_folds(),
        )

    def _finish_round(self) -> None:
        """Aggregate whatever was received, eval, advance (shared by
        the all-received, deadline and quorum-grace paths)."""
        chaos_barrier("server.round_close", round=self.round_idx, rank=self.rank)
        self._cancel_deadline()
        self._cancel_quorum()
        self._empty_deadline_fires = 0
        if self._wait_open:
            self.profiler.log_event_ended("server.wait")
            self._wait_open = False
        import time as _time

        n_aggregated = self.aggregator.num_received()
        # which ranks actually folded into this aggregate (the WAL's
        # exactly-once record) — captured BEFORE aggregate() resets it
        folded_ranks = [i + 1 for i in self.aggregator.folded_indexes()]
        t_agg0 = _time.perf_counter()
        if n_aggregated:
            # the round tag lets the critical-path analyzer pick THIS
            # round's aggregate span off the stitched timeline
            with self.profiler.span("aggregate", round=self.round_idx):
                self.aggregator.aggregate()
        else:
            # every expected client left before uploading (elastic):
            # the global model is unchanged this round; keep going
            logging.warning(
                "round %d: no contributions (all expected clients left); "
                "global model unchanged", self.round_idx,
            )
        # one quarantine-probation period per round close; released
        # ranks re-enter candidate selection at the next broadcast
        released = self.aggregator.tick_defense()
        if released:
            logging.info(
                "round %d: quarantine probation expired for rank(s) %s",
                self.round_idx, [i + 1 for i in released],
            )
        self._record_round_segments(
            self.round_idx, _time.perf_counter() - t_agg0
        )
        eval_round = self.round_idx
        cohort = self.aggregator.client_num  # before begin_round re-arms
        # the completed round's broadcast set, captured BEFORE the next
        # broadcast overwrites the assignment (WAL record)
        cohort_ranks = sorted(self._round_assignment)
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
            self._wal_append(eval_round, ckpt_due, cohort_ranks, folded_ranks)
            if n_aggregated:
                self.aggregator.test_on_server_for_all_clients(eval_round)
            self._report_round(eval_round, cohort, n_aggregated)
            self.send_finish()
            self.finish()
            return
        # comm/compute overlap (SURVEY.md §7 "the round loop must
        # overlap comm and compute explicitly"; the reference evals
        # before syncing, stalling every client for the server's eval):
        # broadcast the next round FIRST so clients train while the
        # server evaluates the round that just closed. The checkpoint
        # save rides the same overlap window — it reads only state the
        # broadcast does not mutate.
        self._broadcast_model(constants.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT)
        if ckpt_due:
            self._save_checkpoint()
        self._wal_append(eval_round, ckpt_due, cohort_ranks, folded_ranks)
        if n_aggregated:
            with self.profiler.span("server_eval_overlapped"):
                self.aggregator.test_on_server_for_all_clients(eval_round)
        self._report_round(eval_round, cohort, n_aggregated)

    def _record_round_segments(self, round_idx: int, aggregate_s: float) -> None:
        """Live per-round critical-path attribution into the telemetry
        registry (``round_segment_seconds{segment=...}``), straggler
        analytics (slack histogram + rank gauge) and the SLO check
        against ``round_deadline_s``. Server-observable times plus the
        clients' self-reported ``train_seconds``; the stitched-trace
        analyzer (``cli trace``) computes the exact cross-process
        version offline."""
        import time as _time

        tel = self.telemetry
        if self._round_span_open:
            tel.recorder.end("cross_silo.round", cat="round", round=round_idx)
            self._round_span_open = False
        if self._bcast_t0 is None:
            return
        now = _time.perf_counter()
        wall = now - self._bcast_t0
        bcast_done = self._bcast_done_t or self._bcast_t0
        segs = {
            "broadcast_send": bcast_done - self._bcast_t0,
            "aggregate": aggregate_s,
        }
        arrivals = self._upload_arrivals
        if arrivals:
            last = max(arrivals.values())
            straggler = max(arrivals, key=arrivals.get)
            wait = max(last - bcast_done, 0.0)
            compute = self._upload_train_s.get(straggler)
            if compute is not None:
                segs["client_compute"] = min(compute, wait)
                segs["wire"] = max(wait - compute, 0.0)
            else:
                segs["wire"] = wait
            tel.set_gauge("round_straggler_rank", straggler)
            # slack: how long each client's finished upload sat waiting
            # on the straggler — the overlap budget items 3/4 of the
            # roadmap (aggregate-on-arrival, PiPar) would reclaim
            for rank, ts in arrivals.items():
                tel.observe(
                    "round_straggler_slack_s",
                    max(last - ts, 0.0),
                    buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0),
                )
        for name, dur in segs.items():
            tel.observe("round_segment_seconds", max(dur, 0.0), segment=name)
        tel.observe("round_wall_seconds", wall)
        # -- idle-time ledger (the PiPar opportunity, measured live) --
        # arrival_to_aggregate: the last upload is in hand but the
        # aggregate hasn't started — segs + this gap reconstruct the
        # round wall exactly (the perf plane asserts within 5%).
        # close_to_broadcast: server idle BETWEEN rounds (previous
        # ledger close -> this broadcast); inter-round by construction,
        # so it is excluded from the intra-round reconciliation. The
        # arithmetic is attribute_idle's (below), the JAX package's
        # analysis/perf.py function
        idle = attribute_idle(
            now=now,
            bcast_t0=self._bcast_t0,
            last_arrival=max(arrivals.values()) if arrivals else bcast_done,
            aggregate_s=aggregate_s,
            prev_close=self._last_round_close_t,
        )
        for gap, dur in idle.items():
            tel.observe(
                "round_idle_seconds", dur, gap=gap,
                buckets=(0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0),
            )
        # fraction of the round wall the wire was actually moving bytes
        # (broadcast down + straggler-path upload); the rest is the
        # overlap budget items 1/3 of the roadmap would reclaim
        wire_busy = segs["broadcast_send"] + segs.get("wire", 0.0)
        wire_frac = min(wire_busy / wall, 1.0) if wall > 0 else 0.0
        tel.set_gauge("wire_utilization_frac", wire_frac)
        tel.recorder.instant(
            "round.ledger", cat="perf", round=round_idx,
            wall_s=round(wall, 6),
            segments={k: round(max(v, 0.0), 6) for k, v in segs.items()},
            idle={k: round(v, 6) for k, v in idle.items()},
            wire_utilization_frac=round(wire_frac, 6),
        )
        self._last_round_close_t = now
        if self.round_deadline_s > 0 and wall > self.round_deadline_s:
            tel.inc("slo_violations_total")
            logging.warning(
                "round %d violated round_deadline_s: %.3fs > %.3fs "
                "(straggler rank %s)",
                round_idx, wall, self.round_deadline_s,
                max(arrivals, key=arrivals.get) if arrivals else "n/a",
            )

    def _save_checkpoint(self) -> None:
        """step = the NEXT round to run (sync) or the publish version
        (async); a restarted server picks up exactly where the
        broadcast/dispatch would have gone."""
        state = {
            "params": self.aggregator.get_global_model_params(),
            "round_idx": self.round_idx,
            "agg_round": self.aggregator._agg_round,
        }
        if self.agg_mode == "async":
            state.update(
                version=self.version,
                dispatch_seq=self._dispatch_seq,
                async_folds=self.async_folds,
            )
        self._ckpt.save(self.round_idx, state)

    def _wal_append(
        self, eval_round: int, ckpt_saved: bool, cohort_ranks, folded_ranks=None
    ) -> None:
        """One WAL record per COMPLETED round (crash recovery): which
        round finished, which checkpoint step (if any) carries it, who
        the round was broadcast to, and whose uploads actually folded
        into the aggregate (a strict subset under a quorum/deadline
        close — the exactly-once ledger)."""
        if self._wal is None:
            return
        try:
            self._wal.append(
                eval_round,
                self.round_idx if ckpt_saved else None,
                cohort_ranks,
                folded=folded_ranks,
            )
            # durable-ledger counters (InvariantChecker evidence): one
            # round record and its fold count, bumped ONLY after the
            # append returned — a crash at the write boundary leaves at
            # most the final record unaccounted, which the checker
            # bounds by the injected-crash count
            self.telemetry.inc("wal_rounds_logged_total")
            self.telemetry.inc(
                "wal_folds_logged_total", len(folded_ranks or [])
            )
        except OSError:
            # the WAL is an aid to recovery, never a reason to kill a
            # healthy federation (disk-full on the log must not)
            logging.exception("round WAL append failed for round %d", eval_round)
            # InvariantChecker evidence: a refused fsync can leave a
            # durable record the ledger counters never acknowledged —
            # this bounds that counter/ledger gap from artifacts alone
            self.telemetry.inc("wal_append_failures_total")

    def _report_round(self, round_idx: int, cohort: int, n_aggregated: int) -> None:
        self.metrics_reporter.report(
            {
                "kind": "round_info",
                "round": round_idx,
                "clients": cohort,
                "clients_aggregated": n_aggregated,
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
        # clean-finish marker: tells the post-hoc InvariantChecker the
        # final incarnation flushed its state (counter-vs-ledger
        # equality is only provable on a cleanly finished run)
        self.telemetry.inc("cross_silo_finish_total")
        for rank in range(1, len(self.client_real_ids) + 1):
            self.send_message(
                Message(constants.MSG_TYPE_S2C_FINISH, self.rank, rank)
            )
        logging.info("server: training finished after %d rounds", self.round_idx)
        if self._failure_detector is not None:
            self._failure_detector.stop()
        self._round_profiler.close()
