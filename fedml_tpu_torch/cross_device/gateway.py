"""Gateway plane: the connectionless server end of the Beehive protocol
(port of ``fedml_tpu/cross_device/gateway.py``, line for line).

``DeviceGateway`` is rank 0 of the two-rank cross-device fabric. It
holds no connection to any device and runs no failure detector: devices
check in, pull the round offer, push one masked delta, and disappear.
Its per-device state is one roster row (device id + mask pubkey) and one
fold-ledger entry an upload, bounded by the cohort, plus a ledger of the
last few closed rounds so that a late upload can still be unmasked and
folded FedBuff-style with a staleness discount
(``core.aggregation.staleness_weight``).

A round never waits for its whole cohort. It closes when the fold count
reaches its target (``crossdevice_fold_target_frac`` of the roster) or
the report window ends, whichever comes first. The fold is add-only
streaming in the mod-p field, host numpy in int64 as in the reference:
pairwise masks (``core.secure_agg``) cancel exactly across whoever did
upload, and the survivors' Shamir reveals recover the dangling masks of
whoever did not (each reconstructed secret checked against its published
key, so a poisoned share counts a ``device_mask_recovery_failures``
instead of corrupting the fold). Every close writes one ``crossdevice``
``RoundWAL`` record carrying the field checksums that the masked folds'
balance is checked against.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from .. import constants
from ..core.aggregation import staleness_weight
from ..core.checkpoint import RoundWAL
from ..core.managers import ServerManager
from ..core.message import Message
from ..core.secure_agg import (
    FIELD_PRIME,
    dequantize,
    field_checksum,
    flatten_params,
    mask_public_key,
    pairwise_mask_vector,
    shamir_reconstruct,
    unflatten_params,
    unmask_correction,
)
from .protocol import (
    encode_offer_params,
    flat_dim,
    linear_template,
    pack_participants,
    unpack_reveals,
)

__all__ = ["DeviceGateway"]

# closed-round ledger depth: how many rounds back a late upload can still
# be unmasked and folded; older ones are dropped (their staleness
# discount would be ~decay^8 anyway)
LEDGER_ROUNDS = 8


class _RoundState:
    """Everything the gateway knows about the open round: all of it
    O(cohort), none of it a connection."""

    def __init__(self, round_idx: int, expected: Set[int], dim: int) -> None:
        self.round_idx = round_idx
        self.expected = expected
        self.checkins: Dict[int, int] = {}  # device -> mask pubkey
        self.participants: Dict[int, int] = {}  # frozen at offer time
        self.fold_target = 0
        self.deadline = float("inf")
        self.acc = np.zeros(dim, dtype=np.int64)  # the streaming field fold
        self.folded: Dict[int, int] = {}  # device -> sample count
        self.seen: Set[int] = set()  # upload dedup (at-most-once fold)
        self.upload_checksums: Dict[int, int] = {}
        self.correction_checksums: Dict[int, int] = {}
        self.secrets: Dict[int, int] = {}  # reconstructed (vanished only)
        self.closed = False
        self.close_reason = ""
        self.awaiting_reveal = False


class DeviceGateway(ServerManager):
    """Rank 0 of the Beehive fabric: offers rounds, folds uploads."""

    def __init__(
        self,
        args,
        registry,
        feature_dim: int,
        class_num: int,
        rounds: int,
        cohort_size: int,
        rank: int = 0,
        size: int = 2,
        backend: str = constants.COMM_BACKEND_LOCAL,
    ) -> None:
        super().__init__(args, None, rank, size, backend)
        self.registry = registry
        self.feature_dim = int(feature_dim)
        self.class_num = int(class_num)
        self.rounds = int(rounds)
        self.cohort_size = int(cohort_size)
        self.fold_frac = float(getattr(args, "crossdevice_fold_target_frac", 0.6))
        self.window_s = float(getattr(args, "crossdevice_report_window_s", 30.0))
        self.secure_agg = bool(getattr(args, "crossdevice_secure_agg", True))
        self.scale = float(getattr(args, "crossdevice_quant_scale", 65536.0))
        self.threshold = int(getattr(args, "crossdevice_mask_threshold", 2))
        self.verify_pubkey = bool(getattr(args, "crossdevice_verify_pubkey", True))
        self.decay = float(getattr(args, "staleness_decay", 0.5))
        self.dim = flat_dim(feature_dim, class_num)
        flat0, self._spec = flatten_params(linear_template(feature_dim, class_num))
        self.global_flat = flat0.astype(np.float64)
        self.wal = RoundWAL(args.checkpoint_dir)
        self._cur: Optional[_RoundState] = None
        self._next_round = 0
        # closed rounds, newest last: {participants, secrets, seen} a
        # round, the bounded memory a late upload is unmasked against
        self._ledger: Dict[int, Dict[str, Any]] = {}
        # late uploads: masked ones wait for a reveal, raw ones for the
        # next finalize (staleness >= 1 by construction)
        self._late_pending: List[Tuple[int, int, np.ndarray, int]] = []
        self._late_ready: List[Tuple[int, int, np.ndarray, int]] = []
        self.round_records: List[Dict[str, Any]] = []
        # host seconds in the fold (uploads, reveals and finalize), summed
        self.fold_seconds = 0.0

    @property
    def global_params(self) -> Dict[str, Any]:
        """The global model as float32 CPU tensors ``{"b", "w"}``."""
        return unflatten_params(self.global_flat, self._spec)

    # -- protocol wiring ----------------------------------------------
    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            constants.MSG_TYPE_D2S_DEVICE_CHECKIN, self._on_checkin
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_D2S_WINDOW_TICK, self._on_tick
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_D2S_MASKED_UPLOAD, self._timed(self._on_upload)
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_D2S_SHARE_REVEAL, self._timed(self._on_reveal)
        )

    def _timed(self, handler):
        def call(msg: Message) -> None:
            t0 = time.perf_counter()
            try:
                handler(msg)
            finally:
                self.fold_seconds += time.perf_counter() - t0
        return call

    def _send(self, msg_type: int, fields: Dict[str, Any]) -> None:
        msg = Message(msg_type, self.rank, 1)
        for k, v in fields.items():
            msg.add_params(k, v)
        self.send_message(msg)

    # -- check-in window ----------------------------------------------
    def _on_checkin(self, msg: Message) -> None:
        round_idx = int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX))
        did = int(msg.get(constants.MSG_ARG_KEY_DEVICE_ID))
        st = self._ensure_round(round_idx)
        if (
            st is None
            or st.closed
            or st.participants  # roster frozen: the offer already went out
            or did not in st.expected
            or did in st.checkins
        ):
            self.telemetry.inc("device_checkins_rejected_total")
            return
        st.checkins[did] = int(msg.get(constants.MSG_ARG_KEY_DEVICE_PUBKEY))
        self.registry.record_checkin(did, round_idx)
        self.telemetry.inc("device_checkins_total")

    def _ensure_round(self, round_idx: int) -> Optional[_RoundState]:
        if self._cur is not None:
            return self._cur if self._cur.round_idx == round_idx else None
        if round_idx != self._next_round or round_idx >= self.rounds:
            return None
        # the eligibility oracle: the same seeded sample the device plane
        # drew, recomputed (no enrollment channel)
        expected = self.registry.sample_available_cohort(round_idx, self.cohort_size)
        self._cur = _RoundState(round_idx, {int(d) for d in expected}, self.dim)
        return self._cur

    def _on_tick(self, msg: Message) -> None:
        round_idx = int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX))
        phase = msg.get(constants.MSG_ARG_KEY_WINDOW_PHASE)
        st = self._ensure_round(round_idx)
        if st is None:
            return
        if phase == constants.DEVICE_WINDOW_CHECKIN and not st.participants:
            self._offer(st)
        elif phase == constants.DEVICE_WINDOW_REPORT and not st.closed:
            self._close(st, constants.DEVICE_CLOSE_WINDOW)

    def _offer(self, st: _RoundState) -> None:
        st.participants = dict(st.checkins)
        st.fold_target = max(1, math.ceil(self.fold_frac * len(st.participants)))
        st.deadline = time.monotonic() + self.window_s
        self._send(
            constants.MSG_TYPE_S2D_ROUND_OFFER,
            {
                constants.MSG_ARG_KEY_ROUND_INDEX: st.round_idx,
                constants.MSG_ARG_KEY_MODEL_PARAMS: encode_offer_params(self.global_params),
                constants.MSG_ARG_KEY_QUANT_SCALE: self.scale,
                constants.MSG_ARG_KEY_PARTICIPANTS: pack_participants(st.participants),
            },
        )

    # -- report window ------------------------------------------------
    def _on_upload(self, msg: Message) -> None:
        round_idx = int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX))
        did = int(msg.get(constants.MSG_ARG_KEY_DEVICE_ID))
        q = np.asarray(msg.get(constants.MSG_ARG_KEY_MASKED_DELTA), dtype=np.int64)
        checksum = int(msg.get(constants.MSG_ARG_KEY_MASK_CHECKSUM))
        n = int(msg.get(constants.MSG_ARG_KEY_NUM_SAMPLES))
        if field_checksum(q) != checksum:
            logging.warning("gateway: upload from device %d fails its own checksum", did)
            return
        st = self._cur
        if st is not None and st.round_idx == round_idx and not st.closed:
            if time.monotonic() > st.deadline:
                self._close(st, constants.DEVICE_CLOSE_WINDOW)
                self._late_upload(round_idx, did, q, n)
                return
            if did in st.seen:
                self.telemetry.inc("device_duplicate_uploads_total")
                return
            st.seen.add(did)
            if did not in st.participants:
                logging.warning(
                    "gateway: upload from %d outside round %d roster", did, round_idx
                )
                return
            st.acc = np.mod(st.acc + q, FIELD_PRIME)
            st.folded[did] = n
            st.upload_checksums[did] = checksum
            self.telemetry.inc("device_uploads_folded_total")
            if len(st.folded) >= st.fold_target:
                self._close(st, constants.DEVICE_CLOSE_TARGET)
        else:
            self._late_upload(round_idx, did, q, n)

    def _late_upload(self, round_idx: int, did: int, q: np.ndarray, n: int) -> None:
        """An upload after its round closed: never an error. Unmask it
        (now if the secret it needs is already reconstructed, after the
        reveal otherwise) and queue it for the next finalize's
        staleness-discounted fold."""
        seen = self._seen_for(round_idx)
        if seen is None:
            logging.info(
                "gateway: upload from %d for evicted round %d dropped", did, round_idx
            )
            return
        if did in seen:
            self.telemetry.inc("device_duplicate_uploads_total")
            return
        seen.add(did)
        self.telemetry.inc("device_uploads_late_total")
        if not self.secure_agg:
            self._late_ready.append((round_idx, did, q, n))
        else:
            self._late_pending.append((round_idx, did, q, n))
            self._drain_pending()

    def _seen_for(self, round_idx: int) -> Optional[Set[int]]:
        if self._cur is not None and self._cur.round_idx == round_idx:
            return self._cur.seen
        entry = self._ledger.get(round_idx)
        return None if entry is None else entry["seen"]

    def _round_crypto(
        self, round_idx: int
    ) -> Optional[Tuple[Dict[int, int], Dict[int, int], bool]]:
        """(participants, reconstructed secrets, reveal_done) of a round
        still in memory, else None."""
        if self._cur is not None and self._cur.round_idx == round_idx:
            st = self._cur
            return st.participants, st.secrets, st.closed and not st.awaiting_reveal
        entry = self._ledger.get(round_idx)
        if entry is None:
            return None
        return entry["participants"], entry["secrets"], True

    def _drain_pending(self) -> None:
        """Move the masked late uploads whose own secret is known to the
        ready queue; drop the unrecoverable ones."""
        keep: List[Tuple[int, int, np.ndarray, int]] = []
        for round_idx, did, q, n in self._late_pending:
            crypto = self._round_crypto(round_idx)
            if crypto is None:
                logging.info(
                    "gateway: late upload from %d round %d evicted unmasked", did, round_idx
                )
                continue
            participants, secrets, reveal_done = crypto
            secret = secrets.get(did)
            if secret is not None:
                raw = np.mod(
                    q - pairwise_mask_vector(did, secret, participants, self.dim),
                    FIELD_PRIME,
                )
                self._late_ready.append((round_idx, did, raw, n))
            elif reveal_done:
                # its secret was never reconstructed (recovery failed or
                # nobody folded it): the delta is noise
                logging.info(
                    "gateway: late upload from %d round %d has no recovered secret; "
                    "dropped", did, round_idx,
                )
            else:
                keep.append((round_idx, did, q, n))
        self._late_pending = keep

    # -- closing a round ----------------------------------------------
    def _close(self, st: _RoundState, reason: str) -> None:
        st.closed = True
        st.close_reason = reason
        self.telemetry.inc("device_rounds_closed_total", reason=reason)
        vanished = sorted(set(st.participants) - set(st.folded))
        if self.secure_agg and vanished and st.folded:
            st.awaiting_reveal = True
            self._send(
                constants.MSG_TYPE_S2D_SHARE_REQUEST,
                {
                    constants.MSG_ARG_KEY_ROUND_INDEX: st.round_idx,
                    constants.MSG_ARG_KEY_DEVICE_ID: np.asarray(vanished, dtype=np.int64),
                    constants.MSG_ARG_KEY_PARTICIPANTS: np.asarray(
                        sorted(st.folded), dtype=np.int64
                    ),
                },
            )
        else:
            self._finalize(st)

    def _on_reveal(self, msg: Message) -> None:
        st = self._cur
        round_idx = int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX))
        if st is None or st.round_idx != round_idx or not st.awaiting_reveal:
            return
        reveals = unpack_reveals(msg.get(constants.MSG_ARG_KEY_SHARE_REVEALS))
        n_roster = len(st.participants)
        t = min(self.threshold, max(1, n_roster - 1))
        folded_pubs = {i: st.participants[i] for i in st.folded}
        for vanished_id in sorted(reveals):
            pairs = sorted(reveals[vanished_id])
            self.telemetry.inc("device_share_reveals_total", value=len(pairs))
            if vanished_id not in st.participants or len(pairs) < t + 1:
                self.telemetry.inc("device_mask_recovery_failures_total")
                continue
            points = [p for p, _ in pairs[: t + 1]]
            values = np.asarray([v for _, v in pairs[: t + 1]], dtype=np.int64)
            secret = int(shamir_reconstruct(values, points))
            if self.verify_pubkey and mask_public_key(secret) != st.participants[vanished_id]:
                # a poisoned share reconstructs the wrong secret; the
                # published key is the tamper evidence
                self.telemetry.inc("device_mask_recovery_failures_total")
                continue
            corr = unmask_correction(vanished_id, secret, folded_pubs, self.dim)
            st.acc = np.mod(st.acc - corr, FIELD_PRIME)
            st.correction_checksums[vanished_id] = field_checksum(corr)
            st.secrets[vanished_id] = secret
            self.telemetry.inc("device_mask_recoveries_total")
        st.awaiting_reveal = False
        self._finalize(st)

    def _finalize(self, st: _RoundState) -> None:
        # the closed-round ledger entry first: late unmasking (this
        # round's own stragglers too) reads it uniformly
        self._ledger[st.round_idx] = {
            "participants": dict(st.participants),
            "secrets": dict(st.secrets),
            "seen": st.seen,
        }
        for evicted in sorted(self._ledger)[:-LEDGER_ROUNDS]:
            del self._ledger[evicted]
        self._drain_pending()
        fchk = field_checksum(st.acc)
        num = dequantize(st.acc, self.scale)
        total_w = float(sum(st.folded.values()))
        # FedBuff leg: stragglers of earlier rounds fold here with a
        # staleness discount; this round's own wait one more
        late_now = sorted(e for e in self._late_ready if e[0] < st.round_idx)
        self._late_ready = [e for e in self._late_ready if e[0] >= st.round_idx]
        for round_idx, did, raw, n in late_now:
            s = st.round_idx - round_idx
            w = staleness_weight(n, s, self.decay)
            num = num + (w / n) * dequantize(raw, self.scale)
            total_w += w
        if total_w > 0:
            self.global_flat = self.global_flat + num / total_w
        record_extra = {
            "checkins": sorted(st.checkins),
            "close_reason": st.close_reason,
            "fold_target": st.fold_target,
            "upload_checksums": {str(d): c for d, c in sorted(st.upload_checksums.items())},
            "correction_checksums": {
                str(v): c for v, c in sorted(st.correction_checksums.items())
            },
            "field_checksum": fchk,
            "masked": self.secure_agg,
            "recovered": sorted(st.secrets),
            "late_folded": len(late_now),
            "quant_scale": self.scale,
        }
        self.wal.append(
            st.round_idx,
            None,
            sorted(st.expected),
            folded=sorted(st.folded),
            kind="crossdevice",
            extra=record_extra,
        )
        self.round_records.append(
            {
                "round_idx": st.round_idx,
                "close_reason": st.close_reason,
                "fold_target": st.fold_target,
                "folds": len(st.folded),
                "checkins": len(st.checkins),
                "recovered": len(st.secrets),
                "late_folded": len(late_now),
            }
        )
        self._send(
            constants.MSG_TYPE_S2D_ROUND_RESULT,
            {
                constants.MSG_ARG_KEY_ROUND_INDEX: st.round_idx,
                constants.MSG_ARG_KEY_CLOSE_INFO: {
                    "reason": st.close_reason,
                    "folds": len(st.folded),
                    "fold_target": st.fold_target,
                },
            },
        )
        self._cur = None
        self._next_round = st.round_idx + 1
        if self._next_round >= self.rounds:
            logging.info("gateway: %d rounds closed", self.rounds)
            self.finish()
