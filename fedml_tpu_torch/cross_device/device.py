"""Device plane: a population of flaky phones behind one host rank (port
of ``fedml_tpu/cross_device/device.py``).

``DeviceHost`` simulates every device of a round's cohort from the
columnar ``scale.ClientRegistry`` (availability phase, speed tier, seed:
bytes a device, no objects) and speaks the Beehive check-in protocol to
the gateway as rank 1 of a two-rank fabric (``core/managers``). Each
device acts only on its own registry row and the round offer, and sends
exactly what a real phone would.

Churn is consulted, not suffered: before each protocol step a device
asks the chaos plane (``core.chaos.device_event``) whether it is
scheduled to vanish (skip the step, or with ``after_close`` deliver the
upload after the round closed) or to reveal a poisoned Shamir share
later (``bad_share``). A vanish is normal operation, never an exception.

Training runs by device class on the card (``device``): the
participants are grouped by speed tier, each tier padded to a pow2
bucket (``core.bucketing``), the group's features made in one launch of
the K2 generator (``registry.materialize_group``), and one group
function trains the group: a linear softmax classifier, the masked-mean
NLL, plain SGD, ``tier + 1`` epochs over the batches, ``vmap(grad)``
over the bucket. A group function is built once a (tier, bucket), so the
census ``trace_count == len(shape_keys)`` is the JAX package's count of
traced executables. The delta is ``trained - global`` in f32 on the card
before its float64 cast, as in the reference: a delta subtracted in
another precision would quantize to other field integers.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Callable, Dict, List, Set, Tuple

import numpy as np
import torch

from .. import constants
from ..core.bucketing import bucket_cohort, pad_cohort_idx
from ..core.chaos import device_event
from ..core.managers import ClientManager
from ..core.message import Message
from ..core.secure_agg import (
    FIELD_PRIME,
    derive_mask_secret,
    field_checksum,
    mask_public_key,
    pairwise_mask_vector,
    quantize,
    shamir_share,
)
from ..device import DeviceLike, get_device
from .protocol import decode_offer_params, pack_reveals, unpack_participants

__all__ = ["DeviceHost"]


def _linear_loss(p, xb, yb, mb):
    """The masked-mean NLL of one device's batch."""
    logp = torch.log_softmax(xb @ p["w"] + p["b"], dim=-1)
    nll = -torch.take_along_dim(logp, yb[:, None], dim=1)[:, 0]
    return (nll * mb).sum() / torch.clamp(mb.sum(), min=1.0)


class DeviceHost(ClientManager):
    """Rank 1 of the Beehive fabric: the whole device population.

    Drives ``rounds`` check-in rounds against the gateway, then leaves
    its receive loop. Exposes the census (``trace_count``,
    ``shape_keys``, ``groups_trained``) and its host timers
    (``train_seconds``: grouping, features and training; ``mask_seconds``:
    quantizing, masking and dealing shares)."""

    def __init__(
        self,
        args,
        registry,
        feature_dim: int,
        class_num: int,
        rounds: int,
        cohort_size: int,
        rank: int = 1,
        size: int = 2,
        backend: str = constants.COMM_BACKEND_LOCAL,
        device: DeviceLike = "cuda",
    ) -> None:
        self.device = get_device(device)
        super().__init__(args, None, rank, size, backend)
        self.registry = registry
        self.feature_dim = int(feature_dim)
        self.class_num = int(class_num)
        self.rounds = int(rounds)
        self.cohort_size = int(cohort_size)
        self.secure_agg = bool(getattr(args, "crossdevice_secure_agg", True))
        self.threshold = int(getattr(args, "crossdevice_mask_threshold", 2))
        self.lr = float(getattr(args, "learning_rate", 0.1))
        self.batch_size = int(getattr(args, "batch_size", 16))
        # every device trains its full (clipped) sample count: one batch
        # count a world, so shapes vary only along (tier, bucket)
        self.num_batches = max(1, math.ceil(registry.max_samples / self.batch_size))
        self._group_fns: Dict[Tuple[int, int], Callable] = {}
        self._trace_events: List[int] = []  # one entry a group function built
        self.shape_keys: Set[Tuple[int, int]] = set()
        self.groups_trained = 0
        self.train_seconds = 0.0
        self.mask_seconds = 0.0
        # per-round device-side state, cleared at the next check-in: mask
        # secrets by device, Shamir shares by holder (a holder reveals only
        # what it was dealt)
        self._secrets: Dict[int, int] = {}
        self._held: Dict[int, Dict[int, Tuple[int, int]]] = {}
        self._bad_share: Set[int] = set()
        self._round_idx = -1

    # -- protocol wiring ----------------------------------------------
    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            constants.MSG_TYPE_CONNECTION_IS_READY, self._on_connect
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_S2D_ROUND_OFFER, self._on_offer
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_S2D_SHARE_REQUEST, self._on_share_request
        )
        self.register_message_receive_handler(
            constants.MSG_TYPE_S2D_ROUND_RESULT, self._on_result
        )

    def _send(self, msg_type: int, fields: Dict[str, Any]) -> None:
        msg = Message(msg_type, self.rank, 0)
        for k, v in fields.items():
            msg.add_params(k, v)
        self.send_message(msg)

    # -- round choreography -------------------------------------------
    def _on_connect(self, _msg: Message) -> None:
        self._begin_round(0)

    def _begin_round(self, round_idx: int) -> None:
        """Check-in window: every sampled, available device checks in
        (its id and mask pubkey, nothing else) or was scheduled to vanish
        and does not."""
        self._round_idx = round_idx
        self._secrets.clear()
        self._held.clear()
        self._bad_share.clear()
        cohort = self.registry.sample_available_cohort(round_idx, self.cohort_size)
        for did in (int(d) for d in cohort):
            fault = device_event("device.checkin", did, round_idx)
            if fault is not None and fault["kind"] == "vanish":
                continue  # churn: a no-show costs nobody anything
            pub = 0
            if self.secure_agg:
                secret = derive_mask_secret(int(self.registry.client_seed[did]), round_idx)
                self._secrets[did] = secret
                pub = mask_public_key(secret)
            self._send(
                constants.MSG_TYPE_D2S_DEVICE_CHECKIN,
                {
                    constants.MSG_ARG_KEY_ROUND_INDEX: round_idx,
                    constants.MSG_ARG_KEY_DEVICE_ID: did,
                    constants.MSG_ARG_KEY_DEVICE_PUBKEY: int(pub),
                },
            )
        self._send(
            constants.MSG_TYPE_D2S_WINDOW_TICK,
            {
                constants.MSG_ARG_KEY_ROUND_INDEX: round_idx,
                constants.MSG_ARG_KEY_WINDOW_PHASE: constants.DEVICE_WINDOW_CHECKIN,
            },
        )

    @property
    def trace_count(self) -> int:
        """Group functions built: equals ``len(shape_keys)`` (one a
        (tier, bucket))."""
        return len(self._trace_events)

    # -- grouped training on the card ---------------------------------
    def _group_fn(self, tier: int, bucket: int) -> Callable:
        """The training function of one (tier, bucket) group: ``(params,
        x [B, nb, bs, F], y, mask) -> params stacked [B, ...]``."""
        key = (int(tier), int(bucket))
        fn = self._group_fns.get(key)
        if fn is not None:
            return fn
        epochs = int(tier) + 1
        lr = self.lr
        step_grad = torch.func.vmap(torch.func.grad(_linear_loss))

        def group_fn(params, x, y, mask):
            p = {k: v.expand((x.shape[0],) + tuple(v.shape)) for k, v in params.items()}
            for _ in range(epochs):
                for i in range(x.shape[1]):
                    g = step_grad(p, x[:, i], y[:, i], mask[:, i])
                    p = {k: p[k] - lr * g[k] for k in p}
            return p

        self._trace_events.append(epochs)
        self._group_fns[key] = group_fn
        return group_fn

    def _train_cohort(
        self, global_params: Dict[str, np.ndarray], part_ids: np.ndarray
    ) -> Tuple[Dict[int, np.ndarray], Dict[int, int]]:
        """Train every participant, grouped by speed tier and padded to
        pow2 buckets. Returns per-device flat float64 deltas (the leaf
        order of ``flatten_params``: ``b``, ``w``) and per-device packed
        sample counts. Padded slots repeat a real device: their deltas
        are dropped."""
        g = {k: torch.as_tensor(v, device=self.device) for k, v in global_params.items()}
        deltas: Dict[int, np.ndarray] = {}
        samples: Dict[int, int] = {}
        tiers = self.registry.speed_tier[part_ids]
        for tier in sorted(int(t) for t in np.unique(tiers)):
            tier_ids = part_ids[tiers == tier]
            bucket = bucket_cohort(len(tier_ids), "pow2")
            padded, _valid = pad_cohort_idx(tier_ids, bucket)
            self.shape_keys.add((tier, bucket))
            batches, ns = self.registry.materialize_group(
                padded, self.num_batches, self.batch_size,
                (self.feature_dim,), self.class_num, device=self.device,
            )
            stacked = self._group_fn(tier, bucket)(g, batches.x, batches.y, batches.mask)
            self.groups_trained += 1
            # trained - global in f32 on the card, then float64 on the host
            flat = torch.cat(
                [(stacked[k] - g[k][None]).reshape(bucket, -1) for k in g], dim=1
            ).cpu().numpy().astype(np.float64)
            for slot, did in enumerate(int(d) for d in tier_ids):
                deltas[did] = flat[slot]
                samples[did] = int(ns[slot])
        return deltas, samples

    # -- the report window --------------------------------------------
    def _on_offer(self, msg: Message) -> None:
        round_idx = int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX))
        participants = unpack_participants(msg.get(constants.MSG_ARG_KEY_PARTICIPANTS))
        scale = float(msg.get(constants.MSG_ARG_KEY_QUANT_SCALE))
        part_ids = np.fromiter(sorted(participants), dtype=np.int64)
        late_uploads: List[Message] = []
        if len(part_ids):
            t0 = time.perf_counter()
            global_params = decode_offer_params(msg.get(constants.MSG_ARG_KEY_MODEL_PARAMS))
            deltas, samples = self._train_cohort(global_params, part_ids)
            t1 = time.perf_counter()
            self.train_seconds += t1 - t0
            dim = next(iter(deltas.values())).shape[0]
            if self.secure_agg:
                self._deal_shares(round_idx, part_ids)
            for did in (int(d) for d in part_ids):
                q = quantize(deltas[did] * samples[did], scale)
                if self.secure_agg:
                    q = np.mod(
                        q + pairwise_mask_vector(did, self._secrets[did], participants, dim),
                        FIELD_PRIME,
                    )
                upload = Message(constants.MSG_TYPE_D2S_MASKED_UPLOAD, self.rank, 0)
                upload.add_params(constants.MSG_ARG_KEY_ROUND_INDEX, round_idx)
                upload.add_params(constants.MSG_ARG_KEY_DEVICE_ID, did)
                upload.add_params(constants.MSG_ARG_KEY_MASKED_DELTA, q)
                upload.add_params(constants.MSG_ARG_KEY_MASK_CHECKSUM, field_checksum(q))
                upload.add_params(constants.MSG_ARG_KEY_NUM_SAMPLES, samples[did])
                fault = device_event("device.upload", did, round_idx)
                kind = None if fault is None else fault["kind"]
                if kind == "bad_share":
                    # uploads fine now; poisons any share it reveals later
                    # for a vanished masker
                    self._bad_share.add(did)
                elif kind == "vanish":
                    if fault.get("after_close"):
                        late_uploads.append(upload)  # arrives after the close
                    continue  # churn: the upload never happens
                self.send_message(upload)
            self.mask_seconds += time.perf_counter() - t1
        self._send(
            constants.MSG_TYPE_D2S_WINDOW_TICK,
            {
                constants.MSG_ARG_KEY_ROUND_INDEX: round_idx,
                constants.MSG_ARG_KEY_WINDOW_PHASE: constants.DEVICE_WINDOW_REPORT,
            },
        )
        # the after_close flavor: the delta was computed in time but the
        # phone's radio came back after the window (FedBuff food)
        for upload in late_uploads:
            self.send_message(upload)

    def _deal_shares(self, round_idx: int, part_ids: np.ndarray) -> None:
        """Every participant Shamir-shares its round secret to the whole
        roster (device to device; the gateway holds no share). The holder
        at roster position k receives the share at point k+1."""
        n = len(part_ids)
        t = min(self.threshold, max(1, n - 1))
        for owner in (int(d) for d in part_ids):
            rng = np.random.default_rng(
                (int(self.registry.client_seed[owner]) * 31 + round_idx * 7 + 3) % (2**32)
            )
            shares = shamir_share(np.asarray(self._secrets[owner], dtype=np.int64), n, t, rng)
            for pos, holder in enumerate(int(d) for d in part_ids):
                if holder == owner:
                    continue
                self._held.setdefault(holder, {})[owner] = (pos + 1, int(shares[pos]))

    def _on_share_request(self, msg: Message) -> None:
        """Dropout recovery: the survivors reveal their shares of each
        vanished masker's secret. A ``bad_share`` device reveals a
        perturbed value, which the gateway's pubkey check must catch."""
        round_idx = int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX))
        vanished = np.asarray(msg.get(constants.MSG_ARG_KEY_DEVICE_ID), dtype=np.int64)
        folded = np.asarray(msg.get(constants.MSG_ARG_KEY_PARTICIPANTS), dtype=np.int64)
        reveals: Dict[int, List[Tuple[int, int]]] = {}
        for v in (int(x) for x in vanished):
            pairs: List[Tuple[int, int]] = []
            for holder in (int(h) for h in folded):
                entry = self._held.get(holder, {}).get(v)
                if entry is None:
                    continue
                point, value = entry
                if holder in self._bad_share:
                    value = (value + 1) % FIELD_PRIME
                pairs.append((point, value))
            reveals[v] = pairs
        self._send(
            constants.MSG_TYPE_D2S_SHARE_REVEAL,
            {
                constants.MSG_ARG_KEY_ROUND_INDEX: round_idx,
                constants.MSG_ARG_KEY_SHARE_REVEALS: pack_reveals(reveals),
            },
        )

    def _on_result(self, msg: Message) -> None:
        round_idx = int(msg.get(constants.MSG_ARG_KEY_ROUND_INDEX))
        if round_idx + 1 < self.rounds:
            self._begin_round(round_idx + 1)
        else:
            logging.info("device host: %d rounds done", self.rounds)
            self.finish()
