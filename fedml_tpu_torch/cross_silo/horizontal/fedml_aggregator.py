"""Server-side aggregation state for cross-silo rounds (port of
``fedml_tpu/cross_silo/horizontal/fedml_aggregator.py``).

Parity with ``python/fedml/cross_silo/horizontal/fedml_aggregator.py:15-153``:
collect per-client results, check-all-received, weighted aggregate, the
``data_silo_selection`` / ``client_selection`` split that lets N real
edge devices map onto M data silos, and deterministic per-round
sampling.

**Streaming aggregate-on-arrival**: with ``agg_mode: stream`` (the
default) each upload is folded into the O(model) exact accumulator
(``core.aggregation.StreamingAccumulator``: one launch of the exact
fold kernel K1 per upload) the moment it lands, so server memory stops
scaling with the cohort and the post-barrier aggregate is a finalize.
The fold is order-independent, so streaming results are bitwise equal
to ``agg_mode: buffered`` (which folds its sorted buffer through the
same accumulator). Aggregations that need the whole cohort at once
(``defense_type: median`` or a custom ``ServerAggregator``) fall back to
the buffered path LOUDLY: one warning plus the
``agg_stream_fallback_total`` counter. ``agg_mode: async`` (FedBuff-
style, see the server manager) folds with staleness-discounted weights
through the same accumulator.

**Byzantine robustness on the streaming path**: ``norm_diff_clipping``
and ``weak_dp`` are per-upload defenses and ride the fold: each upload's
delta is clipped against the broadcast global in its term (one launch
of the robust term kernel K3, as is each int8-encoded upload's decode)
before accumulation (``defense_clipped_total``), and weak-DP noise is
drawn once at finalize from a run-seed + round seeded generator
(``core.aggregation.derive_defense_rng``). The buffered close folds
through the same clipped terms, so stream == buffered stays bitwise and
``agg_stream_fallback_total`` stays 0. On top, the optional on-arrival
anomaly screen (``core/defense.py`` ``AnomalyScreen``) scores every
upload, keeps a per-rank reputation and QUARANTINES ranks past
``defense_anomaly_threshold``: their uploads are rejected before
folding and the server manager excludes them from cohorts until the
probation (``defense_quarantine_rounds``) expires.

Every tree lives on the model's device: networked uploads (numpy on
arrival) are moved there once (``reconcile_to_device``); the initial
params are ``model.init(torch.Generator().manual_seed(random_seed))``,
the simulator's convention, so cross-silo equals the simulation from
round 0.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ... import constants
from ...core.aggregation import (
    RobustAggregator,
    StreamingAccumulator,
    derive_defense_rng,
    needs_full_cohort,
    normalize_weights,
    reconcile_to_device,
    stack_pytrees,
)
from ...core.frame import bind_operator
from ...core.local_trainer import compute_dtype_from_args, make_eval_fn

Params = Dict[str, torch.Tensor]


class FedMLAggregator:
    def __init__(self, args, model, test_data=None, server_aggregator=None) -> None:
        self.args = args
        self.model = model
        self.device = model.device
        self.test_data = test_data
        self.server_aggregator = bind_operator(server_aggregator, model, args)
        self._agg_round = 0
        self.client_num = int(args.client_num_per_round)
        self._expected = None  # set per round via begin_round (elastic)
        self.sample_num_dict: Dict[int, float] = {}
        self.flag_client_model_uploaded_dict: Dict[int, bool] = {}
        # the simulator's init convention (FedAvgAPI.__init__), so
        # cross-silo and simulation runs start from the same params
        seed = int(getattr(args, "random_seed", 0))
        self.global_params: Params = model.init(torch.Generator().manual_seed(seed))
        self._eval = make_eval_fn(
            model.apply, model.loss_fn, compute_dtype=compute_dtype_from_args(args)
        )
        from ...core.compression import make_codec
        from ...core.defense import AnomalyScreen
        from ...core.telemetry import Telemetry

        self._tel = Telemetry.get_instance(args)
        self._codec = make_codec(args)
        self.agg_mode = str(getattr(args, "agg_mode", "stream"))
        # RobustAggregator construction validates defense_type /
        # norm_bound / stddev loudly; needs_full_cohort rejects unknown
        # strings too, so a typo never aggregates undefended
        self._robust = (
            RobustAggregator(args)
            if (getattr(args, "defense_type", None) or None) is not None
            else None
        )
        # clipping/weak_dp stream per upload; median/custom stay buffered
        self._clip_streaming = self._robust is not None and (
            self._robust.defense_type
            in (constants.DEFENSE_NORM_DIFF_CLIPPING, constants.DEFENSE_WEAK_DP)
        )
        self.screen = AnomalyScreen(args)
        self.defense_clipped = 0  # uploads whose clip bound actually bit
        self.defense_rejected = 0  # uploads rejected by quarantine
        # buffered/fallback modes have no accumulator until close, so the
        # screen's cosine reference is this weighted sum of accepted
        # deltas (cosine is scale-invariant)
        self._screen_ref: Optional[Params] = None
        self._fallback_reason = needs_full_cohort(args, self.server_aggregator)
        if self.agg_mode == "async" and self._fallback_reason:
            raise ValueError(
                "agg_mode=async requires the incremental fold but "
                f"{self._fallback_reason}; use agg_mode=buffered with a "
                "synchronous round loop instead"
            )
        self.streaming = (
            self.agg_mode in ("stream", "async") and self._fallback_reason is None
        )
        if self.agg_mode == "stream" and self._fallback_reason is not None:
            # loud one-time fallback: the operator asked for streaming
            # and is getting the buffered path
            logging.warning(
                "agg_mode=stream falling back to the BUFFERED aggregation "
                "path: %s (counted in agg_stream_fallback_total)",
                self._fallback_reason,
            )
            self._tel.inc("agg_stream_fallback_total")
        self._acc: Optional[StreamingAccumulator] = None
        # the in-process edge tier (scale/tree.py): with edge_num >= 2
        # each rank's upload folds into its edge's accumulator and
        # aggregate() finalizes through the root merge, bitwise the flat
        # fold. Sync streaming only (async folds deltas against a moving
        # global). With edge_plane=ranks the edges are real processes
        # (cross_silo/hierarchical) that each run a flat accumulator,
        # and the root merges: building the tree here too would nest
        # the tiers
        edge_num = int(getattr(args, "edge_num", 0) or 0)
        self._tree = None
        if (
            edge_num >= 2
            and self.streaming
            and self.agg_mode == "stream"
            and str(getattr(args, "edge_plane", "inproc")) != "ranks"
        ):
            from ...scale.tree import EdgeAggregationTree

            self._tree = EdgeAggregationTree(self.global_params, edge_num)
        # raw/encoded payloads awaiting a buffered aggregate; streaming
        # never fills it
        self._pending: Dict[int, Tuple[str, Params, float]] = {}
        self._folded: Set[int] = set()
        self.peak_buffered = 0  # max simultaneous buffered uploads
        self.folds_total = 0  # lifetime incremental folds

    def get_global_model_params(self) -> Params:
        return self.global_params

    def set_global_model_params(self, params: Params) -> None:
        self.global_params = reconcile_to_device(params, self.device)

    def _accumulator(self, index: int = 0) -> StreamingAccumulator:
        """The accumulator upload ``index`` folds into: its edge's with
        the in-process tree, else the one flat accumulator."""
        if self._tree is not None:
            return self._tree.acc_for(index)
        if self._acc is None:
            self._acc = StreamingAccumulator(self.global_params)
        return self._acc

    def _running_mean(self) -> Optional[Params]:
        if self._tree is not None:
            return self._tree.running_mean()
        return self._acc.running_mean() if self._acc is not None else None

    def receive_upload(
        self,
        index: int,
        sample_num: float,
        model_params: Optional[Params] = None,
        encoded=None,
        weight_scale: float = 1.0,
    ) -> str:
        """One client upload landed: fold it NOW (streaming) or buffer it
        (buffered / full-cohort fallback). Returns ``"folded"`` /
        ``"buffered"`` / ``"duplicate"`` / ``"quarantined"``, so the
        manager can route a rejected rank through the drop-expected path.

        Exactly one of ``model_params`` (full tree) / ``encoded``
        (compressed delta against the current global) is given;
        ``weight_scale`` discounts the sample weight (1.0 in sync modes)."""
        if index in self._folded:
            # the incremental fold enforces at-most-once per (rank, round)
            # itself: a duplicate would otherwise fold twice
            self._tel.inc("agg_dup_uploads_ignored_total")
            logging.info(
                "duplicate upload from index %d ignored (already folded "
                "this round)", index,
            )
            return "duplicate"
        payload = model_params if model_params is not None else encoded
        payload = reconcile_to_device(payload, self.device)
        w = float(sample_num) * float(weight_scale)
        if self.screen.enabled and self._screen_upload(
            index, payload, raw=model_params is not None, delta_mode=False, w=w,
        ):
            return "quarantined"
        if self.streaming:
            if self._clip_streaming:
                bound = self._robust.norm_bound
                if model_params is not None:
                    _, clipped = self._accumulator(index).fold_clipped(
                        payload, self.global_params, bound, w
                    )
                else:
                    _, clipped = self._accumulator(index).fold_encoded_clipped(
                        self._codec, payload, self.global_params, bound, w
                    )
                self._note_clipped(clipped)
            elif model_params is not None:
                self._accumulator(index).fold(payload, w)
            else:
                self._accumulator(index).fold_encoded(
                    self._codec, payload, self.global_params, w
                )
            self.folds_total += 1
            self._tel.inc("agg_folds_total", mode=self.agg_mode)
        else:
            self._pending[index] = (
                "raw" if model_params is not None else "enc", payload, w,
            )
            self.peak_buffered = max(self.peak_buffered, len(self._pending))
            self._tel.set_gauge("agg_peak_buffered", self.peak_buffered)
        self._folded.add(index)
        self.sample_num_dict[index] = float(sample_num)
        self.flag_client_model_uploaded_dict[index] = True
        return "folded" if self.streaming else "buffered"

    # -- defense plumbing (clip counters + anomaly screen) ------------
    def _note_clipped(self, clipped: bool) -> None:
        if clipped:
            self.defense_clipped += 1
            self._tel.inc("defense_clipped_total")

    def _screen_upload(self, index: int, payload, raw: bool, delta_mode: bool,
                       staleness: int = 0, w: float = 1.0) -> bool:
        """Score one upload for the anomaly screen; True -> REJECT (the
        rank is quarantined, already or by this upload). ``delta_mode``:
        the payload is an update delta (async) rather than a full model;
        ``staleness`` makes the screen staleness-aware. With a codec this
        decodes the payload a second time (the fold decodes again in its
        term): scoring must happen before folding, and the extra pass
        exists only when screening is on."""
        from ...core.defense import decoded_delta, delta_from

        if self.screen.is_quarantined(index):
            self.defense_rejected += 1
            self._tel.inc("defense_quarantined_rejected_total")
            logging.warning(
                "defense: rejecting upload from quarantined index %d", index
            )
            return True
        if delta_mode:
            d = payload if raw else decoded_delta(self._codec, payload, self.global_params)
            running = self._acc.running_mean() if self._acc is not None else None
        else:
            d = (
                delta_from(payload, self.global_params)
                if raw
                else decoded_delta(self._codec, payload, self.global_params)
            )
            rm = self._running_mean() if self.streaming else None
            running = (
                delta_from(rm, self.global_params)
                if rm is not None
                else (None if self.streaming else self._screen_ref)
            )
        score, norm, _cos = self.screen.score_upload(d, running, staleness=staleness)
        self._tel.observe(
            "defense_anomaly_score_ratio", score,
            buckets=(0.05, 0.1, 0.2, 0.4, 0.8, 1.6),
        )
        if self.screen.observe(index, score, norm):
            self.defense_rejected += 1
            self._tel.inc("defense_quarantined_total", rank=index + 1)
            self._tel.inc("defense_quarantined_rejected_total")
            return True
        if not delta_mode and not self.streaming:
            term = {k: w * v for k, v in d.items()}
            self._screen_ref = (
                term if self._screen_ref is None
                else {k: self._screen_ref[k] + term[k] for k in term}
            )
        return False

    def quarantined_ranks(self):
        """Transport ranks currently quarantined (excluded from
        broadcasts and the quorum denominator)."""
        return {i + 1 for i in self.screen.quarantined_indexes()}

    def tick_defense(self):
        """One probation period elapsed (round close / async publish).
        Returns the released aggregator indexes."""
        if not self.screen.enabled:
            return []
        return self.screen.tick()

    def _apply_weak_dp(self, params: Params) -> Params:
        """Weak-DP noise at finalize, from a run-seed + round seeded
        generator; a custom ``ServerAggregator`` owns its whole
        reduction, so it is exempt."""
        if (
            self._robust is None
            or self._robust.defense_type != constants.DEFENSE_WEAK_DP
            or self.server_aggregator is not None
        ):
            return params
        rng = derive_defense_rng(
            getattr(self.args, "random_seed", 0), self._agg_round, self.device
        )
        self._tel.inc("defense_noise_rounds_total")
        return self._robust.add_noise(params, rng)

    def add_local_trained_result(self, index: int, model_params: Params,
                                 sample_num: float) -> str:
        """(fedml_aggregator.py:58-63) the reference's entry point; routes
        through ``receive_upload`` and returns its status."""
        return self.receive_upload(index, sample_num, model_params=model_params)

    # -- async (FedBuff-style) fold/publish ---------------------------
    def fold_delta(self, sample_num: float, delta: Optional[Params] = None,
                   encoded=None, weight_scale: float = 1.0,
                   index: Optional[int] = None, staleness: int = 0) -> str:
        """Fold a staleness-discounted update DELTA (async mode) into the
        buffer that the next publish applies to whatever the global model
        is then. With clipping the delta is clipped before the staleness
        weight applies; with ``index`` and the screen on the upload is
        scored first and may come back ``"quarantined"``."""
        payload = delta if delta is not None else encoded
        payload = reconcile_to_device(payload, self.device)
        w = float(sample_num) * float(weight_scale)
        if (
            index is not None
            and self.screen.enabled
            and self._screen_upload(
                index, payload, raw=delta is not None, delta_mode=True,
                staleness=staleness, w=w,
            )
        ):
            return "quarantined"
        if self._clip_streaming:
            bound = self._robust.norm_bound
            if delta is not None:
                _, clipped = self._accumulator().fold_delta_clipped(payload, bound, w)
            else:
                _, clipped = self._accumulator().fold_encoded_delta_clipped(
                    self._codec, payload, self.global_params, bound, w
                )
            self._note_clipped(clipped)
        elif delta is not None:
            self._accumulator().fold(payload, w)
        else:
            self._accumulator().fold_encoded_delta(
                self._codec, payload, self.global_params, w
            )
        self.folds_total += 1
        self._tel.inc("agg_folds_total", mode=self.agg_mode)
        return "folded"

    def pending_folds(self) -> int:
        return 0 if self._acc is None else self._acc.count

    def publish_async(self) -> Params:
        """Close the async buffer: global += weighted-mean folded delta.
        A no-op when nothing folded since the last publish. Weak-DP
        noise (if configured) lands on each published global."""
        if self.pending_folds() == 0:
            return self.global_params
        mean_delta = self._acc.finalize()
        self.global_params = {
            k: g + mean_delta[k].to(g.dtype) for k, g in self.global_params.items()
        }
        self.global_params = self._apply_weak_dp(self.global_params)
        self._agg_round += 1
        self._reset_window()
        return self.global_params

    def check_whether_all_receive(self) -> bool:
        """(fedml_aggregator.py:65-71)"""
        expected = self._expected if self._expected is not None else range(self.client_num)
        for idx in expected:
            if not self.flag_client_model_uploaded_dict.get(idx, False):
                return False
        for idx in expected:
            self.flag_client_model_uploaded_dict[idx] = False
        return True

    def num_received(self) -> int:
        return len(self._folded)

    def folded_indexes(self) -> List[int]:
        """Aggregator indexes (rank - 1) folded/buffered this round: the
        WAL's per-round folded set."""
        return sorted(self._folded)

    def missing_indexes(self) -> List[int]:
        if self._expected is None:
            return []
        return sorted(set(self._expected) - self._folded)

    def drop_expected(self, index: int) -> bool:
        """Remove a leaver's PENDING slot from the round's expected set.
        A leaver that already uploaded keeps its slot. True only when a
        pending slot was dropped."""
        if self._expected is None or index not in self._expected:
            return False
        if self.flag_client_model_uploaded_dict.get(index, False):
            return False
        self._expected.discard(index)
        self.client_num = len(self._expected)
        return True

    def quorum_target(self, frac: float) -> int:
        """Folds that satisfy a quorum of ``frac`` over the CURRENT
        cohort (``drop_expected`` shrinks it when a rank dies)."""
        return max(1, math.ceil(float(frac) * self.client_num))

    def quorum_met(self, frac: float) -> bool:
        return len(self._folded) >= self.quorum_target(frac)

    def begin_round(self, expected_indexes) -> None:
        """Declare which client indexes this round was broadcast to."""
        self._expected = set(int(i) for i in expected_indexes)
        self.client_num = len(self._expected)

    def _reconstructed_pending(self) -> List[Tuple[int, Params, float]]:
        from ...core.compression import reconstruct_from_encoded

        out = []
        for i in sorted(self._pending):
            kind, payload, w = self._pending[i]
            if kind == "enc":
                payload = reconstruct_from_encoded(self._codec, payload, self.global_params)
            out.append((i, payload, w))
        return out

    def aggregate(self) -> Params:
        """Close the aggregation window over whatever folded (a quorum or
        deadline close aggregates a subset; weights renormalize).
        Streaming: a finalize (plus weak-DP noise). Buffered: the sorted
        buffer through the SAME folds, clipped terms included, so the two
        modes are bitwise equal. Full-cohort fallback (median / custom
        aggregator): the stacked reduction."""
        if not self._folded:
            raise RuntimeError("aggregate() with no received models")
        if self.streaming:
            acc = self._tree if self._tree is not None else self._acc
            self.global_params = self._apply_weak_dp(acc.finalize())
        elif self._fallback_reason is not None:
            idxs_trees = self._reconstructed_pending()
            stacked = stack_pytrees([t for _, t, _ in idxs_trees])
            ns = torch.tensor([w for _, _, w in idxs_trees], device=self.device)
            weights = normalize_weights(ns)
            rng = derive_defense_rng(
                getattr(self.args, "random_seed", 0), self._agg_round, self.device
            )
            if self.server_aggregator is not None:
                # the L3 operator seam (core/frame.py): a custom reduction
                self.global_params = self.server_aggregator.aggregate(
                    self.global_params, stacked, weights, rng
                )
            else:
                self.global_params = self._robust.aggregate(
                    stacked, weights, self.global_params, rng=rng
                )
        else:
            acc = StreamingAccumulator(self.global_params)
            bound = self._robust.norm_bound if self._clip_streaming else None
            for i in sorted(self._pending):
                kind, payload, w = self._pending[i]
                if bound is not None:
                    if kind == "enc":
                        _, clipped = acc.fold_encoded_clipped(
                            self._codec, payload, self.global_params, bound, w
                        )
                    else:
                        _, clipped = acc.fold_clipped(payload, self.global_params, bound, w)
                    self._note_clipped(clipped)
                elif kind == "enc":
                    acc.fold_encoded(self._codec, payload, self.global_params, w)
                else:
                    acc.fold(payload, w)
                self.folds_total += 1
                self._tel.inc("agg_folds_total", mode=self.agg_mode)
            self.global_params = self._apply_weak_dp(acc.finalize())
        self._agg_round += 1
        self._reset_window()
        return self.global_params

    # -- the edge tier over ranks (cross_silo/hierarchical) -----------
    def export_fold_state(self) -> dict:
        """The edge -> root merge payload: this window's fold state (the
        exact 3-limb expansion as per-leaf numpy trees, the weight total
        and the count) WITHOUT finalizing; the root merges the limbs
        through the same exact fold, so the federation's finalize is
        bitwise a flat fold of the same uploads. Streaming mode only."""
        if not self.streaming or self._tree is not None:
            raise RuntimeError(
                "export_fold_state() needs the flat streaming accumulator "
                "(agg_mode=stream, no in-process edge tree)"
            )
        if self._acc is None or self._acc.count == 0:
            # an edge whose whole partition died/left ships an empty
            # report; the root skips the merge
            return {"limbs": [], "total_w": 0.0, "count": 0}
        return self._acc.export_state()

    def reset_window(self) -> None:
        """Close a round WITHOUT finalizing here (the edge tier finalizes
        at the root): advance the round counter and clear the window."""
        self._agg_round += 1
        self._reset_window()

    def _reset_window(self) -> None:
        if self._acc is not None:
            self._acc.reset()
        if self._tree is not None:
            self._tree.reset()
        self._screen_ref = None
        self._pending.clear()
        self._folded.clear()
        self.sample_num_dict.clear()
        self.flag_client_model_uploaded_dict.clear()

    # -- selection (fedml_aggregator.py:103-153) ----------------------
    def data_silo_selection(self, round_idx: int, data_silo_num_in_total: int,
                            client_num_in_total: int) -> List[int]:
        """Which data silos train this round: one silo index per
        participating client."""
        if data_silo_num_in_total == client_num_in_total:
            return list(range(data_silo_num_in_total))
        # a local RandomState: the reference's np.random.seed(round_idx)
        # draws, without touching the global generator
        return (
            np.random.RandomState(round_idx)
            .choice(range(data_silo_num_in_total), client_num_in_total, replace=False)
            .tolist()
        )

    def client_selection(self, round_idx: int, client_id_list_in_total: List,
                         client_num_per_round: int) -> List:
        """Which REAL clients participate (client-id indirection,
        fedml_server_manager.py:33)."""
        if client_num_per_round >= len(client_id_list_in_total):
            return list(client_id_list_in_total)
        return (
            np.random.RandomState(round_idx)
            .choice(client_id_list_in_total, client_num_per_round, replace=False)
            .tolist()
        )

    def test_on_server_for_all_clients(self, round_idx: int) -> Optional[Dict]:
        if self.test_data is None:
            return None
        sums = self._eval(self.global_params, self.test_data)
        stats = self.model.metrics_from_sums(sums)
        logging.info("server eval round %d: %s", round_idx, stats)
        self.last_stats = stats
        return stats
