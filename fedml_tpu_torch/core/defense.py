"""On-arrival anomaly screening and rank quarantine (port of ``core/defense.py``).

The robust aggregators bound how far one upload can move the global
model; this module adds the identity layer of the reference fork's
S-FedAvg line: score every upload the moment it lands, keep a per-rank
reputation, and quarantine a rank whose reputation crosses
``defense_anomaly_threshold``: its uploads are rejected before folding
and it sits out ``defense_quarantine_rounds`` round closes (sync) or
publishes (async).

An upload's score combines its delta's norm excess over the median of
recently accepted norms with its cosine dissimilarity to the current
window's running aggregate (the first upload of a window gets a neutral
cosine: consecutive rounds anti-correlate near convergence).
``anomaly_score`` is the combination, bitwise the JAX package's on the
same host floats. Decisions depend on the arrival order (the running
aggregate does), so the stream == buffered guarantee holds with the
screen off (``defense_anomaly_threshold: 0``, the default).

The cross-silo aggregator (``cross_silo/horizontal/fedml_aggregator.py``)
calls it on every upload; the edge tier over ranks reports its trips to
the root, which decides the quarantine.
"""

from __future__ import annotations

import logging
import statistics
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch

from .. import constants
from .aggregation import Params, global_norm
from .compression import decode_delta


def delta_from(theta: Params, g: Params) -> Params:
    """Upload minus broadcast global, in f32: the tree every score is
    computed over."""
    return {k: theta[k].to(torch.float32) - g[k].to(torch.float32) for k in theta}


def decoded_delta(codec, encoded, like: Params) -> Params:
    """A compressed upload's f32 delta, for scoring (``like`` supplies
    shapes)."""
    return {k: v.to(torch.float32) for k, v in decode_delta(codec, encoded, like).items()}


def _norm_and_cos(delta: Params, ref: Params) -> Tuple[float, float]:
    """(||delta||, cos(delta, ref)) as host floats."""
    n, rn = global_norm(delta), global_norm(ref)
    dot = sum((delta[k].to(torch.float32) * ref[k].to(torch.float32)).sum() for k in delta)
    return float(n), float(dot / torch.clamp(n * rn, min=1e-12))


def anomaly_score(norm: float, cos: Optional[float], ref_norm: Optional[float]) -> float:
    """The score: neutral inputs (no reference yet) score 0. The cosine
    evidence is weighted by the upload's capacity to harm (its norm over
    the reference norm, capped at 4): a small, directionally noisy delta
    is no attack, while an attacker must ship mass to move the mean."""
    ratio = 1.0 if not ref_norm else min(norm / ref_norm, 4.0)
    norm_score = max(ratio - 1.0, 0.0)
    cos_score = 0.0
    if cos is not None:
        cos_score = min(max(1.0 - cos, 0.0), 2.0) / 2.0
    return 0.5 * norm_score + 0.5 * min(ratio, 1.0) * cos_score


class AnomalyScreen:
    """Per-rank reputation and quarantine state of one aggregation
    endpoint, keyed by aggregator index (rank - 1). Enabled iff
    ``defense_anomaly_threshold > 0``."""

    #: EWMA step of the reputation: one outlier moves a clean rank to 0.4x
    #: its score; two quarantine-grade uploads in a row reach 0.64x
    ALPHA = 0.4
    #: recent accepted norms; the reference magnitude is their median
    NORM_WINDOW = 16

    def __init__(self, args) -> None:
        self.threshold = float(getattr(args, "defense_anomaly_threshold", 0.0) or 0.0)
        self.quarantine_rounds = int(getattr(args, "defense_quarantine_rounds", 3))
        self.enabled = self.threshold > 0
        self._rep: Dict[int, float] = {}
        self._quarantined: Dict[int, int] = {}  # idx -> periods left
        # quarantined during the current period: its closing tick is not
        # served probation
        self._fresh: set = set()
        self._recent_norms = deque(maxlen=self.NORM_WINDOW)
        # a floor on the reference magnitude, so that converged norms near
        # zero do not read every ordinary step as a 4x anomaly: a quarter
        # of the clip radius with a clipping defense; without one, a
        # quarter of the peak window median seen
        self.norm_floor = (
            0.25 * float(getattr(args, "norm_bound", 5.0))
            if (getattr(args, "defense_type", None) or None)
            in (constants.DEFENSE_NORM_DIFF_CLIPPING, constants.DEFENSE_WEAK_DP)
            else None
        )
        self._peak_median = 0.0
        self.quarantines_total = 0

    @property
    def _ref_norm(self) -> Optional[float]:
        if not self._recent_norms:
            return None
        med = statistics.median(self._recent_norms)
        if self.norm_floor is not None:
            return max(med, self.norm_floor)
        self._peak_median = max(self._peak_median, med)
        return max(med, 0.25 * self._peak_median)

    def score_upload(self, delta: Params, running_ref: Optional[Params] = None,
                     staleness: int = 0) -> Tuple[float, float, Optional[float]]:
        """(score, norm, cos) of one upload delta. Without ``running_ref``
        (the window's first upload) the cosine is neutral. An update
        ``staleness`` publishes old is scored on ``norm / (1 +
        staleness)``, and that norm is returned (it feeds the window)."""
        if running_ref is None:
            norm, cos = float(global_norm(delta)), None
        else:
            norm, cos = _norm_and_cos(delta, running_ref)
        norm = norm / (1.0 + max(int(staleness), 0))
        return anomaly_score(norm, cos, self._ref_norm), norm, cos

    def observe(self, index: int, score: float, norm: float) -> bool:
        """Fold one upload's score into rank ``index``'s reputation. True:
        the rank just crossed the threshold, is quarantined, and this
        upload is rejected."""
        rep = (1.0 - self.ALPHA) * self._rep.get(index, 0.0) + self.ALPHA * score
        self._rep[index] = rep
        if rep >= self.threshold:
            self._quarantined[index] = self.quarantine_rounds
            self._fresh.add(index)
            self.quarantines_total += 1
            # a fresh slate on release
            self._rep[index] = 0.0
            logging.warning(
                "defense: rank index %d QUARANTINED for %d period(s) "
                "(reputation %.3f >= threshold %.3f; upload rejected)",
                index, self.quarantine_rounds, rep, self.threshold,
            )
            return True
        self._recent_norms.append(norm)
        return False

    def is_quarantined(self, index: int) -> bool:
        return index in self._quarantined

    def quarantined_indexes(self) -> List[int]:
        return sorted(self._quarantined)

    def reputation(self, index: int) -> float:
        return self._rep.get(index, 0.0)

    def tick(self) -> List[int]:
        """One probation period elapsed; returns the indexes released. The
        period a rank was quarantined in does not count."""
        released = []
        for idx in list(self._quarantined):
            if idx in self._fresh:
                self._fresh.discard(idx)
                continue
            self._quarantined[idx] -= 1
            if self._quarantined[idx] <= 0:
                del self._quarantined[idx]
                released.append(idx)
        if released:
            logging.info("defense: probation expired for rank index(es) %s", released)
        return released
