"""The fork's poisoning defenses, S-FedAvg and HS-FedAvg (port of
``fedml_tpu/simulation/defenses.py``).

- **S-FedAvg** (``simulation/single_process/s_fedavg/fedavg_api.py`` of
  the reference): after each round the server estimates every cohort
  member's Shapley value on a validation set it holds (Monte-Carlo over
  permutations until the estimate settles, ``_is_approached``), updates
  the reputation ``phi = alpha * phi + beta * sv``, and samples the next
  round's cohort with probability ``exp(phi)``. One permutation's prefix
  sweep is one computation on the card: the prefix aggregates are a
  cumulative weighted sum along the permuted client axis, and the C
  prefix models are evaluated on the validation batches at once with
  ``torch.func.vmap`` over ``functional_call``. The permutations come
  from a generator seeded by (run seed, round), the port's own stream
  (the JAX package seeds its from ``jax.random``); ``_post_round_stacked``
  takes a list of permutations instead, so that a test drives both
  packages through the same ones. The sampling draws from
  ``RandomState(round_idx)``, bitwise the JAX package's given ``phi``.
- **HS-FedAvg** (``hs_fedavg/hs_fft.py``): every training image's
  low-frequency amplitude band (half-width ``floor(min(H, W) * L)`` around
  the centred DC; ``L = 0`` keeps the DC alone) is replaced by a running
  mean amplitude spectrum kept with momentum in ``server_state``, its
  phases kept; padding is left as it is. ``torch.fft.fft2`` over the H and
  W axes of the NHWC cohort, inside the round.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.aggregation import normalize_weights
from ..core.types import Batches
from .fedavg_api import FedAvgAPI

Params = Dict[str, torch.Tensor]


def _take_batches(b: Batches, n: int) -> Batches:
    return Batches(x=b.x[:n], y=b.y[:n], mask=b.mask[:n])


class SFedAvgAPI(FedAvgAPI):
    """Shapley-value client scoring (S-FedAvg).

    Knobs: ``sfedavg_alpha`` / ``sfedavg_beta`` (the reputation EMA),
    ``sampling_filter`` (``"exp"`` samples by ``exp(phi)``),
    ``score_method`` (``"acc" | "F1" | "Recall" | "Precision"``),
    ``target_label`` (the class watched for a backdoor), ``sv_max_perms``
    (the permutation cap, ``client_num_per_round ** 2`` by default),
    ``sv_tol`` (the convergence limit), ``valid_batches`` (global test
    batches held out as the server's validation set)."""

    algorithm = "SFedAvg"
    _keep_stacked = True

    def __init__(self, args, device, dataset, model) -> None:
        super().__init__(args, device, dataset, model)
        K = dataset.client_num
        self.alpha = float(getattr(args, "sfedavg_alpha", 0.5))
        self.beta = float(getattr(args, "sfedavg_beta", 0.5))
        self.sampling_filter = getattr(args, "sampling_filter", "exp")
        self.score_method = str(getattr(args, "score_method", "acc"))
        self.target_label = getattr(args, "target_label", None)
        self.sv_tol = float(getattr(args, "sv_tol", 0.005))
        cap = getattr(args, "sv_max_perms", None)
        self.sv_max_perms = int(cap if cap is not None else int(args.client_num_per_round) ** 2)
        nval = int(getattr(args, "valid_batches", 4))
        test = self.dataset.test_data_global
        self.val_data = _take_batches(test, max(1, min(nval, test.mask.shape[0])))
        # the reputation state
        self.phi = np.full((K,), 1.0 / K, dtype=np.float64)
        self.sv = np.full((K,), (1.0 - self.alpha) / (K * self.beta), dtype=np.float64)
        self.sv_history: List[Dict[str, float]] = []

    # -- scoring ------------------------------------------------------
    def _score(self, params: Params, x: torch.Tensor, y: torch.Tensor,
               m: torch.Tensor) -> torch.Tensor:
        """One model's score on the validation examples (flat)."""
        pred = torch.argmax(self.model.apply(params, x), dim=-1)
        correct = ((pred == y).to(m.dtype) * m).sum()
        acc = correct / torch.clamp(m.sum(), min=1.0)
        tgt = self.target_label
        if tgt is None or self.score_method in ("acc", "Accuracy"):
            return acc
        is_t = (y == tgt).to(m.dtype) * m
        pred_t = (pred == tgt).to(m.dtype) * m
        tp = (is_t * pred_t).sum()
        fp = ((1 - (y == tgt).to(m.dtype)) * pred_t * m).sum()
        fn = (is_t * (1 - (pred == tgt).to(m.dtype))).sum()
        prec = tp / torch.clamp(tp + fp, min=1.0)
        rec = tp / torch.clamp(tp + fn, min=1.0)
        if self.score_method in ("Precision", "PPV", "ppv"):
            return prec
        if self.score_method in ("Sensitivity", "Recall", "TPR", "tpr"):
            return rec
        return 2.0 * prec * rec / torch.clamp(prec + rec, min=1e-12)

    def _shapley_perm(self, stacked: Params, weights: torch.Tensor, perm: torch.Tensor,
                      val: Batches) -> torch.Tensor:
        """One permutation's marginal contributions ``[C]``, in cohort
        slot order: the C prefix aggregates along ``perm`` scored on
        ``val`` at once."""
        w = weights.index_select(0, perm)
        cw = torch.cumsum(w, dim=0)

        def prefix(leaf: torch.Tensor) -> torch.Tensor:
            shape = (-1,) + (1,) * (leaf.dim() - 1)
            s = leaf.index_select(0, perm)
            wr, cwr = w.reshape(shape).to(leaf.dtype), cw.reshape(shape).to(leaf.dtype)
            return torch.cumsum(wr * s, dim=0) / torch.clamp(cwr, min=1e-12)

        prefix_models = {k: prefix(v) for k, v in stacked.items()}
        x = val.x.reshape((-1,) + tuple(val.x.shape[2:]))
        y = val.y.reshape((-1,) + tuple(val.y.shape[2:]))
        m = val.mask.reshape(-1)
        with torch.no_grad():
            scores = torch.func.vmap(lambda p: self._score(p, x, y, m))(prefix_models)
        marg = scores - torch.cat([torch.zeros(1, dtype=scores.dtype, device=scores.device),
                                   scores[:-1]])
        # back to cohort slot order: slot perm[j] gets marg[j] (a gather,
        # deterministic on the card)
        return marg.index_select(0, torch.argsort(perm))

    def _is_approached(self, d: List[float], cohort: int) -> bool:
        """The reference's convergence test: keep drawing permutations?"""
        if len(d) >= self.sv_max_perms:
            return False
        if len(d) <= cohort:
            return True
        return any(x >= self.sv_tol for x in d[-3:])

    def _post_round_stacked(self, stacked: Params, idx: np.ndarray, round_idx: int,
                            perms: Optional[Sequence[Sequence[int]]] = None) -> None:
        """Estimate the cohort's Shapley values and update the reputation.
        The permutations are ``perms`` in order when given, else drawn from
        a generator seeded by (run seed, ``round_idx``)."""
        C = int(len(idx))
        counts = torch.as_tensor(np.asarray(self.dataset.packed_num_samples)[np.asarray(idx)],
                                 dtype=torch.float32, device=self.device)
        weights = normalize_weights(counts)
        seed = int(getattr(self.args, "random_seed", 0))
        perm_rng = np.random.default_rng([seed, int(round_idx)])
        given = iter(perms) if perms is not None else None
        sv_est = np.zeros((C,), dtype=np.float64)
        cnt = 0
        d: List[float] = []
        while self._is_approached(d, C):
            p = next(given) if given is not None else perm_rng.permutation(C)
            perm = torch.as_tensor(np.asarray(p), dtype=torch.int64, device=self.device)
            sv_new = self._shapley_perm(stacked, weights, perm, self.val_data).cpu().numpy()
            sv_next = (cnt * sv_est + sv_new) / (cnt + 1)
            if cnt:
                d.append(float(np.linalg.norm(sv_next - sv_est)))
            sv_est = sv_next
            cnt += 1
        for j, client_idx in enumerate(np.asarray(idx)):
            self.sv[client_idx] = sv_est[j]
            self.phi[client_idx] = self.alpha * self.phi[client_idx] + self.beta * self.sv[client_idx]
        self.sv_history.append(
            {"perms": cnt, "sv_mean": float(sv_est.mean()), "phi_min": float(self.phi.min())})
        logging.debug("S-FedAvg: %d permutations, sv=%s", cnt, sv_est)

    # -- checkpoint hooks: the reputation state -----------------------
    def _extra_checkpoint_state(self):
        return {"phi": torch.from_numpy(self.phi.copy()), "sv": torch.from_numpy(self.sv.copy())}

    def _restore_extra_state(self, extra) -> None:
        if extra is not None:
            self.phi = np.asarray(extra["phi"].numpy(), dtype=np.float64)
            self.sv = np.asarray(extra["sv"].numpy(), dtype=np.float64)

    # -- reputation-biased sampling -----------------------------------
    def _client_sampling(self, round_idx, client_num_in_total, client_num_per_round):
        if client_num_in_total == client_num_per_round:
            return np.arange(client_num_in_total, dtype=np.int32)
        if self.sampling_filter == "exp":
            p = np.exp(self.phi)
        else:
            p = np.ones((client_num_in_total,))
        p = p / (p.sum() + 1e-13)
        rs = np.random.RandomState(round_idx)
        return np.asarray(
            rs.choice(range(client_num_in_total), client_num_per_round, replace=False, p=p),
            dtype=np.int32,
        )


def make_hs_normalizer(h: int, w: int, L: float, momentum: float):
    """The FFT amplitude normalization: ``normalize(x, mask, running_amp)
    -> (x', running_amp')`` with ``x`` ``[..., H, W, C]`` and the
    per-example ``mask`` of shape ``x.shape[:-3]``; the band is
    ``floor(min(H, W) * L)`` around the fftshifted centre."""
    b = int(np.floor(min(h, w) * L))
    ch, cw = h // 2, w // 2
    band_np = np.zeros((h, w, 1), np.float32)
    band_np[max(ch - b, 0): ch + b + 1, max(cw - b, 0): cw + b + 1] = 1.0
    band_cpu = torch.from_numpy(band_np)

    def normalize(x: torch.Tensor, mask: torch.Tensor, running_amp: torch.Tensor,
                  total=None):
        """``total`` sums the amplitude spectrum's sum and the image count
        over the ranks holding the rest of the cohort (a mesh's lanes)."""
        band = band_cpu.to(x.device)
        xf = x.to(torch.float32)
        fft = torch.fft.fft2(xf, dim=(-3, -2))
        amp, pha = fft.abs(), fft.angle()
        mexp = mask.reshape(tuple(mask.shape) + (1, 1, 1)).to(torch.float32)
        lead = tuple(range(mask.dim()))
        amp_sum, count = (amp * mexp).sum(dim=lead), mexp.sum()
        if total is not None:
            amp_sum, count = total(amp_sum), total(count)
        batch_amp = amp_sum / torch.clamp(count, min=1.0)
        new_running = torch.where(
            running_amp.sum() == 0.0,
            batch_amp,
            running_amp * (1.0 - momentum) + batch_amp * momentum,
        )
        a_src = torch.fft.fftshift(amp, dim=(-3, -2))
        a_trg = torch.fft.fftshift(new_running, dim=(0, 1))
        a_new = a_src * (1.0 - band) + a_trg * band
        fft_new = torch.fft.ifftshift(a_new, dim=(-3, -2)) * torch.exp(1j * pha)
        x_new = torch.fft.ifft2(fft_new, dim=(-3, -2)).real
        return torch.where(mexp > 0, x_new, xf).to(x.dtype), new_running

    return normalize


class HSFedAvgAPI(FedAvgAPI):
    """FFT amplitude-spectrum input normalization (HS-FedAvg). The running
    amplitude spectrum is the server state; the cohort's images are
    normalized in the round before local training. Knobs: ``hs_L`` (band
    ratio; 0 keeps the DC term alone) and ``hs_momentum``. Needs the
    vectorized mode and image data."""

    algorithm = "HSFedAvg"

    def __init__(self, args, device, dataset, model) -> None:
        shape = dataset.packed_train.x.shape
        if len(shape) != 6:
            raise ValueError("HS-FedAvg needs image data [C, nb, bs, H, W, ch]")
        self._img_hw = (int(shape[-3]), int(shape[-2]), int(shape[-1]))
        self._normalize = make_hs_normalizer(
            self._img_hw[0], self._img_hw[1],
            float(getattr(args, "hs_L", 0.0)), float(getattr(args, "hs_momentum", 0.1)),
        )
        super().__init__(args, device, dataset, model)

    def _init_server_state(self):
        return torch.zeros(self._img_hw, dtype=torch.float32, device=self.device)

    def _preprocess(self, cohort: Batches, server_state):
        # on a mesh ``cohort`` is this rank's lane: the spectrum is the
        # whole cohort's
        total = None if self.mesh is None else self.mesh.lane_total
        x_new, new_amp = self._normalize(cohort.x, cohort.mask, server_state, total)
        return Batches(x=x_new, y=cohort.y, mask=cohort.mask), new_amp
