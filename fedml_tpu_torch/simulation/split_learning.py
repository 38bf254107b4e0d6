"""Split and vertical training: SplitNN, FedGKT, classical VFL (port of ``fedml_tpu/simulation/split_learning.py``).

- **SplitNN** (``split_nn``): the network is cut at a layer; a client
  owns the bottom, the server the top. Every batch, activations cross
  the boundary forward and their gradient crosses it back. Clients take
  turns around a ring (``(round + k) % C``), relaying one bottom model;
  the server's top model persists.
- **FedGKT** (``fedgkt``): each client trains a small personal
  extractor + head on its data (CE + alpha * KL against the server's
  logits, the KL off in round 0) and ships features, logits and labels;
  the server trains a deep net on the features (KL against the client
  logits + alpha * CE) and returns refreshed per-client logits. Client
  models are never averaged; their optimizer states persist.
- **Classical VFL** (``classical_vertical_fl``): features are split
  by columns across parties; each party runs a bottom net on its slice,
  the guest sums the representations, applies its top model and the
  loss, and returns the boundary gradient, the same for every party
  (the combiner is a sum).

Each boundary is an explicit autograd seam on the card: the activations
are detached into a leaf that requires grad, the top's gradient for
that leaf is computed with the top's own, and it is fed back through
the bottom's graph (``torch.autograd.grad(..., grad_outputs=...)``).
SplitNN and VFL step batch by batch, sequentially, as the protocol
does; FedGKT's personal client training is vmapped over the clients.

A fully padded batch changes nothing in the JAX package (params and
optimizer state are kept, its metrics are zero), so the sequential
loops skip the batches the host knows to be empty (the packed masks'
``nonempty``, read once), and the vmapped client loop the steps at
which every client is: the same result, without their launches.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.local_trainer import eval_batches_per_pass
from ..core.optimizers import sgd
from ..core.types import Batches
from ..device import get_device
from ..models.gkt import GKTClientNet, GKTServerNet
from ..models.spec import FedModel
from ..models.vfl import GuestTopModel, PartyLocalModel
from .round_loop import RoundLoop, host_sums, mean_of, nonempty_batches

Params = Dict[str, torch.Tensor]


def masked_ce(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
    """The masked mean cross-entropy and (correct, count) sums."""
    logp = torch.log_softmax(logits, dim=-1)
    per = -logp.gather(-1, y[..., None])[..., 0]
    count = mask.sum()
    loss = (per * mask).sum() / torch.clamp(count, min=1.0)
    correct = ((logits.argmax(dim=-1) == y).to(mask.dtype) * mask).sum()
    return loss, {"correct": correct, "count": count}


def kl_loss(student: torch.Tensor, teacher: torch.Tensor, mask: torch.Tensor,
            temperature: float) -> torch.Tensor:
    """KL(teacher || student) at temperature T, scaled by T^2, masked
    mean (the reference GKT's ``utils.KL_Loss``)."""
    t = temperature
    p_t = torch.softmax(teacher / t, dim=-1)
    per = (p_t * (torch.log_softmax(teacher / t, dim=-1)
                  - torch.log_softmax(student / t, dim=-1))).sum(dim=-1) * (t * t)
    return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _keep(cond, new, old):
    return pytree.tree_map(lambda a, b: torch.where(cond, a, b), new, old)


def _apply_sgd(opt, grads: Params, state, params: Params, nonempty=None):
    """One optimizer step; with ``nonempty`` (a device bool, under vmap)
    an empty batch keeps params and state."""
    updates, new_state = opt.update(grads, state, params)
    new = {k: params[k] + updates[k] for k in params}
    if nonempty is None:
        return new, new_state
    return _keep(nonempty, new, params), _keep(nonempty, new_state, state)



def _leaves(params: Params) -> Params:
    """Detached copies that require grad: the leaves of one step's graph."""
    return {k: v.detach().requires_grad_() for k, v in params.items()}


def _sums(parts: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    if not parts:
        return {}
    return {k: torch.stack([p[k] for p in parts]).sum() for k in parts[0]}


def _image_shape(dataset) -> Tuple[int, ...]:
    return tuple(dataset.packed_train.x.shape[-3:])


# ---------------------------------------------------------------------------
# SplitNN
# ---------------------------------------------------------------------------


class SplitNNAPI(RoundLoop):
    """Ring-relay split learning over the GKT pair (a GN ResNet cut after
    its first stage: ``GKTClientNet`` below, ``GKTServerNet`` with
    ``splitnn_stages`` above). No weight averaging: one bottom model is
    relayed around the client ring."""

    algorithm = "SplitNN"

    def __init__(self, args, device, dataset, model=None) -> None:
        self.args = args
        self.device = get_device(device)
        self.dataset = dataset
        self.history: List[Dict[str, float]] = []
        cls, shape = dataset.class_num, _image_shape(dataset)
        self.bottom = FedModel("splitnn_bottom",
                               GKTClientNet(cls, in_channels=shape[-1]).to(self.device),
                               example_shape=shape)
        stages = tuple(int(s) for s in getattr(args, "splitnn_stages", (1, 1, 1)))
        self.top = FedModel("splitnn_top", GKTServerNet(cls, stage_sizes=stages).to(self.device))
        init = torch.Generator().manual_seed(int(getattr(args, "random_seed", 0)))
        self.bottom_params = self.bottom.init(init)
        self.top_params = self.top.init(init)
        lr = float(getattr(args, "learning_rate", 0.1))
        mom = float(getattr(args, "momentum", 0.9))
        self.opt_b = sgd(lr, momentum=mom if mom else None)
        self.opt_t = sgd(lr, momentum=mom if mom else None)
        self.opt_b_state = self.opt_b.init(self.bottom_params)
        self.opt_t_state = self.opt_t.init(self.top_params)
        self.epochs = int(getattr(args, "epochs", 1))
        self._nonempty = nonempty_batches(dataset.packed_train.mask)

    def boundary_grads(self, pb: Params, pt: Params, x, y, m):
        """One batch through the split: (loss, metrics, the bottom's
        grads, the top's grads, the activations' grad)."""
        with torch.enable_grad():
            pb_l, pt_l = _leaves(pb), _leaves(pt)
            # -- the split boundary: activations forward
            feats, _ = self.bottom.apply(pb_l, x)
            acts = feats.detach().requires_grad_()
            # -- server side: the loss over the received activations
            loss, metrics = masked_ce(self.top.apply(pt_l, acts), y, m)
            grads = torch.autograd.grad(loss, [*pt_l.values(), acts])
            g_top, d_acts = dict(zip(pt_l, grads[:-1])), grads[-1]
            # -- the boundary gradient back into the client
            # the bottom's local head is off the path: its gradient is zero
            g_bottom = dict(zip(pb_l, torch.autograd.grad(
                feats, list(pb_l.values()), grad_outputs=d_acts, allow_unused=True,
                materialize_grads=True)))
        return loss.detach(), metrics, g_bottom, g_top, d_acts

    def _client_pass(self, ci: int) -> Dict[str, torch.Tensor]:
        packed = self.dataset.packed_train
        parts = []
        for _ in range(self.epochs):
            parts = []
            for i in np.flatnonzero(self._nonempty[ci]):
                x, y, m = packed.x[ci, i], packed.y[ci, i], packed.mask[ci, i]
                loss, metrics, g_b, g_t, _ = self.boundary_grads(
                    self.bottom_params, self.top_params, x, y, m)
                self.bottom_params, self.opt_b_state = _apply_sgd(
                    self.opt_b, g_b, self.opt_b_state, self.bottom_params)
                self.top_params, self.opt_t_state = _apply_sgd(
                    self.opt_t, g_t, self.opt_t_state, self.top_params)
                parts.append({"loss_sum": loss * metrics["count"], **metrics})
        return _sums(parts)

    def run_round(self, round_idx: int) -> Dict[str, torch.Tensor]:
        C = self.dataset.client_num
        # ring order: client round % C starts the relay this round
        parts = [self._client_pass(ci) for ci in ((round_idx + k) % C for k in range(C))]
        return _sums([p for p in parts if p])

    def evaluate(self, test: Batches) -> Dict[str, float]:
        parts = []
        with torch.no_grad():
            for i in range(test.mask.shape[0]):
                feats, _ = self.bottom.apply(self.bottom_params, test.x[i])
                loss, metrics = masked_ce(self.top.apply(self.top_params, feats), test.y[i],
                                          test.mask[i])
                parts.append({"loss_sum": loss * metrics["count"], **metrics})
        return host_sums(_sums(parts))

    def round_stats(self, round_idx: int, summed) -> Dict[str, float]:
        sums, ev = host_sums(summed), self.evaluate(self.dataset.test_data_global)
        return {"train_loss": mean_of(sums, "loss_sum"), "test_acc": mean_of(ev, "correct"),
                "test_loss": mean_of(ev, "loss_sum")}


# ---------------------------------------------------------------------------
# FedGKT
# ---------------------------------------------------------------------------


class FedGKTAPI(RoundLoop):
    """Group Knowledge Transfer: personal client nets (``client_params``,
    stacked ``[C, ...]``) + one deep server net trained on the exchanged
    features and logits. args: ``gkt_alpha`` (the KD mix),
    ``gkt_temperature``, ``gkt_server_epochs``, ``gkt_server_stages``."""

    algorithm = "FedGKT"

    def __init__(self, args, device, dataset, model=None) -> None:
        self.args = args
        self.device = get_device(device)
        self.dataset = dataset
        self.history: List[Dict[str, float]] = []
        cls, shape = dataset.class_num, _image_shape(dataset)
        self.client = FedModel("gkt_client",
                               GKTClientNet(cls, in_channels=shape[-1]).to(self.device),
                               example_shape=shape)
        stages = tuple(int(s) for s in getattr(args, "gkt_server_stages", (2, 2, 2)))
        self.server = FedModel("gkt_server", GKTServerNet(cls, stage_sizes=stages).to(self.device))
        self.alpha = float(getattr(args, "gkt_alpha", 1.0))
        self.temperature = float(getattr(args, "gkt_temperature", 3.0))
        self.epochs = int(getattr(args, "epochs", 1))
        self.server_epochs = int(getattr(args, "gkt_server_epochs", 1))
        lr = float(getattr(args, "learning_rate", 0.03))

        C = dataset.client_num
        init = torch.Generator().manual_seed(int(getattr(args, "random_seed", 0)))
        self.server_params = self.server.init(init)
        # personal client models, each its own draw: [C, ...]
        per = [self.client.init(init) for _ in range(C)]
        self.client_params = {k: torch.stack([p[k] for p in per]) for k in per[0]}
        nb, bs = dataset.packed_train.mask.shape[-2:]
        self.server_logits = torch.zeros((C, nb, bs, cls), device=self.device)
        self.opt_c = sgd(lr, momentum=0.9)
        self.opt_s = sgd(lr, momentum=0.9)
        self.opt_s_state = self.opt_s.init(self.server_params)
        # the personal optimizers persist across rounds (the reference's
        # GKTClientTrainer builds its SGD once)
        self.opt_c_states = self.init_client_states()
        self._client_grad = torch.func.grad_and_value(self._client_loss, has_aux=True)
        self._client_step = torch.func.vmap(self._client_step_one,
                                            in_dims=(0, 0, 0, 0, 0, 0, None))
        self._nonempty = nonempty_batches(dataset.packed_train.mask)

    def init_client_states(self):
        """Fresh personal optimizer states for ``client_params``."""
        C = self.dataset.client_num
        first = {k: v[0] for k, v in self.client_params.items()}
        return pytree.tree_map(lambda t: t.expand((C,) + tuple(t.shape)).clone(),
                               self.opt_c.init(first))

    def _client_loss(self, p, x, y, m, teacher, kd_weight):
        _, logits = self.client.apply(p, x)
        ce, metrics = masked_ce(logits, y, m)
        kd = kl_loss(logits, teacher, m, self.temperature)
        return ce + self.alpha * kd_weight * kd, metrics

    def _client_step_one(self, p, s, x, y, m, teacher, kd_weight):
        grads, (loss, metrics) = self._client_grad(p, x, y, m, teacher, kd_weight)
        p, s = _apply_sgd(self.opt_c, grads, s, p, m.sum() > 0)
        return p, s, {"loss_sum": loss * metrics["count"], **metrics}

    def _server_grads(self, ps, f, teacher, y, m):
        """One server batch: (grads, loss, metrics) of KL(client logits)
        + alpha * CE, by plain autograd (the sequential loop needs no
        ``torch.func`` transform, whose per-op cost is the host's)."""
        with torch.enable_grad():
            leaves = _leaves(ps)
            out = self.server.apply(leaves, f)
            ce, metrics = masked_ce(out, y, m)
            loss = kl_loss(out, teacher, m, self.temperature) + self.alpha * ce
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return dict(zip(leaves, grads)), loss.detach(), metrics

    def _extract(self, pc: Params, x: torch.Tensor):
        """Features and logits of every local sample of every client:
        ``[C, nb, bs, ...]`` each."""
        C, nb, bs = x.shape[:3]
        flat = x.reshape((C, nb * bs) + tuple(x.shape[3:]))
        with torch.no_grad():
            feats, logits = torch.func.vmap(self.client.apply)(pc, flat)
        return (feats.reshape((C, nb, bs) + tuple(feats.shape[2:])),
                logits.reshape(C, nb, bs, -1))

    def run_round(self, round_idx: int) -> Dict[str, torch.Tensor]:
        packed = self.dataset.packed_train
        C, nb = packed.mask.shape[:2]
        kd_weight = 0.0 if round_idx == 0 else 1.0
        # 1) personal client training, every client every round
        pc, sc = self.client_params, self.opt_c_states
        for _ in range(self.epochs):
            sums = {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
            # the steps at which some client holds a real batch
            for i in np.flatnonzero(self._nonempty.any(axis=0)):
                pc, sc, m = self._client_step(pc, sc, packed.x[:, i], packed.y[:, i],
                                              packed.mask[:, i], self.server_logits[:, i],
                                              kd_weight)
                sums = {k: sums[k] + m[k] for k in sums}
        self.client_params, self.opt_c_states = pc, sc
        client_sums = {k: v.sum() for k, v in sums.items()}
        # 2) the feature and logit exchange
        feats, client_logits = self._extract(pc, packed.x)
        # 3) the server's epochs over every client's batches, [C * nb]
        sf = feats.reshape((C * nb,) + tuple(feats.shape[2:]))
        sl = client_logits.reshape((C * nb,) + tuple(client_logits.shape[2:]))
        sy, sm = packed.y.reshape(C * nb, -1), packed.mask.reshape(C * nb, -1)
        ps, ss = self.server_params, self.opt_s_state
        for _ in range(self.server_epochs):
            parts = []
            for b in np.flatnonzero(self._nonempty.reshape(-1)):
                grads, loss, metrics = self._server_grads(ps, sf[b], sl[b], sy[b], sm[b])
                ps, ss = _apply_sgd(self.opt_s, grads, ss, ps)
                parts.append({"loss_sum": loss * metrics["count"], **metrics})
        self.server_params, self.opt_s_state = ps, ss
        server_sums = _sums(parts)
        # 4) refreshed per-client server logits, the next round's teachers
        with torch.no_grad():
            flat = feats.reshape((C * nb * feats.shape[2],) + tuple(feats.shape[3:]))
            per = max(1, eval_batches_per_pass(packed) * int(feats.shape[2]))
            out = torch.cat([self.server.apply(ps, flat[i:i + per])
                             for i in range(0, flat.shape[0], per)])
        self.server_logits = out.reshape(self.server_logits.shape).to(self.server_logits.dtype)
        return {**client_sums, **{f"server_{k}": v for k, v in server_sums.items()}}

    def evaluate(self) -> Dict[str, float]:
        """Each client's extractor, then the server net, on the client's
        own test batches (the reference's server-side test)."""
        test = self.dataset.packed_test
        parts = []
        with torch.no_grad():
            for c in range(test.mask.shape[0]):
                pc = {k: v[c] for k, v in self.client_params.items()}
                for i in range(test.mask.shape[1]):
                    f, _ = self.client.apply(pc, test.x[c, i])
                    loss, metrics = masked_ce(self.server.apply(self.server_params, f),
                                              test.y[c, i], test.mask[c, i])
                    parts.append({"loss_sum": loss * metrics["count"], **metrics})
        return host_sums(_sums(parts))

    def round_stats(self, round_idx: int, summed) -> Dict[str, float]:
        sums, ev = host_sums(summed), self.evaluate()
        return {"train_loss": mean_of(sums, "loss_sum"),
                "server_loss": mean_of(sums, "server_loss_sum", "server_count"),
                "test_acc": mean_of(ev, "correct"), "test_loss": mean_of(ev, "loss_sum")}


# ---------------------------------------------------------------------------
# Classical VFL
# ---------------------------------------------------------------------------


def vertical_split(x: np.ndarray, n_parties: int) -> List[np.ndarray]:
    """Flattened features split column-wise across parties (the
    NUS-WIDE / lending-club feature split)."""
    flat = x.reshape(x.shape[0], -1)
    cols = np.array_split(np.arange(flat.shape[1]), n_parties)
    return [flat[:, c] for c in cols]


class VFLAPI(RoundLoop):
    """Classical vertical FL: the guest and ``vfl_parties - 1`` hosts.
    Real party CSVs (``party_K.csv`` under ``data_cache_dir/<dataset>``,
    the loader's ``vfl_parties``) are the split when present; else the
    loaded dataset's global features are split by columns."""

    algorithm = "VFL"

    def __init__(self, args, device, dataset, model=None) -> None:
        self.args = args
        self.device = get_device(device)
        self.dataset = dataset
        self.history: List[Dict[str, float]] = []
        self.n_parties = int(getattr(args, "vfl_parties", 2))
        rep_dim = int(getattr(args, "vfl_rep_dim", 32))
        cls = dataset.class_num
        lr = float(getattr(args, "learning_rate", 0.05))
        self.epochs = int(getattr(args, "epochs", 1))
        real = getattr(dataset, "vfl_parties", None) or self._try_load_party_csvs(args)
        if real is not None:
            # each organization's columns ARE the split
            feats, labels = real
            self.n_parties = len(feats)
            cls = max(cls, int(labels.max()) + 1)
            self._train, self._test = self._pack_party_data(
                feats, labels, int(getattr(args, "batch_size", 32)))
        else:
            self._train = self._split_batches(dataset.train_data_global)
            self._test = self._split_batches(dataset.test_data_global)
        self.party = [FedModel(f"vfl_party_{k}", PartyLocalModel(
            int(self._train[0][k].shape[-1]), output_dim=rep_dim).to(self.device))
            for k in range(self.n_parties)]
        self.top = FedModel("vfl_top", GuestTopModel(rep_dim, cls).to(self.device))
        init = torch.Generator().manual_seed(int(getattr(args, "random_seed", 0)))
        self.party_params = [m.init(init) for m in self.party]
        self.top_params = self.top.init(init)
        self.opt = sgd(lr)
        self.opt_states = [self.opt.init(p) for p in self.party_params]
        self.opt_top_state = self.opt.init(self.top_params)
        self._nonempty = nonempty_batches(self._train[2])

    @staticmethod
    def _try_load_party_csvs(args):
        from ..data.ingest import load_vfl_party_csvs, vfl_party_csvs_available

        cache = getattr(args, "data_cache_dir", None)
        name = str(getattr(args, "dataset", "")).lower()
        if not cache or not name:
            return None
        d = os.path.join(cache, name)
        return load_vfl_party_csvs(d) if vfl_party_csvs_available(d) else None

    def _pack_party_data(self, feats, labels, batch_size: int):
        """Row-aligned party arrays -> two (xs, y, mask) batch sets, split
        by ``ingest.vfl_train_test_split``, the loader's own split of the
        same CSVs, so the two views never share test rows."""
        from ..data.ingest import vfl_train_test_split

        f_tr, y_tr, f_te, y_te = vfl_train_test_split(
            feats, labels, int(getattr(self.args, "random_seed", 0)))

        def pack(split_feats, split_labels):
            m = len(split_labels)
            nb = max(1, -(-m // batch_size))
            pad = nb * batch_size - m
            xs = []
            for sl in split_feats:
                if pad:
                    sl = np.concatenate([sl, np.zeros((pad,) + sl.shape[1:], sl.dtype)])
                xs.append(torch.as_tensor(sl.reshape(nb, batch_size, -1), device=self.device))
            y = split_labels
            if pad:
                y = np.concatenate([y, np.zeros(pad, y.dtype)])
            mask = np.concatenate([np.ones(m, np.float32), np.zeros(pad, np.float32)])
            return (xs, torch.as_tensor(y.reshape(nb, batch_size), device=self.device),
                    torch.as_tensor(mask.reshape(nb, batch_size), device=self.device))

        return pack(f_tr, y_tr), pack(f_te, y_te)

    def _split_batches(self, b: Batches):
        """``[nb, bs, ...]`` -> (the party slices ``[nb, bs, d_k]``, y, mask)."""
        nb, bs = b.mask.shape
        flat = b.x.reshape(nb * bs, -1)
        cols = np.array_split(np.arange(flat.shape[1]), self.n_parties)
        return ([flat[:, int(c[0]):int(c[-1]) + 1].reshape(nb, bs, -1) for c in cols],
                b.y, b.mask)

    def boundary_grads(self, xs, y, m):
        """One batch: (loss, metrics, each party's grads, the top's grads,
        the boundary gradient every party receives)."""
        with torch.enable_grad():
            leaves = [_leaves(p) for p in self.party_params]
            reps = [self.party[k].apply(leaves[k], xs[k]) for k in range(self.n_parties)]
            rep_sum = sum(r.detach() for r in reps).requires_grad_()
            top = _leaves(self.top_params)
            loss, metrics = masked_ce(self.top.apply(top, rep_sum), y, m)
            grads = torch.autograd.grad(loss, [*top.values(), rep_sum])
            g_top, d_rep = dict(zip(top, grads[:-1])), grads[-1]
            # the same boundary gradient to every party
            g_party = [dict(zip(leaves[k], torch.autograd.grad(
                reps[k], list(leaves[k].values()), grad_outputs=d_rep)))
                for k in range(self.n_parties)]
        return loss.detach(), metrics, g_party, g_top, d_rep

    def run_round(self, round_idx: int) -> Dict[str, torch.Tensor]:
        xs, y, m = self._train
        for _ in range(self.epochs):
            parts = []
            for i in np.flatnonzero(self._nonempty):
                loss, metrics, g_party, g_top, _ = self.boundary_grads(
                    [x[i] for x in xs], y[i], m[i])
                for k in range(self.n_parties):
                    self.party_params[k], self.opt_states[k] = _apply_sgd(
                        self.opt, g_party[k], self.opt_states[k], self.party_params[k])
                self.top_params, self.opt_top_state = _apply_sgd(
                    self.opt, g_top, self.opt_top_state, self.top_params)
                parts.append({"loss_sum": loss * metrics["count"], **metrics})
        return _sums(parts)

    def evaluate(self) -> Dict[str, float]:
        xs, y, m = self._test
        parts = []
        with torch.no_grad():
            for i in range(m.shape[0]):
                rep = sum(self.party[k].apply(self.party_params[k], xs[k][i])
                          for k in range(self.n_parties))
                loss, metrics = masked_ce(self.top.apply(self.top_params, rep), y[i], m[i])
                parts.append({"loss_sum": loss * metrics["count"], **metrics})
        return host_sums(_sums(parts))

    def round_stats(self, round_idx: int, summed) -> Dict[str, float]:
        sums, ev = host_sums(summed), self.evaluate()
        return {"train_loss": mean_of(sums, "loss_sum"), "test_acc": mean_of(ev, "correct"),
                "test_loss": mean_of(ev, "loss_sum"), "parties": self.n_parties}
