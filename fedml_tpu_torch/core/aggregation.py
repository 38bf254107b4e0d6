"""Server-side aggregation (port of ``core/aggregation.py``).

"A set of client models" is one params dict whose tensors carry a
leading client axis ``C`` (``stack_pytrees``), the layout the local
trainer returns; FedAvg is then one weighted sum over that axis on the
device.

The exact part keeps the JAX package's bits: ``exact_weighted_mean``
and the streaming fold (``StreamingAccumulator``) accumulate per-client
terms ``t = fl32(w * theta)``, each rounded once, into a 3-limb float32
expansion with Knuth two-sums, so the result does not depend on the
order of the folds nor on how they were split across accumulators
(stream == buffered, tree == flat, bitwise). The fold runs in
``ops/exact_fold.py`` (a hand-written kernel on the card, whose adds are
never contracted into FMAs; the plain version on the CPU). An
accumulator keeps its limbs as one flat f32 buffer ``[3, N]`` over the
model's leaves in the template's order, so a fold is one launch
whatever the number of leaves, and several terms fold in one launch in
the order of their one-by-one folds (``fold_weighted_terms``);
``export_state`` still hands out per-leaf trees. ``AccumulatorBank``
lays E accumulators' limbs out as the rows of one ``[E, 3, N]`` buffer,
so that a term for each folds in one launch and all of them merge into
another accumulator in one launch (an edge tree's two hops).

The encoded and clipped folds (quantized uplinks, norm-diff clipping)
arrive with the robust-aggregation planes (ROADMAP.md, queue A item 7).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..ops import exact_fold
from . import devtime

Params = Dict[str, torch.Tensor]

_LATER_FOLDS = "arrives with the robust-aggregation planes (ROADMAP.md, queue A item 7)"


def stack_pytrees(trees: Sequence[Params]) -> Params:
    """[params, params, ...] -> params with leading axis C."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def unstack_pytrees(stacked: Params, count: int) -> List[Params]:
    return [{k: v[i] for k, v in stacked.items()} for i in range(count)]


def normalize_weights(
    sample_nums: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Sample counts -> normalized FedAvg weights. ``valid`` ([C] in
    {0,1}) zeroes the weight of padded cohort slots."""
    w = sample_nums.to(torch.float32)
    if valid is not None:
        w = w * valid.to(torch.float32)
    return w / torch.clamp(w.sum(), min=1.0)


def weighted_average(stacked: Params, weights: torch.Tensor) -> Params:
    """FedAvg: sum_c w_c * theta_c; ``weights`` already normalized."""

    def avg(leaf: torch.Tensor) -> torch.Tensor:
        w = weights.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)
        return (w * leaf).sum(dim=0)

    return {k: avg(v) for k, v in stacked.items()}


# ---------------------------------------------------------------------
# The exact fold (the JAX package's ``_two_sum`` / ``_fold_leaf`` /
# ``_fold_tree``, ``exact_weighted_mean`` and ``StreamingAccumulator``)
# ---------------------------------------------------------------------

_two_sum = exact_fold.two_sum
_fold_leaf = exact_fold.fold_leaf


def _fold_tree(limbs: torch.Tensor, term: torch.Tensor) -> torch.Tensor:
    """Fold an already-weighted term (``[N]``, or ``[K, N]`` folded in
    row order) into the flat expansion ``limbs`` ``[3, N]``, in place;
    returns ``limbs``. Adds only: the term's multiply happened where the
    term was made (``_weighted_term``)."""
    exact_fold.fold(limbs, term)
    return limbs


def exact_weighted_mean(stacked: Params, weights: torch.Tensor) -> Params:
    """Placement-independent weighted mean over a stacked client axis:
    per leaf, the terms ``fl32(w_c * theta_c)`` folded in client-index
    order into the 3-limb expansion and collapsed ``(s0 + s1) + s2``, in
    the leaf's dtype; bitwise the JAX package's. One kernel launch a
    leaf on the card."""
    w32 = weights.to(torch.float32)

    def leaf_mean(leaf: torch.Tensor) -> torch.Tensor:
        C = leaf.shape[0]
        flat = leaf.reshape(C, -1)
        if flat.dtype not in (torch.float32, torch.bfloat16):
            flat = flat.to(torch.float32)
        return exact_fold.weighted_mean(flat, w32).reshape(leaf.shape[1:]).to(leaf.dtype)

    return {k: leaf_mean(v) for k, v in stacked.items()}


class _FlatSpec:
    """The leaves of a params dict laid end to end as one f32 vector: each
    leaf's name, shape, dtype and [start, stop) span."""

    def __init__(self, template: Params) -> None:
        self.names = list(template)
        self.shapes = [tuple(template[k].shape) for k in self.names]
        self.dtypes = [template[k].dtype for k in self.names]
        sizes = [int(np.prod(s)) for s in self.shapes]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self.numel = int(self.offsets[-1])
        first = next(iter(template.values()), None)
        self.device = first.device if first is not None else torch.device("cpu")

    def flatten(self, tree: Params) -> torch.Tensor:
        """``tree`` (the template's leaves) as one ``[N]`` f32 tensor."""
        if set(tree) != set(self.names):
            raise ValueError(f"tree holds {sorted(tree)}, the template {sorted(self.names)}")
        leaves = [torch.as_tensor(tree[k], device=self.device).reshape(-1) for k in self.names]
        if not leaves:
            return torch.zeros(0, dtype=torch.float32, device=self.device)
        return torch.cat([v.to(torch.float32) for v in leaves])

    def views(self, flat: torch.Tensor) -> Params:
        """Per-leaf views of a flat ``[..., N]`` tensor (leading axes kept)."""
        lead = tuple(flat.shape[:-1])
        return {
            k: flat[..., int(a):int(b)].reshape(lead + s)
            for k, s, a, b in zip(self.names, self.shapes, self.offsets[:-1], self.offsets[1:])
        }


def _weighted_term(spec: _FlatSpec, theta: Params, w: float) -> torch.Tensor:
    """``t = fl32(w) * theta``, rounded once per element, as one flat
    ``[N]`` f32 tensor: a pure function of (theta, w), whatever the
    order uploads arrive in."""
    return spec.flatten(theta) * float(np.float32(w))


def _tree_scaled(tree: Params, denom) -> Params:
    return {k: v / denom for k, v in tree.items()}


class StreamingAccumulator:
    """Incremental weighted-sum fold over model uploads: O(model)
    memory, order-independent finalize.

    ``fold(theta, w)`` the moment an upload lands; ``finalize()`` once
    the round closes returns ``sum_i w_i * theta_i / sum_i w_i`` in the
    template's dtypes, on the template's device — weights renormalize
    over whatever was folded, so a quorum-closed partial cohort needs no
    special casing. The buffered path folds its sorted buffer through
    this same class, which is what makes buffered and streaming
    bit-identical.

    The limbs are one ``[3, N]`` f32 buffer (``_limbs``), updated in
    place by each fold; ``limbs`` hands in that buffer (a row of an
    ``AccumulatorBank``'s), else the accumulator allocates it. ``reset``
    and ``load_state`` write into it and never rebind it.
    """

    def __init__(self, template: Params, limbs: Optional[torch.Tensor] = None) -> None:
        self._template = template
        self._spec = _FlatSpec(template)
        shape = (3, self._spec.numel)
        if limbs is None:
            limbs = torch.zeros(shape, dtype=torch.float32, device=self._spec.device)
        elif tuple(limbs.shape) != shape or limbs.dtype != torch.float32:
            raise ValueError(f"limbs {limbs.dtype} {tuple(limbs.shape)}; want float32 {shape}")
        self._limbs = limbs
        self.reset()

    def _flat(self, term: Union[Params, torch.Tensor]) -> torch.Tensor:
        if isinstance(term, torch.Tensor):
            if term.shape[-1] != self._spec.numel:
                raise ValueError(
                    f"term of {term.shape[-1]} elements; the template has {self._spec.numel}"
                )
            return term.to(device=self._spec.device, dtype=torch.float32)
        return self._spec.flatten(term)

    def fold(self, theta: Params, w: float) -> None:
        with devtime.measure("agg.weighted_term"):
            term = _weighted_term(self._spec, theta, w)
        self._fold_term(term, w)

    def fold_weighted_term(self, term: Union[Params, torch.Tensor], w: float) -> None:
        """Fold an ALREADY-WEIGHTED partial sum ``term = sum_i w_i *
        theta_i`` (a params dict, or its flat ``[N]`` f32 layout) carrying
        total weight ``w = sum_i w_i``: the registry loop's client -> edge
        hop, where a group's per-edge partial sum was rounded once where
        it was computed."""
        self._fold_term(self._flat(term), w)

    def fold_encoded(self, codec, encoded, like, w: float) -> None:
        raise NotImplementedError(f"StreamingAccumulator.fold_encoded {_LATER_FOLDS}")

    def fold_encoded_delta(self, codec, encoded, like, w: float) -> None:
        raise NotImplementedError(f"StreamingAccumulator.fold_encoded_delta {_LATER_FOLDS}")

    def fold_clipped(self, theta, against, bound: float, w: float):
        raise NotImplementedError(f"StreamingAccumulator.fold_clipped {_LATER_FOLDS}")

    def fold_encoded_clipped(self, codec, encoded, like, bound: float, w: float):
        raise NotImplementedError(f"StreamingAccumulator.fold_encoded_clipped {_LATER_FOLDS}")

    def fold_delta_clipped(self, delta, bound: float, w: float):
        raise NotImplementedError(f"StreamingAccumulator.fold_delta_clipped {_LATER_FOLDS}")

    def fold_encoded_delta_clipped(self, codec, encoded, like, bound: float, w: float):
        raise NotImplementedError(
            f"StreamingAccumulator.fold_encoded_delta_clipped {_LATER_FOLDS}"
        )

    def running_mean(self) -> Optional[Params]:
        """Approximate mean of everything folded so far (top limb only —
        a scoring aid, NOT the exact finalize). None before the first
        fold."""
        if self.count == 0:
            return None
        top = self._spec.views(self._limbs[0])
        return _tree_scaled(top, torch.tensor(self.total_w, dtype=torch.float32))

    def export_state(self) -> dict:
        """Wire-portable snapshot of the fold state: the exact 3-limb f32
        expansion as per-leaf numpy trees, the folded weight total and
        the fold count. No rounding happens at export (the fetch is
        byte-exact), so merging a ``load_state``-restored shell is
        bitwise merging the live accumulator. The snapshot is a copy:
        the limbs it came from are reset and refolded in place."""
        host = self._limbs.detach().cpu().numpy().copy()
        return {
            "limbs": [
                {k: np.asarray(v) for k, v in self._spec.views(torch.from_numpy(host[i])).items()}
                for i in range(3)
            ],
            "total_w": float(self.total_w),
            "count": int(self.count),
        }

    def load_state(self, state: dict) -> "StreamingAccumulator":
        """Restore an ``export_state`` snapshot (per-leaf numpy or tensor
        trees) onto this accumulator; the template must match the
        exporter's. The limbs arrive unchanged."""
        limbs = state["limbs"]
        if len(limbs) != 3:
            raise ValueError(
                f"edge fold state carries {len(limbs)} limbs, expected 3"
            )
        self._limbs.copy_(torch.stack([self._spec.flatten(
            {k: torch.as_tensor(np.asarray(v)) for k, v in limb.items()}) for limb in limbs]))
        self.total_w = float(state["total_w"])
        self.count = int(state["count"])
        return self

    def fold_limbs(self, limbs, w: float, count: int = 1) -> None:
        """Fold an exported 3-limb expansion carrying total weight ``w``
        over ``count`` underlying uploads (``merge``'s edge -> root hop
        routes through here). ``limbs`` is a sequence of three per-leaf
        trees or flat ``[N]`` tensors, or one ``[3, N]`` tensor; the three
        fold in order as terms, in one launch, bitwise the same as three
        folds. ``w``/``count`` add exactly."""
        if len(limbs) != 3:
            raise ValueError(f"expected a 3-limb expansion, got {len(limbs)}")
        if count < 0:
            raise ValueError(
                f"count={count}: a limb-set represents >= 0 uploads"
            )
        terms = limbs if isinstance(limbs, torch.Tensor) else torch.stack(
            [self._flat(limb) for limb in limbs])
        with devtime.measure("agg.fold_tree"):
            _fold_tree(self._limbs, terms.to(self._limbs.device))
        self.total_w += float(w)
        self.count += int(count)

    def merge(self, other: "StreamingAccumulator") -> None:
        """Fold another accumulator's state into this one — the edge ->
        root hop of a two-tier aggregation tree (``scale/tree.py``). The
        float32 finalize stays bitwise independent of how uploads were
        partitioned across accumulators (tree == flat)."""
        self.fold_limbs(other._limbs, other.total_w, count=other.count)

    def fold_weighted_terms(self, terms: torch.Tensor, weights: Sequence[float]) -> int:
        """Fold the rows of ``terms`` ``[E, N]`` whose weight in ``weights``
        (E host floats) is > 0, in row order, each an already-weighted
        partial sum carrying that weight, in one launch: bitwise
        ``fold_weighted_term`` of each in turn (the registry loop's flat
        fold of a group). Returns the rows folded."""
        hit = [e for e, w in enumerate(weights) if w > 0.0]
        if hit:
            terms = terms.to(device=self._spec.device, dtype=torch.float32)
            with devtime.measure("agg.fold_tree"):
                exact_fold.fold_set(self._limbs, terms.unsqueeze(1), exact_fold.edge_mask(hit))
        for e in hit:
            self._count_fold(weights[e])
        return len(hit)

    def _fold_term(self, term: torch.Tensor, w: float) -> None:
        with devtime.measure("agg.fold_tree"):
            _fold_tree(self._limbs, term)
        self._count_fold(w)

    def _count_fold(self, w: float) -> None:
        # float32 first (the term used fl32(w)); python-float sums of
        # integer sample counts are exact in any order
        self.total_w += float(np.float32(w))
        self.count += 1

    def finalize(self) -> Params:
        """Weighted average of everything folded so far. The limbs
        collapse on the host in extended precision (``np.longdouble``:
        80-bit on x86-64, else float64) so the final float32 rounding
        sees the exact expansion value."""
        if self.count == 0:
            raise RuntimeError("finalize() with no folded uploads")
        wide = np.longdouble
        host = self._limbs.detach().cpu().numpy()
        acc = (
            np.asarray(host[0], dtype=wide)
            + np.asarray(host[1], dtype=wide)
            + np.asarray(host[2], dtype=wide)
        )
        spec = self._spec
        out = torch.from_numpy((acc / wide(self.total_w)).astype(np.float32)).to(spec.device)
        return {k: v.to(dt) for (k, v), dt in zip(spec.views(out).items(), spec.dtypes)}

    def reset(self) -> None:
        self._limbs.zero_()
        # python float: sample counts are integers, exactly summed in
        # float64 in any order
        self.total_w = 0.0
        self.count = 0


class AccumulatorBank:
    """E ``StreamingAccumulator``s over one ``[E, 3, N]`` f32 limb buffer,
    accumulator ``e``'s limbs its row ``e``: the term for each of them
    folds in one launch (``fold_terms``) and all of them merge into
    another accumulator in one launch (``merge_into``), each bitwise the
    one-by-one folds and merges. ``bank[e]`` is accumulator ``e``, with
    every ``fold*`` of its own."""

    def __init__(self, template: Params, count: int) -> None:
        spec = _FlatSpec(template)
        self._limbs = torch.zeros((int(count), 3, spec.numel), dtype=torch.float32,
                                  device=spec.device)
        self._accs = [StreamingAccumulator(template, limbs=row) for row in self._limbs]

    def __getitem__(self, e: int) -> StreamingAccumulator:
        return self._accs[e]

    @property
    def count(self) -> int:
        return sum(a.count for a in self._accs)

    @property
    def total_w(self) -> float:
        return float(sum(a.total_w for a in self._accs))

    def fold_terms(self, terms: torch.Tensor, weights: Sequence[float]) -> int:
        """Fold row ``e`` of ``terms`` ``[E, N]`` (an already-weighted
        partial sum) into accumulator ``e`` for every ``e`` whose weight in
        ``weights`` (E host floats) is > 0, in one launch: bitwise
        ``self[e].fold_weighted_term(terms[e], weights[e])`` for each.
        Returns the accumulators folded into."""
        hit = [e for e, w in enumerate(weights) if w > 0.0]
        if hit:
            terms = terms.to(device=self._limbs.device, dtype=torch.float32)
            with devtime.measure("agg.fold_tree"):
                exact_fold.fold_edges(self._limbs, terms, exact_fold.edge_mask(hit))
        for e in hit:
            self._accs[e]._count_fold(weights[e])
        return len(hit)

    def merge_into(self, root: StreamingAccumulator) -> int:
        """``root.merge`` of every accumulator that holds a fold, in index
        order, in one launch and bitwise those merges. Returns the
        accumulators merged."""
        hit = [e for e, a in enumerate(self._accs) if a.count]
        if hit:
            with devtime.measure("agg.fold_tree"):
                exact_fold.fold_set(root._limbs, self._limbs, exact_fold.edge_mask(hit))
        for e in hit:
            root.total_w += float(self._accs[e].total_w)
            root.count += self._accs[e].count
        return len(hit)

    def running_mean(self) -> Optional[Params]:
        """Top-limb mean over every accumulator (same contract as
        ``StreamingAccumulator.running_mean``)."""
        if self.count == 0:
            return None
        total = None
        for a in self._accs:
            if a.count:
                total = a._limbs[0] if total is None else total + a._limbs[0]
        w = torch.tensor(self.total_w, dtype=torch.float32)
        return {k: v / w for k, v in self._accs[0]._spec.views(total).items()}

    def reset(self) -> None:
        for acc in self._accs:
            acc.reset()


def staleness_weight(sample_num: float, staleness: int, decay: float) -> float:
    """FedBuff-style staleness discount: an update trained against a
    model ``staleness`` publishes old contributes ``n * decay^s``."""
    if staleness < 0:
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    return float(sample_num) * float(decay) ** int(staleness)
