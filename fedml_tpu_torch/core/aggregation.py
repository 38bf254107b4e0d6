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

The robust planes keep the reference's separation: a term is one step
and the add-only fold another. The encoded and clipped folds
(``fold_encoded`` ... ``fold_encoded_delta_clipped``) make each upload's
term ``w * (g + delta * min(1, bound / ||delta||))`` (or the delta-only
form; ``delta`` decoded from an int8 or top-k payload, or ``theta - g``)
in one launch of K3 (``ops/robust_term.py``) over the flat layout, then
fold it through K1; the norm comes from one torch reduction before it.
``RobustAggregator`` (norm-diff clipping, weak DP, coordinate-wise
median) clips the stacked cohort with one K3 launch the same way.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import constants
from ..analysis.compiled import auditable
from ..ops import exact_fold
from ..ops.robust_term import aligned_rows, robust_term
from . import devtime
from .compression import Int8Codec, TopKCodec

Params = Dict[str, torch.Tensor]


# -- the compiled-artifact audit (fedml_tpu_torch/analysis/compiled.py) --
# Fake-input builders for the registered term and fold executables:
# `cli audit` traces each against these (no data, nothing executed) and
# checks host transfers and host constants on the recorded ops. As in the
# JAX package, the encoded and decoded codec variants are not registered.

def _audit_spec(ctx) -> "_FlatSpec":
    return _FlatSpec(ctx.abstract_params_f32())


def _audit_term_inputs(ctx):
    return [("model", (_audit_spec(ctx), ctx.abstract_params_f32(), 0.5), {})]


def _audit_term_clipped_inputs(ctx):
    p = ctx.abstract_params_f32()
    return [("model", (_audit_spec(ctx), p, p, 1.0, 0.5), {})]


def _audit_delta_term_clipped_inputs(ctx):
    return [("model", (_audit_spec(ctx), ctx.abstract_params_f32(), 1.0, 0.5), {})]


def _audit_fold_inputs(ctx):
    n = _audit_spec(ctx).numel
    return [("model", (ctx.sds((3, n)), ctx.sds((n,))), {})]


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


@auditable("agg.fold_tree", _audit_fold_inputs, round_shaped=True)
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
        self._offsets: Dict[str, torch.Tensor] = {}

    def leaf_offsets(self, device) -> torch.Tensor:
        """The leaves' spans ``[L + 1]`` int64 on ``device`` (K3's int8
        scales)."""
        key = str(torch.device(device))
        if key not in self._offsets:
            self._offsets[key] = torch.as_tensor(self.offsets, dtype=torch.int64, device=device)
        return self._offsets[key]

    @staticmethod
    def stacked_dtype(stacked: Params) -> torch.dtype:
        """The flat layout's dtype for a stacked tree: f32, or float64 when
        a leaf is (the float64 parity runs, off the card)."""
        wide = any(v.dtype == torch.float64 for v in stacked.values())
        return torch.float64 if wide else torch.float32

    def flatten_stacked(self, stacked: Params,
                        minus: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A stacked tree (leaves ``[C, ...]``) as ``[C, N]`` in
        ``stacked_dtype``, each row starting on a 16-byte boundary (K3
        reads 16 bytes at a time). ``minus`` (``[N]`` in that dtype) is
        taken from every row as it is laid out: the clip's deltas in one
        pass."""
        if set(stacked) != set(self.names):
            raise ValueError(f"tree holds {sorted(stacked)}, the template {sorted(self.names)}")
        C = stacked[self.names[0]].shape[0] if self.names else 0
        flat = aligned_rows(C, self.numel, self.stacked_dtype(stacked), device=self.device)
        for k, a, b in zip(self.names, self.offsets[:-1], self.offsets[1:]):
            leaf = stacked[k].reshape(C, -1)
            if minus is None:
                flat[:, int(a):int(b)] = leaf
            else:
                torch.sub(leaf.to(flat.dtype), minus[int(a):int(b)], out=flat[:, int(a):int(b)])
        return flat

    def flatten(self, tree: Params, dtype=torch.float32) -> torch.Tensor:
        """``tree`` (the template's leaves) as one ``[N]`` tensor, f32 unless
        ``dtype`` says otherwise."""
        if set(tree) != set(self.names):
            raise ValueError(f"tree holds {sorted(tree)}, the template {sorted(self.names)}")
        leaves = [torch.as_tensor(tree[k], device=self.device).reshape(-1) for k in self.names]
        if not leaves:
            return torch.zeros(0, dtype=dtype, device=self.device)
        return torch.cat([v.to(dtype) for v in leaves])

    def views(self, flat: torch.Tensor) -> Params:
        """Per-leaf views of a flat ``[..., N]`` tensor (leading axes kept)."""
        lead = tuple(flat.shape[:-1])
        return {
            k: flat[..., int(a):int(b)].reshape(lead + s)
            for k, s, a, b in zip(self.names, self.shapes, self.offsets[:-1], self.offsets[1:])
        }


@auditable("agg.weighted_term", _audit_term_inputs)
def _weighted_term(spec: _FlatSpec, theta: Params, w: float) -> torch.Tensor:
    """``t = fl32(w) * theta``, rounded once per element, as one flat
    ``[N]`` f32 tensor: a pure function of (theta, w), whatever the
    order uploads arrive in."""
    return spec.flatten(theta) * float(np.float32(w))


def _tree_scaled(tree: Params, denom) -> Params:
    return {k: v / denom for k, v in tree.items()}


# ---------------------------------------------------------------------
# The robust terms (the JAX package's ``global_norm``, ``_stacked_norms``,
# ``_clip_scale`` and the six terms ``_weighted_term_encoded`` ...
# ``_weighted_delta_term_decoded_clipped``): each one launch of K3 over
# the flat layout, its norm from one torch reduction before it
# ---------------------------------------------------------------------


def _norm(x: torch.Tensor, dim=None) -> torch.Tensor:
    """The L2 norm over ``dim``, one reduction accumulated in float64 (an
    f32 sum of 10^5-10^7 squares can be ~1e-5 off, which a clip to the
    bound would carry), returned in f32 (float64 for float64 input)."""
    out = torch.linalg.vector_norm(x, dim=dim, dtype=torch.float64)
    return out if x.dtype == torch.float64 else out.to(torch.float32)


def global_norm(tree: Union[Params, torch.Tensor]) -> torch.Tensor:
    """L2 norm over all leaves (the reference's ``vectorize_weight``
    flattens to one vector), an f32 0-d tensor on the leaves' device: one
    reduction over the flat layout (a params dict, or a tensor)."""
    if isinstance(tree, torch.Tensor):
        flat = tree.reshape(-1)
    else:
        flat = torch.cat([v.reshape(-1).to(torch.float32) for v in tree.values()])
    return _norm(flat)


def _stacked_norms(stacked: Union[Params, torch.Tensor]) -> torch.Tensor:
    """Per-client L2 norms ``[C]`` of a stacked tree (leaves ``[C, ...]``)
    or of its flat ``[C, N]`` layout, one reduction (see ``_norm``)."""
    if not isinstance(stacked, torch.Tensor):
        stacked = torch.cat([v.reshape(v.shape[0], -1) for v in stacked.values()], dim=1)
    return _norm(stacked, dim=1)


def _clip_scale(norm: torch.Tensor, bound: float) -> torch.Tensor:
    """``min(1, bound / max(||delta||, 1e-12))`` in the norm's dtype (the
    eps guards a zero delta)."""
    b = torch.tensor(float(bound), dtype=norm.dtype, device=norm.device)
    return torch.clamp(b / torch.clamp(norm, min=1e-12), max=1.0)


def _row(value: float, device) -> torch.Tensor:
    """A host scalar as ``[1]`` f32 on ``device`` (a K3 row operand)."""
    return torch.tensor([float(np.float32(value))], dtype=torch.float32, device=device)


def _payload(spec: _FlatSpec, codec, encoded):
    """One upload's payload in the flat layout, as K3 takes it: ``(src
    [1, N], leaf scales [1, L] or None)``; an int8 payload stays int8
    (one scale a leaf), a top-k one is scattered into an f32 delta."""
    if isinstance(codec, TopKCodec):
        return codec.decode_flat(encoded, spec.numel, spec.device)[None], None
    if not isinstance(codec, Int8Codec):
        raise ValueError(f"codec {codec!r}: want an Int8Codec or a TopKCodec")
    if set(encoded) != set(spec.names):
        raise ValueError(f"payload holds {sorted(encoded)}, the template {sorted(spec.names)}")
    q = aligned_rows(1, spec.numel, dtype=torch.int8, device=spec.device)
    for k, a, b in zip(spec.names, spec.offsets[:-1], spec.offsets[1:]):
        q[0, int(a):int(b)] = torch.as_tensor(encoded[k]["q"], device=spec.device).reshape(-1)
    scales = torch.stack([torch.as_tensor(encoded[k]["scale"], device=spec.device)
                          .to(torch.float32).reshape(()) for k in spec.names])
    return q, scales[None]


def _payload_norm(spec: _FlatSpec, src: torch.Tensor, scales) -> torch.Tensor:
    """The L2 norm of a payload's delta, an f32 0-d tensor. An int8
    payload is not decoded for it: ``||d||^2 = sum_l scale_l^2 * S_l``,
    with each leaf's ``S_l = sum q^2`` summed exactly in integers (a
    running int64 sum read at the leaves' ends), the rest in float64."""
    if scales is None:
        return global_norm(src)
    q = src[0].to(torch.int16)
    ends = torch.cumsum(q * q, 0, dtype=torch.int64)
    at = spec.leaf_offsets(spec.device) - 1
    ends = torch.where(at >= 0, ends[at.clamp(min=0)], 0)
    sq = (ends[1:] - ends[:-1]).to(torch.float64)
    return torch.sqrt((scales[0].to(torch.float64).square() * sq).sum()).to(torch.float32)


def _k3(spec: _FlatSpec, src, scales, **kw) -> torch.Tensor:
    offsets = spec.leaf_offsets(spec.device) if scales is not None else None
    return robust_term(src, leaf_scales=scales, leaf_offsets=offsets, **kw)[0]


def _weighted_term_encoded(spec, codec, encoded, like: Params, w: float) -> torch.Tensor:
    """Decode + reconstruct + weight: ``w * (g + decode(payload))``."""
    src, scales = _payload(spec, codec, encoded)
    return _k3(spec, src, scales, g=spec.flatten(like), add_g=True, w=_row(w, spec.device))


def _weighted_term_decoded(spec, codec, encoded, w: float) -> torch.Tensor:
    """Decode + weight of an update delta: ``w * decode(payload)``."""
    src, scales = _payload(spec, codec, encoded)
    return _k3(spec, src, scales, w=_row(w, spec.device))


@auditable("agg.weighted_term_clipped", _audit_term_clipped_inputs)
def _weighted_term_clipped(spec, theta: Params, g: Params, bound: float, w: float):
    """Clip against the global + weight: ``w * (g + delta * s)``, delta =
    theta - g. Returns (term, pre-clip norm)."""
    gf = spec.flatten(g)
    delta = (spec.flatten(theta) - gf)[None]
    norm = global_norm(delta)
    return _k3(spec, delta, None, g=gf, add_g=True,
               s=_clip_scale(norm, bound).reshape(1), w=_row(w, spec.device)), norm


def _weighted_term_encoded_clipped(spec, codec, encoded, like: Params, bound: float, w: float):
    """Decode + clip + reconstruct + weight: the payload is the delta
    against the broadcast global."""
    src, scales = _payload(spec, codec, encoded)
    norm = _payload_norm(spec, src, scales)
    return _k3(spec, src, scales, g=spec.flatten(like), add_g=True,
               s=_clip_scale(norm, bound).reshape(1), w=_row(w, spec.device)), norm


@auditable("agg.weighted_delta_term_clipped", _audit_delta_term_clipped_inputs)
def _weighted_delta_term_clipped(spec, delta: Params, bound: float, w: float):
    """The delta-only clip (the async fold currency): ``w * (delta * s)``."""
    src = spec.flatten(delta)[None]
    norm = global_norm(src)
    return _k3(spec, src, None, s=_clip_scale(norm, bound).reshape(1),
               w=_row(w, spec.device)), norm


def _weighted_delta_term_decoded_clipped(spec, codec, encoded, bound: float, w: float):
    """Decode + clip + weight of an update delta."""
    src, scales = _payload(spec, codec, encoded)
    norm = _payload_norm(spec, src, scales)
    return _k3(spec, src, scales, s=_clip_scale(norm, bound).reshape(1),
               w=_row(w, spec.device)), norm


def reconcile_to_device(tree, device):
    """A payload tree (params, an encoded delta, a fold state) with every
    array leaf a tensor on ``device``: a networked transport hands the
    receiver read-only numpy arrays (and bf16 as CPU tensors), the LOCAL
    fabric the sender's own tensors. A tensor already there is returned
    as it is (the in-process path stays zero-copy); scalars pass."""
    if isinstance(tree, dict):
        return {k: reconcile_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(reconcile_to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree)).to(device)
    return tree


def derive_defense_rng(seed: int, index: int, device="cuda") -> torch.Generator:
    """THE defense generator convention: a ``torch.Generator`` on
    ``device`` (the card unless asked otherwise; the model's device, where
    the noise is drawn) seeded from (run seed, round or publish index), so weak
    DP's noise differs every round and repeats for the same pair. The
    stream is the port's own (PyTorch's generators), not the JAX
    package's threefry: the two packages draw different noise."""
    state = np.random.SeedSequence([int(seed) % 2**32, int(index) % (2**31)])
    return torch.Generator(device=device).manual_seed(int(state.generate_state(1, np.uint64)[0] >> 1))


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

    def fold_encoded(self, codec, encoded, like: Params, w: float) -> None:
        """Fold a compressed upload: decode + reconstruct against the
        pre-round global ``like`` + weight, one K3 launch, then the fold."""
        with devtime.measure("agg.weighted_term"):
            term = _weighted_term_encoded(self._spec, codec, encoded, like, w)
        self._fold_term(term, w)

    def fold_encoded_delta(self, codec, encoded, like: Params, w: float) -> None:
        """Fold a compressed update DELTA without reconstructing a model
        (``like`` supplies shapes only)."""
        with devtime.measure("agg.weighted_term"):
            term = _weighted_term_decoded(self._spec, codec, encoded, w)
        self._fold_term(term, w)

    # -- defense folds (norm_diff_clipping / weak_dp in the stream) ---
    # Each clips the upload's delta against the broadcast global in its
    # term (one K3 launch), folds the clipped term, and returns the
    # pre-clip delta norm and whether the bound bit, on the host (one
    # deliberate fetch an upload, as in the JAX package).

    def fold_clipped(self, theta: Params, against: Params, bound: float,
                     w: float) -> Tuple[float, bool]:
        with devtime.measure("agg.weighted_term_clipped"):
            term, norm = _weighted_term_clipped(self._spec, theta, against, bound, w)
        return self._fold_clipped_term(term, norm, bound, w)

    def fold_encoded_clipped(self, codec, encoded, like: Params, bound: float,
                             w: float) -> Tuple[float, bool]:
        with devtime.measure("agg.weighted_term_clipped"):
            term, norm = _weighted_term_encoded_clipped(self._spec, codec, encoded, like,
                                                        bound, w)
        return self._fold_clipped_term(term, norm, bound, w)

    def fold_delta_clipped(self, delta: Params, bound: float, w: float) -> Tuple[float, bool]:
        with devtime.measure("agg.weighted_delta_term_clipped"):
            term, norm = _weighted_delta_term_clipped(self._spec, delta, bound, w)
        return self._fold_clipped_term(term, norm, bound, w)

    def fold_encoded_delta_clipped(self, codec, encoded, like: Params, bound: float,
                                   w: float) -> Tuple[float, bool]:
        with devtime.measure("agg.weighted_delta_term_clipped"):
            term, norm = _weighted_delta_term_decoded_clipped(self._spec, codec, encoded,
                                                              bound, w)
        return self._fold_clipped_term(term, norm, bound, w)

    def _fold_clipped_term(self, term, norm, bound: float, w: float) -> Tuple[float, bool]:
        self._fold_term(term, w)
        n = float(norm)
        return n, n > float(np.float32(bound))

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


def needs_full_cohort(args, server_aggregator) -> Optional[str]:
    """Why streaming aggregation cannot serve this configuration, or
    None. The fold is a weighted sum: an aggregator that needs the whole
    cohort at once (coordinate-wise median, a custom ``ServerAggregator``)
    keeps the buffered path. ``norm_diff_clipping`` and ``weak_dp`` are
    per upload (the clip in the term, the noise at finalize) and stream.
    Unknown defense strings raise here rather than being averaged."""
    if server_aggregator is not None:
        return "custom ServerAggregator reduces over the stacked cohort"
    defense = getattr(args, "defense_type", None) or None
    if defense is not None and defense not in constants.DEFENSE_TYPES:
        raise ValueError(
            f"unknown defense_type {defense!r}; pick one of "
            f"{constants.DEFENSE_TYPES} (or None) — refusing to fall "
            "through to an UNDEFENDED plain mean"
        )
    if defense == constants.DEFENSE_MEDIAN:
        return "defense_type=median needs the full cohort at once"
    return None


class RobustAggregator:
    """The reference's ``RobustAggregator`` (``robust_aggregation.py:41-99``)
    over a stacked client axis: ``defense_type`` ``norm_diff_clipping`` |
    ``weak_dp`` | ``median`` | None."""

    def __init__(self, args) -> None:
        defense = getattr(args, "defense_type", None) or None
        if defense is not None and defense not in constants.DEFENSE_TYPES:
            raise ValueError(
                f"unknown defense_type {defense!r}; pick one of "
                f"{constants.DEFENSE_TYPES} (or None)"
            )
        self.defense_type = defense
        self.norm_bound = float(getattr(args, "norm_bound", 5.0))
        self.stddev = float(getattr(args, "stddev", 0.158))
        if self.norm_bound <= 0:
            raise ValueError(
                f"norm_bound={self.norm_bound}: must be > 0 (the clip "
                "radius around the global model)"
            )
        if self.stddev < 0:
            raise ValueError(f"stddev={self.stddev}: must be >= 0")

    def clip_updates(self, stacked: Params, global_params: Params) -> Params:
        """Norm-difference clipping (``robust_aggregation.py:47-58``): each
        client's delta scaled so ``||theta_c - g|| <= norm_bound``, as
        ``g + delta_c * s_c``. The cohort is one ``[C, N]`` f32 flat layout:
        the norms one torch reduction, the clip one K3 launch; the leaves
        come back in their own dtypes."""
        spec = _FlatSpec(global_params)
        g = spec.flatten(global_params, spec.stacked_dtype(stacked))
        delta = spec.flatten_stacked(stacked, minus=g)
        s = _clip_scale(_stacked_norms(delta), self.norm_bound)
        out = robust_term(delta, g, add_g=True, s=s)
        return {k: v.to(stacked[k].dtype) for k, v in spec.views(out).items()}

    def add_noise(self, params: Params, generator: torch.Generator) -> Params:
        """Weak DP: Gaussian noise of ``stddev`` on the aggregate
        (``robust_aggregation.py:60-63``), drawn leaf by leaf in the dict's
        order from ``generator``."""
        return {
            k: v + self.stddev * torch.randn(v.shape, generator=generator, device=v.device,
                                             dtype=v.dtype)
            for k, v in params.items()
        }

    @staticmethod
    def coordinate_median(stacked: Params) -> Params:
        """Coordinate-wise median across clients (``robust_aggregation.py:
        65-99``), as ``jnp.median`` computes it: the two middle values of
        the sorted cohort, ``(lo + hi) * 0.5`` (for an odd cohort both are
        the middle one). ``torch.median`` would return the lower middle
        for an even cohort."""

        def med(leaf: torch.Tensor) -> torch.Tensor:
            c = leaf.shape[0]
            srt = torch.sort(leaf, dim=0).values
            return (srt[(c - 1) // 2] + srt[c // 2]) * 0.5

        return {k: med(v) for k, v in stacked.items()}

    def aggregate(self, stacked: Params, weights: torch.Tensor, global_params: Params,
                  rng: Optional[torch.Generator] = None) -> Params:
        """The robust FedAvg step (``FedAvgRobustAggregator.aggregate``):
        the median; or the clip, the weighted mean and, for weak DP, the
        noise from ``rng`` (``derive_defense_rng(seed, round)``)."""
        if self.defense_type == constants.DEFENSE_MEDIAN:
            return self.coordinate_median(stacked)
        if self.defense_type in (constants.DEFENSE_NORM_DIFF_CLIPPING,
                                 constants.DEFENSE_WEAK_DP):
            stacked = self.clip_updates(stacked, global_params)
        out = weighted_average(stacked, weights)
        if self.defense_type == constants.DEFENSE_WEAK_DP:
            if rng is None:
                # a fixed generator would add the same noise every round
                raise ValueError(
                    "weak_dp needs a per-round rng; pass "
                    "derive_defense_rng(args.random_seed, round_idx, device=<the "
                    "model's device>) — a fixed key re-adds the same noise every round"
                )
            out = self.add_noise(out, rng)
        return out
