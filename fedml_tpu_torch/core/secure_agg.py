"""Secure-aggregation primitives (port of ``fedml_tpu/core/secure_agg.py``).

TurboAggregate's host-side protocol (reference:
``simulation/mpi_p2p_mp/turboaggregate/mpc_function.py``): finite-field
arithmetic over p = 2^31 - 1 (products of two residues fit int64
exactly), Lagrange coefficients and Shamir (BGW) shares, additive
shares, the pairwise masks of the cross-device plane (a shared seed per
pair of devices, signed PRG vectors that cancel exactly in the field
sum, and the dropout correction), and float <-> field quantization.

This is host numpy by design, as in the JAX package: shares are what
crosses the wire between parties; the card computes the model updates.
Every function is a numpy copy of the JAX package's, bitwise the same
for the same inputs and seeds. Only the flat layout of a params tree is
the port's own: ``flatten_params`` / ``unflatten_params`` lay a
``{name: Tensor}`` dict end to end in its key order, and unflatten
casts back to float32 as the JAX package does.

Two host shortcuts give the same numbers faster, as the cross-device
plane needs at cohorts of hundreds (a device's mask is a PRG vector per
peer): a scalar power mod p is Python's ``pow`` (exact integers, where
``modpow`` squares in int64), and the seeded ``RandomState`` draws come
from one generator a thread reseeded by ``.seed(s)``, the same stream as
``RandomState(s)`` without the entropy read its constructor makes first.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

FIELD_PRIME = 2**31 - 1

# generator for the pairwise-mask key exchange: 7 is a primitive root
# of the Mersenne prime 2^31 - 1, so g^b ranges over the whole
# multiplicative group
MASK_GENERATOR = 7

Params = Any


def modpow(base: np.ndarray, exp: int, p: int = FIELD_PRIME) -> np.ndarray:
    """Vectorized square-and-multiply base**exp mod p (int64-safe)."""
    base = np.mod(np.asarray(base, dtype=np.int64), p)
    result = np.ones_like(base)
    e = int(exp)
    while e > 0:
        if e & 1:
            result = np.mod(result * base, p)
        base = np.mod(base * base, p)
        e >>= 1
    return result


def modular_inv(a: np.ndarray, p: int = FIELD_PRIME) -> np.ndarray:
    """a^-1 mod p via Fermat (p prime). Vectorized."""
    return modpow(a, p - 2, p)


def lagrange_coeffs(
    alpha_s: Sequence[int], beta_s: Sequence[int], p: int = FIELD_PRIME
) -> np.ndarray:
    """U[i, j] = prod_{o != j} (alpha_i - beta_o) / (beta_j - beta_o) mod p.

    Evaluating a degree-(len(beta)-1) interpolant through points
    ``beta_s`` at targets ``alpha_s`` (``gen_Lagrange_coeffs``).
    """
    alpha = np.mod(np.asarray(alpha_s, dtype=np.int64), p)
    beta = np.mod(np.asarray(beta_s, dtype=np.int64), p)
    n_a, n_b = len(alpha), len(beta)
    U = np.zeros((n_a, n_b), dtype=np.int64)
    for j in range(n_b):
        others = np.delete(beta, j)
        den = 1
        for o in others:
            den = (den * int(np.mod(beta[j] - o, p))) % p
        den_inv = int(modular_inv(np.int64(den), p))
        num = np.ones((n_a,), dtype=np.int64)
        for o in others:
            num = np.mod(num * np.mod(alpha - o, p), p)
        U[:, j] = np.mod(num * den_inv, p)
    return U


def shamir_share(
    x: np.ndarray, n: int, t: int, rng: np.random.Generator, p: int = FIELD_PRIME
) -> np.ndarray:
    """Degree-t Shamir shares of field vector ``x`` at points 1..n
    (``BGW_encoding`` semantics). Returns [n, *x.shape]."""
    x = np.mod(np.asarray(x, dtype=np.int64), p)
    coeffs = rng.integers(0, p, size=(t + 1,) + x.shape, dtype=np.int64)
    coeffs[0] = x
    shares = np.zeros((n,) + x.shape, dtype=np.int64)
    for i in range(1, n + 1):
        acc = np.zeros_like(x)
        power = np.int64(1)
        for c in coeffs:
            acc = np.mod(acc + c * power, p)
            power = (power * i) % p
        shares[i - 1] = acc
    return shares


def shamir_reconstruct(
    shares: np.ndarray, points: Sequence[int], p: int = FIELD_PRIME
) -> np.ndarray:
    """Interpolate the secret (value at 0) from shares at ``points``."""
    U = lagrange_coeffs([0], points, p)[0]  # [k]
    acc = np.zeros(shares.shape[1:], dtype=np.int64)
    for lam, s in zip(U, shares):
        acc = np.mod(acc + lam * s, p)
    return acc


def additive_share(
    x: np.ndarray, n: int, rng: np.random.Generator, p: int = FIELD_PRIME
) -> np.ndarray:
    """n additive shares summing to x mod p. Returns [n, *x.shape]."""
    if n < 1:
        raise ValueError("additive_share needs at least one recipient")
    x = np.mod(np.asarray(x, dtype=np.int64), p)
    shares = rng.integers(0, p, size=(n - 1,) + x.shape, dtype=np.int64)
    last = np.mod(x - np.mod(shares.sum(axis=0), p), p)
    return np.concatenate([shares, last[None]], axis=0)


# -- pairwise masking (SecAgg shape, cross-device plane) -------------------
#
# Each device derives a round-scoped secret b_i, publishes p_i = g^b_i,
# and computes one shared seed per peer s_ij = p_j^b_i = g^(b_i*b_j)
# (symmetric, so both ends expand the SAME pseudorandom field vector).
# Device i's upload is its quantized delta plus
# sum_{j != i} sign(i, j) * PRG(s_ij) with sign(i, j) = +1 iff i < j —
# across any set that all uploaded, the signed terms cancel EXACTLY in
# integer mod-p addition, which is what makes the masked streaming fold
# bitwise identical to the unmasked one. A device that checked in but never
# uploaded leaves its pairwise terms dangling in everyone else's
# uploads; survivors reveal Shamir shares of the vanished secret, the
# server reconstructs b_v (verifying g^b_v against the published key),
# regenerates the dangling terms, and subtracts them.


_THREAD = threading.local()


def _seeded(seed: int) -> np.random.RandomState:
    """This thread's ``RandomState``, reseeded: the stream of
    ``RandomState(seed)``."""
    rs = getattr(_THREAD, "rs", None)
    if rs is None:
        rs = _THREAD.rs = np.random.RandomState()
    rs.seed(int(seed))
    return rs


def derive_mask_secret(
    device_seed: int, round_idx: int, p: int = FIELD_PRIME
) -> int:
    """Round-scoped mask secret b in [1, p-2], deterministic per
    (device seed, round) — replayable worlds need replayable masks."""
    rs = _seeded(
        (int(device_seed) * 2_654_435_761 + int(round_idx) * 97 + 13)
        % (2**32)
    )
    return int(rs.randint(1, p - 1))


def mask_public_key(
    secret: int, p: int = FIELD_PRIME, g: int = MASK_GENERATOR
) -> int:
    """Published half of the pairwise key exchange: g^secret mod p."""
    return pow(int(g) % p, int(secret), p)


def pairwise_seed(secret_i: int, public_j: int, p: int = FIELD_PRIME) -> int:
    """Shared seed s_ij = p_j^b_i = g^(b_i*b_j) — symmetric, so both
    devices expand the identical mask vector from it."""
    return pow(int(public_j) % p, int(secret_i), p)


def prg_field_vector(seed: int, dim: int, p: int = FIELD_PRIME) -> np.ndarray:
    """Deterministic pseudorandom field vector from a shared seed."""
    return _seeded(int(seed) % (2**32)).randint(0, p, size=int(dim), dtype=np.int64)


def pairwise_mask_vector(
    device_id: int,
    secret: int,
    peer_publics: Dict[int, int],
    dim: int,
    p: int = FIELD_PRIME,
) -> np.ndarray:
    """Device ``device_id``'s total mask: the signed sum of its
    pairwise PRG vectors against every peer, mod p. Adding this to the
    quantized delta hides it; summed over any complete set of
    participants the masks cancel to exactly zero."""
    mask = np.zeros(int(dim), dtype=np.int64)
    for j, pub_j in peer_publics.items():
        if int(j) == int(device_id):
            continue
        r = prg_field_vector(pairwise_seed(secret, pub_j, p), dim, p)
        if int(device_id) < int(j):
            mask = np.mod(mask + r, p)
        else:
            mask = np.mod(mask - r, p)
    return mask


def unmask_correction(
    vanished_id: int,
    vanished_secret: int,
    folded_publics: Dict[int, int],
    dim: int,
    p: int = FIELD_PRIME,
) -> np.ndarray:
    """The dangling-mask residue a vanished participant left in the
    fold: sum over folded devices i of sign(i, v) * PRG(s_iv), mod p.
    Subtracting this from the field total restores exact cancellation
    (dropout recovery). Computed from the RECONSTRUCTED secret, so a
    bad share surfaces as a pubkey-verification failure upstream."""
    corr = np.zeros(int(dim), dtype=np.int64)
    for i, pub_i in folded_publics.items():
        if int(i) == int(vanished_id):
            continue
        r = prg_field_vector(
            pairwise_seed(vanished_secret, pub_i, p), dim, p
        )
        if int(i) < int(vanished_id):
            corr = np.mod(corr + r, p)
        else:
            corr = np.mod(corr - r, p)
    return corr


def field_checksum(q: np.ndarray, p: int = FIELD_PRIME) -> int:
    """Sum of a field vector mod p: the per-upload balance witness of a
    masked fold."""
    return int(np.mod(np.asarray(q, dtype=np.int64).sum(), p))


# -- float <-> field quantization ------------------------------------------


def quantize(x: np.ndarray, scale: float, p: int = FIELD_PRIME) -> np.ndarray:
    """Signed floats → field residues (two's-complement style: negatives
    map to the top half of the field)."""
    q = np.round(np.asarray(x, dtype=np.float64) * scale).astype(np.int64)
    return np.mod(q, p)


def dequantize(
    q: np.ndarray, scale: float, p: int = FIELD_PRIME
) -> np.ndarray:
    """Field residues → signed floats (values above p/2 are negative)."""
    q = np.asarray(q, dtype=np.int64)
    signed = np.where(q > p // 2, q - p, q)
    return signed.astype(np.float64) / scale


def flatten_params(params: Dict[str, Any]):
    """A ``{name: tensor or array}`` dict -> (one flat numpy vector in
    the dict's key order, the spec ``unflatten_params`` needs)."""
    names = list(params)
    leaves = [np.asarray(torch.as_tensor(params[k]).detach().cpu()) for k in names]
    flat = np.concatenate([l.reshape(-1) for l in leaves])
    return flat, (names, [l.shape for l in leaves])


def unflatten_params(flat: np.ndarray, spec) -> Dict[str, torch.Tensor]:
    """The inverse of ``flatten_params``: float32 CPU tensors."""
    names, shapes = spec
    out, off = {}, 0
    for name, s in zip(names, shapes):
        n = int(np.prod(s)) if len(s) else 1
        out[name] = torch.from_numpy(
            np.asarray(flat[off:off + n], dtype=np.float32).reshape(s).copy())
        off += n
    return out


class TurboAggregateProtocol:
    """Ring-of-groups secure aggregation (TurboAggregate shape).

    Clients are arranged in ``n_groups`` groups along a ring. Each
    client quantizes its (pre-weighted) update into the field and
    additively shares it to the members of the NEXT group; each member
    of a group only ever sees a sum of random-looking shares. Group
    partial sums travel one hop per stage; after the full ring pass the
    final group's shares reconstruct exactly ``sum_i q(w_i * x_i)``.
    Dropout resilience (the reference's Lagrange-coded redundancy) is
    available via :func:`shamir_share` with threshold ``t`` on the
    group partial sums.
    """

    def __init__(self, n_clients: int, n_groups: int = 4, scale: float = 2.0**16,
                 seed: int = 0, p: int = FIELD_PRIME):
        self.n_clients = n_clients
        # at most one group per client (an empty group would have no
        # members to receive shares), at least one
        self.n_groups = max(1, min(n_groups, n_clients))
        self.scale = scale
        self.p = p
        self.rng = np.random.default_rng(seed)
        self.groups: List[List[int]] = [
            list(range(g, n_clients, self.n_groups)) for g in range(self.n_groups)
        ]

    def secure_weighted_sum(self, updates: List[np.ndarray], weights: np.ndarray) -> np.ndarray:
        """Returns sum_i weights[i] * updates[i], computed via additive
        shares along the group ring — no party observes a raw update."""
        p = self.p
        dim = updates[0].shape[0]
        # stage 0: every client shares its quantized weighted update to
        # the members of the next group
        group_share_sums = [
            np.zeros((len(g), dim), dtype=np.int64) for g in self.groups
        ]
        for gi, group in enumerate(self.groups):
            nxt = (gi + 1) % self.n_groups
            n_recv = len(self.groups[nxt])
            for ci in group:
                q = quantize(updates[ci] * weights[ci], self.scale, p)
                shares = additive_share(q, n_recv, self.rng, p)
                group_share_sums[nxt] = np.mod(group_share_sums[nxt] + shares, p)
        # ring pass: each group forwards its (re-shared) partial sum —
        # partials stay additively masked end to end
        total = np.zeros((dim,), dtype=np.int64)
        for gi in range(self.n_groups):
            total = np.mod(total + np.mod(group_share_sums[gi].sum(axis=0), p), p)
        return dequantize(total, self.scale, p)
