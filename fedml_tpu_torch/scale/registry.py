"""Columnar client registry: a million registered clients in megabytes.

The port of ``fedml_tpu/scale/registry.py``: the columns, the cohort
samplers and the label generator are numpy and bitwise the JAX
package's (the labels drawn from one reseeded generator, not a new one
a client); ``materialize_group`` returns the port's ``Batches`` on the
device, its features made there by
``data/synthetic.synthetic_classification_device_per_client``. The
text below is the JAX package's own.

FedML Parrot (arXiv:2303.01778) and FedJAX (arXiv:2108.02117) both
locate planet-scale simulation in the same design move: client state is
*data*, not objects. A registered client here is one row across six
columns — dataset size, speed tier, data-shard offset, per-client seed,
diurnal availability phase, last check-in round — about 22 bytes, so a
1M-client registry is ~22 MB of NumPy (or disk-backed memmap) instead
of a million Python dataset objects.

Everything per-round is O(cohort):

- ``sample_cohort`` draws a without-replacement cohort with Floyd's
  algorithm — a hash-set of exactly ``cohort_size`` draws. It never
  builds ``arange(N)`` or a permutation of the registry
  (``np.random.choice(N, k, replace=False)`` permutes all N under the
  hood, which is exactly the eager O(total-clients) work this module
  exists to remove).
- ``client_labels`` / ``materialize_group`` generate a client's data on
  demand from its own seed column (device-synth path, the zero-egress
  stand-in convention of ``data/synthetic.py``); ``shard_slice`` is the
  equivalent seam for real datasets stored as one contiguous shard file
  (offset/length reads instead of per-client arrays).

Determinism contract: the same ``(seed, size)`` registry produces the
same columns, the same ``(registry, round_idx)`` produces the same
cohort, and the same client index produces the same data on every
materialization — asserted in ``tests/test_planet_scale.py``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.telemetry import Telemetry
from ..core.types import Batches
from ..data.packing import pack_labels_np
from ..data.synthetic import synthetic_classification_device_per_client
from ..device import DeviceLike, get_device

__all__ = ["ClientRegistry"]

# column name -> dtype; the registry's entire per-client schema. One
# row is 4 + 1 + 8 + 4 + 1 + 4 = 22 bytes.
_COLUMNS = (
    ("num_samples", np.int32),
    ("speed_tier", np.int8),
    ("shard_offset", np.int64),
    ("client_seed", np.uint32),
    ("availability", np.uint8),
    ("last_checkin", np.int32),
)

# columns that are mutated at run time (memmaps reopen writable);
# everything else is generated once and reopened read-only
_MUTABLE_COLUMNS = frozenset({"last_checkin"})


class ClientRegistry:
    """N registered clients as columnar arrays with O(cohort) access.

    ``size``: registered population (N). ``seed``: generates every
    column (and, folded with the round index, every cohort draw).
    ``min_samples``/``max_samples``: lognormal per-client dataset sizes
    are clipped into this range (the ``synthetic_fedprox`` convention —
    a heavy-tailed, heterogeneous population). ``speed_tiers``: number
    of device-speed classes; tier ``t`` is modeled as ``2**t`` x slower
    per sample by the cohort packer's LPT balancing. ``duty_hours``:
    hours per day a device is reachable — each device's ``availability``
    column is a seeded diurnal phase (the hour its on-window opens), so
    availability is a deterministic on/off trace per device, never a
    coin flip per query.
    ``memmap_dir``: when given, columns live in ``<dir>/<name>.npy``
    memmaps (written once, reopened read-only — except the mutable
    ``last_checkin`` column, reopened writable) so even the O(N) column
    footprint leaves host RAM.
    """

    def __init__(
        self,
        size: int,
        seed: int = 0,
        min_samples: int = 20,
        max_samples: int = 400,
        speed_tiers: int = 3,
        duty_hours: int = 14,
        memmap_dir: Optional[str] = None,
    ) -> None:
        if size < 1:
            raise ValueError(f"registry size {size}: must be >= 1")
        if not 1 <= min_samples <= max_samples:
            raise ValueError(
                f"sample bounds [{min_samples}, {max_samples}] invalid"
            )
        if speed_tiers < 1:
            raise ValueError(f"speed_tiers={speed_tiers}: must be >= 1")
        if not 1 <= duty_hours <= 24:
            raise ValueError(
                f"duty_hours={duty_hours}: must be in [1, 24]"
            )
        self.size = int(size)
        self.seed = int(seed)
        self.min_samples = int(min_samples)
        self.max_samples = int(max_samples)
        self.speed_tiers = int(speed_tiers)
        self.duty_hours = int(duty_hours)
        cols = self._generate_columns()
        if memmap_dir is not None:
            cols = self._to_memmap(cols, memmap_dir)
        self.num_samples: np.ndarray = cols["num_samples"]
        self.speed_tier: np.ndarray = cols["speed_tier"]
        self.shard_offset: np.ndarray = cols["shard_offset"]
        self.client_seed: np.ndarray = cols["client_seed"]
        self.availability: np.ndarray = cols["availability"]
        self.last_checkin: np.ndarray = cols["last_checkin"]
        self.total_samples = int(
            self.shard_offset[-1] + self.num_samples[-1]
        )
        # one generator, reseeded per client: constructing a RandomState
        # first seeds a fresh MT19937 from OS entropy, the round's main
        # host cost at 10k clients; reseeding runs only the legacy
        # seeding that RandomState(seed) ends with, so the stream is the
        # same
        self._labels_rs = np.random.RandomState(0)
        # flat-memory claims are measured, not asserted in prose
        Telemetry.get_instance().set_gauge(
            "registry_clients", self.size
        )

    # -- column synthesis ---------------------------------------------
    def _generate_columns(self) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed)
        n = np.clip(
            rng.lognormal(4.0, 1.0, self.size), self.min_samples,
            self.max_samples,
        ).astype(np.int32)
        tier = rng.randint(0, self.speed_tiers, self.size).astype(np.int8)
        cseed = rng.randint(
            0, 2**31 - 1, size=self.size, dtype=np.int64
        ).astype(np.uint32)
        # diurnal phase draw comes AFTER the original column draws so
        # the pre-availability columns stay bit-identical for a given
        # seed (the determinism contract is per (seed, size), ratcheted
        # — never reshuffled by a new column)
        phase = rng.randint(0, 24, size=self.size).astype(np.uint8)
        # prefix-sum offsets: client i's samples live at
        # [offset[i], offset[i] + num_samples[i]) of a contiguous shard
        off = np.zeros(self.size, dtype=np.int64)
        np.cumsum(n[:-1], out=off[1:])
        return {
            "num_samples": n,
            "speed_tier": tier,
            "shard_offset": off,
            "client_seed": cseed,
            "availability": phase,
            # -1 = never checked in; the check-in plane stamps rounds
            "last_checkin": np.full(self.size, -1, dtype=np.int32),
        }

    @staticmethod
    def _to_memmap(
        cols: Dict[str, np.ndarray], memmap_dir: str
    ) -> Dict[str, np.ndarray]:
        os.makedirs(memmap_dir, exist_ok=True)
        out: Dict[str, np.ndarray] = {}
        for name, dtype in _COLUMNS:
            path = os.path.join(memmap_dir, f"{name}.npy")
            mm = np.lib.format.open_memmap(
                path, mode="w+", dtype=dtype, shape=cols[name].shape
            )
            mm[:] = cols[name]
            mm.flush()
            del mm
            mode = "r+" if name in _MUTABLE_COLUMNS else "r"
            out[name] = np.load(path, mmap_mode=mode)
        return out

    def nbytes(self) -> int:
        """Registry column footprint in bytes (~22 per client)."""
        return int(
            sum(
                getattr(self, name).dtype.itemsize
                for name, _ in _COLUMNS
            )
            * self.size
        )

    # -- O(cohort) sampling -------------------------------------------
    def sample_cohort(self, round_idx: int, cohort_size: int) -> np.ndarray:
        """Deterministic without-replacement cohort for ``round_idx``.

        Floyd's algorithm: k draws, a k-sized set, no ``arange(N)`` /
        permutation — peak memory is O(cohort) no matter how large the
        registry is (asserted with tracemalloc in the tests). Returns
        sorted int64 registry indices; sorting keeps downstream
        grouping independent of draw order."""
        k = int(cohort_size)
        n = self.size
        if not 1 <= k <= n:
            raise ValueError(
                f"cohort_size={k} out of range for registry size {n}"
            )
        rs = np.random.RandomState(
            (self.seed * 1_000_003 + int(round_idx)) % (2**32)
        )
        chosen: set = set()
        for j in range(n - k, n):
            t = int(rs.randint(0, j + 1))
            chosen.add(t if t not in chosen else j)
        return np.fromiter(sorted(chosen), dtype=np.int64, count=k)

    # -- availability (diurnal on/off process) ------------------------
    def is_available(self, index, hour: int) -> np.ndarray:
        """Whether device(s) ``index`` are reachable at ``hour``
        (0-23). A device's on-window opens at its seeded diurnal phase
        and lasts ``duty_hours`` — a deterministic per-device trace, so
        the same (registry, hour) always yields the same on/off set."""
        ph = self.availability[index].astype(np.int64)
        return ((int(hour) - ph) % 24) < self.duty_hours

    def sample_available_cohort(
        self,
        round_idx: int,
        cohort_size: int,
        hour: Optional[int] = None,
        max_draw_factor: int = 64,
    ) -> np.ndarray:
        """Deterministic cohort restricted to currently-available
        devices — the Beehive sampler (docs/cross_device.md).

        Rejection sampling over single draws: candidates are drawn one
        at a time from the full registry and kept only when available
        at ``hour`` (default ``round_idx % 24``) and not already
        chosen, so peak memory stays O(cohort) — no availability mask
        over all N is ever built. Draw attempts are capped at
        ``max_draw_factor * cohort_size``; exhausting the cap (duty
        cycle too low for the requested cohort) raises a named error
        instead of looping forever."""
        k = int(cohort_size)
        n = self.size
        if not 1 <= k <= n:
            raise ValueError(
                f"cohort_size={k} out of range for registry size {n}"
            )
        h = int(round_idx) % 24 if hour is None else int(hour) % 24
        # a distinct stream from sample_cohort's: availability-aware
        # draws must not correlate with the unconditional sampler
        rs = np.random.RandomState(
            (self.seed * 1_000_003 + int(round_idx) * 2 + 1) % (2**32)
        )
        chosen: set = set()
        attempts = 0
        cap = max_draw_factor * k
        while len(chosen) < k:
            if attempts >= cap:
                raise ValueError(
                    f"sample_available_cohort: {attempts} draws found "
                    f"only {len(chosen)}/{k} available devices at "
                    f"hour={h} (duty_hours={self.duty_hours}); lower "
                    "the cohort or raise the duty cycle"
                )
            t = int(rs.randint(0, n))
            attempts += 1
            if t in chosen:
                continue
            if bool(self.is_available(t, h)):
                chosen.add(t)
        return np.fromiter(sorted(chosen), dtype=np.int64, count=k)

    def record_checkin(self, index, round_idx: int) -> None:
        """Stamp ``last_checkin`` for device(s) ``index`` — the only
        mutable column (writable memmap when disk-backed)."""
        self.last_checkin[index] = np.int32(round_idx)

    # -- O(cohort) materialization ------------------------------------
    def shard_slice(self, index: int) -> Tuple[int, int]:
        """(offset, length) of client ``index``'s samples in a
        contiguous on-disk data shard — the read plan for real datasets
        (the synthetic path below generates instead of reading; both
        touch only the requested client)."""
        return int(self.shard_offset[index]), int(self.num_samples[index])

    def client_labels(self, index: int, class_num: int) -> np.ndarray:
        """Client ``index``'s label vector, regenerated on demand from
        its own seed column — identical on every materialization, and a
        function of the client alone (not of which cohort or group it
        happens to land in). Bitwise ``RandomState(seed).randint(...)``,
        drawn from the registry's one reseeded generator."""
        rs = self._labels_rs
        rs.seed(int(self.client_seed[index]))
        return rs.randint(
            0, int(class_num), int(self.num_samples[index])
        ).astype(np.int64)

    def materialize_group(
        self,
        client_idx: np.ndarray,
        num_batches: int,
        batch_size: int,
        feature_shape: Tuple[int, ...],
        class_num: int,
        sigma: float = 1.0,
        dtype=None,
        device: DeviceLike = "cuda",
    ):
        """One packed cohort group -> ``Batches`` on ``device``.

        Labels are generated per client (KBs) and packed host-side;
        the feature tensor is synthesized directly on the device
        (``data/synthetic.synthetic_classification_device_per_client``,
        one kernel launch), so the host never holds a group's features
        and the host->device link carries labels + masks only. Each
        row's noise is keyed by that client's seed column per sample
        index, so features — like labels — are a function of the client
        alone, not of which slot, group shape, or cohort it lands in.
        Returns ``(batches, num_samples[C])``; padded label slots carry
        mask 0 exactly as in ``data/packing.py``. Labels are int64, the
        port's class-label dtype."""
        dev = get_device(device)
        # pre-truncate to the group's packed capacity: the waste-cap
        # truncation was already decided (and counted) by pack_cohort,
        # so the packer must not re-warn per group per round
        cap = int(num_batches) * int(batch_size)
        # padded slots repeat a real client: its labels are made once
        made = {
            int(i): self.client_labels(int(i), class_num)[:cap]
            for i in np.unique(client_idx)
        }
        ys = [made[int(i)] for i in client_idx]
        y_p, mask, num_samples = pack_labels_np(
            ys, batch_size, num_batches=int(num_batches)
        )
        y = torch.as_tensor(y_p, dtype=torch.int64, device=dev)
        x = synthetic_classification_device_per_client(
            y, tuple(feature_shape), int(class_num),
            self.client_seed[np.asarray(client_idx, dtype=np.int64)],
            sigma=float(sigma), dtype=dtype, device=dev,
        )
        batches = Batches(x=x, y=y, mask=torch.as_tensor(mask, device=dev))
        return batches, num_samples
