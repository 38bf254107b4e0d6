"""Beehive world driver: one whole cross-device federation in process
(port of ``fedml_tpu/cross_device/driver.py``).

``run_beehive_world`` stands up the two-rank LOCAL fabric (the gateway
and the device population, a thread each), runs ``args.comm_round``
check-in rounds end to end, tears the fabric down, and returns a plain
dict: the final params, the per-round close records, the census and the
host timers. Only the device host's thread touches the card. The
``cli device`` command and the tests enter here; nothing of the
protocol lives in this file.
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Dict, Optional

import numpy as np

from ..core.telemetry import Telemetry
from ..device import DeviceLike, get_device
from ..scale.registry import ClientRegistry
from .device import DeviceHost
from .gateway import DeviceGateway

__all__ = ["run_beehive_world", "beehive_registry", "beehive_cohort"]

# a wedged protocol fails loudly instead of hanging
_JOIN_TIMEOUT_S = 300.0


def beehive_registry(args) -> ClientRegistry:
    """The device registry a config names: ``client_registry_size``
    devices (10,000 when unset), seeded by ``random_seed``."""
    size = int(getattr(args, "client_registry_size", 0) or 0) or 10_000
    return ClientRegistry(
        size,
        seed=int(getattr(args, "random_seed", 0) or 0),
        duty_hours=int(getattr(args, "crossdevice_duty_hours", 14)),
    )


def beehive_cohort(args) -> int:
    """Devices sampled a round: ``crossdevice_cohort``, else the planet's
    ``cohort_size``, else ``client_num_per_round``."""
    return (
        int(getattr(args, "crossdevice_cohort", 0) or 0)
        or int(getattr(args, "cohort_size", 0) or 0)
        or int(getattr(args, "client_num_per_round", 4))
    )


def run_beehive_world(
    args,
    *,
    feature_dim: int = 8,
    class_num: int = 4,
    registry: Optional[ClientRegistry] = None,
    device: DeviceLike = "cuda",
) -> Dict[str, Any]:
    """Run a full Beehive federation, the devices training on
    ``device``, and return its observable state: ``final_flat`` /
    ``final_params`` (the gateway's global model), ``round_records``
    (close reason, fold target, folds, recoveries a round),
    ``trace_count`` / ``shape_keys`` / ``groups_trained`` (the device
    plane's census), ``registry_size`` and the host timers
    (``train_s``, ``mask_s``, ``fold_s``)."""
    dev = get_device(device)
    a = copy.copy(args)
    a.run_id = f"{getattr(args, 'run_id', '0')}-beehive"
    if registry is None:
        registry = beehive_registry(a)
    cohort = beehive_cohort(a)
    rounds = int(getattr(a, "comm_round", 1))
    gateway = DeviceGateway(a, registry, feature_dim, class_num, rounds, cohort)
    host = DeviceHost(a, registry, feature_dim, class_num, rounds, cohort, device=dev)
    errors = []

    def target(manager):
        def run():
            try:
                manager.run()
            except BaseException as e:  # surfaced below: the world failed
                errors.append(e)
                gateway.com_manager.stop_receive_message()
                host.com_manager.stop_receive_message()
        return run

    threads = [
        threading.Thread(target=target(gateway), name="beehive-gateway", daemon=True),
        threading.Thread(target=target(host), name="beehive-devices", daemon=True),
    ]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=_JOIN_TIMEOUT_S)
        wedged = [t.name for t in threads if t.is_alive()]
        if wedged:
            raise RuntimeError(
                f"beehive world wedged after {_JOIN_TIMEOUT_S}s: {wedged} still "
                "running (protocol deadlock; the RoundWAL holds the last close)"
            )
        if errors:
            raise RuntimeError("a beehive rank failed") from errors[0]
    finally:
        # artifacts before teardown: the invariant checker reads the
        # exported counter snapshot next to the WAL even on failure
        tel = Telemetry.get_instance()
        tel.bind_device(dev)
        tel.export_run_artifacts(getattr(a, "telemetry_dir", None))
        gateway.com_manager.stop_receive_message()
        host.com_manager.stop_receive_message()
        inner = gateway.com_manager
        while not hasattr(inner, "destroy_fabric") and hasattr(inner, "inner"):
            inner = inner.inner
        if hasattr(inner, "destroy_fabric"):
            inner.destroy_fabric()
    return {
        "final_flat": np.asarray(gateway.global_flat, dtype=np.float64),
        "final_params": gateway.global_params,
        "round_records": list(gateway.round_records),
        "trace_count": int(host.trace_count),
        "shape_keys": sorted(host.shape_keys),
        "groups_trained": int(host.groups_trained),
        "registry_size": int(registry.size),
        "train_s": host.train_seconds,
        "mask_s": host.mask_seconds,
        "fold_s": gateway.fold_seconds,
    }
