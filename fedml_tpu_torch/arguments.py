"""Configuration: YAML -> flat ``Arguments`` (port of ``fedml_tpu/arguments.py``).

The subset the serving slice reads: the YAML load and section
flattening, the defaults for the seed, the dataset, the model geometry
and the serving knobs the engine reads, and their validation. A YAML
written for the JAX package loads here unchanged; knobs this subset
has no default for still land on the object as the YAML sets them.

Validation imports nothing else of the port, and nothing of JAX: the
dtype knob is checked here against its own table.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import yaml

# Defaults applied when neither the YAML nor the caller provides a value.
_DEFAULTS: Dict[str, Any] = {
    "random_seed": 0,
    # data
    "dataset": "synthetic",
    # model
    "model": "lr",
    # compute dtype of the hot loop ("float32" = no casting)
    "dtype": "float32",
    "vocab_size": 0,  # LM vocabulary (0 = the model family's default)
    "num_layers": 2,  # transformer depth
    "num_heads": 4,  # attention heads
    "embed_dim": 128,  # transformer model width
    "max_len": 512,  # positional-embedding capacity
    "attention_impl": "full",  # "full" | "flash"
    # serving plane (fedml_tpu_torch/serving):
    # bounded request queue; a full queue sheds new requests
    # (serving_shed_total{reason=queue_full}) instead of growing
    "serve_queue_size": 256,
    # micro-batch cap: the batcher drains up to this many queued
    # requests into one forward pass (pow2-bucketed below the cap)
    "serve_max_batch": 64,
    # linger time while assembling a micro-batch once the first
    # request is in hand — the latency/occupancy tradeoff knob
    "serve_batch_wait_ms": 2.0,
    # default per-request deadline; requests still queued past it are
    # shed (serving_shed_total{reason=deadline}). 0 disables
    "serve_deadline_ms": 100.0,
    # serving batch-shape bucket policy: "pow2" or "exact"
    "serve_bucket": "pow2",
}

_SECTIONS = (
    "common_args",
    "data_args",
    "model_args",
    "train_args",
    "validation_args",
    "device_args",
    "comm_args",
    "tracking_args",
    "defense_args",
    "attack_args",
)

_DTYPES = ("bfloat16", "float32")


class Arguments:
    """Flat attribute bag over a sectioned YAML config."""

    def __init__(self, cmd_args: Optional[argparse.Namespace] = None) -> None:
        self._raw: Dict[str, Any] = {}
        if cmd_args is not None:
            for k, v in vars(cmd_args).items():
                setattr(self, k, v)
        config_path = getattr(self, "yaml_config_file", None) or None
        if config_path:
            self.load_yaml_config(config_path)
        for key, val in _DEFAULTS.items():
            if not hasattr(self, key):
                setattr(self, key, val)
        self._validate()

    # -- YAML ----------------------------------------------------------
    def load_yaml_config(self, path: str) -> None:
        with open(path, "r") as f:
            cfg = yaml.safe_load(f) or {}
        self._raw = cfg
        self.set_attr_from_config(cfg)

    def set_attr_from_config(self, configuration: Dict[str, Any]) -> None:
        """Flatten sections: every key of a ``*_args`` section becomes
        an attribute; a top-level scalar stays as it is."""
        for section, content in configuration.items():
            if isinstance(content, dict) and (
                section in _SECTIONS or section.endswith("_args")
            ):
                for key, val in content.items():
                    setattr(self, key, val)
            else:
                setattr(self, section, content)

    # -- validation ----------------------------------------------------
    def _validate(self) -> None:
        dtype = str(getattr(self, "dtype", "float32") or "float32")
        if dtype not in _DTYPES:
            raise ValueError(
                f"dtype {dtype!r}: pick one of {sorted(_DTYPES)} (float16 is "
                "unsupported — no loss scaling)"
            )
        for int_key in ("random_seed", "serve_queue_size", "serve_max_batch"):
            setattr(self, int_key, int(getattr(self, int_key)))
        if self.serve_queue_size < 1 or self.serve_max_batch < 1:
            raise ValueError(
                f"serve_queue_size={self.serve_queue_size} / "
                f"serve_max_batch={self.serve_max_batch}: both must be >= 1"
            )
        for nonneg_key in ("serve_batch_wait_ms", "serve_deadline_ms"):
            if getattr(self, nonneg_key) < 0:
                raise ValueError(
                    f"{nonneg_key}={getattr(self, nonneg_key)}: must be >= 0"
                )
        if self.serve_bucket not in ("pow2", "exact"):
            raise ValueError(
                f"serve_bucket {self.serve_bucket!r}: pick 'pow2' or 'exact'"
            )


def load_arguments(path: str) -> Arguments:
    """``Arguments`` from one YAML file (what ``--cf <yaml>`` does)."""
    return Arguments(argparse.Namespace(yaml_config_file=path))
