"""Typed flat configuration (counterpart of ``fedml_tpu/arguments.py``).

A YAML file with sections (``common_args``, ``data_args``, ...) is flattened
into one attribute namespace so every component reads ``args.X``. The schema
holds only the keys the ported slice reads; unknown keys are kept untyped,
and :func:`fedml_tpu_torch.runner.check_ported` refuses the knobs of
features the slice has not ported.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

import yaml

from .constants import (FEDML_SIMULATION_BACKEND_ALIASES,
                        FEDML_TRAINING_PLATFORM_SIMULATION)

_SCHEMA: Dict[str, Any] = {
    # common_args
    "training_type": FEDML_TRAINING_PLATFORM_SIMULATION,
    "random_seed": 0,
    "run_id": "0",
    # data_args
    "dataset": "synthetic_cifar10",
    "data_cache_dir": "~/.cache/fedml_tpu/data",
    "partition_method": "hetero",
    "partition_alpha": 0.5,
    "allow_synthetic": False,    # opt-in gate for synthetic stand-ins
    "synthetic_size": 0,         # stand-in train set size (0 = default)
    "synthetic_test_size": 0,    # stand-in test set size (0 = 1000)
    "max_total_samples": 0,      # cap on the train set (0 = none)
    # model_args
    "model": "resnet56",
    "precision": "float32",      # or "bfloat16" for the compute path
    # fused conv->GN->residual->ReLU block for the <= 64-channel ResNet
    # stages: true/pallas = the hand-written CUDA kernel, reference = the
    # same math in plain PyTorch. A mode string; bools work too
    "fused_conv_block": "",
    # train_args
    "federated_optimizer": "FedAvg",
    "client_num_in_total": 8,
    "client_num_per_round": 8,
    "comm_round": 10,
    "epochs": 1,
    "batch_size": 32,
    "client_optimizer": "sgd",
    "learning_rate": 0.03,
    "weight_decay": 0.0,
    "momentum": 0.0,
    "sampling_stream": "legacy",
    # validation_args
    "frequency_of_the_test": 5,
    # comm_args
    "backend": "gpu",
}


class Arguments:
    """Flat config namespace. Known keys get defaults from ``_SCHEMA``;
    unknown keys are attached as-is."""

    def __init__(self, config: Optional[Dict[str, Any]] = None,
                 **overrides: Any):
        for key, default in _SCHEMA.items():
            setattr(self, key, default)
        merged: Dict[str, Any] = {}
        if config:
            merged.update(_flatten_sections(config))
        merged.update(overrides)
        for key, value in merged.items():
            setattr(self, key, _coerce(key, value))
        self._finalize()

    def _finalize(self) -> None:
        backend = str(getattr(self, "backend", "gpu")).lower()
        self.backend = FEDML_SIMULATION_BACKEND_ALIASES.get(backend, backend)
        if self.client_num_per_round > self.client_num_in_total:
            self.client_num_per_round = self.client_num_in_total
        if isinstance(self.data_cache_dir, str):
            self.data_cache_dir = os.path.expanduser(self.data_cache_dir)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}

    def __repr__(self) -> str:
        keys = sorted(self.to_dict())
        return "Arguments(" + ", ".join(
            f"{k}={getattr(self, k)!r}" for k in keys) + ")"


_SECTION_SUFFIX = "_args"


def _flatten_sections(config: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten ``{section_args: {k: v}}`` into ``{k: v}``; later sections
    win on duplicate keys."""
    flat: Dict[str, Any] = {}
    for key, value in config.items():
        if key.endswith(_SECTION_SUFFIX) and isinstance(value, dict):
            flat.update(value)
        else:
            flat[key] = value
    return flat


def _coerce(key: str, value: Any) -> Any:
    default = _SCHEMA.get(key)
    if default is None or value is None:
        return value
    ty = type(default)
    if isinstance(value, ty):
        return value
    try:
        if ty is bool and isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return ty(value)
    except (TypeError, ValueError):
        return value


def load_arguments(config_path: Optional[str] = None, rank: int = 0,
                   role: Optional[str] = None, **overrides: Any) -> Arguments:
    """Load a YAML config (if given) into a flat :class:`Arguments`."""
    config: Dict[str, Any] = {}
    if config_path:
        with open(config_path, "r") as f:
            config = yaml.safe_load(f) or {}
    args = Arguments(config, **overrides)
    args.rank = rank
    if role is not None:
        args.role = role
    return args


def add_args() -> argparse.Namespace:
    """Bootstrap CLI flags (``--cf <yaml>``)."""
    parser = argparse.ArgumentParser(description="fedml_tpu_torch")
    parser.add_argument("--cf", "--config_file", dest="yaml_config_file",
                        type=str, default=None, help="yaml configuration file")
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--role", type=str, default="client")
    parser.add_argument("--run_id", type=str, default="0")
    known, _ = parser.parse_known_args()
    return known

