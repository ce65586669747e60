"""Hierarchical experiment configuration (counterpart of
pidnet_tpu/config.py).

The JAX package's YAML schema, defaults and ``KEY VALUE`` overrides (the
reference's configs/default.py:12-97), as an explicit, freezable node
tree with no global singleton: ``load_config(yaml_path, opts)`` gives the
same tree as the JAX package's for every file under configs/. The
engine's functions read it as they read ``engine.config(...)``. The
``XLA`` and ``CUDNN`` sections are kept so that every YAML loads
unchanged; the port reads neither yet.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Iterable

import yaml


class ConfigNode:
    """A freezable attribute tree (``cfg.TRAIN.LR``-style access)."""

    def __init__(self, init: dict[str, Any] | None = None):
        object.__setattr__(self, "_frozen", False)
        object.__setattr__(self, "_fields", {})
        if init:
            for k, v in init.items():
                self._fields[k] = ConfigNode(v) if isinstance(v, dict) else v

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        fields = object.__getattribute__(self, "_fields")
        if name in fields:
            return fields[name]
        raise AttributeError(f"Config has no key {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"Config is frozen; cannot set {name!r}")
        self._fields[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._fields

    def keys(self) -> Iterable[str]:
        return self._fields.keys()

    def to_dict(self) -> dict[str, Any]:
        return {
            k: v.to_dict() if isinstance(v, ConfigNode) else v
            for k, v in self._fields.items()
        }

    def __repr__(self) -> str:  # readable multi-line dump for logging
        return yaml.safe_dump(self.to_dict(), default_flow_style=None, sort_keys=False)

    # -- mutation ------------------------------------------------------------
    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, "_frozen", True)
        for v in self._fields.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        return self

    def clone(self) -> "ConfigNode":
        node = ConfigNode()
        for k, v in self._fields.items():
            node._fields[k] = v.clone() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return node

    def merge_dict(self, other: dict[str, Any]) -> None:
        for k, v in other.items():
            if k not in self._fields:
                raise KeyError(f"Unknown config key {k!r}")
            cur = self._fields[k]
            if isinstance(cur, ConfigNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Config key {k!r} expects a mapping")
                cur.merge_dict(v)
            else:
                self._fields[k] = _coerce(v, cur)

    def merge_list(self, opts: list[str] | None) -> None:
        """Apply ``KEY VALUE`` pairs (dotted keys), e.g. ``TRAIN.LR 0.02``."""
        if not opts:
            return
        if len(opts) % 2 != 0:
            raise ValueError("Override list must be KEY VALUE pairs")
        for key, raw in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = getattr(node, p)
            leaf = parts[-1]
            if leaf not in node._fields:
                raise KeyError(f"Unknown config key {key!r}")
            try:
                value = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                value = raw
            node._fields[leaf] = _coerce(value, node._fields[leaf])


def _coerce(value: Any, template: Any) -> Any:
    """Cast overrides to the default's type where that is unambiguous."""
    if template is None or value is None:
        return value
    if isinstance(template, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(template, float) and isinstance(value, int):
        return float(value)
    if isinstance(template, (list, tuple)) and isinstance(value, (list, tuple)):
        return list(value)
    if isinstance(template, str) and not isinstance(value, str):
        return str(value)
    return value


def default_config() -> ConfigNode:
    """Default tree: the JAX package's keys and defaults (reference
    configs/default.py:12-97, plus its ``XLA`` section and DATASET.CACHE,
    CACHE_GB and TRAIN.ACCUM_STEPS)."""
    return ConfigNode(
        {
            "OUTPUT_DIR": "",
            "LOG_DIR": "",
            "DEVICES": -1,  # number of devices for data parallelism; -1 = all
            "GPUS": (0,),  # accepted for reference-YAML compat; DEVICES wins
            "WORKERS": 4,
            "PRINT_FREQ": 20,
            "AUTO_RESUME": False,
            "PIN_MEMORY": True,
            "SEED": 304,
            "CUDNN": {"BENCHMARK": True, "DETERMINISTIC": False, "ENABLED": True},
            "XLA": {
                # the JAX package's compute-dtype, BN and padding switches
                "BF16_INFERENCE": True,
                "BF16_TRAIN": True,
                "BF16_EVAL": False,
                "SYNC_BN": False,
                "PAD_BATCH": True,
                "PROFILE_DIR": "",
            },
            "MODEL": {
                "NAME": "pidnet_s",
                "PRETRAINED": "pretrained_models/imagenet/PIDNet_S_ImageNet.pth.tar",
                "ALIGN_CORNERS": True,
                "NUM_OUTPUTS": 2,
            },
            "LOSS": {
                "USE_OHEM": True,
                "OHEMTHRES": 0.9,
                "OHEMKEEP": 100000,
                "CLASS_BALANCE": False,
                "BALANCE_WEIGHTS": [0.5, 0.5],
                "SB_WEIGHTS": 0.5,
            },
            "DATASET": {
                "ROOT": "data/",
                "DATASET": "cityscapes",
                "NUM_CLASSES": 19,
                "TRAIN_SET": "list/cityscapes/train.lst",
                "EXTRA_TRAIN_SET": "",
                "TEST_SET": "list/cityscapes/val.lst",
                # memoize decoded images and labels and their edge targets
                # in host memory (data/base.py); no reference analogue
                "CACHE": False,
                # CACHE's byte budget in GiB (an LRU bound)
                "CACHE_GB": 32.0,
            },
            "TRAIN": {
                "IMAGE_SIZE": [1024, 1024],  # width * height
                "BASE_SIZE": 2048,
                "FLIP": True,
                "MULTI_SCALE": True,
                "SCALE_FACTOR": 16,
                "LR": 0.01,
                "EXTRA_LR": 0.001,
                "OPTIMIZER": "sgd",
                "MOMENTUM": 0.9,
                "WD": 0.0001,
                "NESTEROV": False,
                "IGNORE_LABEL": -1,
                "BEGIN_EPOCH": 0,
                "END_EPOCH": 484,
                "EXTRA_EPOCH": 0,
                "RESUME": False,
                "BATCH_SIZE_PER_GPU": 32,
                "SHUFFLE": True,
                # gradient accumulation as virtual data-parallel shards (the
                # JAX package's; not ported yet); no reference analogue
                "ACCUM_STEPS": 1,
            },
            "TEST": {
                "IMAGE_SIZE": [2048, 1024],  # width * height
                "BASE_SIZE": 2048,
                "BATCH_SIZE_PER_GPU": 32,
                "MODEL_FILE": "",
                "FLIP_TEST": False,
                "MULTI_SCALE": False,
                # engine.make_ms_flip_inference's scales under
                # TEST.MULTI_SCALE: the HRNet/Cityscapes TTA sweep
                "SCALE_LIST": [0.5, 0.75, 1.0, 1.25, 1.5, 1.75],
                "OUTPUT_INDEX": -1,
            },
        }
    )


def load_config(cfg_path: str, opts: list[str] | None = None) -> ConfigNode:
    """YAML merge + CLI ``KEY VALUE`` overrides, then freeze."""
    cfg = default_config()
    with open(cfg_path) as f:
        data = yaml.safe_load(f) or {}
    cfg.merge_dict(data)
    cfg.merge_list(opts)
    return cfg.freeze()
