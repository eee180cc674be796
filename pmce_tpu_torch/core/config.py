"""Typed configuration with strict YAML overlay.

The port's own copy of ``pmce_tpu/core/config.py`` (same groups, keys and
defaults, so the same ``configs/*.yml`` load into either package): DATASET
/ MODEL / TRAIN / AUG / TEST as dataclasses with a strict overlay, where
unknown keys raise like the reference's ``update_config``. PyYAML is
imported only when a YAML path is given, so code that sets the values
itself needs no YAML package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any


@dataclasses.dataclass
class DatasetConfig:
    train_list: list = dataclasses.field(
        default_factory=lambda: ["Human36M"])
    test_list: list = dataclasses.field(default_factory=lambda: ["PW3D"])
    input_joint_set: str = "coco"
    target_joint_set: str = "coco"
    workers: int = 0
    use_gt_input: bool = False
    seqlen: int = 16
    stride: int = 1
    noise: float = 0.0
    BASE_DATA_DIR: str = "data/base_data"
    # Additions (not in the reference):
    synthetic: bool = False          # run on generated fixture data
    synthetic_samples: int = 256     # fixture size per dataset


@dataclasses.dataclass
class ModelConfig:
    name: str = "PMCE"
    hpe_dim: int = 256
    hpe_dep: int = 3
    joint_dim: int = 64
    vertx_dim: int = 64
    input_shape: tuple = (384, 288)
    normal_loss_weight: float = 1e-1
    edge_loss_weight: float = 20.0
    joint_loss_weight: float = 1e-3
    posenet_pretrained: bool = False
    posenet_path: str = ""
    # Additions:
    num_verts: int = 6890
    num_vertx_coarse: int = 431
    # Mixed-precision policy: "float32" = full-f32 products (metric-grade,
    # the reference's effective numerics); "bfloat16" = bf16 products with
    # f32 params and f32 coordinate heads.
    compute_dtype: str = "float32"
    # Route the transformer blocks through the kernel entry points
    # (ops/fused_attention.py): same math, kernels forward and backward.
    fused_attn: bool = False


@dataclasses.dataclass
class TrainConfig:
    print_freq: int = 20
    batch_size: int = 32
    shuffle: bool = True
    begin_epoch: int = 1
    end_epoch: int = 20
    edge_loss_start: int = 2
    scheduler: str = "step"
    lr: float = 5e-5
    lr_step: list = dataclasses.field(default_factory=lambda: [5, 10, 15])
    lr_factor: float = 0.95
    optimizer: str = "adam"
    wandb: bool = False
    # Additions:
    seed: int = 123
    steps_per_epoch: int = 0         # 0 = full dataset
    data_axis: str = "data"          # mesh axis for batch sharding
    # Shard params + optimizer state over data-parallel devices (the JAX
    # package's FSDP; not ported yet: the port trains on one card).
    fsdp: bool = False


@dataclasses.dataclass
class AugConfig:
    flip: bool = False
    rotate_factor: float = 0.0


@dataclasses.dataclass
class TestConfig:
    batch_size: int = 64
    shuffle: bool = False
    vis: bool = False
    weight_path: str = ""


@dataclasses.dataclass
class Config:
    DATASET: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    MODEL: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    TRAIN: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    AUG: AugConfig = dataclasses.field(default_factory=AugConfig)
    TEST: TestConfig = dataclasses.field(default_factory=TestConfig)
    output_dir: str = "experiment"
    data_dir: str = "data"


def _overlay(obj: Any, updates: dict, path: str) -> None:
    for key, value in updates.items():
        if not hasattr(obj, key):
            raise ValueError(f"{path}.{key} does not exist in the config")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _overlay(current, value, f"{path}.{key}")
        else:
            if isinstance(current, tuple) and isinstance(value, list):
                value = tuple(value)
            setattr(obj, key, value)


def load_config(yaml_path: str | None = None,
                overrides: dict | None = None) -> Config:
    """Build a Config from defaults + optional YAML + optional dict overlay.

    Unknown keys anywhere raise ValueError (strict, like the reference).
    """
    cfg = Config()
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        _overlay(cfg, data, "cfg")
    if overrides:
        _overlay(cfg, overrides, "cfg")
    return cfg


def ensure_output_dirs(cfg: Config, tag: str = "run") -> dict[str, str]:
    """Create (never delete) the output directory tree for one run."""
    out = os.path.join(cfg.output_dir, tag)
    dirs = {
        "output": out,
        "checkpoint": os.path.join(out, "checkpoint"),
        "vis": os.path.join(out, "vis"),
        "result": os.path.join(out, "result"),
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    return dirs
