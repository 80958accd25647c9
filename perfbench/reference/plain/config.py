"""Configuration — the same dataclass groups, flag vocabulary and defaults
as gi_gs_tpu/config.py, so a `cfg_args.json` written by the JAX trainer
loads unchanged and every `--<field>` flag keeps its name.
"""
from __future__ import annotations

import dataclasses
import json
import os
from argparse import ArgumentParser, Namespace
from typing import List, Optional

from .ops.rasterize import RasterConfig
from .ops.screen_space import GIParams


@dataclasses.dataclass
class ModelConfig:
    """Ref ModelParams (arguments/__init__.py:52-67)."""
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = False
    capacity: int = 1 << 19
    max_capacity: int = 1 << 22
    max_cameras: int = 0             # 0 = all (debug subsetting)


@dataclasses.dataclass
class OptimizationConfig:
    """Ref OptimizationParams (arguments/__init__.py:78-98)."""
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    BRDF_lr: float = 0.005
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    size_screen_threshold: float = 20.0
    random_background: bool = False
    brdf_lr_offset: int = 30_000


@dataclasses.dataclass
class TrainConfig:
    """Ref train.py top-level flags (train.py:821-899)."""
    pbr_iteration: int = 30_000
    metallic: bool = False
    tone: bool = False
    gamma: bool = False
    indirect: bool = False
    normal_tv_weight: float = 5.0
    brdf_tv_weight: float = 1.0
    env_tv_weight: float = 0.01
    test_iterations: List[int] = dataclasses.field(
        default_factory=lambda: [7_000, 30_000])
    save_iterations: List[int] = dataclasses.field(
        default_factory=lambda: [30_000, 35_000, 40_000])
    checkpoint_iterations: List[int] = dataclasses.field(default_factory=list)
    start_checkpoint: str = ""
    seed: int = 0
    light_base_res: int = 256
    dp: int = 1
    hdri_path: str = ""


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    opt: OptimizationConfig = dataclasses.field(default_factory=OptimizationConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    raster: RasterConfig = dataclasses.field(default_factory=RasterConfig)
    gi: GIParams = dataclasses.field(default_factory=GIParams)


_GROUPS = ("model", "opt", "train", "raster", "gi")


def _items(group):
    if dataclasses.is_dataclass(group):
        return [(f.name, getattr(group, f.name))
                for f in dataclasses.fields(group)]
    return list(group._asdict().items())  # GIParams is a NamedTuple


def _replace(group, kw):
    if dataclasses.is_dataclass(group):
        return dataclasses.replace(group, **kw)
    return group._replace(**kw)


def add_args(parser: ArgumentParser, cfg: Optional[Config] = None) -> None:
    cfg = cfg or Config()
    seen = set()
    for gname in _GROUPS:
        pg = parser.add_argument_group(gname)
        for name, value in _items(getattr(cfg, gname)):
            if name in seen:
                continue
            seen.add(name)
            if isinstance(value, bool):
                pg.add_argument(f"--{name}", action="store_true", default=None)
            elif isinstance(value, list):
                pg.add_argument(f"--{name}", nargs="+", type=int, default=None)
            else:
                pg.add_argument(f"--{name}", type=type(value), default=None)


def from_args(args: Namespace, base: Optional[Config] = None) -> Config:
    cfg = base or Config()
    updates = {k: v for k, v in vars(args).items() if v is not None}
    for gname in _GROUPS:
        group = getattr(cfg, gname)
        names = {n for n, _ in _items(group)}
        kw = {k: v for k, v in updates.items() if k in names}
        if kw:
            setattr(cfg, gname, _replace(group, kw))
    return cfg


def save_cfg(cfg: Config, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    out = {gname: dict(_items(getattr(cfg, gname))) for gname in _GROUPS}
    with open(os.path.join(path, "cfg_args.json"), "w") as f:
        json.dump(out, f, indent=2)


def load_cfg(path: str, base: Optional[Config] = None) -> Config:
    cfg = base or Config()
    with open(os.path.join(path, "cfg_args.json")) as f:
        data = json.load(f)
    for gname in _GROUPS:
        if gname in data:
            setattr(cfg, gname, _replace(getattr(cfg, gname), data[gname]))
    return cfg
