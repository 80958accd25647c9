"""The two sides a cell runs: the program under test (`gi_gs_tpu_torch`)
and the plain reference (`perfbench.reference.plain`, a frozen copy of
the program's plain PyTorch path as of commit 4cf87c6). Both have the same modules and entry
points, so one adapter builds either from a cell's inputs; the package
is imported by name, so building the reference imports nothing of the
program."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

import numpy as np
import torch

from . import scenes

PROGRAM = "gi_gs_tpu_torch"
REFERENCE = "perfbench.reference.plain"
B1 = 0.9                      # Adam's first-moment decay, both sides


class Side:
    def __init__(self, package: str):
        self.package = package
        m = lambda name: importlib.import_module(f"{package}.{name}")
        self.config = m("config")
        self.gaussians = m("models.gaussians")
        self.cameras = m("scene.cameras")
        self.trainer = m("train.trainer")
        self.optim = m("train.optim")
        self.render_cli = m("cli.render_cli")
        self.timing = m("utils.timing")
        self.preprocess = m("ops.rasterize.preprocess")
        self.binning = m("ops.rasterize.binning")
        self.binning_quantum = m("ops.rasterize.pipeline").CAP_QUANTUM

    # -- configuration ----------------------------------------------------
    def make_config(self, cfg: dict):
        """The side's Config with the configuration file's groups
        (`model`, `opt`, `train`, `raster`, `gi`) laid over its defaults."""
        c = self.config.Config()
        for group, values in cfg["port"].items():
            cur = getattr(c, group)
            setattr(c, group, dataclasses.replace(cur, **values)
                    if dataclasses.is_dataclass(cur) else cur._replace(**values))
        return c

    # -- inputs -----------------------------------------------------------
    def params(self, cfg: dict, fields: Dict[str, torch.Tensor], dev):
        """GaussianParams of the cell's generated fields in capacity
        `capacity`, with every SH degree active. Fields without `scaling`
        get the program's own init from the points' nearest neighbours
        (`create_from_points`), as a scene loaded from its points does."""
        deg = cfg["port"]["model"]["sh_degree"]
        cap = cfg["capacity"]
        if "scaling" not in fields:
            init = self.gaussians.create_from_points(
                fields["xyz"].cpu().numpy(),
                np.zeros(fields["xyz"].shape, np.float32), capacity=cap,
                max_sh_degree=deg, device=dev)
            fields = dict(fields, scaling=init.scaling[:fields["xyz"].shape[0]])
        f = scenes.padded(fields, cap)
        return self.gaussians.GaussianParams(**f, active_sh_degree=deg,
                                             max_sh_degree=deg)

    def camera_list(self, views: List[scenes.View], dev):
        return [self.cameras.make_camera(v.R, v.T, v.fovx, v.fovy, v.width,
                                         v.height, device=dev)
                for v in views]

    # -- capacities ---------------------------------------------------------
    @torch.no_grad()
    def size_capacities(self, cfg, params, cams,
                        headroom: float = 1.0) -> None:
        """cfg.raster's instance and tile-depth capacities as the train CLI
        sets them, over every camera the cell renders: `cap_instances`
        from `probe_cap_instances`, and `cap_tile` grown past the densest
        tile's pre-cap population by the CLI's rule (x1.3, chunk-aligned),
        so that nothing overflows. `headroom` > 1 sizes both for that many
        times the population (traffic whose population grows)."""
        r = cfg.raster
        cap = self.trainer.probe_cap_instances(cfg, params, cams,
                                               max_views=len(cams))
        if headroom != 1.0:
            q = self.binning_quantum
            cap = -(-int(cap * headroom) // q) * q
        r = dataclasses.replace(r, cap_instances=cap)
        cov3d = params.get_covariance(1.0)
        opacity = params.get_opacity()
        worst = torch.zeros((), dtype=torch.int64, device=params.device)
        for cam in cams:
            pre = self.preprocess.preprocess(
                params.xyz, cov3d, cam.w2c, cam.full_proj, cam.tanfovx,
                cam.tanfovy, cam.width, cam.height, r, opacity=opacity)
            b = self.binning.bin_and_sort(pre, cam.height, cam.width, r)
            worst = torch.maximum(worst, b.max_tile_count.to(torch.int64))
        worst = int(int(worst) * headroom)
        if worst > r.cap_tile:
            ch = r.chunk
            r = dataclasses.replace(
                r, cap_tile=-(-int(worst * 1.3) // ch) * ch)
        cfg.raster = r


def fast_forward_counts(state, it0: int):
    """Add it0 to every Gaussian group's Adam count, not the light's (the
    quality gate's `fast_forward_counts`): the schedules and the bias
    correction read the count as a run at iteration it0 would have it."""
    return state.replace(opt_state={
        grp: dict(st, count=st["count"] + it0)
        for grp, st in state.opt_state.items()})


def leaves(state, n_alive: int, light: bool) -> Dict[str, torch.Tensor]:
    """The trained leaves on the host: each Gaussian field's live rows,
    and the cubemap where the light trains."""
    out = {f: t[:n_alive].detach().double().cpu()
           for f, t in state.params.__dict__.items()
           if f in ("xyz", "features_dc", "features_rest", "opacity",
                    "normal", "albedo", "roughness", "metallic", "scaling",
                    "rotation")}
    if light:
        out["cubemap"] = state.cubemap.detach().double().cpu()
    return out


def first_gradients(state, n_alive: int, light: bool) -> Dict[str, float]:
    """Norm per leaf of the first step's gradient as the optimizer got
    it, worked out from its state after that step: mu / (1 - b1), since
    the moments started at zero. Live rows only: dead slots carry
    round-off of no meaning."""
    fields = {"f_dc": "features_dc", "f_rest": "features_rest"}
    out = {fields.get(g, g): float(torch.linalg.norm(
               st["mu"][:n_alive].double())) / (1 - B1)
           for g, st in state.opt_state.items()}
    if light:
        out["cubemap"] = float(torch.linalg.norm(
            state.light_opt_state["cubemap"]["mu"].double())) / (1 - B1)
    return out


def change_norms(before: Dict[str, torch.Tensor],
                 after: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.norm(after[k] - before[k])) for k in before}
