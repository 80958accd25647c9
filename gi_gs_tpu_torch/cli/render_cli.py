"""NVS evaluation CLI (port of gi_gs_tpu/cli/render_cli.py; ref render.py
render_set): renders the test views through the full PBR + SSR path,
saves the image products and writes PSNR/SSIM to `NVS.json`. LPIPS needs
pretrained VGG weights that are not shipped; `lpips_avg` is null, as in
the JAX CLI. Albedo evaluation waits for a later slice.

    python -m gi_gs_tpu_torch.cli.render_cli --model_path OUT \
        --source_path SCENE [--device cpu] [--max_views N]

The model directory holds the port's `chkpnt{it}.pt` (see
utils/checkpoint.py) and, optionally, `cfg_args.json`.
"""
from __future__ import annotations

import json
import os
import time
import types
from argparse import ArgumentParser
from typing import Dict, Optional

import numpy as np
import torch

from .. import config as config_mod
from ..models import light as light_mod
from ..ops import screen_space
from ..ops.shading import pbr_shading_chw
from ..renderer import render
from ..scene.cameras import compute_view_dirs
from ..scene.dataset import load_scene
from ..utils import checkpoint as ckpt
from ..utils import image_utils, math_utils, timing
from ..utils.device import resolve_device
from ..utils.image_io import write_png


def save_image(path: str, img, chw: bool = True) -> None:
    arr = img.detach().cpu().numpy() if torch.is_tensor(img) else \
        np.asarray(img)
    if chw and arr.ndim == 3:
        arr = arr.transpose(1, 2, 0)
    arr = np.clip(arr, 0.0, 1.0)
    write_png(path, (arr * 255).astype(np.uint8))


@torch.inference_mode()
def build_light(cfg, cubemap: torch.Tensor) -> light_mod.CubemapLight:
    """Prefiltered light of the cubemap base on its device."""
    with timing.stage("prefilter_tables", cubemap.device):
        spec, arrays = light_mod.build_prefilter_tables(
            cubemap.shape[1], device=cubemap.device)
    with timing.stage("build_mips", cubemap.device):
        return light_mod.build_mips_packed(cubemap, spec, arrays)


@torch.inference_mode()
def render_pbr_view(cfg, state, cam, bg: torch.Tensor, light=None,
                    albedo_ratio: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """Full PBR + SSR render of one view (render.py:206-341). `state`
    carries `params` (GaussianParams) and `cubemap`; the view renders on
    their device."""
    dev = resolve_device(state.params.device)
    if light is None:
        light = build_light(cfg, state.cubemap)
    t = cfg.train
    res = render(cam, state.params, bg, cfg.raster, cfg.gi, inference=True,
                 pad_normal=True, derive_normal=True, compute_occlusion=True)
    rmax, rmin = 1.0, 0.04
    roughness_map = res["roughness_map"] * (rmax - rmin) + rmin
    albedo_map = res["albedo_map"]
    if albedo_ratio is not None:
        albedo_map = albedo_map * albedo_ratio[:, None, None]
    metallic_map = res["metallic_map"]
    normal_mask = res["normal_mask"]
    with timing.stage("shading", dev):
        pbr = pbr_shading_chw(
            light=light, normals=res["normal_map_world"],
            view_dirs=compute_view_dirs(cam), albedo=albedo_map,
            roughness=roughness_map, mask=normal_mask, tone=t.tone,
            gamma=t.gamma, occlusion=res["occlusion_map"],
            metallic=metallic_map if t.metallic else None)
        b = bg[:, None, None]
        diffuse_rgb = torch.where(
            normal_mask, torch.clamp(pbr["diffuse_rgb"], 0, 1), b)
        specular_rgb = torch.where(
            normal_mask, torch.clamp(pbr["specular_rgb"], 0, 1), b)
        render_rgb = torch.where(normal_mask, pbr["render_rgb"], b)
    if t.metallic:
        f0 = (1.0 - metallic_map) * 0.04 + albedo_map * metallic_map
    else:
        f0 = torch.full_like(albedo_map, 0.04)
        metallic_map = torch.zeros_like(roughness_map)

    with timing.stage("ssr", dev):
        linear_rgb = math_utils.srgb_to_linear(render_rgb)
        irr, _ = screen_space.ssr(
            res["out_normal_view"], res["depth_pos"], linear_rgb, albedo_map,
            roughness_map, metallic_map, f0, cam.fx, cam.fy, cfg.gi)
        irr2 = image_utils.median_blur_3x3(math_utils.linear_to_srgb(irr))
        render_rgb = torch.where(normal_mask, render_rgb + irr2, b)
    return {
        "render_rgb": render_rgb, "diffuse_rgb": diffuse_rgb,
        "specular_rgb": specular_rgb, "indirect": irr2,
        "albedo_map": albedo_map, "roughness_map": roughness_map,
        "metallic_map": metallic_map, "normal_map": res["normal_map"],
        "normal_map_from_depth": res["normal_map_from_depth"],
        "normal_mask": normal_mask, "depth_map": res["depth_map"],
        "occlusion_map": res["occlusion_map"], "render_raw": res["render"],
        "overflow": res["overflow"],
    }


def _save_products(out_root, idx, name, out, gt):
    pbr = os.path.join(out_root, "pbr")
    for key, suffix in (("render_rgb", ""), ("albedo_map", "_albedo"),
                        ("roughness_map", "_roughness"),
                        ("metallic_map", "_metallic"),
                        ("diffuse_rgb", "_diffuse"),
                        ("specular_rgb", "_specular"),
                        ("indirect", "_indirect"),
                        ("occlusion_map", "_occlusion")):
        save_image(os.path.join(pbr, f"{name}{suffix}.png"), out[key])
    sheet = torch.cat([out["albedo_map"],
                       out["roughness_map"].expand(3, -1, -1),
                       out["metallic_map"].expand(3, -1, -1)], dim=2)
    save_image(os.path.join(pbr, f"{name}_brdf.png"), sheet)
    save_image(os.path.join(pbr, f"{name}_DIR.png"),
               torch.clamp(out["render_rgb"] - out["indirect"], 0, 1))
    save_image(os.path.join(out_root, "normal", f"{name}_normal.png"),
               (out["normal_map"] + 1) / 2)
    save_image(os.path.join(out_root, "normal", f"{name}_from_depth.png"),
               (out["normal_map_from_depth"] + 1) / 2)
    d = out["depth_map"]
    save_image(os.path.join(out_root, "depth", f"{name}_depth.png"),
               (d - d.min()) / torch.clamp(d.max() - d.min(), min=1e-6))
    save_image(os.path.join(out_root, "renders", f"{idx:05d}.png"),
               out["render_raw"])
    save_image(os.path.join(out_root, "gt", f"{idx:05d}.png"), gt)


def main(argv=None):
    parser = ArgumentParser(description="gi_gs_tpu_torch NVS rendering/eval")
    config_mod.add_args(parser)
    parser.add_argument("--checkpoint", type=str, default="")
    parser.add_argument("--max_views", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_mod.load_cfg(args.model_path) \
        if os.path.exists(os.path.join(args.model_path or "",
                                       "cfg_args.json")) else config_mod.Config()
    cfg = config_mod.from_args(args, cfg)
    if args.backend is None:
        # Eval runs the exact march whatever backend cfg_args.json saved
        # (the coherent march is a training-speed approximation), as the
        # JAX CLI does; --backend pallas asks for the coherent one.
        cfg.gi = cfg.gi._replace(backend="pallas_exact")

    ckpt_path = args.checkpoint
    if not ckpt_path:
        cands = sorted(f for f in os.listdir(cfg.model.model_path)
                       if f.startswith("chkpnt") and f.endswith(".pt"))
        if not cands:
            raise FileNotFoundError(
                f"no chkpnt*.pt in {cfg.model.model_path}")
        ckpt_path = os.path.join(cfg.model.model_path, cands[-1])
    params, cubemap, extra = ckpt.load_state(ckpt_path, device)
    state = types.SimpleNamespace(params=params, cubemap=cubemap)
    iteration = extra.get("iteration", 0)

    scene = load_scene(cfg.model.source_path, images=cfg.model.images,
                       eval_split=True, resolution=cfg.model.resolution,
                       white_background=cfg.model.white_background,
                       max_cameras=cfg.model.max_cameras or None)
    views = scene.test_cameras or scene.train_cameras
    if args.max_views:
        views = views[:args.max_views]

    out_root = os.path.join(cfg.model.model_path, "test", f"ours_{iteration}")
    for sub in ("renders", "gt", "normal", "pbr", "depth"):
        os.makedirs(os.path.join(out_root, sub), exist_ok=True)

    light = build_light(cfg, state.cubemap)
    with torch.inference_mode():
        envmap = light_mod.export_envmap(state.cubemap)
    save_image(os.path.join(cfg.model.model_path, "test", "envmap.png"),
               envmap / max(float(envmap.max()), 1e-6), chw=False)

    bg = torch.zeros(3, device=device)
    psnrs, ssims, view_seconds = [], [], []
    for idx, rec in enumerate(views):
        cam = rec.camera(device)
        image = torch.as_tensor(rec.image, device=device)
        alpha = torch.as_tensor(rec.alpha, device=device)
        gt = torch.clamp(image * alpha + bg[:, None, None] * (1 - alpha), 0, 1)
        t0 = time.perf_counter()
        out = render_pbr_view(cfg, state, cam, bg, light=light)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        view_seconds.append(time.perf_counter() - t0)
        _save_products(out_root, idx, rec.name, out, gt)
        pred = torch.clamp(out["render_rgb"], 0, 1)
        psnrs.append(float(image_utils.psnr(pred, gt)))
        ssims.append(float(image_utils.ssim(pred, gt)))
        if int(out["overflow"]) > 0:
            print(f"view {idx}: {int(out['overflow'])} instances beyond "
                  f"cap_instances={cfg.raster.cap_instances} were dropped",
                  flush=True)
        print(f"view {idx} psnr {psnrs[-1]:.2f}", flush=True)

    results = {"psnr_avg": float(np.mean(psnrs)),
               "ssim_avg": float(np.mean(ssims)),
               "lpips_avg": None}
    with open(os.path.join(out_root, "pbr", "NVS.json"), "w") as f:
        json.dump(results, f, indent=4)
    print(json.dumps(results, indent=2))
    return dict(results, view_seconds=view_seconds)


if __name__ == "__main__":
    main()
