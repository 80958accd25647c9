"""NVS and albedo evaluation CLI (port of gi_gs_tpu/cli/render_cli.py;
ref render.py render_set :115-395, eval_brdf :496-635): renders the test
views through the full PBR + SSR path, saves the image products and
writes PSNR/SSIM(/LPIPS) to `NVS.json`. LPIPS needs VGG weights that are
not shipped: `--lpips_weights FILE` computes `lpips_avg` (utils/lpips.py
names the formats), without it the value is null, as in the JAX CLI.
`--brdf_eval` adds the TensoIR albedo evaluation (`eval_albedo`).

    python -m gi_gs_tpu_torch.cli.render_cli --model_path OUT \
        --source_path SCENE [--device cpu] [--max_views N] [--brdf_eval] \
        [--lpips_weights FILE]

The model directory holds the port's `chkpnt{it}.pt` (see
utils/checkpoint.py) and, optionally, `cfg_args.json`. `--skip_train`
and `--pbr` are accepted for the JAX CLI's command lines; as there, the
test views are rendered through the PBR path either way.
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
from ..utils import lpips as lpips_mod
from ..utils.device import resolve_device
from ..utils.image_io import read_png, write_png


def save_image(path: str, img, chw: bool = True) -> None:
    arr = img.detach().cpu().numpy() if torch.is_tensor(img) else \
        np.asarray(img)
    if chw and arr.ndim == 3:
        arr = arr.transpose(1, 2, 0)
    arr = np.clip(arr, 0.0, 1.0)
    write_png(path, (arr * 255).astype(np.uint8))


@torch.inference_mode()
@timing.spanned("light")
def build_light(cfg, cubemap: torch.Tensor) -> light_mod.CubemapLight:
    """Prefiltered light of the cubemap base on its device: the span
    `light` (a root where a relight builds it, under `view` where
    `render_pbr_view` does) and one count of `light_builds`. The tables
    are uploaded by the first build on a device and kept."""
    timing.count("light_builds", 1)
    with timing.stage("prefilter_tables", cubemap.device):
        spec, arrays = light_mod.build_prefilter_tables(
            cubemap.shape[1], device=cubemap.device)
    with timing.stage("build_mips", cubemap.device):
        return light_mod.build_mips_packed(cubemap, spec, arrays)


@torch.inference_mode()
@timing.spanned("view")
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


def eval_albedo(cfg, state, records, out_dir: str, device: torch.device
                ) -> Dict:
    """Albedo evaluation with a 3-channel median-ratio rescale (TensoIR
    protocol, render.py:496-635; JAX render_cli.eval_albedo). GT albedo is
    `<name>_albedo.png` in the scene's test folder or its root. The ratio
    is the per-channel median of GT / prediction over the masked pixels of
    the whole set; writes `albedo_{i:05d}.png` and `albedo_ratio.json`
    under `out_dir`. Also returns the per-view render seconds
    (`view_seconds`, device synchronised)."""
    gts, preds, masks, seconds = [], [], [], []
    bg = torch.zeros(3, device=device)
    for rec in records:
        gt_path = None
        for cand in (os.path.join(cfg.model.source_path, "test",
                                  f"{rec.name}_albedo.png"),
                     os.path.join(cfg.model.source_path,
                                  f"{rec.name}_albedo.png")):
            if os.path.exists(cand):
                gt_path = cand
                break
        if gt_path is None:
            continue
        gts.append(read_png(gt_path).astype(np.float32)[..., :3] / 255.0)
        t0 = time.perf_counter()
        with torch.inference_mode():
            res = render(rec.camera(device), state.params, bg, cfg.raster,
                         cfg.gi, inference=True, pad_normal=True,
                         derive_normal=False, compute_occlusion=False)
            preds.append(res["albedo_map"].cpu().numpy().transpose(1, 2, 0))
        seconds.append(time.perf_counter() - t0)
        masks.append(rec.alpha[0] > 0.5)
    if not gts:
        return {"error": "no GT albedo found"}

    all_gt = np.concatenate([g[m] for g, m in zip(gts, masks)], 0)
    all_pr = np.concatenate([p[m] for p, m in zip(preds, masks)], 0)
    ratio = np.median(all_gt / np.clip(all_pr, 1e-6, None), axis=0)

    psnrs, ssims = [], []
    os.makedirs(out_dir, exist_ok=True)
    for i, (g, p, m) in enumerate(zip(gts, preds, masks)):
        scaled = np.clip(p * ratio, 0, 1) * m[..., None]
        gm = g * m[..., None]
        a = torch.as_tensor(scaled.transpose(2, 0, 1), device=device)
        b = torch.as_tensor(gm.transpose(2, 0, 1), device=device)
        psnrs.append(float(image_utils.psnr(a, b)))
        ssims.append(float(image_utils.ssim(a, b)))
        save_image(os.path.join(out_dir, f"albedo_{i:05d}.png"), scaled,
                   chw=False)
    with open(os.path.join(out_dir, "albedo_ratio.json"), "w") as f:
        json.dump({"albedo_ratio": ratio.tolist()}, f)
    return {"albedo_psnr": float(np.mean(psnrs)),
            "albedo_ssim": float(np.mean(ssims)),
            "albedo_ratio": ratio.tolist(), "view_seconds": seconds}


def find_checkpoint(model_path: str) -> str:
    """The last `chkpnt*.pt` of `model_path` in sorted (lexicographic)
    order, as the JAX CLIs pick theirs: chkpnt9 sorts after chkpnt10."""
    cands = sorted(f for f in os.listdir(model_path)
                   if f.startswith("chkpnt") and f.endswith(".pt"))
    if not cands:
        raise FileNotFoundError(f"no chkpnt*.pt in {model_path}")
    return os.path.join(model_path, cands[-1])


def eval_config(args) -> config_mod.Config:
    """cfg_args.json of the model (if any) under the command line; the
    exact march unless --backend names one."""
    cfg = config_mod.load_cfg(args.model_path) \
        if os.path.exists(os.path.join(args.model_path or "",
                                       "cfg_args.json")) else config_mod.Config()
    cfg = config_mod.from_args(args, cfg)
    if args.backend is None:
        # Eval runs the exact march whatever backend cfg_args.json saved
        # (the coherent march is a training-speed approximation), as the
        # JAX CLIs do; --backend pallas asks for the coherent one.
        cfg.gi = cfg.gi._replace(backend="pallas_exact")
    return cfg


def main(argv=None):
    parser = ArgumentParser(description="gi_gs_tpu_torch NVS rendering/eval")
    config_mod.add_args(parser)
    parser.add_argument("--checkpoint", type=str, default="")
    parser.add_argument("--skip_train", action="store_true", default=True)
    parser.add_argument("--pbr", action="store_true")
    parser.add_argument("--brdf_eval", action="store_true")
    parser.add_argument("--max_views", type=int, default=0)
    parser.add_argument("--lpips_weights", type=str, default="",
                        help="VGG-LPIPS weights file (.npz or torch .pt); "
                             "lpips_avg is null when absent")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    lpips_w = lpips_mod.maybe_load(args.lpips_weights)
    cfg = eval_config(args)
    ckpt_path = args.checkpoint or find_checkpoint(cfg.model.model_path)
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
    psnrs, ssims, lpipss, view_seconds, lpips_seconds = [], [], [], [], []
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
        if lpips_w is not None:
            t0 = time.perf_counter()
            lpipss.append(lpips_mod.lpips(pred, gt, lpips_w))
            lpips_seconds.append(time.perf_counter() - t0)
        if int(out["overflow"]) > 0:
            print(f"view {idx}: {int(out['overflow'])} instances beyond "
                  f"cap_instances={cfg.raster.cap_instances} were dropped",
                  flush=True)
        print(f"view {idx} psnr {psnrs[-1]:.2f}", flush=True)

    results = {"psnr_avg": float(np.mean(psnrs)),
               "ssim_avg": float(np.mean(ssims)),
               "lpips_avg": float(np.mean(lpipss)) if lpipss else None}
    albedo_seconds = []
    if args.brdf_eval:
        albedo = eval_albedo(cfg, state, views,
                             os.path.join(out_root, "albedo"), device)
        albedo_seconds = albedo.pop("view_seconds", [])
        results.update(albedo)
    with open(os.path.join(out_root, "pbr", "NVS.json"), "w") as f:
        json.dump(results, f, indent=4)
    print(json.dumps(results, indent=2))
    return dict(results, view_seconds=view_seconds,
                lpips_seconds=lpips_seconds, albedo_seconds=albedo_seconds)


if __name__ == "__main__":
    main()
