"""Relighting CLI (port of gi_gs_tpu/cli/relight_cli.py; ref relight.py
:114-334): a new environment from an HDRI (`load_hdr` ->
`latlong_to_cubemap` at `--cubemap_res` -> the prefiltered light), the
albedo ratio saved by `render_cli --brdf_eval` when present, and the full
PBR + SSR render of every test view under it. Writes
`test/ours_{it}/relight/<hdri name>/{view name}.png` and `envmap.png`.

    python -m gi_gs_tpu_torch.cli.relight_cli --model_path OUT \
        --source_path SCENE --hdri ENV.hdr [--cubemap_res 256] \
        [--resolution 2] [--device cpu]
"""
from __future__ import annotations

import json
import os
import time
import types
from argparse import ArgumentParser

import torch

from .. import config as config_mod
from ..models import light as light_mod
from ..scene.dataset import load_scene
from ..utils import checkpoint as ckpt
from ..utils.device import resolve_device
from .render_cli import (build_light, eval_config, find_checkpoint,
                         render_pbr_view, save_image)


def main(argv=None):
    parser = ArgumentParser(description="gi_gs_tpu_torch relighting")
    config_mod.add_args(parser)
    parser.add_argument("--checkpoint", type=str, default="")
    parser.add_argument("--hdri", type=str, required=True)
    parser.add_argument("--cubemap_res", type=int, default=256)
    parser.add_argument("--max_views", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = eval_config(args)
    ckpt_path = args.checkpoint or find_checkpoint(cfg.model.model_path)
    params, _, extra = ckpt.load_state(ckpt_path, device)
    iteration = extra.get("iteration", 0)

    # The new environment light from the HDRI (relight.py:254-334).
    hdri = torch.as_tensor(light_mod.load_hdr(args.hdri), device=device)
    with torch.inference_mode():
        base = light_mod.latlong_to_cubemap(hdri, args.cubemap_res)
    light = build_light(cfg, base)
    state = types.SimpleNamespace(params=params, cubemap=base)

    # The albedo ratio of the NVS albedo eval, if present (relight.py:204-210)
    ratio = None
    ratio_path = os.path.join(cfg.model.model_path, "test",
                              f"ours_{iteration}", "albedo",
                              "albedo_ratio.json")
    if os.path.exists(ratio_path):
        with open(ratio_path) as f:
            ratio = torch.as_tensor(json.load(f)["albedo_ratio"],
                                    dtype=torch.float32, device=device)
        print(f"albedo ratio: {ratio.tolist()}")

    scene = load_scene(cfg.model.source_path, images=cfg.model.images,
                       eval_split=True, resolution=cfg.model.resolution,
                       white_background=cfg.model.white_background,
                       max_cameras=cfg.model.max_cameras or None)
    views = scene.test_cameras or scene.train_cameras
    if args.max_views:
        views = views[:args.max_views]

    env_name = os.path.splitext(os.path.basename(args.hdri))[0]
    out_dir = os.path.join(cfg.model.model_path, "test", f"ours_{iteration}",
                           "relight", env_name)
    os.makedirs(out_dir, exist_ok=True)
    with torch.inference_mode():
        envmap = light_mod.export_envmap(base)
    save_image(os.path.join(out_dir, "envmap.png"),
               envmap / max(float(envmap.max()), 1e-6), chw=False)

    bg = torch.zeros(3, device=device)
    view_seconds = []
    for idx, rec in enumerate(views):
        t0 = time.perf_counter()
        out = render_pbr_view(cfg, state, rec.camera(device), bg, light=light,
                              albedo_ratio=ratio)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        view_seconds.append(time.perf_counter() - t0)
        save_image(os.path.join(out_dir, f"{rec.name}.png"), out["render_rgb"])
        print(f"relit view {idx}: {rec.name}", flush=True)
    return {"out_dir": out_dir, "names": [rec.name for rec in views],
            "view_seconds": view_seconds}


if __name__ == "__main__":
    main()
