"""The port's render CLI on a JAX state carried over by
`params_from_numpy` / `state_from_numpy`: its NVS.json PSNR against the
PSNR of the JAX `render_pbr_view` on the same views (CPU, plain paths on
both sides; shared small env-BRDF LUT as in test_torch_render.py)."""
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gi_gs_tpu.cli import render_cli as jax_cli
from gi_gs_tpu.scene.dataset import load_scene as jax_load_scene
from gi_gs_tpu.utils import image_utils as jax_image_utils

from gi_gs_tpu_torch import config
from gi_gs_tpu_torch.cli import render_cli
from gi_gs_tpu_torch.utils import timing
from gi_gs_tpu_torch.utils.checkpoint import state_from_numpy

from test_io import make_blender_dataset
from test_torch_render import (CAP, gaussian_fields, jax_cfg, jax_state,
                               shared_lut)  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)


def test_render_cli_psnr_matches_jax(tmp_path):
    data = str(tmp_path / "scene")
    model = str(tmp_path / "model")
    make_blender_dataset(data, n_frames=3, size=32)
    fields = gaussian_fields(n=1500, cap=2048, seed=2)
    cubemap = np.random.RandomState(3).uniform(0, 1.5, (6, 64, 64, 3)
                                               ).astype(np.float32)

    # the JAX renderer on the test views
    jcfg = jax_cfg()
    jstate = jax_state(fields, cubemap)
    scene = jax_load_scene(data, eval_split=True, white_background=False)
    psnrs = []
    for rec in scene.test_cameras:
        gt = jnp.clip(jnp.asarray(rec.image) * jnp.asarray(rec.alpha), 0, 1)
        out = jax_cli.render_pbr_view(jcfg, jstate, rec.camera(), jnp.zeros(3))
        psnrs.append(float(jax_image_utils.psnr(
            jnp.clip(out["render_rgb"], 0, 1), gt)))

    # the port's CLI on the carried-over state
    cfg = config.Config()
    cfg.raster = type(cfg.raster)(cap_instances=CAP)
    cfg.train.light_base_res = 64
    config.save_cfg(cfg, model)
    path = state_from_numpy(fields, cubemap, {"iteration": 7}, model)
    assert os.path.basename(path) == "chkpnt7.pt"
    timing.start()
    res = render_cli.main(["--model_path", model, "--source_path", data,
                           "--device", "cpu"])
    stages = timing.stop()
    assert {"preprocess", "binning", "composite", "ssao", "ssr", "shading",
            "build_mips"} <= set(stages)
    nvs = os.path.join(model, "test", "ours_7", "pbr", "NVS.json")
    with open(nvs) as f:
        written = json.load(f)
    assert written["lpips_avg"] is None
    assert abs(written["psnr_avg"] - float(np.mean(psnrs))) < 0.01
    assert written["psnr_avg"] == res["psnr_avg"]
    assert len(res["view_seconds"]) == 3
    for name in ("r_0.png", "r_0_albedo.png", "r_0_indirect.png"):
        assert os.path.exists(os.path.join(model, "test", "ours_7", "pbr",
                                           name))


@pytest.mark.parametrize("flags,march", [
    ([], "gi_march"), (["--backend", "pallas"], "gi_march_coherent")])
def test_render_cli_backend_selects_the_march(tmp_path, monkeypatch, flags,
                                              march):
    """Without --backend the CLI runs the exact march whatever
    cfg_args.json saved (here the default "pallas"), as the JAX CLI does;
    --backend pallas runs the coherent one. The march a wrapper would
    launch on the card is recorded by patching both wrappers."""
    from gi_gs_tpu_torch.ops import screen_space
    data, model = str(tmp_path / "scene"), str(tmp_path / "model")
    make_blender_dataset(data, n_frames=2, size=32)
    cfg = config.Config()
    cfg.raster = type(cfg.raster)(cap_instances=CAP)
    cfg.train.light_base_res = 16
    cfg.gi = cfg.gi._replace(step=4, start=2, delta=0.25)
    assert cfg.gi.backend == "pallas"
    config.save_cfg(cfg, model)
    state_from_numpy(gaussian_fields(n=500, cap=1024, seed=4),
                     np.full((6, 16, 16, 3), 0.5, np.float32),
                     {"iteration": 3}, model)
    ran = []
    for name in ("gi_march", "gi_march_coherent"):
        fn = getattr(screen_space, name)
        monkeypatch.setattr(screen_space, name,
                            lambda *a, _f=fn, _n=name: ran.append(_n) or _f(*a))
    out = render_cli.main(["--model_path", model, "--source_path", data,
                           "--device", "cpu", "--max_views", "1", *flags])
    assert np.isfinite(out["psnr_avg"])
    assert ran == [march, march]            # SSAO, then SSR
