"""The port's train CLI on the CPU: the synthetic 32x32 Blender scene
(tests/test_io.make_blender_dataset) trains 8 phase-1 iterations with a
densification and an opacity reset, writes its checkpoint, eval JSON and
PLY, and the port's render CLI renders that checkpoint; a two-phase run
switches to deferred-PBR training past --pbr_iteration. Unported settings
fail at startup. Both packages read the small shared env-BRDF LUT."""
import json
import os

import numpy as np
import pytest
import torch

from gi_gs_tpu_torch.cli import render_cli, train_cli
from gi_gs_tpu_torch.utils import checkpoint as ckpt

from test_io import make_blender_dataset
from test_torch_render import shared_lut  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

SMALL = ["--capacity", "4096", "--cap_tile", "256", "--chunk", "8",
         "--tile_w", "32", "--light_base_res", "16", "--step", "4",
         "--start", "2", "--delta", "0.25"]


def test_train_cli_eight_iterations_then_render(tmp_path):
    data, model = str(tmp_path / "scene"), str(tmp_path / "model")
    make_blender_dataset(data, n_frames=2, size=32)
    res = train_cli.main([
        "--source_path", data, "--model_path", model, "--eval",
        "--iterations", "8", "--test_iterations", "8",
        "--save_iterations", "8", "--densify_from_iter", "2",
        "--densification_interval", "3", "--opacity_reset_interval", "6",
        "--device", "cpu", *SMALL])
    for name in ("chkpnt8.pt", "eval_8.json", "cameras.json",
                 "cfg_args.json",
                 os.path.join("point_cloud", "iteration_8",
                              "point_cloud.ply")):
        assert os.path.exists(os.path.join(model, name)), name
    with open(os.path.join(model, "eval_8.json")) as f:
        metrics = json.load(f)
    assert np.isfinite(metrics["psnr"]) and metrics["n_views"] == 2
    assert [s["iteration"] for s in res["steps"]] == list(range(1, 9))
    assert all(np.isfinite(s["loss"]) for s in res["steps"])
    assert [r["iteration"] for r in res["reports"]] == [1, 3, 6]
    # a densification ran (iterations 3 and 6) and nothing died out
    state = res["state"]
    assert int(state.params.alive.sum()) > 0
    # the whole train state round-trips
    loaded, extra = ckpt.load_train_state(os.path.join(model, "chkpnt8.pt"),
                                          "cpu")
    assert extra["iteration"] == 8
    for k in ("xyz", "opacity", "alive"):
        assert torch.equal(getattr(loaded.params, k),
                           getattr(state.params, k))
    for grp, st in state.opt_state.items():
        assert loaded.opt_state[grp]["count"] == st["count"] == 8
        assert torch.equal(loaded.opt_state[grp]["nu"], st["nu"])
    # the render CLI reads the training checkpoint
    out = render_cli.main(["--model_path", model, "--source_path", data,
                           "--device", "cpu", "--max_views", "1"])
    assert np.isfinite(out["psnr_avg"])
    assert os.path.exists(os.path.join(model, "test", "ours_8", "pbr",
                                       "NVS.json"))


def test_train_cli_phase2_after_phase1(tmp_path):
    """--pbr_iteration 4 --iterations 8 --indirect: steps 5-8 are phase-2
    steps (deferred PBR with SSAO, SSR and the learnable cubemap); the
    checkpoint, the phase-2 eval JSON (the PBR view) and a non-negative
    cubemap the light's Adam has moved are written."""
    data, model = str(tmp_path / "scene"), str(tmp_path / "model")
    make_blender_dataset(data, n_frames=2, size=32)
    res = train_cli.main([
        "--source_path", data, "--model_path", model, "--eval",
        "--iterations", "8", "--pbr_iteration", "4", "--indirect",
        "--test_iterations", "8", "--save_iterations", "8",
        "--device", "cpu", *SMALL])
    assert [s["phase"] for s in res["steps"]] == [1] * 4 + [2] * 4
    assert all(np.isfinite(s["loss"]) for s in res["steps"])
    with open(os.path.join(model, "eval_8.json")) as f:
        metrics = json.load(f)
    assert np.isfinite(metrics["psnr"]) and metrics["n_views"] == 2
    loaded, extra = ckpt.load_train_state(os.path.join(model, "chkpnt8.pt"),
                                          "cpu")
    assert extra["iteration"] == 8
    cube = res["state"].cubemap
    assert torch.equal(loaded.cubemap, cube)
    assert bool((cube >= 0).all()) and bool(torch.isfinite(cube).all())
    assert loaded.light_opt_state["cubemap"]["count"] == 4
    assert float(loaded.light_opt_state["cubemap"]["nu"].abs().max()) > 0


def test_train_cli_refuses_unported_settings(tmp_path):
    with pytest.raises(NotImplementedError, match="data-parallel"):
        train_cli.main(["--source_path", str(tmp_path), "--model_path",
                        str(tmp_path / "m"), "--device", "cpu", "--dp", "2"])
    assert not os.path.exists(tmp_path / "m")
