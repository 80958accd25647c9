"""The port's train CLI on the CPU: the synthetic 32x32 Blender scene
(tests/test_io.make_blender_dataset) trains 8 phase-1 iterations with a
densification and an opacity reset, writes its checkpoint, eval JSON and
PLY, and the port's render CLI renders that checkpoint; a two-phase run
switches to deferred-PBR training past --pbr_iteration; `--dp 2 --device
cpu` trains under torch.distributed.run with 2 gloo ranks, rank 0 alone
writing. --dp different from the launcher's world size fails at startup.
Both packages read the small shared env-BRDF LUT."""
import glob
import json
import os
import subprocess
import sys

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


def test_train_cli_refuses_unported_settings(tmp_path, monkeypatch):
    """--dp 2 outside a 2-process launch (world size 1) raises before
    anything is written."""
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="data-parallel.*WORLD_SIZE is 1"):
        train_cli.main(["--source_path", str(tmp_path), "--model_path",
                        str(tmp_path / "m"), "--device", "cpu", "--dp", "2"])
    assert not os.path.exists(tmp_path / "m")


def test_train_cli_data_parallel_two_ranks(tmp_path):
    """`python -m torch.distributed.run --standalone --nproc_per_node 2`
    (a free rendezvous port) of `train_cli --dp 2 --device cpu`, 4
    iterations on the 32x32 scene with a densification: both ranks train
    2 views a step; only rank 0 writes (its log has the checkpoint line,
    rank 1's none, and rank 1 reports no step) and the checkpoint holds 4
    steps of Adam."""
    data, model = str(tmp_path / "scene"), str(tmp_path / "model")
    logs = str(tmp_path / "logs")
    make_blender_dataset(data, n_frames=2, size=32)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "--log_dir", logs, "--redirects", "3",
           "-m", "gi_gs_tpu_torch.cli.train_cli", "--source_path", data,
           "--model_path", model, "--eval", "--dp", "2", "--device", "cpu",
           "--iterations", "4", "--test_iterations", "4",
           "--save_iterations", "4", "--densify_from_iter", "1",
           "--densification_interval", "2", *SMALL]
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    out = {}
    for path in glob.glob(os.path.join(logs, "**", "stdout.log"),
                          recursive=True):
        with open(path) as f:
            out[int(os.path.basename(os.path.dirname(path)))] = f.read()
    assert set(out) == {0, 1}, out
    assert "data-parallel over 2 ranks (gloo)" in out[0]
    assert "saved checkpoint" in out[0] and "eval:" in out[0]
    for line in ("saved checkpoint", "eval:", "] loss "):
        assert line not in out[1], out[1]
    for name in ("chkpnt4.pt", "eval_4.json", "cameras.json",
                 "cfg_args.json"):
        assert os.path.exists(os.path.join(model, name)), name
    loaded, extra = ckpt.load_train_state(os.path.join(model, "chkpnt4.pt"),
                                          "cpu")
    assert extra["iteration"] == 4
    assert all(st["count"] == 4 for st in loaded.opt_state.values())
    assert bool(torch.isfinite(loaded.params.xyz).all())
