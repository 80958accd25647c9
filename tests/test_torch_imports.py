"""Import hygiene of the port and its CUDA-by-default entry points."""
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import gi_gs_tpu_torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        gi_gs_tpu_torch.__path__, "gi_gs_tpu_torch."))


def test_port_imports_without_jax_or_reference_package():
    """Every module imports with `jax` and `gi_gs_tpu` made unimportable."""
    mods = _modules()
    assert "gi_gs_tpu_torch.cli.render_cli" in mods
    assert "gi_gs_tpu_torch.ops.cuda_kernels" in mods
    assert {"gi_gs_tpu_torch.cli.train_cli", "gi_gs_tpu_torch.ops.knn",
            "gi_gs_tpu_torch.train.losses", "gi_gs_tpu_torch.train.optim",
            "gi_gs_tpu_torch.train.densify",
            "gi_gs_tpu_torch.train.trainer"} <= set(mods)
    assert {"gi_gs_tpu_torch.cli.relight_cli",
            "gi_gs_tpu_torch.cli.relight_eval_cli",
            "gi_gs_tpu_torch.cli.normal_eval_cli",
            "gi_gs_tpu_torch.cli.collect_cli",
            "gi_gs_tpu_torch.utils.lpips"} <= set(mods)
    assert {"gi_gs_tpu_torch.parallel.collectives",
            "gi_gs_tpu_torch.parallel.data_parallel",
            "gi_gs_tpu_torch.parallel.tile_sharded",
            "gi_gs_tpu_torch.ops.bsdf", "gi_gs_tpu_torch.utils.profiling",
            "gi_gs_tpu_torch.cli.network_gui"} <= set(mods)
    assert {"gi_gs_tpu_torch.bench",
            "gi_gs_tpu_torch.ops.rasterize.reference"} <= set(mods)
    assert {"gi_gs_tpu_torch.quality_gate",
            "gi_gs_tpu_torch.dryrun"} <= set(mods)
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'gi_gs_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'gi_gs_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_no_kernel_is_built_at_import():
    from gi_gs_tpu_torch.ops import cuda_kernels as ck
    assert ck._lib is None
    assert set(ck.launches) == {"expand", "composite_fwd",
                                "composite_fwd_peak", "composite_bwd",
                                "gi_march", "gi_march_coherent", "patch_fwd",
                                "patch_bwd"}


def test_cuda_default_entry_points_raise_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CUDA default is valid")
    from gi_gs_tpu_torch.cli import (relight_cli, relight_eval_cli,
                                     render_cli, train_cli)
    from gi_gs_tpu_torch.models.gaussians import (FIELDS, create_from_points,
                                                  params_from_numpy)
    from gi_gs_tpu_torch.scene.cameras import make_camera
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_cli.main(["--model_path", str(tmp_path),
                         "--source_path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--model_path", str(tmp_path),
                        "--source_path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        relight_cli.main(["--model_path", str(tmp_path), "--source_path",
                          str(tmp_path), "--hdri", str(tmp_path / "e.hdr")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        relight_eval_cli.main(["--output_dir", str(tmp_path),
                               "--gt_dir", str(tmp_path)])
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_from_points(pts, pts, 8)
    fields = {k: np.zeros((4, 3), np.float32) for k in FIELDS}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(fields, 0, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_camera(np.eye(3), np.zeros(3), 1.0, 1.0, 8, 8)
    from gi_gs_tpu_torch import dryrun, quality_gate
    out = tmp_path / "q.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quality_gate.main(["--gates", "phase1", "--out", str(out)])
    assert not out.exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quality_gate.run_phase2_gate(size=16, iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main([])
    # asking for the CPU works
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 1.0, 8, 8, device="cpu")
    assert cam.w2c.device.type == "cpu"


def test_wrappers_reject_bad_cuda_arguments():
    """The argument checks run before any build: wrong device, dtype,
    shape or layout raise instead of launching."""
    from gi_gs_tpu_torch.ops import cuda_kernels as ck
    t = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ck.check(t, "t", torch.float32)
