"""Import hygiene of the port and its CUDA-by-default entry points."""
import ctypes
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import gi_gs_tpu_torch
from gi_gs_tpu_torch.ops import cuda_kernels as ck

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
    assert "gi_gs_tpu_torch.ops.rasterize.reference" in mods
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
                                "reduce_instance_grads", "gi_march",
                                "gi_march_coherent", "patch_fwd",
                                "patch_bwd", "sh_fwd", "sh_bwd", "adam"}
    assert {"sh.cu", "adam.cu"} <= {p.name for p in ck.sources()}


def _c_declarations():
    """{name: [parameter types]} of every `GIGS_API` function in csrc/*.cu,
    read independently of the registry's parser."""
    decls = {}
    for src in sorted(ck.CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r"GIGS_API\s+[\w\s\*]+?\b(gigs_\w+)\s*\(([^)]*)\)",
                             text):
            decls[m.group(1)] = [" ".join(p.split()[:-1]) for p in
                                 m.group(2).split(",")]
    return decls


@pytest.mark.parametrize("name", sorted(_c_declarations()))
def test_ctypes_signature_matches_the_c_declaration(name):
    """The registry's ctypes signature of each C function has the C
    declaration's parameters, one for one: a pointer for a pointer, c_int
    for int, c_float for float (a pointer passed as c_int would be cut to
    32 bits on the card)."""
    decl = _c_declarations()[name]
    want = [ctypes.c_void_p if "*" in t else
            ctypes.c_float if t.endswith("float") else ctypes.c_int
            for t in decl]
    assert all("*" in t or t.endswith(("int", "float")) for t in decl)
    assert list(ck.signatures()[name]) == want


def test_every_launcher_has_a_signature():
    decls = set(_c_declarations())
    assert set(ck.signatures()) == decls
    assert {f"gigs_{k}" for k in ck.launches} == {
        n for n in decls if not n.endswith("_resources")} - {
        "gigs_error_string"}
    assert {"gigs_sh_fwd", "gigs_sh_bwd"} <= set(ck.signatures())
    assert {p.name for p in ck.sources()} == {
        p.name for p in ck.CSRC.iterdir() if p.suffix == ".cu"}


def test_registry_raises_on_what_csrc_does_not_declare(tmp_path):
    """A parameter type other than a pointer, int or float raises, naming
    the function and the type; so does a launch or a resource query of a
    function no source declares (before any build)."""
    (tmp_path / "ok.cu").write_text(
        "GIGS_API int gigs_ok(int device, const float *x, float a,\n"
        "                     void* stream) {\n")
    assert ck.parse_declarations(tmp_path) == {
        "gigs_ok": (ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
                    ctypes.c_void_p)}
    (tmp_path / "bad.cu").write_text(
        "GIGS_API int gigs_bad(int device, double scale, void* stream) {\n")
    with pytest.raises(ValueError, match=r"gigs_bad .*'double'"):
        ck.parse_declarations(tmp_path)
    dev = torch.device("cuda")
    with pytest.raises(ValueError, match="gigs_no_such_kernel"):
        ck.launch("no_such_kernel", dev)
    with pytest.raises(ValueError, match="gigs_no_such_resources"):
        ck.resources("gigs_no_such_resources", dev)
    assert ck._lib is None or torch.cuda.is_available()


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
