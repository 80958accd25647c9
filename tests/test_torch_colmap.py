"""COLMAP scenes in the port on the CPU: its readers (binary and text)
against the JAX package's `scene/colmap.py`, its native reader against
its Python readers, `load_colmap` / `load_scene` against JAX's on a
`sparse/0` written here (the writer is chip_smoke.py's, which writes the
card's COLMAP scene too), and the train CLI through both phases on a
32x32 COLMAP scene. No download: every scene comes from a seed."""
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from gi_gs_tpu.scene import colmap as jcolmap
from gi_gs_tpu.scene.dataset import load_scene as jax_load_scene

from gi_gs_tpu_torch import native
from gi_gs_tpu_torch.cli import render_cli, train_cli
from gi_gs_tpu_torch.scene import colmap
from gi_gs_tpu_torch.scene.dataset import load_colmap, load_scene
from gi_gs_tpu_torch.utils import checkpoint as ckpt

import chip_smoke as cs
from test_native import write_images, write_points3d
from test_torch_render import shared_lut  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

CAMERAS = [(1, "SIMPLE_PINHOLE", 40, 30, [35.0, 20.0, 15.0]),
           (2, "PINHOLE", 40, 30, [33.0, 36.5, 20.5, 14.0]),
           (3, "RADIAL", 64, 48, [50.0, 32.0, 24.0, 0.01, -0.002])]


def _model(root, binary, seed=0):
    """A model with the three cameras, four images and 50 points."""
    rng = np.random.RandomState(seed)
    images = []
    for i in range(4):
        q = rng.normal(size=4)
        images.append((10 + i, q / np.linalg.norm(q), rng.normal(size=3),
                       1 + i % 3, f"img_{3 - i:02d}.png"))
    xyz = rng.normal(size=(50, 3))
    rgb = rng.randint(0, 256, (50, 3))
    cs.write_colmap_model(root, CAMERAS, images, xyz, rgb, binary)
    return images, xyz, rgb


@pytest.mark.parametrize("binary", [True, False], ids=["bin", "txt"])
def test_readers_match_jax(tmp_path, binary):
    """Cameras (SIMPLE_PINHOLE, PINHOLE and RADIAL, whose focal lengths
    raise in both packages), images and points3D read by the port equal
    JAX's reads of the same files, and what was written."""
    images, xyz, rgb = _model(str(tmp_path), binary)
    ext = "bin" if binary else "txt"
    pick = lambda mod, kind: getattr(mod, f"read_{kind}_"
                                     f"{'binary' if binary else 'text'}")
    path = lambda kind: str(tmp_path / f"{kind}.{ext}")
    cams = pick(colmap, "cameras")(path("cameras"))
    jcams = pick(jcolmap, "cameras")(path("cameras"))
    assert sorted(cams) == sorted(jcams) == [1, 2, 3]
    for cid, model, w, h, params in CAMERAS:
        got, want = cams[cid], jcams[cid]
        assert (got.model, got.width, got.height) == (model, w, h) == \
            (want.model, want.width, want.height)
        np.testing.assert_array_equal(got.params, want.params)
        np.testing.assert_array_equal(got.params, params)
    assert colmap.focals_from_camera(cams[1]) == \
        jcolmap.focals_from_camera(jcams[1]) == (35.0, 35.0)
    assert colmap.focals_from_camera(cams[2]) == \
        jcolmap.focals_from_camera(jcams[2]) == (33.0, 36.5)
    for mod, c in ((colmap, cams[3]), (jcolmap, jcams[3])):
        with pytest.raises(ValueError, match="RADIAL"):
            mod.focals_from_camera(c)

    imgs = pick(colmap, "images")(path("images"))
    jimgs = pick(jcolmap, "images")(path("images"))
    assert sorted(imgs) == sorted(jimgs) == [iid for iid, *_ in images]
    for iid, q, t, cid, name in images:
        for got in (imgs[iid], jimgs[iid]):
            np.testing.assert_array_equal(got.qvec, q)
            np.testing.assert_array_equal(got.tvec, t)
            assert (got.camera_id, got.name) == (cid, name)
        np.testing.assert_array_equal(colmap.qvec2rotmat(q),
                                      jcolmap.qvec2rotmat(q))

    pts = pick(colmap, "points3d")(path("points3D"))
    jpts = pick(jcolmap, "points3d")(path("points3D"))
    for got, want in zip(pts, jpts):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pts[0], xyz)
    np.testing.assert_array_equal(pts[1], rgb)


@pytest.mark.parametrize("writer", ["test_native", "chip_smoke"])
def test_native_reader_matches_python(tmp_path, writer):
    """The port's native reader (built with g++ into build/torch_native/)
    against the port's Python readers on the same files: equal arrays,
    names and poses, and each read counted."""
    assert native.get() is not None
    pfile, ifile = str(tmp_path / "points3D.bin"), str(tmp_path / "images.bin")
    if writer == "test_native":
        write_points3d(pfile, n=40, seed=3)
        write_images(ifile, n=5)
    else:
        _model(str(tmp_path), True, seed=4)
    before = dict(native.reads)
    for got, want in zip(native.read_points3d_binary(pfile),
                         colmap.read_points3d_binary(pfile)):
        np.testing.assert_array_equal(got, want)
    ni, pi = native.read_images_binary(ifile), colmap.read_images_binary(ifile)
    assert sorted(ni) == sorted(pi)
    for k in ni:
        assert (ni[k].name, ni[k].camera_id) == (pi[k].name, pi[k].camera_id)
        np.testing.assert_array_equal(ni[k].qvec, pi[k].qvec)
        np.testing.assert_array_equal(ni[k].tvec, pi[k].tvec)
    assert native.reads["points3D.bin"] == before.get("points3D.bin", 0) + 1
    assert native.reads["images.bin"] == before.get("images.bin", 0) + 1


def _colmap_scene(root, binary, n_points=2000, seed=0):
    """chip_smoke's Blender scene at 32x32 (8 train + 2 test poses around
    a shell of points) in COLMAP form under root/colmap; returns its path
    and the points."""
    rng = np.random.RandomState(seed)
    cs.write_scene(os.path.join(root, "blender"), rng, 2, 32, n_train=8)
    xyz = cs.gaussian_fields(rng, n_points, n_points)["xyz"]
    rgb = rng.randint(0, 256, (n_points, 3))
    path = os.path.join(root, "colmap")
    cs.blender_to_colmap(os.path.join(root, "blender"), path,
                         xyz.astype(np.float64), rgb, binary)
    return path, xyz


def _as_jpeg(path):
    """Rewrite the scene's frames as JPEG files, renamed in its model."""
    sparse = os.path.join(path, "sparse", "0")
    cams = jcolmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    imgs = jcolmap.read_images_binary(os.path.join(sparse, "images.bin"))
    xyz, rgb, _ = jcolmap.read_points3d_binary(
        os.path.join(sparse, "points3D.bin"))
    images = []
    for iid, im in imgs.items():
        name = im.name.replace(".png", ".jpg")
        Image.open(os.path.join(path, "images", im.name)).save(
            os.path.join(path, "images", name), quality=90)
        os.remove(os.path.join(path, "images", im.name))
        images.append((iid, im.qvec, im.tvec, im.camera_id, name))
    cs.write_colmap_model(sparse, [(c.id, c.model, c.width, c.height,
                                    list(c.params)) for c in cams.values()],
                          images, xyz, rgb.astype(np.int64))


CASES = {"bin": dict(binary=True), "txt": dict(binary=False),
         "resolution_2": dict(binary=True, resolution=2),
         "max_cameras_5": dict(binary=True, max_cameras=5),
         "llffhold_3": dict(binary=False, llffhold=3),
         "jpeg": dict(binary=True, jpeg=True)}


@pytest.mark.parametrize("case", CASES)
def test_load_colmap_matches_jax(tmp_path, case):
    """`load_scene` on a sparse/0 scene (or `load_colmap` with llffhold)
    against JAX's on a copy of the same files: names and splits, R and T
    (equal: the same f64 arithmetic), FoVs, images and alpha (equal: the
    same pixels, read by the built-in PNG decoder or by PIL), points,
    colours, extent, translate, and the points3D.ply each writes on its
    first load (equal bytes; a second load reads it back)."""
    kw = dict(CASES[case])
    binary, jpeg = kw.pop("binary"), kw.pop("jpeg", False)
    path, _ = _colmap_scene(str(tmp_path), binary)
    if jpeg:
        _as_jpeg(path)
    jpath = str(tmp_path / "jax_copy")
    shutil.copytree(path, jpath)
    if "llffhold" in kw:
        from gi_gs_tpu.scene.dataset import load_colmap as jax_load_colmap
        load = lambda p: load_colmap(p, eval_split=True, **kw)
        jload = lambda p: jax_load_colmap(p, eval_split=True, **kw)
    else:
        args = dict(images="images", eval_split=True, white_background=False,
                    resolution=kw.get("resolution", -1),
                    max_cameras=kw.get("max_cameras"))
        load = lambda p: load_scene(p, **args)
        jload = lambda p: jax_load_scene(p, **args)
    got, want = load(path), jload(jpath)
    n = kw.get("max_cameras", 10)
    hold = kw.get("llffhold", 8)
    assert len(got.test_cameras) == len(range(0, n, hold))
    assert len(got.train_cameras) + len(got.test_cameras) == n
    size = 16 if kw.get("resolution") == 2 else 32
    for a, b in zip(got.train_cameras + got.test_cameras,
                    want.train_cameras + want.test_cameras):
        assert (a.uid, a.name, a.fovx, a.fovy) == (b.uid, b.name, b.fovx,
                                                   b.fovy)
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.T, b.T)
        assert a.image.shape == (3, size, size)
        np.testing.assert_array_equal(a.image, b.image)
        np.testing.assert_array_equal(a.alpha, b.alpha)
    for key in ("points", "colors", "translate"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    assert got.cameras_extent == want.cameras_extent
    ply_file = os.path.join("sparse", "0", "points3D.ply")
    with open(os.path.join(path, ply_file), "rb") as f, \
            open(os.path.join(jpath, ply_file), "rb") as g:
        assert f.read() == g.read()
    again = load(path)
    np.testing.assert_array_equal(again.points, got.points)
    np.testing.assert_array_equal(again.colors, got.colors)


def test_colmap_cameras_match_the_blender_form(tmp_path):
    """The COLMAP form of a Blender scene gives the same world-view and
    projection matrices (to 1e-12), the points as written."""
    path, xyz = _colmap_scene(str(tmp_path), True)
    bl = load_scene(str(tmp_path / "blender"), eval_split=True)
    scene = load_scene(path, eval_split=True)
    co = {r.name: r for r in scene.train_cameras + scene.test_cameras}
    for split, recs in (("train", bl.train_cameras), ("test", bl.test_cameras)):
        for r in recs:
            a, b = r.camera("cpu"), co[f"{split}_{r.name}"].camera("cpu")
            torch.testing.assert_close(a.w2c, b.w2c, rtol=0, atol=1e-12)
            torch.testing.assert_close(a.full_proj, b.full_proj, rtol=0,
                                       atol=1e-12)
    np.testing.assert_array_equal(scene.points, xyz)


def test_train_cli_trains_a_colmap_scene(tmp_path):
    """`train_cli --device cpu` on a 32x32 COLMAP scene (binary sparse/0):
    3 phase-1 steps, then 3 phase-2 steps past --pbr_iteration with
    --indirect; finite losses, the checkpoint and the PBR eval written;
    the render CLI renders a test view of the checkpoint."""
    path, _ = _colmap_scene(str(tmp_path), True)
    model = str(tmp_path / "model")
    res = train_cli.main([
        "--source_path", path, "--model_path", model, "--eval",
        "--iterations", "6", "--pbr_iteration", "3", "--indirect",
        "--test_iterations", "6", "--save_iterations", "6", "--device", "cpu",
        "--capacity", "4096", "--cap_tile", "256", "--chunk", "8",
        "--tile_w", "32", "--light_base_res", "16", "--step", "4",
        "--start", "2", "--delta", "0.25"])
    assert [s["phase"] for s in res["steps"]] == [1] * 3 + [2] * 3
    assert all(np.isfinite(s["loss"]) for s in res["steps"])
    state, extra = ckpt.load_train_state(os.path.join(model, "chkpnt6.pt"),
                                         "cpu")
    assert extra["iteration"] == 6
    assert int(state.params.alive.sum()) == 2000
    assert os.path.exists(os.path.join(model, "eval_6.json"))
    assert os.path.exists(os.path.join(path, "sparse", "0", "points3D.ply"))
    out = render_cli.main(["--model_path", model, "--source_path", path,
                           "--device", "cpu", "--max_views", "1"])
    assert np.isfinite(out["psnr_avg"])
