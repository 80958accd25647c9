"""The port's IO against the JAX package: Blender scene loading, the
reference-schema Gaussian PLY, the port's state file, and its own PNG
reader/writer (checked against PIL)."""
import struct
import zlib

import numpy as np
import torch
import jax.numpy as jnp
from PIL import Image

from gi_gs_tpu.models.gaussians import GaussianParams as JaxParams
from gi_gs_tpu.scene.dataset import load_scene as jax_load_scene
from gi_gs_tpu.utils import checkpoint as jax_ckpt

from gi_gs_tpu_torch.models.gaussians import FIELDS
from gi_gs_tpu_torch.scene.dataset import load_scene
from gi_gs_tpu_torch.utils import checkpoint, image_io

from test_io import make_blender_dataset

torch.set_num_threads(1)


def _fields(n=40, cap=64, seed=0):
    rng = np.random.RandomState(seed)
    shapes = dict(xyz=(3,), features_dc=(1, 3), features_rest=(15, 3),
                  opacity=(1,), normal=(3,), albedo=(3,), roughness=(1,),
                  metallic=(1,), scaling=(3,), rotation=(4,))
    f = {k: rng.randn(cap, *s).astype(np.float32) for k, s in shapes.items()}
    f["alive"] = np.arange(cap) < n
    return f


def test_blender_loader_matches_jax(tmp_path):
    root = str(tmp_path / "scene")
    make_blender_dataset(root, n_frames=2, size=24)
    ref = jax_load_scene(root, white_background=True, eval_split=True,
                         seed=1)
    got = load_scene(root, white_background=True, eval_split=True, seed=1)
    for a_list, b_list in ((got.train_cameras, ref.train_cameras),
                           (got.test_cameras, ref.test_cameras)):
        assert len(a_list) == len(b_list) == 2
        for a, b in zip(a_list, b_list):
            assert a.name == b.name
            np.testing.assert_array_equal(a.R, b.R)
            np.testing.assert_array_equal(a.T, b.T)
            assert (a.fovx, a.fovy) == (b.fovx, b.fovy)
            np.testing.assert_array_equal(a.image, b.image)
            np.testing.assert_array_equal(a.alpha, b.alpha)
            cam_a, cam_b = a.camera("cpu"), b.camera()
            np.testing.assert_array_equal(cam_a.full_proj.numpy(),
                                          np.asarray(cam_b.full_proj))
            assert cam_a.fx == float(cam_b.fx)
    np.testing.assert_array_equal(got.points, ref.points)
    assert got.cameras_extent == ref.cameras_extent


def test_gaussian_ply_interchange_with_jax(tmp_path):
    f = _fields()
    jp = JaxParams(**{k: jnp.asarray(v) for k, v in f.items()},
                   active_sh_degree=3, max_sh_degree=3)
    path = str(tmp_path / "point_cloud.ply")
    jax_ckpt.save_gaussians_ply(path, jp)        # written by the JAX side
    got = checkpoint.load_gaussians_ply(path, capacity=64, device="cpu")
    want = jax_ckpt.load_gaussians_ply(path, capacity=64)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    # and back: the port writes what the JAX loader reads
    path2 = str(tmp_path / "again.ply")
    checkpoint.save_gaussians_ply(path2, got)
    again = jax_ckpt.load_gaussians_ply(path2, capacity=64)
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(again, k)),
                                      np.asarray(getattr(want, k)), err_msg=k)


def test_state_file_roundtrip(tmp_path):
    f = _fields(seed=1)
    cub = np.random.RandomState(2).rand(6, 8, 8, 3).astype(np.float32)
    path = checkpoint.state_from_numpy(f, cub, {"iteration": 30},
                                       str(tmp_path), active_sh_degree=2)
    assert path.endswith("chkpnt30.pt")
    params, cubemap, extra = checkpoint.load_state(path, "cpu")
    assert extra == {"iteration": 30}
    assert (params.active_sh_degree, params.max_sh_degree) == (2, 3)
    np.testing.assert_array_equal(cubemap.numpy(), cub)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(params, k).numpy(), f[k])


def _png_with_filters(path, img):
    """Encode `img` [H, W, C] uint8 with row filter y % 5 (types 0-4)."""
    h, w, c = img.shape
    rows = []
    prior = np.zeros(w * c, np.int32)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int32)
        ft = y % 5
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prior[:-c]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prior
        elif ft == 3:
            pred = (left + prior) >> 1
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        rows.append(bytes([ft]) + ((cur - pred) & 0xFF).astype(np.uint8)
                    .tobytes())
        prior = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                            0)))
        fh.write(chunk(b"IDAT", zlib.compress(b"".join(rows))))
        fh.write(chunk(b"IEND", b""))


def test_png_reader_writer_against_pil(tmp_path):
    rng = np.random.RandomState(0)
    for c in (1, 3, 4):
        img = (rng.rand(11, 13, c) * 255).astype(np.uint8)
        img[:, :6] = img[:, :1]            # smooth runs too
        p = str(tmp_path / f"f{c}.png")
        _png_with_filters(p, img)
        np.testing.assert_array_equal(image_io.read_png(p), img)
        pil = np.asarray(Image.open(p))
        np.testing.assert_array_equal(pil.reshape(img.shape), img)
        q = str(tmp_path / f"w{c}.png")
        image_io.write_png(q, img)
        np.testing.assert_array_equal(
            np.asarray(Image.open(q)).reshape(img.shape), img)
        Image.fromarray(img[..., 0] if c == 1 else img).save(
            str(tmp_path / f"pil{c}.png"))
        np.testing.assert_array_equal(
            image_io.read_png(str(tmp_path / f"pil{c}.png")), img)
    # a larger picture PIL encodes with its adaptive per-row filters
    ys, xs = np.mgrid[0:90, 0:70]
    img = np.stack([(xs * 3) % 256, (ys * 5 + xs) % 256,
                    (rng.rand(90, 70) * 255).astype(int),
                    np.full((90, 70), 200)], -1).astype(np.uint8)
    Image.fromarray(img).save(str(tmp_path / "adaptive.png"))
    np.testing.assert_array_equal(
        image_io.read_png(str(tmp_path / "adaptive.png")), img)
