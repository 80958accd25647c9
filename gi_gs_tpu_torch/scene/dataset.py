"""Scene loading (port of gi_gs_tpu/scene/dataset.py; ref
scene/dataset_readers.py): COLMAP `sparse/0` captures (`load_colmap`) and
Blender / NeRF-synthetic scenes (`load_blender`), dispatched by
`load_scene`. Host side: numpy camera records plus the initial point
cloud and the NeRF++ radius; frames are resized as `--resolution` asks
(PIL, imported only then). PNG frames are read by the built-in decoder,
other formats (COLMAP captures are mostly JPEG) through PIL."""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import List, Optional

import numpy as np

from . import colmap, ply
from .cameras import Camera, make_camera
from .. import native
from ..utils.image_io import read_png
from ..utils.math_utils import focal2fov, fov2focal, world_to_view


@dataclasses.dataclass
class CameraRecord:
    uid: int
    name: str
    R: np.ndarray           # cam-to-world rotation (COLMAP convention)
    T: np.ndarray           # world-to-cam translation
    fovx: float
    fovy: float
    image: np.ndarray       # [3, H, W] float32 in [0, 1]
    alpha: np.ndarray       # [1, H, W] float32 (ones without alpha)

    @property
    def height(self) -> int:
        return self.image.shape[1]

    @property
    def width(self) -> int:
        return self.image.shape[2]

    def camera(self, device=None) -> Camera:
        return make_camera(self.R, self.T, self.fovx, self.fovy,
                           self.width, self.height, device=device)


@dataclasses.dataclass
class SceneData:
    train_cameras: List[CameraRecord]
    test_cameras: List[CameraRecord]
    points: np.ndarray      # [N, 3]
    colors: np.ndarray      # [N, 3] in [0, 1]
    cameras_extent: float   # NeRF++ radius
    translate: np.ndarray
    ply_path: str


def _target_resolution(orig_w, orig_h, resolution, resolution_scale=1.0):
    """utils/camera_utils.py:30-55 downscale policy."""
    if resolution in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution)),
                round(orig_h / (resolution_scale * resolution)))
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def _resize(pixels: np.ndarray, size) -> np.ndarray:
    """[H, W, C] uint8 -> resized to size = (w, h) by PIL's `resize` with
    its default filter, the call JAX's loader makes (dataset.py:62-68), so
    the pixels are equal. PIL is needed only here."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"--resolution resizes the images to {size[0]}x{size[1]}, which "
            "needs PIL (pip package Pillow); render at the native size "
            "(--resolution 1) without it") from e
    img = Image.fromarray(pixels[..., 0] if pixels.shape[2] == 1 else pixels)
    out = np.asarray(img.resize(size))
    return out[..., None] if out.ndim == 2 else out


def _read_image(path: str) -> np.ndarray:
    """[H, W, C] uint8 pixels of a frame: PNGs through `read_png`, any
    other format through PIL (which JAX's loader opens every frame with)."""
    try:
        return read_png(path)
    except ValueError:
        pass
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{path} is not an 8-bit PNG; reading it needs "
                           "PIL (pip package Pillow)") from e
    with Image.open(path) as img:
        pixels = np.asarray(img)
    return pixels[..., None] if pixels.ndim == 2 else pixels


def _record_from(uid, name, R, T, fovx, fovy, pixels: np.ndarray,
                 resolution) -> CameraRecord:
    size = _target_resolution(pixels.shape[1], pixels.shape[0], resolution)
    if size != (pixels.shape[1], pixels.shape[0]):
        pixels = _resize(pixels, size)
    h, w = pixels.shape[:2]
    arr = pixels.astype(np.float32).transpose(2, 0, 1) / 255.0
    if arr.shape[0] == 4:
        image, alpha = arr[:3], arr[3:4]
    else:
        image = arr[:3] if arr.shape[0] >= 3 else np.repeat(arr[:1], 3, 0)
        alpha = np.ones((1, h, w), np.float32)
    return CameraRecord(uid=uid, name=name, R=R, T=T, fovx=fovx, fovy=fovy,
                        image=np.clip(image, 0.0, 1.0), alpha=alpha)


def _nerfpp_norm(records: List[CameraRecord]):
    centers = np.stack([np.linalg.inv(world_to_view(r.R, r.T))[:3, 3]
                        for r in records])
    center = centers.mean(axis=0)
    radius = float(np.linalg.norm(centers - center, axis=1).max()) * 1.1
    return -center, radius


def load_blender(path: str, white_background: bool = True,
                 eval_split: bool = True, extension: str = ".png",
                 resolution: int = 1, max_cameras: Optional[int] = None,
                 seed: int = 0) -> SceneData:
    """transforms_{train,test}.json loader."""

    def read_split(fname, base_uid=0):
        with open(os.path.join(path, fname)) as f:
            contents = json.load(f)
        fovx = contents["camera_angle_x"]
        frames = contents["frames"]
        if max_cameras is not None:
            frames = frames[:max_cameras]
        recs = []
        for idx, frame in enumerate(frames):
            cam_name = os.path.join(path, frame["file_path"] + extension)
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP axes
            w2c = np.linalg.inv(c2w)
            R = np.transpose(w2c[:3, :3])
            T = w2c[:3, 3]
            subdir = os.environ.get("DATA_SUBDIR", "")
            image_path = os.path.join(path, subdir, os.path.basename(cam_name)) \
                if subdir else cam_name
            pixels = read_png(image_path)
            fovy = focal2fov(fov2focal(fovx, pixels.shape[1]), pixels.shape[0])
            recs.append(_record_from(base_uid + idx, Path(cam_name).stem,
                                     R, T, fovx, fovy, pixels, resolution))
        return recs

    train = read_split("transforms_train.json")
    test = read_split("transforms_test.json", base_uid=len(train)) \
        if os.path.exists(os.path.join(path, "transforms_test.json")) else []
    if not eval_split:
        train, test = train + test, []
    translate, radius = _nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        xyz, colors, _ = ply.fetch_point_cloud(ply_path)
    else:
        # Random init inside the synthetic-scene bounds
        # (scene/dataset_readers.py:303-311).
        rng = np.random.RandomState(seed)
        xyz = rng.random((100_000, 3)) * 2.6 - 1.3
        colors = rng.random((100_000, 3)) / 255.0 * 0.28209479177387814 + 0.5
        try:
            ply.store_point_cloud(ply_path, xyz, colors * 255)
        except OSError:
            pass
    return SceneData(train_cameras=train, test_cameras=test,
                     points=xyz.astype(np.float32),
                     colors=colors.astype(np.float32),
                     cameras_extent=radius, translate=translate,
                     ply_path=ply_path)


def load_colmap(path: str, images: str = "images", eval_split: bool = True,
                llffhold: int = 8, resolution: int = -1,
                max_cameras: Optional[int] = None) -> SceneData:
    """COLMAP sparse/0 loader (JAX dataset.py:170-226; ref
    readColmapSceneInfo, scene/dataset_readers.py:170-221): binary model
    files first, then text; frames sorted by name, every `llffhold`-th a
    test view; the points cached as sparse/0/points3D.ply on first load."""
    sparse = os.path.join(path, "sparse/0")
    try:
        cams = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        imgs = native.read_images_binary(os.path.join(sparse, "images.bin"))
    except FileNotFoundError:
        cams = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))
        imgs = colmap.read_images_text(os.path.join(sparse, "images.txt"))

    recs = []
    for _, im in sorted(imgs.items(), key=lambda kv: kv[1].name):
        cam = cams[im.camera_id]
        R = np.transpose(colmap.qvec2rotmat(im.qvec))
        T = np.array(im.tvec)
        fx, fy = colmap.focals_from_camera(cam)
        pixels = _read_image(os.path.join(path, images, im.name))
        recs.append(_record_from(len(recs), Path(im.name).stem, R, T,
                                 focal2fov(fx, cam.width),
                                 focal2fov(fy, cam.height), pixels,
                                 resolution))
        if max_cameras is not None and len(recs) >= max_cameras:
            break

    if eval_split:
        train = [c for i, c in enumerate(recs) if i % llffhold != 0]
        test = [c for i, c in enumerate(recs) if i % llffhold == 0]
    else:
        train, test = recs, []
    translate, radius = _nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if os.path.exists(ply_path):
        xyz, colors, _ = ply.fetch_point_cloud(ply_path)
    else:
        try:
            xyz, rgb, _ = native.read_points3d_binary(
                os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3d_text(
                os.path.join(sparse, "points3D.txt"))
        colors = rgb / 255.0
        try:
            ply.store_point_cloud(ply_path, xyz, rgb)
        except OSError:
            pass
    return SceneData(train_cameras=train, test_cameras=test,
                     points=xyz.astype(np.float32),
                     colors=colors.astype(np.float32),
                     cameras_extent=radius, translate=translate,
                     ply_path=ply_path)


def load_scene(path: str, **kwargs) -> SceneData:
    """Dataset-type dispatch (ref Scene.__init__, scene/__init__.py:60-77)."""
    if os.path.exists(os.path.join(path, "sparse")):
        kwargs.pop("white_background", None)
        return load_colmap(path, **kwargs)
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        kwargs.pop("images", None)
        kwargs.pop("llffhold", None)
        return load_blender(path, **kwargs)
    raise ValueError(f"Could not recognize scene type for {path}")
