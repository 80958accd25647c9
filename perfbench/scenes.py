"""Inputs of a cell, made from `--seed`: the Gaussian fields, the cameras,
the training targets and the environment cubemap.

Everything large is drawn on the run's device by one `torch.Generator`
in a few large calls. The camera poses are 4x4 matrices per view, built
on the host. Both sides, the program and the reference, get the same
inputs: the reference regenerates them from the same seed, and derives
anything further (scales, tables, light) itself.

A configuration file names its scene kind (`scene.kind`) and its camera
rig (`cameras.kind`); the generators below are looked up by that name.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

@dataclasses.dataclass
class View:
    """One camera in the program's (COLMAP) convention: R is the
    camera-to-world rotation, T the world-to-camera translation."""
    R: np.ndarray
    T: np.ndarray
    fovx: float
    fovy: float
    width: int
    height: int


@dataclasses.dataclass
class Rig:
    train: List[View]
    test: List[View]
    extent: float            # NeRF++ radius of the train cameras


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def host_rng(seed: int, salt: int) -> np.random.RandomState:
    """A host RandomState for the few small draws (poses, orders)."""
    return np.random.RandomState(
        np.random.SeedSequence([int(seed) % (1 << 63), salt]).generate_state(1))


# ---------------------------------------------------------------------------
# Gaussian fields
# ---------------------------------------------------------------------------

def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp(min=1e-12)


def _random_fields(n: int, sh_rest: int, g: torch.Generator, dev,
                   xyz: torch.Tensor, normal: torch.Tensor) -> Dict:
    """Raw fields of n Gaussians at xyz: colours, opacities, BRDF and
    rotations as a trained scene spreads them (chip_smoke.gaussian_fields'
    draws)."""
    def normal_(shape, mean, std):
        return torch.randn(shape, generator=g, device=dev) * std + mean
    return dict(
        xyz=xyz, features_dc=normal_((n, 1, 3), 0.0, 0.6),
        features_rest=normal_((n, sh_rest, 3), 0.0, 0.1),
        opacity=normal_((n, 1), 1.0, 1.5),
        normal=normal + normal_((n, 3), 0.0, 0.2),
        albedo=normal_((n, 3), 0.0, 1.0), roughness=normal_((n, 1), 0.0, 1.0),
        metallic=normal_((n, 1), 0.0, 1.0),
        rotation=_unit(normal_((n, 4), 0.0, 1.0)))


def shell_scene(cfg: dict, seed: int, dev) -> Dict:
    """A noisy shell of `n_gaussians` around the origin (a coherent
    surface for the depth, normal and screen-space stages), with scales
    drawn as chip_smoke's serving shell draws them."""
    s = cfg["scene"]
    n = cfg["n_gaussians"]
    g = generator(seed, dev)
    d = _unit(torch.randn((n, 3), generator=g, device=dev))
    r = torch.rand((n, 1), generator=g, device=dev) * 0.06 + 0.97
    f = _random_fields(n, (cfg["port"]["model"]["sh_degree"] + 1) ** 2 - 1, g, dev,
                       d * r * s["radius"], d)
    lo, hi = s["log_scale"]
    f["scaling"] = torch.rand((n, 3), generator=g, device=dev) * (hi - lo) + lo
    return f


def unbounded_scene(cfg: dict, seed: int, dev) -> Dict:
    """An unbounded outdoor scene: a ground disk, a central object and a
    far background shell (shares from `scene.parts`). `scaling` is left
    out: the program's set-up derives it from the points' nearest
    neighbours, as `create_from_points` does, and so does the reference."""
    s = cfg["scene"]
    n = cfg["n_gaussians"]
    g = generator(seed, dev)
    parts = s["parts"]
    counts = [int(n * p["share"]) for p in parts]
    counts[0] += n - sum(counts)
    pts, nrm = [], []
    for p, m in zip(parts, counts):
        u = torch.rand((m, 3), generator=g, device=dev)
        if p["kind"] == "disk":
            rad = p["radius"] * torch.sqrt(u[:, 0])
            ang = 2 * math.pi * u[:, 1]
            xyz = torch.stack([rad * torch.cos(ang), rad * torch.sin(ang),
                               (u[:, 2] - 0.5) * p["thickness"]], 1)
            nv = torch.zeros_like(xyz)
            nv[:, 2] = 1.0
        else:                                   # "sphere": a noisy shell
            nv = _unit(torch.randn((m, 3), generator=g, device=dev))
            if p.get("upper_only"):
                nv[:, 2] = nv[:, 2].abs()
            xyz = nv * p["radius"] * (1.0 + (u[:, :1] - 0.5) * p["thickness"])
            nv = nv if p["radius"] < 5 else -nv
        pts.append(xyz + torch.tensor(p.get("centre", [0, 0, 0]),
                                      dtype=torch.float32, device=dev))
        nrm.append(nv)
    return _random_fields(n, (cfg["port"]["model"]["sh_degree"] + 1) ** 2 - 1, g,
                          dev, torch.cat(pts), torch.cat(nrm))


SCENES = {"shell": shell_scene, "unbounded": unbounded_scene}


def scene_fields(cfg: dict, seed: int, dev) -> Dict:
    return SCENES[cfg["scene"]["kind"]](cfg, seed, dev)


def padded(fields: Dict, capacity: int) -> Dict:
    """Raw fields padded to `capacity` dead slots (zeros, scaling -10,
    identity rotation), and `alive`."""
    n = fields["xyz"].shape[0]
    out = {}
    for k, v in fields.items():
        pad = v.new_zeros((capacity - n,) + v.shape[1:])
        if k == "scaling":
            pad.fill_(-10.0)
        if k == "rotation":
            pad[:, 0] = 1.0
        out[k] = torch.cat([v, pad])
    out["alive"] = torch.arange(capacity, device=fields["xyz"].device) < n
    return out


# ---------------------------------------------------------------------------
# Cameras
# ---------------------------------------------------------------------------

def look_at(eye: np.ndarray, target: np.ndarray):
    """Blender/OpenGL camera at `eye` looking at `target`, z up, turned
    into the program's convention as its Blender loader does."""
    fwd = (target - eye) / np.linalg.norm(target - eye)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
    c2w[:3, 1:3] *= -1                            # OpenGL -> COLMAP axes
    w2c = np.linalg.inv(c2w)
    return w2c[:3, :3].T.copy(), w2c[:3, 3].copy()


def _views(poses, c: dict) -> List[View]:
    w, h = c["width"], c["height"]
    fovx = c["camera_angle_x"]
    fovy = 2 * math.atan(math.tan(fovx / 2) * h / w)
    return [View(R, T, fovx, fovy, w, h) for R, T in poses]


def nerfpp_radius(views: List[View]) -> float:
    """1.1 x the largest distance of a camera centre from their mean
    (the loaders' getNerfppNorm)."""
    centres = np.stack([-v.R @ v.T for v in views])
    return float(1.1 * np.linalg.norm(centres - centres.mean(0), axis=1).max())


def hemisphere_rig(cfg: dict, seed: int) -> Rig:
    """Blender-style cameras on the upper hemisphere at `radius`, looking
    at the origin, drawn apart for the train and the test split."""
    c = cfg["cameras"]
    rng = host_rng(seed, 1)

    def poses(m):
        z = rng.uniform(c["min_elevation_z"], 1.0, m)
        a = rng.uniform(0, 2 * math.pi, m)
        d = np.stack([np.sqrt(1 - z * z) * np.cos(a),
                      np.sqrt(1 - z * z) * np.sin(a), z], 1)
        return [look_at(c["radius"] * e, np.zeros(3)) for e in d]

    train = _views(poses(c["n_train"]), c)
    return Rig(train, _views(poses(c["n_test"]), c), nerfpp_radius(train))


def ring_rig(cfg: dict, seed: int) -> Rig:
    """A ring of inward-looking cameras around the centre object (a
    handheld capture walked around it), every `hold_out`-th one held out
    for testing."""
    c = cfg["cameras"]
    rng = host_rng(seed, 1)
    m = c["n_views"]
    a = 2 * math.pi * (np.arange(m) + rng.uniform(-0.3, 0.3, m)) / m
    rad = c["radius"] * rng.uniform(0.9, 1.1, m)
    hgt = c["elevation"] * rng.uniform(0.8, 1.2, m)
    target = np.array(c["target"], np.float64)
    poses = [look_at(np.array([r * math.cos(t), r * math.sin(t), z]),
                     target + rng.normal(0, 0.1, 3))
             for t, r, z in zip(a, rad, hgt)]
    test = set(range(0, m, c["hold_out"]))
    train = _views([p for i, p in enumerate(poses) if i not in test], c)
    return Rig(train, _views([poses[i] for i in sorted(test)], c),
               nerfpp_radius(train))


RIGS = {"hemisphere": hemisphere_rig, "ring": ring_rig}


def rig(cfg: dict, seed: int) -> Rig:
    return RIGS[cfg["cameras"]["kind"]](cfg, seed)


# ---------------------------------------------------------------------------
# Targets and light
# ---------------------------------------------------------------------------

def targets(n: int, height: int, width: int, masked: bool, seed: int, dev):
    """n training targets, every one different: smooth colour waves
    ([n, 3, H, W]) and, with `masked`, an object mask of a disc whose
    centre and radius vary per view ([n, 1, H, W]; ones without)."""
    g = generator(seed + 2, dev)
    ys = (torch.arange(height, device=dev, dtype=torch.float32)[:, None]
          + 0.5) / height
    xs = (torch.arange(width, device=dev, dtype=torch.float32)[None, :]
          + 0.5) / width
    ph = torch.rand((n, 3, 1, 1), generator=g, device=dev) * (2 * math.pi)
    fr = torch.rand((n, 3, 2), generator=g, device=dev) * 6.0 + 2.0
    image = 0.5 + 0.4 * torch.sin(fr[..., 0, None, None] * xs
                                  + fr[..., 1, None, None] * ys + ph)
    if not masked:
        return image, torch.ones((n, 1, height, width), device=dev)
    c = torch.rand((n, 3, 1, 1), generator=g, device=dev)
    r = torch.hypot(xs - (0.4 + 0.2 * c[:, :1]), ys - (0.4 + 0.2 * c[:, 1:2]))
    return image, (r < 0.25 + 0.1 * c[:, 2:3]).to(torch.float32)


def cube_dirs(res: int, dev) -> torch.Tensor:
    """[6, res, res, 3] unit directions of the cubemap texel centres."""
    t = (torch.arange(res, device=dev, dtype=torch.float32) + 0.5) / res * 2 - 1
    v, u = torch.meshgrid(-t, t, indexing="ij")
    one = torch.ones_like(u)
    faces = [(one, v, -u), (-one, v, u), (u, one, -v), (u, -one, v),
             (u, v, one), (-u, v, -one)]
    return _unit(torch.stack([torch.stack(f, -1) for f in faces]))


def cubemap(res: int, seed: int, dev, index: int = 0) -> torch.Tensor:
    """[6, res, res, 3] environment: a few smooth lobes over a base level
    with texel noise (chip_smoke.random_cubemap's draws). `index` > 0
    draws another environment of the same seed (a relit scene)."""
    g = generator(seed + 3 if index == 0 else int(np.random.SeedSequence(
        [int(seed) % (1 << 63), 3, index]).generate_state(1)[0]), dev)
    dirs = cube_dirs(res, dev)
    axes = _unit(torch.randn((6, 3), generator=g, device=dev))
    expo = torch.rand(6, generator=g, device=dev) * 38 + 2
    col = torch.rand((6, 3), generator=g, device=dev) * 1.8 + 0.2
    lobes = torch.clamp(dirs @ axes.T, min=0) ** expo          # [6,R,R,6]
    out = 0.2 + lobes @ col
    return out * (torch.rand(out.shape, generator=g, device=dev) * 0.2 + 0.9)
