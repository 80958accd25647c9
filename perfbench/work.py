"""The yardstick's shared part of the work counts: the H100's peaks, the
inputs a traced run counts its work on, and the walks that count what
the algorithm needs on them. Each per-layer metric (`metrics/*.py`)
turns these into its own operations and bytes, so a metric of another
kernel is a new file, not an edit here.

The walks run the reference's plain code on the state the traced window
started from, so they read the same whatever implements the step:

- compositing: the (instance, pixel) pairs up to each pixel's
  termination (its alpha) and the pairs that contribute, the instances
  and the distinct table rows they name;
- marches: the samples each direction's walk takes up to its hit or its
  exit (SSAO, then SSR), and the block-coherent march's keys.
A count never includes work an implementation could skip (pairs past a
pixel's termination, samples past a ray's end), so no implementation can
exceed its bound. The operation counts of the algorithm (per pair, per
sample, per Adam element) are here too, as both a kernel's roofline and
the whole step's `mfu` read them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional

import torch

from .loops import _config
from .sides import REFERENCE, Side

# NVIDIA H100 SXM data sheet, dense rates at 700 W
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# operations of the algorithm
COMPOSITE_PAIR = 13.0           # per pair up to the pixel's termination
COMPOSITE_CONTRIB = {"fwd": 32.0, "bwd": 50.0}  # more per contributing pair
MARCH_SAMPLE = {"exact": 20.0, "coherent": 8.0}
MARCH_KEY = 30.0                # per block, direction and step (coherent)
ADAM_ELEMENT = 10.0
TABLE_DIM = 21                  # floats per Gaussian in compositing's table
NUM_CH = 16                     # accumulated channels per pixel

BLOCK_TILES = 256               # tiles per plain compositing call


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the chip could take: the larger of the bytes over
    the HBM's rate and the operations over the f32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def share(nbytes: float, flops: float, seconds: float) -> float:
    """% of the bound that work done in `seconds` reaches."""
    return 100.0 * bound_s(nbytes, flops) / seconds


@dataclasses.dataclass
class Inputs:
    cell: object
    fields: Dict[str, torch.Tensor]    # the trained fields (a device copy)
    sh: tuple                          # (active, max) SH degree
    cam: object                        # the program's camera of the view
    cfg: object                        # the program's config (capacities)


def inputs(cell, params, cam, cfg) -> Inputs:
    """The first traced step's (or view's) inputs, as they stand before
    it runs."""
    return Inputs(cell, {k: v.detach().clone() for k, v in
                         params.__dict__.items() if torch.is_tensor(v)},
                  (params.active_sh_degree, params.max_sh_degree), cam, cfg)


def _ref(name: str):
    return importlib.import_module(f"{REFERENCE}.{name}")


def _cached(fn):
    def wrapped(t):
        if fn.__name__ not in t.cache:
            t.cache[fn.__name__] = fn(t)
        return t.cache[fn.__name__]
    wrapped.__name__, wrapped.__doc__ = fn.__name__, fn.__doc__
    return wrapped


@_cached
def gbuffer(t) -> Optional[Dict]:
    """The traced view binned by the reference's plain path at the
    program's capacities: its config, raster config, camera, binning and
    compositing table. None where the run has no inputs to count on."""
    x = t.inputs
    if x is None:
        return None
    side = Side(REFERENCE)
    cfg = _config(side, x.cell)
    r = dataclasses.replace(cfg.raster,
                            cap_instances=x.cfg.raster.cap_instances,
                            cap_tile=x.cfg.raster.cap_tile)
    p = side.gaussians.GaussianParams(**x.fields, active_sh_degree=x.sh[0],
                                      max_sh_degree=x.sh[1])
    cam = side.cameras.Camera(**x.cam.__dict__)
    pre_m, bin_m, comp_m = (_ref("ops.rasterize.preprocess"),
                            _ref("ops.rasterize.binning"),
                            _ref("ops.rasterize.composite"))
    with torch.no_grad():
        opacity = p.get_opacity()
        pre = pre_m.preprocess(p.xyz, p.get_covariance(1.0), cam.w2c,
                               cam.full_proj, cam.tanfovx, cam.tanfovy,
                               cam.width, cam.height, r, opacity=opacity)
        b = bin_m.bin_and_sort(pre, cam.height, cam.width, r)
        table = comp_m.composite_table(
            pre, opacity, p.colors_from_sh(cam.cam_pos), p.get_normal(),
            p.get_albedo(), p.get_roughness(), p.get_metallic())
    return dict(cfg=cfg, raster=r, cam=cam, binning=b, table=table)


def composite_walk_of(r, cam, b, table) -> Dict:
    """The forward walk's pairs and contributing pairs, the instances,
    the distinct rows they name, and the tiles and pixels of the grid."""
    comp = _ref("ops.rasterize.composite")
    grid = r.grid(cam.height, cam.width)
    T, P = grid[0] * grid[1], r.pixels_per_tile
    w = {"pairs": 0, "contrib": 0}
    with torch.no_grad():
        for s in range(0, T, BLOCK_TILES):
            part = {}
            comp._composite_fwd_plain(
                table, b.ids, b.tile_start[s:s + BLOCK_TILES],
                b.tile_count[s:s + BLOCK_TILES], r, grid, work=part,
                tile_base=s)
            w["pairs"] += part["pairs"]
            w["contrib"] += part.get("contrib", 0)
        n_inst = int(b.tile_count.sum())
        rows = int(torch.unique(b.ids[:n_inst]).numel()) if n_inst else 0
    return dict(w, instances=n_inst, rows=rows, tiles=T, pixels=T * P)


@_cached
def composite_walk(t) -> Optional[Dict]:
    """`composite_walk_of` the traced view; None without inputs."""
    g = gbuffer(t)
    return g and composite_walk_of(g["raster"], g["cam"], g["binning"],
                                   g["table"])


def composite_flops(w: Dict, direction: str) -> float:
    """Operations of the forward (`fwd`) or backward (`bwd`) walk."""
    return COMPOSITE_PAIR * w["pairs"] + \
        COMPOSITE_CONTRIB[direction] * w["contrib"]


def march_mode(cfg) -> str:
    gi = cfg.gi
    return "coherent" if gi.backend.startswith("pallas") and \
        gi.backend != "pallas_exact" else "exact"


@_cached
def march_walks(t) -> Optional[List[Dict]]:
    """The SSAO and the SSR march of the traced view on the G-buffer the
    renderer hands them: per march, its samples, its keys (coherent
    only), the pixels and the directions. None without inputs."""
    g = gbuffer(t)
    if g is None:
        return None
    pipe, rend, ss, iu, comp = (
        _ref("ops.rasterize.pipeline"), _ref("renderer"),
        _ref("ops.screen_space"), _ref("utils.image_utils"),
        _ref("ops.rasterize.composite"))
    cfg, r, cam, b, table = (g["cfg"], g["raster"], g["cam"], g["binning"],
                             g["table"])
    grid = r.grid(cam.height, cam.width)
    H, W = cam.height, cam.width
    mode = march_mode(cfg)
    out = []
    with torch.no_grad():
        accum, _ = comp.composite_fwd(table, b.ids, b.tile_start,
                                      b.tile_count, r, grid)
        img = pipe._tiles_to_image(accum, grid, r, H, W)
        depth = pipe._ref_quotient(img[12:13], img[3:4])
        n_view = pipe.rotate_chw(cam.w2c[:3, :3], img[4:7])
        n_view = n_view / torch.clamp(torch.linalg.norm(n_view, dim=0,
                                                        keepdim=True),
                                      min=1e-12)
        fake = type("O", (), {"depth": depth, "normal": img[4:7]})
        _, depth_pos = rend._derive_maps(fake, cam, True)
        ssr_normal = iu.median_blur_3x3(rend._norm_where_nonzero(n_view))
        tab = torch.as_tensor(ss.direction_table(cfg.gi)[0],
                              device=table.device)
        for nv in (n_view, ssr_normal):
            w = {"samples": 0}
            keys = 0
            if mode == "coherent":
                k = ss.centre_offset_table(nv, depth_pos, tab, cam.fx,
                                           cam.fy, cfg.gi)
                ss._gi_march_coherent_plain(nv, depth_pos, None, k, cfg.gi,
                                            work=w)
                keys = k.numel()
            else:
                ss._gi_march_plain(nv, depth_pos, None, cam.fx, cam.fy,
                                   cfg.gi, work=w)
            out.append(dict(samples=w["samples"], keys=keys, mode=mode,
                            pixels=H * W, directions=tab.shape[0]))
    return out


def march_flops(m: Dict) -> float:
    return MARCH_SAMPLE[m["mode"]] * m["samples"] + MARCH_KEY * m["keys"]


def trained_elements(t) -> int:
    """Elements Adam updates in a training step: every trained field of
    the live Gaussians, and the cubemap where the light trains."""
    x = t.inputs
    per = sum(v[0].numel() for k, v in x.fields.items() if k != "alive")
    n = per * x.cell.config["n_gaussians"]
    if x.cell.traffic.get("phase") == 2:
        n += 6 * x.cfg.train.light_base_res ** 2 * 3
    return n


def roofline(t, kernel: str, launches: int, count) -> Optional[float]:
    """% of the bound of the kernel's first `launches` traced launches
    (those of the step the work was counted on): `count(t)` gives their
    (bytes, operations), or None where there is nothing to count."""
    ms = t.kernel_ms(kernel)
    if len(ms) < launches:
        return None
    c = count(t)
    if c is None:
        return None
    return share(c[0], c[1], sum(ms[:launches]) * 1e-3)


def mfu(t, flops: Optional[float]) -> Optional[float]:
    """% of the f32 peak: a step's (or view's) counted operations over
    its time in the traced run's window that neither the profiler nor
    the stage timer slows."""
    if not flops or not t.step_s:
        return None
    return 100.0 * flops / t.step_s / F32_FLOPS
