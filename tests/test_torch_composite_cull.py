"""The compositing kernels' exact sub-tile cull, through its plain twin
(`composite._subtile_keep_plain`), on the CPU:

* it never drops an (instance, pixel) pair that `_composite_fwd_plain`'s
  test lets pass, over seeded rows that include opacity 0.99, opacity at
  and just above (and below) 1/255, thin anisotropic and nearly
  degenerate conics, degenerate conics, centres outside the tile, and
  ellipses placed to graze a sub-tile's edge pixel;
* the plain forward and backward run over the culled per-sub-tile lists
  equal the unculled ones bit for bit, at a 16x64 tile on an image whose
  width is not a multiple of 64, with the cap_tile cut applied before the
  cull; the forward also matches JAX's jnp compositing forward on the same
  scene;
* `subtile_layout` covers every pixel of a tile once, in at most 8
  sub-tiles, for every tile shape the kernels take.

The kernels evaluate the same walk (csrc/composite_walk.cuh); the card
tests in test_torch_kernels_cuda.py hold them against the plain versions.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gi_gs_tpu.ops.rasterize import RasterConfig as JaxRasterConfig
from gi_gs_tpu.ops.rasterize.composite import _fwd_impl

from gi_gs_tpu_torch.ops.rasterize import RasterConfig, binning, composite
from gi_gs_tpu_torch.ops.rasterize.preprocess import preprocess

from cull_rows import AMIN, cull_rows
from utils import random_scene

torch.set_num_threads(1)

def _pass_mask(rows, px, py, cfg):
    """[N, M] bool: row n passes at pixel m, with `_composite_fwd_plain`'s
    f32 arithmetic (power <= 0 and min(clamp, op exp(power)) >=
    alpha_min)."""
    dx = rows[:, 0:1] - px[None]
    dy = rows[:, 1:2] - py[None]
    power = (-0.5 * (rows[:, 2:3] * dx * dx + rows[:, 4:5] * dy * dy)
             - rows[:, 3:4] * dx * dy)
    alpha = torch.clamp(rows[:, 5:6] * torch.exp(power), max=cfg.alpha_clamp)
    return (power <= 0.0) & (alpha >= cfg.alpha_min)


# The 8 16x16 sub-tiles of a 2x1 grid of 16x64 tiles (a 64x32 image).
CFG = RasterConfig(tile_h=16, tile_w=64)


@pytest.mark.parametrize("graze", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cull_never_drops_a_passing_pair(seed, graze):
    rng = np.random.RandomState(seed)
    x0, x1, y0, y1, pix_sub = composite.subtile_rects(CFG, (2, 1), "cpu")
    rects = torch.stack([x0, x1, y0, y1], -1).reshape(-1, 4)     # [8, 4]
    rows = cull_rows(rng, 6000, rects.numpy().astype(np.int64), graze)
    keep = composite._subtile_keep_plain(
        rows[:, None, :], rects[None, :, 0], rects[None, :, 1],
        rects[None, :, 2], rects[None, :, 3], CFG.alpha_min)   # [N, 8]
    px, py = composite._tile_pixel_coords((2, 1), CFG, "cpu")  # [2, 1024]
    passes = _pass_mask(rows, px.reshape(-1), py.reshape(-1), CFG)
    sub = (torch.arange(2)[:, None] * 4 + pix_sub[None]).reshape(-1)
    dropped = passes & ~keep[:, sub]
    assert int(dropped.sum()) == 0, torch.nonzero(dropped)[:5]
    n_pass = int(passes.sum())
    assert n_pass > 5000
    if graze:
        # the grazing pixel itself passes for about half of the rows
        assert int(passes.any(dim=1).sum()) > 1000
    else:
        # the cull removes most (row, sub-tile) pairs of the spread rows
        assert float(keep.float().mean()) < 0.6
    # rows at or above 1/255 are never culled outright; rows below it are,
    # wherever they are; degenerate conics are never culled
    op = rows[:, 5]
    assert not bool(keep[op < float(AMIN) * (1 - 1e-6)].any())
    a, b, c = rows[:, 2], rows[:, 3], rows[:, 4]
    not_pd = ~((a > 0) & (a * c - b * b > 0))
    assert int(not_pd.sum()) > 100
    assert bool(keep[not_pd & (op >= float(AMIN))].all())


def test_cull_keeps_the_reference_pixels_past_three_sigma():
    """At opacity 0.99 a pixel 3.2 sigma from the mean still passes 1/255:
    the cull keeps it (a 3-sigma cull would drop it)."""
    sigma = 1.5
    rows = torch.zeros((1, 21))
    rows[0, 0:2] = torch.tensor([-3.2 * sigma, 8.0])
    rows[0, 2:5] = torch.tensor([1 / sigma ** 2, 0.0, 1 / sigma ** 2])
    rows[0, 5] = 0.99
    px, py = torch.zeros(1), torch.full((1,), 8.0)
    assert bool(_pass_mask(rows, px, py, CFG).all())
    assert bool(composite._subtile_keep_plain(rows, 0.0, 15.0, 0.0, 15.0,
                                              CFG.alpha_min).all())
    rows[0, 0] = -6.0 * sigma
    assert not bool(composite._subtile_keep_plain(rows, 0.0, 15.0, 0.0, 15.0,
                                                  CFG.alpha_min).any())


def test_cull_constants_are_the_kernels():
    """The twin's slack and sub-tile constants are those the CUDA walk
    compiles (csrc/composite_walk.cuh), so the tests above hold the
    kernels' cull too."""
    src = (Path(composite.__file__).parents[2] / "csrc"
           / "composite_walk.cuh").read_text()
    slack = {name: float(num) / float(den or 1) for name, num, den in
             re.findall(r"constexpr double (k\w+) = ([0-9.e+-]+)"
                        r"(?: / ([0-9.e+-]+))?;", src)}
    assert slack == {"kOpSlack": composite._CULL_OP_SLACK,
                     "kTauAbs": composite._CULL_TAU_ABS,
                     "kTauRel": composite._CULL_TAU_REL,
                     "kKappa": composite._CULL_KAPPA,
                     "kPx": composite._CULL_PX}
    sub = dict(re.findall(r"constexpr int (kSub\w+) = (\d+);", src))
    assert sub == {"kSubPixels": str(composite.SUBTILE_PIXELS),
                   "kSubW": str(composite.SUBTILE_W)}


@pytest.mark.parametrize("tile", [(16, 64), (8, 32), (16, 16), (17, 60),
                                  (3, 341), (33, 31), (1, 1024), (32, 32),
                                  (5, 7), (341, 3), (1024, 1)])
def test_subtile_layout_covers_each_pixel_once(tile):
    cfg = RasterConfig(tile_h=tile[0], tile_w=tile[1])
    sw, sh, nx, ny = composite.subtile_layout(cfg)
    assert nx * ny <= 8 and sw * sh <= 256
    x0, x1, y0, y1, pix_sub = composite.subtile_rects(cfg, (2, 3), "cpu")
    px, py = composite._tile_pixel_coords((2, 3), cfg, "cpu")
    s = pix_sub[None].expand(6, -1)
    t = torch.arange(6)[:, None]
    inside = ((px >= x0[t, s]) & (px <= x1[t, s]) & (py >= y0[t, s])
              & (py <= y1[t, s]))
    assert bool(inside.all())
    area = ((x1 - x0 + 1) * (y1 - y0 + 1)).sum(dim=1)
    assert bool((area == cfg.pixels_per_tile).all())
    if cfg.pixels_per_tile <= 256:
        assert (sw, sh, nx, ny) == (tile[1], tile[0], 1, 1)


def _scene(seed, w, h, n, cfg):
    s = random_scene(n=n, seed=seed, w=w, h=h, op_max=0.99)
    t = lambda a: torch.as_tensor(np.array(a))
    cam = s["cam"]
    pre = preprocess(t(s["xyz"]), t(s["cov3d"]), t(cam.w2c),
                     t(cam.full_proj), float(cam.tanfovx), float(cam.tanfovy),
                     w, h, cfg, opacity=t(s["opacity"]))
    b = binning.bin_and_sort(pre, h, w, cfg)
    feats = torch.as_tensor(np.random.RandomState(seed + 50).uniform(
        -1, 1, (n, 11)).astype(np.float32))
    table = torch.cat([pre.means2d, pre.conic, t(s["opacity"]), feats,
                       pre.depth[:, None], pre.pos_view], 1)
    return table, b


def _subtile_lists(table, b, cfg, grid, cull):
    """Per-sub-tile instance lists as a tile grid of 16x16 tiles: the
    tile's first min(count, n_max) ids, culled for the sub-tile or not."""
    ty, tx = grid
    n_max = cfg.chunks_per_tile * cfg.chunk
    x0, x1, y0, y1, _ = composite.subtile_rects(cfg, grid, "cpu")
    ids, starts, counts = [], [], []
    pos = 0
    for tr in range(ty):
        for s in range(4 * tx):
            t, q = tr * tx + s // 4, s % 4
            lo = int(b.tile_start[t])
            tile_ids = b.ids[lo:lo + min(int(b.tile_count[t]), n_max)]
            if cull:
                keep = composite._subtile_keep_plain(
                    table[tile_ids.long()], x0[t, q], x1[t, q], y0[t, q],
                    y1[t, q], cfg.alpha_min)
                tile_ids = tile_ids[keep]
            ids.append(tile_ids)
            starts.append(pos)
            counts.append(tile_ids.numel())
            pos += tile_ids.numel()
    ids.append(torch.zeros(1, dtype=torch.int32))     # never empty
    return (torch.cat(ids), torch.tensor(starts, dtype=torch.int32),
            torch.tensor(counts, dtype=torch.int32))


def _to_sub(x, grid):
    """[T, C, 1024] per 16x64 tile -> [T * 4, C, 256] per 16x16 sub-tile."""
    ty, tx = grid
    C = x.shape[1]
    return (x.reshape(ty, tx, C, 16, 4, 16).permute(0, 1, 4, 2, 3, 5)
            .reshape(ty * tx * 4, C, 256))


@pytest.mark.parametrize("seed,w", [(0, 200), (1, 136)])
def test_culled_walk_equals_unculled(seed, w):
    """16x64 tiles, W not a multiple of 64, cap_tile 96 below the densest
    tile's count, chunk 1 (the plain walk is then the kernels' sequential
    one). Per sub-tile, the plain forward over the culled list equals the
    forward over the whole list and the tile-level forward bit for bit;
    the plain backward gives the kept instances the same rows and the
    culled ones rows of 0."""
    h = 48
    cfg = RasterConfig(tile_h=16, tile_w=64, cap_instances=1 << 14,
                       cap_tile=96, chunk=1)
    grid = cfg.grid(h, w)
    table, b = _scene(seed, w, h, 1500, cfg)
    assert int(b.max_tile_count) > 96
    acc, ft = composite._composite_fwd_plain(table, b.ids, b.tile_start,
                                             b.tile_count, cfg, grid)
    scfg = RasterConfig(tile_h=16, tile_w=16, cap_instances=1 << 14,
                        cap_tile=96, chunk=1)
    sgrid = (grid[0], 4 * grid[1])
    full = _subtile_lists(table, b, cfg, grid, cull=False)
    kept = _subtile_lists(table, b, cfg, grid, cull=True)
    assert int(kept[2].sum()) < 0.7 * int(full[2].sum())
    fa, fT = composite._composite_fwd_plain(table, *full, scfg, sgrid)
    ka, kT = composite._composite_fwd_plain(table, *kept, scfg, sgrid)
    assert torch.equal(ka, fa) and torch.equal(kT, fT)
    assert torch.equal(ka, _to_sub(acc, grid))
    assert torch.equal(kT, _to_sub(ft[:, None], grid)[:, 0])
    assert float(acc[:, 3].max()) > 0.999         # saturated pixels

    # JAX's jnp forward on the same table and lists (chunked cumulative
    # product: the JAX tolerance of test_torch_rasterize.py)
    jcfg = JaxRasterConfig(tile_h=16, tile_w=64, cap_instances=1 << 14,
                           cap_tile=96, chunk=1, use_pallas=False,
                           expand_backend="xla")
    ja, jt = _fwd_impl(jnp.asarray(table.numpy()), jnp.asarray(b.ids.numpy()),
                       jnp.asarray(b.tile_start.numpy()),
                       jnp.asarray(b.tile_count.numpy()), jcfg, grid)
    np.testing.assert_allclose(acc.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ft.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-6)

    rng = np.random.RandomState(seed + 7)
    g_acc = _to_sub(torch.as_tensor(rng.normal(size=acc.shape)
                                    .astype(np.float32)), grid)
    g_t = torch.as_tensor(rng.normal(size=(ka.shape[0], 256))
                          .astype(np.float32))
    args = (ka[:, :4].contiguous(), kT, g_acc, g_t, scfg, sgrid, (h, w))
    fr = composite._composite_bwd_plain(table, *full, *args)
    kr = composite._composite_bwd_plain(table, *kept, *args)
    n_sub = sgrid[0] * sgrid[1]
    n_culled = 0
    for i in range(n_sub):
        fs, fc = int(full[1][i]), int(full[2][i])
        ks, kc = int(kept[1][i]), int(kept[2][i])
        x0, x1, y0, y1, _ = composite.subtile_rects(cfg, grid, "cpu")
        t, q = (i // sgrid[1]) * grid[1] + (i % sgrid[1]) // 4, i % 4
        keep = composite._subtile_keep_plain(
            table[full[0][fs:fs + fc].long()], x0[t, q], x1[t, q], y0[t, q],
            y1[t, q], cfg.alpha_min)
        assert int(keep.sum()) == kc
        assert torch.equal(fr[fs:fs + fc][keep], kr[ks:ks + kc])
        assert bool((fr[fs:fs + fc][~keep] == 0).all())
        n_culled += int((~keep).sum())
    assert n_culled > 0 and float(kr.abs().max()) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_cull_pair_count(seed):
    """The plain walks' `work` counts: the forward and the backward count
    the same pairs before and after the sub-tile cull, the culled walk
    evaluates fewer, and the culled count is what the walk over each
    sub-tile's culled list evaluates (the culled rows were skipped without
    touching any pixel's state; chunk 1 keeps the two walks' transmittance
    bit-equal)."""
    cfg = RasterConfig(tile_h=16, tile_w=64, cap_instances=1 << 14,
                       cap_tile=256, chunk=1)
    h, w = 48, 200
    grid = cfg.grid(h, w)
    table, b = _scene(seed + 3, w, h, 1000, cfg)
    args = (table, b.ids, b.tile_start, b.tile_count, cfg, grid)
    work, bwork = {}, {}
    acc, ft = composite._composite_fwd_plain(*args, work=work)
    composite._composite_bwd_plain(
        *args[:4], acc[:, :4].contiguous(), ft, torch.ones_like(acc),
        torch.ones_like(ft), cfg, grid, (h, w), work=bwork)
    assert (bwork["pairs"], bwork["culled_pairs"]) == (work["pairs"],
                                                       work["culled_pairs"])
    assert 0 < work["culled_pairs"] < 0.7 * work["pairs"]
    assert 0 < bwork["contrib"] <= work["culled_pairs"]
    scfg = RasterConfig(tile_h=16, tile_w=16, cap_instances=1 << 14,
                        cap_tile=256, chunk=1)
    swork = {}
    composite._composite_fwd_plain(
        table, *_subtile_lists(table, b, cfg, grid, cull=True), scfg,
        (grid[0], 4 * grid[1]), work=swork)
    assert swork["pairs"] == work["culled_pairs"]
