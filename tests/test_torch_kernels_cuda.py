"""The twelve CUDA kernels against their plain PyTorch versions on the card
(csrc/*.cu, built at first use), the coherent march's keys against the
plain offset table included, and the tiled rasterizer against the
brute-force oracle. Marked `cuda`: they skip without a GPU.
On a machine with one (without JAX, so skip the tests' conftest):
    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py"""
import math

import numpy as np
import pytest
import torch

from gi_gs_tpu_torch.ops import cubemap as cm
from gi_gs_tpu_torch.ops import cuda_kernels as ck
from gi_gs_tpu_torch.ops import screen_space as ss
from gi_gs_tpu_torch.ops import sh
from gi_gs_tpu_torch.ops.rasterize import RasterConfig, binning, composite
from gi_gs_tpu_torch.ops.rasterize.preprocess import (PreFlat,
                                                      Preprocessed,
                                                      preprocess)
from gi_gs_tpu_torch.scene.cameras import make_camera
from gi_gs_tpu_torch.train import optim
from gi_gs_tpu_torch.utils.math_utils import build_covariance_3d

import adam_cases
import expand_cases
from cull_rows import cull_rows
from march_scenes import degenerate_centres, smooth_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _scene(dev, n=4000, w=200, h=120, seed=0):
    rng = np.random.RandomState(seed)
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.7, w, h, device=dev)
    z = rng.uniform(1, 5, (n, 1))
    xyz = np.concatenate([rng.uniform(-0.45, 0.45, (n, 2)) * z, z], 1)
    q = rng.normal(size=(n, 4))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    cov = build_covariance_3d(t(np.exp(rng.uniform(-4, -2.5, (n, 3)))),
                              t(q / np.linalg.norm(q, axis=1, keepdims=True)))
    op = t(rng.uniform(0.05, 0.99, (n, 1)))
    cfg = RasterConfig(cap_instances=1 << 16)
    pre = preprocess(t(xyz), cov, cam.w2c, cam.full_proj, cam.tanfovx,
                     cam.tanfovy, w, h, cfg, opacity=op)
    feats = t(rng.uniform(0, 1, (n, 15)))
    return cfg, pre, op, feats, (h, w)


def tie_table(gap):
    """Two Gaussians with the same footprint centred on pixel (5, 3) of
    one 8x32 tile, opacities 0.2 then 0.25, and `gap` zero-opacity
    instances between them. At the centre alpha is the opacity, and in
    f32 0.25 * (1 - 0.2) == 0.2: the two weights tie exactly, in the
    oracle's cumulative product, the Pallas kernel's and the sequential
    walk alike. The first (depth 2) must win the tie."""
    n = gap + 2
    table = np.zeros((n, 21), np.float32)
    table[:, 0:2] = (5.0, 3.0)
    table[:, 2:5] = (0.02, 0.0, 0.02)
    table[:, 5] = 0.0
    table[0, 5], table[-1, 5] = 0.2, 0.25
    table[:, 6:17] = np.random.RandomState(0).uniform(0, 1, (n, 11))
    table[:, 17] = np.arange(n) + 2.0
    table[:, 18:21] = np.arange(n)[:, None] * np.array([1.0, -1.0, 0.5])
    f = np.float32
    assert f(0.25) * (f(1) - f(0.2)) == f(0.2)
    return table


def test_expand_matches_plain(dev):
    cfg, pre, _, _, (h, w) = _scene(dev)
    before = ck.launches["expand"]
    k = binning.expand(pre, h, w, cfg)
    p = binning._expand_plain(pre, h, w, cfg)
    assert ck.launches["expand"] == before + 1
    for a, b in zip(k[:4], p[:4]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", expand_cases.CASES)
def test_expand_matches_plain_at_block_edges(dev, case):
    """The kernel's per-CTA search and shared-memory window at the edges
    of tests/expand_cases.py (one Gaussian over many 256-slot blocks, every
    count 0, total == cap, total > cap): every output equal to the plain
    expansion's."""
    cols, cap = expand_cases.expand_case(case)
    pre = expand_cases.preprocessed(
        cols, Preprocessed, PreFlat, lambda a: torch.as_tensor(a, device=dev))
    cfg = RasterConfig(cap_instances=cap, tile_h=expand_cases.TILE_H,
                       tile_w=expand_cases.TILE_W)
    h, w = expand_cases.HEIGHT, expand_cases.WIDTH
    k = binning.expand(pre, h, w, cfg)
    p = binning._expand_plain(pre, h, w, cfg)
    for a, b in zip(k, p):
        assert torch.equal(a, b)


def test_composite_matches_plain(dev):
    cfg, pre, op, feats, (h, w) = _scene(dev, seed=1)
    b = binning.bin_and_sort(pre, h, w, cfg)
    table = torch.cat([pre.means2d, pre.conic, op, feats[:, :11],
                       pre.depth[:, None], pre.pos_view], 1).contiguous()
    grid = cfg.grid(h, w)
    ka, kt = composite.composite_fwd(table, b.ids, b.tile_start,
                                     b.tile_count, cfg, grid)
    pa, pt = composite._composite_fwd_plain(table, b.ids, b.tile_start,
                                            b.tile_count, cfg, grid)
    torch.testing.assert_close(ka, pa, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kt, pt, rtol=1e-5, atol=1e-6)


# (seed, Gaussians, width, height, fov x, fov y, half-width of the x/y
# draw over z): a 96x64 scene, and a denser 64x48 one at fov 1.0
ORACLE_SCENES = {"96x64": (3, 1500, 96, 64, 1.0, 0.7, 0.45),
                 "64x48": (6, 2000, 64, 48, 1.0, 1.0, 0.9 * math.tan(0.5))}


@pytest.mark.parametrize("tile_h,tile_w,scene", [(16, 64, "96x64"),
                                                 (8, 32, "96x64"),
                                                 (16, 64, "64x48")])
def test_tiled_rasterize_matches_bruteforce_oracle(dev, tile_h, tile_w,
                                                   scene):
    """The tiled rasterizer on the card (`expand`, `composite_fwd`) against
    the brute-force oracle on the card, at tests/test_rasterize.py's
    tolerances: every accumulator and the depth (where the opacity exceeds
    1e-6) within rtol 1e-4, atol 1e-5; final T rtol 1e-5, atol 1e-6."""
    from gi_gs_tpu_torch.ops.rasterize.pipeline import rasterize
    from gi_gs_tpu_torch.ops.rasterize.reference import rasterize_bruteforce
    seed, n, w, h, fovx, fovy, lim = ORACLE_SCENES[scene]
    rng = np.random.RandomState(seed)
    cam = make_camera(np.eye(3), np.zeros(3), fovx, fovy, w, h, device=dev)
    z = rng.uniform(1, 5, (n, 1))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    xyz = t(np.concatenate([rng.uniform(-lim, lim, (n, 2)) * z, z], 1))
    q = rng.normal(size=(n, 4))
    cov = build_covariance_3d(t(np.exp(rng.uniform(-3.5, -2.0, (n, 3)))),
                              t(q / np.linalg.norm(q, axis=1, keepdims=True)))
    op = t(rng.uniform(0.05, 0.95, (n, 1)))
    f = t(rng.uniform(0, 1, (n, 11)))
    cfg = RasterConfig(tile_h=tile_h, tile_w=tile_w, cap_instances=1 << 16)
    args = (cam.w2c, cam.full_proj, cam.tanfovx, cam.tanfovy)
    before = dict(ck.launches)
    out = rasterize(xyz, cov, op, f[:, 0:3], f[:, 3:6], f[:, 6:9],
                    f[:, 9:10], f[:, 10:11], *args, h, w,
                    torch.zeros(3, device=dev), cfg)
    assert ck.launches["composite_fwd"] == before["composite_fwd"] + 1
    assert ck.launches["expand"] == before["expand"] + 1
    pre = preprocess(xyz, cov, *args, w, h, cfg)
    feats = torch.cat([f[:, 0:3], torch.ones_like(f[:, 9:10]), f[:, 3:9],
                       f[:, 9:11], pre.depth[:, None], pre.pos_view], 1)
    acc, final_t = rasterize_bruteforce(xyz, cov, op, feats, *args, h, w,
                                        cfg)
    assert 0.0 < float(final_t.min()) < 0.5
    torch.testing.assert_close(out.final_t[0], final_t, rtol=1e-5, atol=1e-6)
    for got, want in ((out.color, acc[0:3]), (out.opacity[0], acc[3]),
                      (out.normal, acc[4:7]), (out.albedo, acc[7:10]),
                      (out.roughness[0], acc[10]),
                      (out.metallic[0], acc[11]),
                      (out.depth[0], torch.where(acc[3] > 1e-6, acc[12] / (
                          acc[3].clamp(min=1e-6)), 0.0))):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_composite_fwd_peak_matches_plain(dev):
    """The peak kernel's accumulator and final-T rows equal the peak=False
    kernel's bit for bit (the same walk); its peak rows match the plain
    version's on all but near-tie pixels (<= 0.1% of covered pixels: the
    plain cumulative product and the sequential product round apart);
    a constructed exact tie resolves to the first instance on the card."""
    cfg, pre, op, feats, (h, w) = _scene(dev, seed=4)
    b = binning.bin_and_sort(pre, h, w, cfg)
    table = torch.cat([pre.means2d, pre.conic, op, feats[:, :11],
                       pre.depth[:, None], pre.pos_view], 1).contiguous()
    grid = cfg.grid(h, w)
    args = (table, b.ids, b.tile_start, b.tile_count, cfg, grid)
    before = dict(ck.launches)
    ka, kt, kp = composite.composite_fwd(*args, peak=True)
    assert ck.launches["composite_fwd_peak"] == \
        before["composite_fwd_peak"] + 1
    assert ck.launches["composite_fwd"] == before["composite_fwd"]
    fa, ft = composite.composite_fwd(*args)
    assert torch.equal(ka, fa) and torch.equal(kt, ft)
    pa, pt, pp = composite._composite_fwd_plain(*args, peak=True)
    torch.testing.assert_close(ka, pa, rtol=1e-5, atol=1e-5)
    covered = pa[:, 3] > 1e-6
    differ = (kp != pp).any(dim=1) & covered
    assert int(covered.sum()) > 1000
    assert int(differ.sum()) <= 1e-3 * int(covered.sum())

    for gap in (0, 7):
        tie = torch.as_tensor(tie_table(gap), device=dev)
        ids = torch.arange(16, dtype=torch.int32, device=dev) % tie.shape[0]
        ts = torch.zeros(1, dtype=torch.int32, device=dev)
        tc = torch.full((1,), tie.shape[0], dtype=torch.int32, device=dev)
        tcfg = RasterConfig(tile_h=8, tile_w=32, cap_tile=256, chunk=8)
        _, _, k = composite.composite_fwd(tie, ids, ts, tc, tcfg, (1, 1),
                                          peak=True)
        _, _, p = composite._composite_fwd_plain(tie, ids, ts, tc, tcfg,
                                                 (1, 1), peak=True)
        assert torch.equal(k, p)
        assert torch.equal(k[0, :, 3 * 32 + 5], tie[0, 17:21])


def test_composite_bwd_matches_plain(dev):
    """Gradient rows and the per-Gaussian reduction against the plain
    backward, at the JAX test tolerance (rtol 2e-4, atol 2e-5 x the
    largest column maximum): the kernel sums each instance's pixels in
    warp order, the plain version per chunk."""
    cfg, pre, op, feats, (h, w) = _scene(dev, seed=2)
    b = binning.bin_and_sort(pre, h, w, cfg)
    table = torch.cat([pre.means2d, pre.conic, op, feats[:, :11],
                       pre.depth[:, None], pre.pos_view], 1).contiguous()
    grid = cfg.grid(h, w)
    acc, ft = composite.composite_fwd(table, b.ids, b.tile_start,
                                      b.tile_count, cfg, grid)
    g = torch.Generator(device=dev).manual_seed(3)
    g_acc = torch.randn(acc.shape, device=dev, generator=g)
    g_t = torch.randn(ft.shape, device=dev, generator=g)
    args = (table, b.ids, b.tile_start, b.tile_count,
            acc[:, :4].contiguous(), ft, g_acc, g_t, cfg, grid, (h, w))
    before = ck.launches["composite_bwd"]
    k = composite.composite_bwd(*args)
    assert ck.launches["composite_bwd"] == before + 1
    p = composite._composite_bwd_plain(*args)
    red = lambda r: composite.reduce_sorted_instance_grads(r, b.inv_perm,
                                                           b.offsets)
    for got, want in ((k, p), (red(k), red(p))):
        scale = float(want.abs().amax(dim=0).max()) + 1e-3
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5 * scale)


def _composite_case(dev, cfg, w, h, seed, n=4000, op_lo=0.05):
    """A random scene binned at `cfg`; returns the composite arguments, the
    per-launch backward arguments (random cotangents) and the plain
    forward's outputs."""
    rng = np.random.RandomState(seed)
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.7, w, h, device=dev)
    z = rng.uniform(1, 5, (n, 1))
    xyz = np.concatenate([rng.uniform(-0.45, 0.45, (n, 2)) * z, z], 1)
    q = rng.normal(size=(n, 4))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    cov = build_covariance_3d(t(np.exp(rng.uniform(-4, -2.5, (n, 3)))),
                              t(q / np.linalg.norm(q, axis=1, keepdims=True)))
    op = t(rng.uniform(op_lo, 0.99, (n, 1)))
    pre = preprocess(t(xyz), cov, cam.w2c, cam.full_proj, cam.tanfovx,
                     cam.tanfovy, w, h, cfg, opacity=op)
    b = binning.bin_and_sort(pre, h, w, cfg)
    table = torch.cat([pre.means2d, pre.conic, op, t(rng.uniform(
        -1, 1, (n, 11))), pre.depth[:, None], pre.pos_view], 1).contiguous()
    grid = cfg.grid(h, w)
    args = (table, b.ids, b.tile_start, b.tile_count, cfg, grid)
    pa, pt = composite._composite_fwd_plain(*args)
    g = torch.Generator(device=dev).manual_seed(seed)
    g_acc = torch.randn(pa.shape, device=dev, generator=g)
    g_t = torch.randn(pt.shape, device=dev, generator=g)
    bargs = (table, b.ids, b.tile_start, b.tile_count, pa[:, :4].contiguous(),
             pt, g_acc, g_t, cfg, grid, (h, w))
    return b, args, bargs, pa, pt


@pytest.mark.parametrize("case", ["w136", "n_max_mid_batch", "saturated",
                                  "tile_8x16", "tile_24x40_ragged"])
def test_composite_subtile_walk_matches_plain(dev, case):
    """The sub-tile kernels against the plain versions where the walk's
    edges lie: an image width that is not a multiple of 64 (padded columns
    past the image); a cap_tile cut of 200 (in the middle of a forward
    batch of 128 and a backward batch of 64) below the densest tile's
    count; opaque splats that saturate some sub-tiles of a tile and not
    others (per-CTA early exit; the backward's saturated CTAs keep joining
    the cluster barriers); a 128-pixel tile (one CTA, a cluster of one);
    and a 24x40 tile (six ragged sub-tiles, a cluster of six). Forward
    rtol 1e-5, atol 1e-5; backward rows and per-Gaussian sums at the JAX
    tolerance."""
    kw = dict(cap_instances=1 << 17)
    w, h, n, op_lo = 200, 120, 4000, 0.05
    if case == "w136":
        w = 136
    elif case == "n_max_mid_batch":
        kw.update(cap_tile=200, chunk=8)
    elif case == "saturated":
        n, op_lo = 12000, 0.9
    elif case == "tile_8x16":
        kw.update(tile_h=8, tile_w=16, cap_tile=1024)
    else:
        kw.update(tile_h=24, tile_w=40)
    cfg = RasterConfig(**kw)
    b, args, bargs, pa, pt = _composite_case(dev, cfg, w, h, 7, n, op_lo)
    if case == "n_max_mid_batch":
        assert int(b.max_tile_count) > 200
    if case == "saturated":
        # per 16x16 sub-tile of each 16x64 tile: every pixel saturated?
        sat = (pa[:, 3] > 0.999).reshape(-1, 16, 4, 16).all(dim=3).all(dim=1)
        assert bool((sat.any(dim=1) & ~sat.all(dim=1)).any())
    ka, kt = composite.composite_fwd(*args)
    torch.testing.assert_close(ka, pa, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kt, pt, rtol=1e-5, atol=1e-6)
    before = ck.launches["composite_bwd"]
    k = composite.composite_bwd(*bargs)
    assert ck.launches["composite_bwd"] == before + 1
    p = composite._composite_bwd_plain(*bargs)
    red = lambda r: composite.reduce_sorted_instance_grads(r, b.inv_perm,
                                                           b.offsets)
    for got, want in ((k, p), (red(k), red(p))):
        scale = float(want.abs().amax(dim=0).max()) + 1e-3
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5 * scale)


@pytest.mark.parametrize("seed", [0, 1])
def test_composite_grazing_rows_match_plain(dev, seed):
    """The kernels' own cull (`subtile_keep` and the per-warp row skip of
    composite_walk.cuh) where its slack is tight: each 16x64 tile of a
    136x32 image (its last tile half past the image) lists 384 rows whose
    exact alpha_min extent grazes an edge pixel of one of its sub-tiles to
    within 0.05 px, with opacities 0.99, at and next to 1/255 and 0, thin
    and degenerate conics (cull_rows.py). A dropped pair passes with alpha
    >= 1/255 and would move an accumulator far past the tolerance (each
    pixel walks about 340 of its tile's 384 rows before it saturates). Chunk 1
    makes the plain walks sequential, as the kernels are. The backward is
    compared on the rows the plain backward leaves finite: it multiplies a
    rejected pair's zero d(alpha) by exp(power), which is NaN for a NaN
    conic and inf where an indefinite conic's power overflows; the kernel
    skips rejected pairs, so its rows are all finite. Every such row's
    feature columns (sums of w x cotangent, which a dropped pair would
    change by at least T / 255 x its cotangent) are held to the JAX
    tolerance; so are all 21 columns of the rows with opacity below 0.9.
    At opacity 0.99 d(alpha) divides the suffix accum - prefix, which
    cancels near T = 1e-4, by 1 - alpha = 0.01, and the two sums' rounding
    (the kernel's collapsed gA - S, the plain's per-channel suffix) then
    differs by up to ~1e-3 of such a row's conic column (seen on a flat
    conic of opacity 0.99 that covers the whole tile)."""
    cfg = RasterConfig(cap_instances=1 << 14, cap_tile=512, chunk=1)
    h, w, n = 32, 136, 384
    grid = cfg.grid(h, w)
    T = grid[0] * grid[1]
    x0, x1, y0, y1, _ = composite.subtile_rects(cfg, grid, "cpu")
    rects = torch.stack([x0, x1, y0, y1], -1).numpy().astype(np.int64)
    rng = np.random.RandomState(seed)
    table = torch.cat([cull_rows(rng, n, rects[t], graze=True)[
        rng.permutation(n)] for t in range(T)]).to(dev)
    assert bool(table[:, 2:5].isnan().any())
    ids = torch.arange(T * n, dtype=torch.int32, device=dev)
    start = torch.arange(T, dtype=torch.int32, device=dev) * n
    count = torch.full((T,), n, dtype=torch.int32, device=dev)
    ka, kt = composite.composite_fwd(table, ids, start, count, cfg, grid)
    pa, pt = composite._composite_fwd_plain(table, ids, start, count, cfg,
                                            grid)
    torch.testing.assert_close(ka, pa, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kt, pt, rtol=1e-5, atol=1e-6)
    assert float(pa[:, 3].max()) > 0.5         # rows did blend

    g = torch.Generator(device=dev).manual_seed(seed)
    bargs = (table, ids, start, count, pa[:, :4].contiguous(), pt,
             torch.randn(pa.shape, device=dev, generator=g),
             torch.randn(pt.shape, device=dev, generator=g), cfg, grid,
             (h, w))
    k = composite.composite_bwd(*bargs)
    p = composite._composite_bwd_plain(*bargs)
    fin = p.isfinite().all(dim=1)
    assert float(fin.float().mean()) > 0.8 and bool(k.isfinite().all())
    low = fin & (table[:, 5] < 0.9)
    assert float(low.float().mean()) > 0.5
    for rows, cols in ((fin, slice(6, 21)), (low, slice(0, 21))):
        want = p[rows][:, cols]
        scale = float(want.abs().amax(dim=0).max()) + 1e-3
        torch.testing.assert_close(k[rows][:, cols], want, rtol=2e-4,
                                   atol=2e-5 * scale)


def _check_tile_ranges(table, ids, start, count, cfg, grid, hw, g_acc, g_t,
                       n_ranges=3, bwd_rows=None):
    """The kernels over `n_ranges` contiguous tile ranges (`tile_base`,
    the tiles padded with empty ones to a multiple of n_ranges) against
    the whole-image launch and against their plain versions: the forward
    ranges concatenated bit-equal to the whole launch; the backward rows
    summed over the ranges bit-equal to the whole launch's (each instance
    row belongs to one tile); each range against the plain version at the
    tolerances of test_composite_bwd_matches_plain (the backward on the
    rows `bwd_rows` selects, default all)."""
    T = grid[0] * grid[1]
    acc, ft = composite.composite_fwd(table, ids, start, count, cfg, grid)
    rows = composite.composite_bwd(table, ids, start, count,
                                   acc[:, :4].contiguous(), ft, g_acc, g_t,
                                   cfg, grid, hw)
    t_local = -(-T // n_ranges)
    pad = n_ranges * t_local - T
    padded = lambda x: torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
    start_p, count_p, g_acc_p, g_t_p = map(padded, (start, count, g_acc,
                                                    g_t))
    accs, fts, row_sum = [], [], torch.zeros_like(rows)
    before = dict(ck.launches)
    for r in range(n_ranges):
        base = r * t_local
        sl = slice(base, base + t_local)
        fargs = (table, ids, start_p[sl], count_p[sl], cfg, grid)
        a, f = composite.composite_fwd(*fargs, tile_base=base)
        pa, pt = composite._composite_fwd_plain(*fargs, tile_base=base)
        torch.testing.assert_close(a, pa, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(f, pt, rtol=1e-5, atol=1e-6)
        bargs = (table, ids, start_p[sl], count_p[sl], a[:, :4].contiguous(),
                 f, g_acc_p[sl], g_t_p[sl], cfg, grid, hw)
        k = composite.composite_bwd(*bargs, tile_base=base)
        p = composite._composite_bwd_plain(*bargs, tile_base=base)
        sel = slice(None) if bwd_rows is None else bwd_rows
        scale = float(p[sel].abs().amax(dim=0).max()) + 1e-3
        torch.testing.assert_close(k[sel], p[sel], rtol=2e-4,
                                   atol=2e-5 * scale)
        accs.append(a)
        fts.append(f)
        row_sum = row_sum + k
    assert ck.launches["composite_fwd"] == before["composite_fwd"] + n_ranges
    assert ck.launches["composite_bwd"] == before["composite_bwd"] + n_ranges
    assert torch.equal(torch.cat(accs)[:T], acc)
    assert torch.equal(torch.cat(fts)[:T], ft)
    assert float(rows.abs().max()) > 0
    assert torch.equal(row_sum, rows)
    return pad


def test_composite_tile_ranges_match_whole_launch(dev):
    """A 200x120 scene (an 8 x 4 grid: 32 tiles, padded to 33) as 3 tile
    ranges."""
    cfg = RasterConfig(cap_instances=1 << 17)
    b, args, bargs, _, _ = _composite_case(dev, cfg, 200, 120, 5)
    table, ids, start, count, _, grid = args
    assert _check_tile_ranges(table, ids, start, count, cfg, grid,
                              bargs[-1], bargs[6], bargs[7]) == 1


def test_composite_tile_ranges_grazing_rows(dev):
    """The grazing rows of test_composite_grazing_rows_match_plain (136x32,
    a 2 x 3 grid of 16x64 tiles, 384 rows each, chunk 1) as 3 tile
    ranges: the cull of a range's sub-tiles takes their image position
    from tile_base. The backward against the plain version on the rows
    the plain backward leaves finite with opacity below 0.9 (that test's
    docstring says why)."""
    cfg = RasterConfig(cap_instances=1 << 14, cap_tile=512, chunk=1)
    h, w, n = 32, 136, 384
    grid = cfg.grid(h, w)
    T = grid[0] * grid[1]
    x0, x1, y0, y1, _ = composite.subtile_rects(cfg, grid, "cpu")
    rects = torch.stack([x0, x1, y0, y1], -1).numpy().astype(np.int64)
    rng = np.random.RandomState(2)
    table = torch.cat([cull_rows(rng, n, rects[t], graze=True)[
        rng.permutation(n)] for t in range(T)]).to(dev)
    ids = torch.arange(T * n, dtype=torch.int32, device=dev)
    start = torch.arange(T, dtype=torch.int32, device=dev) * n
    count = torch.full((T,), n, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    g_acc = torch.randn((T, 16, cfg.pixels_per_tile), device=dev,
                        generator=g)
    g_t = torch.randn((T, cfg.pixels_per_tile), device=dev, generator=g)
    plain = composite._composite_bwd_plain(
        table, ids, start, count, *(lambda a, f: (a[:, :4].contiguous(), f))(
            *composite._composite_fwd_plain(table, ids, start, count, cfg,
                                            grid)),
        g_acc, g_t, cfg, grid, (h, w))
    low = plain.isfinite().all(dim=1) & (table[:, 5] < 0.9)
    assert float(low.float().mean()) > 0.5
    _check_tile_ranges(table, ids, start, count, cfg, grid, (h, w), g_acc,
                       g_t, bwd_rows=low)


def test_composite_bwd_is_deterministic(dev):
    """No atomics: two launches on one input give bit-identical rows."""
    cfg = RasterConfig(cap_instances=1 << 17)
    _, _, bargs, _, _ = _composite_case(dev, cfg, 200, 120, 11)
    first = composite.composite_bwd(*bargs)
    second = composite.composite_bwd(*bargs)
    assert float(first.abs().max()) > 0
    assert torch.equal(first, second)


@pytest.mark.parametrize("cap", [pytest.param(1 << 18, id="cap_above_total"),
                                 pytest.param(20000, id="cap_below_total"),
                                 pytest.param(3000, id="cap_in_512_chunks")])
def test_reduce_instance_grads_matches_plain(dev, cap):
    """The per-Gaussian reduction kernel on a binned scene of 12,000 small
    Gaussians and one that covers all 1,024 tiles of a 512x256 image at
    8x16 tiles, with random rows (those of no segment included), at a cap
    above the instance count and at two below it (the last segments
    clamped to the cap; a partial last chunk of the prefix sum; at 3,000
    PyTorch's cumsum scans in chunks of 512, not 1024): bit-equal to the
    plain gather, cumsum and differences on the card, two launches
    bit-identical, one launch counted, the plain version's shape and
    strides; against a float64 segment sum of the same rows, within the
    f32 prefix sums' error: 2 x (11 x chunks + 11) x 2^-24 x the column's
    sum of |row| (the depth of the chunked scan's sums, at most 11 adds a
    chunk of at least 512), plus the difference's own rounding."""
    rng = np.random.RandomState(5)
    w, h, n = 512, 256, 12001
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.7, w, h, device=dev)
    z = rng.uniform(1, 5, (n, 1))
    xyz = np.concatenate([rng.uniform(-0.45, 0.45, (n, 2)) * z, z], 1)
    scale = np.exp(rng.uniform(-5, -3.5, (n, 3)))
    xyz[300], scale[300] = (0.0, 0.0, 2.0), 0.6
    q = rng.normal(size=(n, 4))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    cov = build_covariance_3d(t(scale), t(q / np.linalg.norm(
        q, axis=1, keepdims=True)))
    op = rng.uniform(0.05, 0.99, (n, 1))
    op[300] = 0.9
    cfg = RasterConfig(tile_h=8, tile_w=16, cap_instances=cap)
    pre = preprocess(t(xyz), cov, cam.w2c, cam.full_proj, cam.tanfovx,
                     cam.tanfovy, w, h, cfg, opacity=t(op))
    b = binning.bin_and_sort(pre, h, w, cfg)
    seg = (b.offsets[1:] - b.offsets[:-1]).long()
    assert int(seg[300]) == 1024 and int(seg.min()) == 1
    total = int(b.offsets[-1])
    assert total < cap if cap == 1 << 18 else total > cap
    rows = torch.randn((cap, composite.TABLE_DIM), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(6))

    before = ck.launches["reduce_instance_grads"]
    k = composite.reduce_sorted_instance_grads(rows, b.inv_perm, b.offsets)
    assert ck.launches["reduce_instance_grads"] == before + 1
    again = composite.reduce_sorted_instance_grads(rows, b.inv_perm,
                                                   b.offsets)
    assert torch.equal(k, again)
    p = composite._reduce_sorted_instance_grads_plain(rows, b.inv_perm,
                                                      b.offsets)
    assert k.shape == p.shape and k.stride() == p.stride()
    assert torch.equal(k, p)

    lo = torch.clamp(b.offsets[:-1].long(), 0, cap)
    length = torch.clamp(b.offsets[1:].long(), 0, cap) - lo
    owner = torch.repeat_interleave(torch.arange(n, device=dev), length)
    gathered = rows[b.inv_perm].double()
    exact = torch.zeros((n, composite.TABLE_DIM), dtype=torch.float64,
                        device=dev).index_add_(0, owner,
                                               gathered[:owner.numel()])
    depth = 11 * -(-cap // 512) + 11
    bound = (2 * depth * 2.0 ** -24 * gathered.abs().sum(0)
             + 2.0 ** -24 * exact.abs())
    assert bool(((k.double() - exact).abs() <= bound).all())


def _march_inputs(dev, h, w, with_rgb, seed=0):
    """A smooth G-buffer with a hard edge (march_scenes.smooth_scene) on
    the card, normals of random length, and random RGB for SSR."""
    n, pos, fx, _ = smooth_scene(h, w, seed)
    t = lambda a: torch.as_tensor(a, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    nrm = t(n) * (0.5 + torch.rand(1, h, w, device=dev, generator=g))
    rgb = torch.rand(3, h, w, device=dev, generator=g) if with_rgb else None
    return nrm, t(pos), rgb, fx


MARCH_SHAPES = [pytest.param(60, 90, id="60x90"),
                pytest.param(800, 800, id="800x800")]


@pytest.mark.parametrize("h,w", MARCH_SHAPES)
@pytest.mark.parametrize("with_rgb", [False, True])
def test_gi_march_matches_plain(dev, with_rgb, h, w):
    """The exact march's lock-step walk against the plain march: same hits,
    the sums over the directions in another order (rtol 1e-5, atol 1e-4);
    one launch per call."""
    nrm, pos, rgb, fx = _march_inputs(dev, h, w, with_rgb)
    p = ss.GIParams()
    before = ck.launches["gi_march"]
    ko, kd = ss.gi_march(nrm, pos, rgb, fx, fx, p)
    assert ck.launches["gi_march"] == before + 1
    po, pd = ss._gi_march_plain(nrm, pos, rgb, fx, fx, p)
    assert float(po.max()) > 0
    torch.testing.assert_close(ko, po, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(kd, pd, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("R,rough", [(64, 0.36), (128, 0.22)])
def test_patch_matches_plain(dev, R, rough):
    h, src, W = cm._patch_tables(R, rough, 0.99)
    W = torch.as_tensor(W, device=dev)
    src = torch.as_tensor(src, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    cmap = torch.rand(6, R, R, 3, device=dev, generator=g)
    k = cm._specular_apply_patch(cmap, src, W, h)
    p = cm._apply_patch_plain(cmap, src, W, h)
    torch.testing.assert_close(k, p, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("h,w", [pytest.param(48, 200, id="48x200"),
                                 pytest.param(800, 800, id="800x800")])
@pytest.mark.parametrize("with_rgb", [False, True])
def test_gi_march_coherent_matches_plain(dev, with_rgb, h, w):
    """One launch builds the block-centre keys and marches. At 48x200 (one
    full 128-column block and a partial one whose centre lies in the
    padding) and 800x800: the keys the kernel built equal the plain table
    on the card and on the CPU (integer keys, no mismatch allowed); the
    kernel matches the plain coherent march on those keys (same hits, sums
    over the directions in another order: rtol 1e-5, atol 1e-4)."""
    nrm, pos, rgb, fx = _march_inputs(dev, h, w, with_rgb)
    p = ss.GIParams()
    tab = torch.as_tensor(ss.direction_table(p)[0], device=dev)
    keys = ss.centre_offset_table(nrm, pos, tab, fx, fx, p)
    got = torch.full_like(keys, -1)
    before = ck.launches["gi_march_coherent"]
    ko, kd = ss.gi_march_coherent(nrm, pos, rgb, fx, fx, p, keys_out=got)
    assert ck.launches["gi_march_coherent"] == before + 1
    assert torch.equal(got, keys)
    assert torch.equal(keys.cpu(), ss.centre_offset_table(
        nrm.cpu(), pos.cpu(), tab.cpu(), fx, fx, p))
    po, pd = ss._gi_march_coherent_plain(nrm, pos, rgb, keys, p)
    assert float(po.max()) > 0
    torch.testing.assert_close(ko, po, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(kd, pd, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("gi", [{}, dict(delta=0.25, step=4, start=2)],
                         ids=["defaults", "small"])
def test_gi_march_coherent_keys_at_degenerate_centres(dev, gi):
    """The kernel's keys equal the plain table's (on the card and on the
    CPU) where the table degenerates (march_scenes.degenerate_centres):
    normals at +-up and of length 0, a centre at z = 1e-6 whose offsets
    are clipped to +-2047, and a last column block whose centre lies in
    the zero padding (W = 272)."""
    n, pos, fx, _ = degenerate_centres(48, 272, seed=3)
    nrm, pos = (torch.as_tensor(a, device=dev) for a in (n, pos))
    p = ss.GIParams(**gi)
    tab = torch.as_tensor(ss.direction_table(p)[0], device=dev)
    keys = ss.centre_offset_table(nrm, pos, tab, fx, fx, p)
    dy, dx = keys // 4096 - 2048, keys % 4096 - 2048
    assert bool((torch.maximum(dx.abs(), dy.abs())[1, 1] == 2047).any())
    got = torch.full_like(keys, -1)
    ss.gi_march_coherent(nrm, pos, None, fx, fx, p, keys_out=got)
    assert torch.equal(got, keys)
    assert torch.equal(keys.cpu(), ss.centre_offset_table(
        nrm.cpu(), pos.cpu(), tab.cpu(), fx, fx, p))


@pytest.mark.parametrize("kernel", ["gi_march", "gi_march_coherent"])
def test_marches_are_deterministic(dev, kernel):
    """No atomics and a fixed sum order: two launches on one input give
    bit-identical occlusion and indirect sums."""
    nrm, pos, rgb, fx = _march_inputs(dev, 160, 300, True, seed=5)
    march = getattr(ss, kernel)
    first = march(nrm, pos, rgb, fx, fx, ss.GIParams())
    second = march(nrm, pos, rgb, fx, fx, ss.GIParams())
    assert float(first[0].max()) > 0
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.parametrize("start", [4, 6])
@pytest.mark.parametrize("kernel", ["gi_march", "gi_march_coherent"])
def test_marches_take_no_step_from_start_at_step(dev, kernel, start):
    """start >= step: no sample, so occlusion and indirect sums are 0 (JAX:
    SSAO 1, SSR 0), and the coherent kernel's keys are JAX's zero table
    [nby, nbx, nd, 1]."""
    nrm, pos, rgb, fx = _march_inputs(dev, 40, 150, True)
    p = ss.GIParams(delta=0.25, step=4, start=start)
    kw = {}
    if kernel == "gi_march_coherent":
        tab = torch.as_tensor(ss.direction_table(p)[0], device=dev)
        keys = ss.centre_offset_table(nrm, pos, tab, fx, fx, p)
        assert keys.shape == (3, 2, tab.shape[0], 1)
        kw["keys_out"] = torch.full_like(keys, -1)
    occ, dif = getattr(ss, kernel)(nrm, pos, rgb, fx, fx, p, **kw)
    assert not occ.any() and not dif.any()
    if kw:
        assert not kw["keys_out"].any()
    assert float(ss.ssao(nrm, pos, fx, fx, p).min()) == 1.0


@pytest.mark.parametrize("R,rough", [(256, 0.08), (128, 0.22), (64, 0.36),
                                     pytest.param(64, 0.45,
                                                  id="64-0.45-clamped")])
def test_patch_bwd_matches_plain(dev, R, rough):
    """The transpose kernel against `_patch_bwd_plain` at the three patch
    levels of the 256 light and at a halo clamped to R // 2 (P = R + 1):
    bit-equal (the same products added in the same offset order, no FMA;
    the zero-filled terms outside the face add +0). And the cubemap
    gradient of the whole filter on the card (forward and backward
    kernels) against autograd of the plain filter (1e-5: the halo
    border's scatter adds in another order)."""
    h, src, W = cm._patch_tables(R, rough, 0.99)
    W = torch.as_tensor(W, device=dev)
    src = torch.as_tensor(src, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    cot = torch.randn(6, 3, R, R, device=dev, generator=g)
    P = 2 * h + 1
    before = ck.launches["patch_bwd"]
    k = cm.patch_bwd(W, cot, R, P, h)
    assert ck.launches["patch_bwd"] == before + 1
    if rough == 0.45:
        assert h == R // 2
    assert torch.equal(k, cm._patch_bwd_plain(W, cot, h))
    cmap = torch.rand(6, R, R, 3, device=dev, generator=g)
    gout = cot.permute(0, 2, 3, 1)
    grads = []
    for fn in (cm._specular_apply_patch, cm._apply_patch_plain):
        c = cmap.clone().requires_grad_(True)
        (fn(c, src, W, h) * gout).sum().backward()
        grads.append(c.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("base", [256, 128, 64])
def test_patch_fwd_matches_plain_bit_equal(dev, base):
    """The filter kernel against `_patch_fwd_plain` at every patch level of
    the light of `base` (`build_prefilter_tables`: 256, 128 and 64 at
    roughness 0.08, 0.22 and 0.36 for the 256 light; 128 and 64 for the
    128 light; 64 for the 64 light, each with its own halo), on the
    halo-padded faces of a random cubemap: bit-equal (the same products
    added in the same offset order, no FMA), one launch per call, and the
    C launcher's shared memory is `patch_fwd_shape`'s."""
    from gi_gs_tpu_torch.models import light as light_mod
    spec, arrays = light_mod.build_prefilter_tables(base, device=dev)
    ops, _ = cm.level_operators(spec, arrays)
    g = torch.Generator(device=dev).manual_seed(3)
    levels = 0
    for sp, op in zip(spec, ops):
        if sp[0] == "dense":
            continue
        (src, W), h = op, sp[1]
        R = W.shape[-1]
        padded = cm.halo_pad(torch.rand(6, R, R, 3, device=dev, generator=g),
                             src, h)
        before = ck.launches["patch_fwd"]
        k = cm.patch_fwd(W, padded, R, 2 * h + 1, h)
        assert ck.launches["patch_fwd"] == before + 1
        assert torch.equal(k, cm._patch_fwd_plain(W, padded, h)), (R, h)
        res = cm.patch_resources("patch_fwd", R, h, dev)
        assert res["dynamic_smem_bytes"] == cm.patch_fwd_shape(R, h)["smem"]
        assert res["blocks_per_sm"] >= 1
        levels += 1
    assert levels == {256: 3, 128: 2, 64: 1}[base]


def _transpose_case(case: str, device):
    """One gather transpose at the phase-2 path's shapes, inputs from a
    numpy seed on `device`: (forward output, input cotangent)."""
    from gi_gs_tpu_torch.models import light as light_mod
    rng = np.random.RandomState(31)
    t = lambda a, **kw: torch.tensor(a, device=device, **kw)
    if case.startswith("take_rows"):
        # 800x800 lookups into the 16^2 diffuse quad table (1,734 rows,
        # C = 12), or 20,000 into 17 rows of C = 3
        rows, C, n = (1734, 12, 640_000) if case == "take_rows_1734" else \
            (17, 3, 20_000)
        flat = t(rng.randn(rows, C).astype(np.float32), requires_grad=True)
        idx = t(rng.randint(0, rows, n))
        out = cm.take_rows(flat, idx)
        leaf, cot = flat, rng.randn(n, C)
    elif case == "pad_cubemap":
        leaf = t(rng.rand(6, 256, 256, 3).astype(np.float32),
                 requires_grad=True)
        out = cm.pad_cubemap(leaf)
        cot = rng.randn(6, 258, 258, 3)
    elif case == "patch_filter":
        h, src, W = cm._patch_tables(256, 0.08, 0.99)
        leaf = t(rng.rand(6, 256, 256, 3).astype(np.float32),
                 requires_grad=True)
        out = cm._specular_apply_patch(leaf, t(src), t(W), h)
        cot = rng.randn(6, 256, 256, 3)
    else:
        leaf = t(rng.rand(6, 256, 256, 3).astype(np.float32),
                 requires_grad=True)
        out = light_mod.make_latlong_sampler(256)(leaf)
        cot = rng.randn(512, 1024, 3)
    out.backward(t(cot.astype(np.float32)))
    return out.detach().cpu(), leaf.grad.cpu(), cot


def _largest_prefix(cot: np.ndarray) -> float:
    """The largest |prefix sum| of the lat-long sampler's sorted tap
    cotangents (512x1024 from a 256^2 cube): the scale of its f32 cumsum
    differences' rounding."""
    from gi_gs_tpu_torch.models import light as light_mod
    _, w, order, _ = light_mod._latlong_struct(256, 512, 1024)
    taps = (cot.reshape(-1, 1, 3) * w[..., None]).reshape(-1, 3)
    return float(np.abs(np.cumsum(taps[order], axis=0)).max())


@pytest.mark.parametrize("case", ["take_rows_1734", "take_rows_17",
                                  "pad_cubemap", "patch_filter", "latlong"])
def test_gather_transposes_match_cpu(dev, case):
    """Each transpose's Function on CUDA tensors against the same Function
    on CPU tensors: forwards within 1e-6 (the same gathers; the patch
    filter and the four-tap sums may round apart); cotangents within 1e-5
    x the largest (`index_add_` adds on the card in atomic order), the
    lat-long sampler's within 4 f32 ulps (2^-23) of its largest prefix
    sum: each is a difference of two f32 prefix sums over all 2.1M taps,
    which the card and the CPU scan in another association, so their
    rounding scales with the prefix, not with the cotangent."""
    ko, kg, cot = _transpose_case(case, dev)
    po, pg, _ = _transpose_case(case, torch.device("cpu"))
    torch.testing.assert_close(ko, po, rtol=1e-6, atol=1e-6)
    scale = float(pg.abs().max())
    assert scale > 0
    atol = (4 * 2.0 ** -23 * _largest_prefix(cot) if case == "latlong"
            else 1e-5 * scale)
    torch.testing.assert_close(kg, pg, rtol=0, atol=atol)


def test_latlong_backward_is_deterministic(dev):
    """The env-TV sampler's backward (a gather in texel order and the
    differences of a cumsum, no atomics) gives the same bits on every call
    on the card, at the training shapes (a 256^2 cube, 512x1024)."""
    grads = [_transpose_case("latlong", dev)[1] for _ in range(3)]
    assert all(torch.equal(grads[0], g) for g in grads[1:])


def _chain_step(tx, view, grads, state):
    """The plain chain, group by group, on the same tensors."""
    out = {}
    for f, p in view.items():
        grp = optim.GROUP_OF_FIELD.get(f, f)
        out[f] = optim.adam_step(p, grads[f], state[grp], tx.lrs[grp])
    return out


def _misaligned(t):
    """The same values, contiguous, 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _column_major(t):
    """The same values, first dimension innermost, as the compositing
    table's gradient hands normal's and albedo's over."""
    return t.reshape(t.shape[0], -1).t().contiguous().t().view(t.shape)


@pytest.mark.parametrize("layout", ["aligned", "misaligned", "strided"])
@pytest.mark.parametrize("count", adam_cases.COUNTS)
@pytest.mark.parametrize("group", ["gaussians", "light"])
def test_adam_matches_the_chain(dev, group, count, layout):
    """One `adam` launch over every group against `adam_step` on the card:
    p, mu and nu bit for bit in every group, at ragged group sizes, the
    scheduled and constant rates, gradients with zeros, residues,
    denormals and large values, and nu at 0. A misaligned gradient takes
    the kernel's scalar accesses; a strided one is copied first."""
    tx = adam_cases.optimizer(group)
    view, grads, state = adam_cases.to(
        *adam_cases.step_inputs(group, count, seed=count), dev)
    if layout != "aligned":
        grads = {f: (_misaligned if layout == "misaligned"
                     else _column_major)(g) for f, g in grads.items()}
        assert all(g.is_contiguous() == (layout == "misaligned")
                   or g.shape[1:].numel() == 1 for g in grads.values())
    before = ck.launches["adam"]
    new_view, new_state = tx.step(grads, state, view)
    torch.cuda.synchronize()
    assert ck.launches["adam"] == before + 1
    for f, (want_p, want_st) in _chain_step(tx, view, grads, state).items():
        grp = optim.GROUP_OF_FIELD.get(f, f)
        _same_bits(f"{f}.p", new_view[f], want_p)
        _same_bits(f"{f}.mu", new_state[grp]["mu"], want_st["mu"])
        _same_bits(f"{f}.nu", new_state[grp]["nu"], want_st["nu"])
        assert new_state[grp]["count"] == count
        assert new_view[f].data_ptr() != view[f].data_ptr()


def test_adam_refuses_strided_and_non_f32_tensors(dev):
    view, grads, state = adam_cases.to(*adam_cases.step_inputs("light", 2),
                                       dev)
    item = lambda **kw: [tuple(dict(dict(
        name="cubemap", p=view["cubemap"], g=grads["cubemap"],
        st=state["cubemap"], rate=0.05), **kw).values())]
    optim.adam_cuda(item())
    with pytest.raises(ValueError, match="contiguous"):
        optim.adam_cuda(item(g=grads["cubemap"].transpose(1, 2)))
    with pytest.raises(ValueError, match="contiguous"):
        optim.adam_cuda(item(p=view["cubemap"].transpose(1, 2)))
    with pytest.raises(ValueError, match="dtype"):
        optim.adam_cuda(item(g=grads["cubemap"].double()))
    with pytest.raises(ValueError, match="dtype"):
        optim.adam_cuda(item(st=dict(state["cubemap"],
                                     mu=state["cubemap"]["mu"].half())))
    with pytest.raises(ValueError, match="shape"):
        optim.adam_cuda(item(g=grads["cubemap"][:, :, :, :2].contiguous()))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        optim.adam_cuda(item(g=grads["cubemap"].cpu()))


@pytest.mark.parametrize("phase", [1, 2])
def test_adam_launches_once_per_optimizer_per_training_step(dev, phase):
    """A training step on the card launches `adam` once for the
    Gaussians' ten groups and, in phase 2, once for the cubemap; every
    gradient arrives as the launcher takes it."""
    from test_torch_spans import Scene, make_step, port_cfg
    state, step = make_step(Scene(dev), phase, port_cfg(), dev)
    step(state)
    for _ in range(2):
        before = ck.launches["adam"]
        step(state)
        torch.cuda.synchronize()
        assert ck.launches["adam"] - before == phase


SH_N = 1000                 # 7 tiles of 128 slots and a partial one
# (active degree, stored rest rows): every degree over bicycle's 15 rows,
# and garden's degree 1 over 3
SH_CASES = [pytest.param(0, 15, id="deg0"), pytest.param(1, 15, id="deg1"),
            pytest.param(2, 15, id="deg2"), pytest.param(3, 15, id="deg3"),
            pytest.param(1, 3, id="deg1_rows3")]
CLAMP_SLOT, FLOOR_SLOT, ZERO_SLOT = 0, 1, 2


def _dc_at_the_clamp() -> float:
    """An f32 x with f32(C0) * x + 0.5 == 0 exactly (IEEE products and
    sums round alike on the CPU and the card)."""
    c0 = torch.tensor(sh.SH_C0, dtype=torch.float32)
    x = torch.tensor(-0.5, dtype=torch.float32) / c0
    for _ in range(64):
        if c0 * x + 0.5 == 0:
            return float(x)
        x = torch.nextafter(x, torch.tensor(0.0))
    raise AssertionError("no dc puts the colour at the clamp")


def _sh_inputs(dev, deg, rows, offset=0, seed=0):
    """features_dc [N, 1, 3], features_rest [N, rows, 3], means [N, 3] and
    campos [3] on the card (offset > 0: views that start that many slots
    into larger buffers, off 16-byte alignment), with a colour channel
    exactly at the clamp (slot 0, channel 1: rest rows 0), a mean at
    campos (slot 1: the MIN_NORM2 floor), and the colour's incoming
    gradient as the compositing backward hands it over: columns 6:9 of a
    column-major [N, 21] gradient, zero in slot 2."""
    g = torch.Generator(device=dev).manual_seed(seed + 100 * deg + rows)
    n = SH_N + offset
    dc = torch.randn((n, 1, 3), device=dev, generator=g)[offset:]
    rest = 0.3 * torch.randn((n, rows, 3), device=dev, generator=g)
    rest = rest[offset:]
    means = 2.0 * torch.randn((n, 3), device=dev, generator=g)[offset:]
    campos = torch.tensor([0.3, -0.2, 4.0], device=dev)
    dc[CLAMP_SLOT, 0, 1] = _dc_at_the_clamp()
    rest[CLAMP_SLOT] = 0.0
    means[FLOOR_SLOT] = campos
    table_grad = torch.randn((21, SH_N), device=dev, generator=g).t()
    table_grad[ZERO_SLOT] = 0.0
    return dc, rest, means, campos, table_grad[:, 6:9]


def _same_bits(name, got, want):
    bad = got != want
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} of {bad.numel()} differ, largest by "
        f"{float((got - want).abs().max()):.3e}")


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("deg,rows", SH_CASES)
def test_sh_matches_plain(dev, deg, rows, offset):
    """`sh_fwd` and `sh_bwd` against the plain twin on the card: the
    colour and every gradient bit for bit (the kernels take the twin's
    operations in PyTorch's order, with PyTorch's sum orders, unfused).
    The incoming gradient strided as on the training path; a tie at the
    clamp passes half (C0 x g / 2); the zero-gradient slot gets exact
    zeros; the MIN_NORM2 slot's mean gradient is finite; coefficients
    past the active degree get zeros. offset 1: inputs off 16-byte
    alignment (the kernels' one-float copies)."""
    dc, rest, means, campos, g = _sh_inputs(dev, deg, rows, offset)
    assert g.stride() == (1, SH_N)
    if offset:
        assert rest.data_ptr() % 16 and dc.data_ptr() % 16
    needs = (True, True, True)
    out = sh.sh_fwd(deg, dc, rest, means, campos)
    grads = sh.sh_bwd(deg, g, dc, rest, means, campos, needs)
    want, saved = sh._sh_fwd_plain(deg, dc, rest, means, campos)
    ref = sh._sh_bwd_plain(deg, g, saved, needs)
    assert bool((want == 0).any()) and bool((want > 0).any())
    _same_bits("colour", out, want)
    _same_bits("g_dc", grads[0], ref[0])
    _same_bits("g_rest", grads[1], ref[1])
    if deg == 0:
        assert grads[2] is None and ref[2] is None
    else:
        _same_bits("g_means", grads[2], ref[2])
        assert not bool(grads[2][ZERO_SLOT].any())
        assert bool(torch.isfinite(grads[2][FLOOR_SLOT]).all())
    assert out[CLAMP_SLOT, 1] == 0
    assert grads[0][CLAMP_SLOT, 0, 1] == (
        torch.tensor(sh.SH_C0, dtype=torch.float32) * (0.5 * g[CLAMP_SLOT, 1]))
    assert not bool(grads[0][ZERO_SLOT].any())
    assert not bool(grads[1][ZERO_SLOT].any())
    B = (deg + 1) ** 2
    assert not bool(grads[1][:, B - 1:].any())


def test_sh_takes_a_row_major_gradient_and_partial_needs(dev):
    """A row-major incoming gradient (columns 6:9 of a contiguous [N, 21])
    and an expanded one (stride 0) give the bits of the same values
    handed over contiguous; a gradient not wanted is not written (None),
    the others unchanged."""
    dc, rest, means, campos, g = _sh_inputs(dev, 3, 15)
    rows = torch.zeros((SH_N, 21), device=dev)
    rows[:, 6:9] = g
    dense = g.contiguous()
    needs = (True, True, True)
    want = sh.sh_bwd(3, dense, dc, rest, means, campos, needs)
    got = sh.sh_bwd(3, rows[:, 6:9], dc, rest, means, campos, needs)
    for name, a, b in zip(("g_dc", "g_rest", "g_means"), got, want):
        _same_bits(name, a, b)
    ones = torch.ones((), device=dev).expand(SH_N, 3)
    got = sh.sh_bwd(3, ones, dc, rest, means, campos, needs)
    want = sh.sh_bwd(3, ones.contiguous(), dc, rest, means, campos, needs)
    for name, a, b in zip(("g_dc", "g_rest", "g_means"), got, want):
        _same_bits(name, a, b)
    part = sh.sh_bwd(3, dense, dc, rest, means, campos, (False, True, False))
    full = sh.sh_bwd(3, dense, dc, rest, means, campos, needs)
    assert part[0] is None and part[2] is None
    _same_bits("g_rest", part[1], full[1])


def _device_kernels(fn):
    """The names of the device kernels fn() runs (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]


def test_sh_function_launches_once_each_way(dev):
    """Through autograd: the colour is one sh_fwd launch and nothing else
    on the device, its backward one sh_bwd launch and nothing else, and the
    leaves' gradients are the plain twin's bits."""
    dc, rest, means, campos, g = _sh_inputs(dev, 3, 15)
    leaves = [t.detach().clone().requires_grad_() for t in (dc, rest, means)]
    before = dict(ck.launches)
    out, fwd = _device_kernels(lambda: sh.sh_to_rgb(3, *leaves, campos))
    assert ck.launches["sh_fwd"] == before["sh_fwd"] + 2
    assert ck.launches["sh_bwd"] == before["sh_bwd"]
    grads, bwd = _device_kernels(
        lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))
    assert ck.launches["sh_fwd"] == before["sh_fwd"] + 2
    assert ck.launches["sh_bwd"] == before["sh_bwd"] + 2
    assert len(fwd) == 1 and "sh_fwd_kernel" in fwd[0], fwd
    assert len(bwd) == 1 and "sh_bwd_kernel" in bwd[0], bwd
    want, saved = sh._sh_fwd_plain(3, dc, rest, means, campos)
    ref = sh._sh_bwd_plain(3, g, saved, (True, True, True))
    _same_bits("colour", out.detach(), want)
    for name, got, r in zip(("g_dc", "g_rest", "g_means"), grads, ref):
        _same_bits(name, got, r)


@pytest.mark.parametrize("group", ["gaussians", "light"])
def test_adam_step_is_one_launch(dev, group):
    """GroupAdam.step on CUDA tensors runs one device kernel, `adam`'s,
    and nothing else, whatever the number of groups; the step's inputs
    are left as they were."""
    tx = adam_cases.optimizer(group)
    view, grads, state = adam_cases.to(*adam_cases.step_inputs(group, 2),
                                       dev)
    keep = {f: p.clone() for f, p in view.items()}
    tx.step(grads, state, view)
    torch.cuda.synchronize()
    before = ck.launches["adam"]
    # device activity alone, as tests/test_torch_spans.py's sleep test
    # records it: with CPU activity here too, that later session of the
    # same process recorded no device event (PyTorch 2.11 on the H100)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        tx.step(grads, state, view)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert ck.launches["adam"] == before + 1
    assert len(kernels) == 1 and "adam_kernel" in kernels[0], kernels
    assert all(torch.equal(view[f], keep[f]) for f in view)


def test_sh_launches_once_each_way_per_training_step(dev):
    """A phase-1 training step on the card launches sh_fwd once and
    sh_bwd once, step after step."""
    from test_torch_spans import Scene, make_step, port_cfg
    state, step = make_step(Scene(dev), 1, port_cfg(), dev)
    step(state)
    for _ in range(2):
        before = dict(ck.launches)
        step(state)
        torch.cuda.synchronize()
        assert (ck.launches["sh_fwd"] - before["sh_fwd"],
                ck.launches["sh_bwd"] - before["sh_bwd"]) == (1, 1)

