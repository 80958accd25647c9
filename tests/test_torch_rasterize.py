"""The port's rasterizer (gi_gs_tpu_torch.ops.rasterize) against the JAX
reference on the same numpy-seeded scenes, on the CPU: the plain PyTorch
versions of the expand and composite kernels are what CUDA tensors would
send to csrc/expand.cu and csrc/composite_fwd.cu."""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gi_gs_tpu.ops.rasterize import RasterConfig as JaxRasterConfig
from gi_gs_tpu.ops.rasterize.binning import _expand_xla
from gi_gs_tpu.ops.rasterize.binning import bin_and_sort as jax_bin_and_sort
from gi_gs_tpu.ops.rasterize.composite import _fwd_impl
from gi_gs_tpu.ops.rasterize.pallas_composite import ROW, composite_fwd_pallas
from gi_gs_tpu.ops.rasterize.preprocess import PreFlat as JaxPreFlat
from gi_gs_tpu.ops.rasterize.preprocess import \
    Preprocessed as JaxPreprocessed
from gi_gs_tpu.ops.rasterize.preprocess import preprocess as jax_preprocess

from gi_gs_tpu_torch import config as cfg_mod
from gi_gs_tpu_torch.models.gaussians import create_from_points
from gi_gs_tpu_torch.ops.rasterize import RasterConfig
from gi_gs_tpu_torch.ops.rasterize import binning, composite, pipeline
from gi_gs_tpu_torch.ops.rasterize.preprocess import (PreFlat,
                                                      Preprocessed,
                                                      preprocess)
from gi_gs_tpu_torch.scene.cameras import make_camera
from gi_gs_tpu_torch.train import trainer

import bench_scene
import expand_cases
from utils import random_scene

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
SIZES = dict(tile_h=8, tile_w=32, cap_instances=1 << 14, cap_tile=512,
             chunk=8)
JCFG = JaxRasterConfig(**SIZES, use_pallas=False, expand_backend="xla")
CFG = RasterConfig(**SIZES)


def _t(a):
    return torch.as_tensor(np.array(a))


def _both(seed, n=300):
    """The same scene preprocessed by JAX and by the port."""
    s = random_scene(n=n, seed=seed)
    cam, w, h = s["cam"], s["width"], s["height"]
    jp = jax_preprocess(s["xyz"], s["cov3d"], cam.w2c, cam.full_proj,
                        cam.tanfovx, cam.tanfovy, w, h, JCFG,
                        opacity=s["opacity"])
    tp = preprocess(_t(s["xyz"]), _t(s["cov3d"]), _t(cam.w2c),
                    _t(cam.full_proj), float(cam.tanfovx),
                    float(cam.tanfovy), w, h, CFG, opacity=_t(s["opacity"]))
    return s, jp, tp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preprocess_matches_jax(seed):
    _, jp, tp = _both(seed)
    np.testing.assert_array_equal(tp.radius.numpy(), np.asarray(jp.radius))
    np.testing.assert_array_equal(tp.tiles_touched.numpy(),
                                  np.asarray(jp.tiles_touched))
    np.testing.assert_allclose(tp.means2d.numpy(), np.asarray(jp.means2d),
                               rtol=1e-5)
    np.testing.assert_allclose(tp.conic.numpy(), np.asarray(jp.conic),
                               rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expand_plain_matches_xla(seed):
    s, jp, tp = _both(seed)
    h, w = s["height"], s["width"]
    j_tile, j_depth, j_gid, j_off, j_total = _expand_xla(jp, h, w, JCFG)
    t_tile, t_depth, t_gid, t_off, t_total = binning._expand_plain(
        tp, h, w, CFG)
    assert int(t_total) == int(j_total)
    np.testing.assert_array_equal(t_off.numpy(), np.asarray(j_off))
    np.testing.assert_array_equal(t_tile.numpy(), np.asarray(j_tile))
    np.testing.assert_array_equal(t_gid.numpy(), np.asarray(j_gid))
    np.testing.assert_array_equal(t_depth.numpy(), np.asarray(j_depth))


@pytest.mark.parametrize("case", expand_cases.CASES)
def test_expand_plain_matches_xla_at_block_edges(case):
    """The cases that probe the expand kernel's 256-slot block windows
    (tests/expand_cases.py): the plain expansion against JAX's oracle,
    every output equal."""
    cols, cap = expand_cases.expand_case(case)
    jp = expand_cases.preprocessed(cols, JaxPreprocessed, JaxPreFlat,
                                   jnp.asarray)
    tp = expand_cases.preprocessed(cols, Preprocessed, PreFlat,
                                   torch.as_tensor)
    sizes = dict(SIZES, cap_instances=cap, tile_h=expand_cases.TILE_H,
                 tile_w=expand_cases.TILE_W)
    jcfg = JaxRasterConfig(**sizes, use_pallas=False, expand_backend="xla")
    h, w = expand_cases.HEIGHT, expand_cases.WIDTH
    j_tile, j_depth, j_gid, j_off, j_total = _expand_xla(jp, h, w, jcfg)
    t_tile, t_depth, t_gid, t_off, t_total = binning._expand_plain(
        tp, h, w, RasterConfig(**sizes))
    assert int(t_total) == int(j_total)
    np.testing.assert_array_equal(t_off.numpy(), np.asarray(j_off))
    np.testing.assert_array_equal(t_tile.numpy(), np.asarray(j_tile))
    np.testing.assert_array_equal(t_gid.numpy(), np.asarray(j_gid))
    np.testing.assert_array_equal(t_depth.numpy(), np.asarray(j_depth))
    kept = t_tile < 64 * 64
    in_range = torch.arange(cap) < int(t_total)
    # the case reaches what it names: kept and culled instances (only
    # dummies at count 0), and a tail past the total or a total at / past
    # the capacity
    if case == "all_count_zero":
        assert not kept.any()
    else:
        assert 0 < int(kept.sum()) < int(in_range.sum())
    if case == "total_is_cap":
        assert int(t_total) == cap
    elif case == "total_past_cap":
        assert int(t_total) > cap
    else:
        assert int(t_total) < cap
    if case == "one_spans_many_blocks":
        assert int((t_gid == 7).sum()) == 3000


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bin_and_sort_matches_jax(seed):
    s, jp, tp = _both(seed)
    h, w = s["height"], s["width"]
    jb = jax_bin_and_sort(jp, h, w, JCFG)
    tb = binning.bin_and_sort(tp, h, w, CFG)
    np.testing.assert_array_equal(tb.ids.numpy(), np.asarray(jb.ids))
    np.testing.assert_array_equal(tb.inst_tile.numpy(),
                                  np.asarray(jb.inst_tile))
    np.testing.assert_array_equal(tb.tile_start.numpy(),
                                  np.asarray(jb.tile_start))
    np.testing.assert_array_equal(tb.tile_count.numpy(),
                                  np.asarray(jb.tile_count))
    assert int(tb.overflow) == int(jb.overflow)
    assert int(tb.max_tile_count) == int(jb.max_tile_count)


def test_sort_key_orders_like_two_key_sort():
    """ordered_bits keeps f32 order across signs, zeros and infinities."""
    depth = torch.tensor([3.0, -1.0, 0.0, -0.0, float("inf"), -2.5, 1e-30,
                          -1e-30, 7.0, 3.0], dtype=torch.float32)
    tile = torch.tensor([1, 1, 1, 1, 1, 0, 0, 0, 2, 1], dtype=torch.int32)
    _, perm = torch.sort(binning.sort_key(tile, depth), stable=True)
    d = depth.tolist()
    order = sorted(range(10), key=lambda i: (int(tile[i]), d[i],
                                             math.copysign(1.0, d[i]), i))
    assert perm.tolist() == order


def _tables(seed=0):
    s, jp, tp = _both(seed, n=200)
    h, w = s["height"], s["width"]
    jb = jax_bin_and_sort(jp, h, w, JCFG)
    tb = binning.bin_and_sort(tp, h, w, CFG)
    jt = jnp.concatenate([
        jp.means2d, jp.conic, s["opacity"], s["color"], s["normal"],
        s["albedo"], s["roughness"], s["metallic"], jp.depth[:, None],
        jp.pos_view], axis=1)
    return (h, w), jt, jb, tb


def test_composite_plain_matches_pallas_and_jnp():
    (h, w), jt, jb, tb = _tables()
    grid = CFG.grid(h, w)
    acc, final_t = composite._composite_fwd_plain(
        _t(jt), tb.ids, tb.tile_start, tb.tile_count, CFG, grid)
    # the jnp oracle
    j_acc, j_t = _fwd_impl(jt, jb.ids, jb.tile_start, jb.tile_count, JCFG,
                           grid)
    np.testing.assert_allclose(acc.numpy(), np.asarray(j_acc),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(final_t.numpy(), np.asarray(j_t),
                               rtol=1e-5, atol=1e-6)
    # the Pallas kernel in interpret mode
    inst = jnp.pad(jt[jb.ids], ((0, 0), (0, ROW - jt.shape[1])))
    packed = np.asarray(composite_fwd_pallas(
        inst, jb.tile_start, jb.tile_count, JCFG, grid, interpret=True))
    np.testing.assert_allclose(acc.numpy(), packed[:, :16],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(final_t.numpy(), packed[:, 16],
                               rtol=1e-5, atol=1e-6)
    # the CPU wrapper takes the plain version
    acc2, _ = composite.composite_fwd(_t(jt), tb.ids, tb.tile_start,
                                      tb.tile_count, CFG, grid)
    assert torch.equal(acc2, acc)


def test_rasterize_matches_golden():
    """Frozen brute-force accumulators (tests/fixtures, tools/make_goldens.py)
    against the port's tiled path: all 16 channels, and the rasterize()
    colour/opacity images."""
    g = np.load(os.path.join(FIX, "golden_rasterize.npz"))
    s = random_scene(n=300, seed=0)
    cam, w, h = s["cam"], s["width"], s["height"]
    tp = preprocess(_t(s["xyz"]), _t(s["cov3d"]), _t(cam.w2c),
                    _t(cam.full_proj), float(cam.tanfovx),
                    float(cam.tanfovy), w, h, CFG, opacity=_t(s["opacity"]))
    tb = binning.bin_and_sort(tp, h, w, CFG)
    feats = [_t(s[k]) for k in ("color",)] + [torch.ones(300, 1)] + \
        [_t(s[k]) for k in ("normal", "albedo", "roughness", "metallic")]
    table = torch.cat([tp.means2d, tp.conic, _t(s["opacity"]), feats[0]] +
                      feats[2:] + [tp.depth[:, None], tp.pos_view], dim=1)
    grid = CFG.grid(h, w)
    acc, _ = composite.composite_fwd(table, tb.ids, tb.tile_start,
                                     tb.tile_count, CFG, grid)
    img = pipeline._tiles_to_image(acc, grid, CFG, h, w).numpy()
    # the table's "ones" channel is the opacity accumulator; the golden's
    # channel 3 integrates a ones feature — both are sum(w)
    np.testing.assert_allclose(img, g["accum"], atol=1e-5)

    out = pipeline.rasterize(
        _t(s["xyz"]), _t(s["cov3d"]), _t(s["opacity"]), _t(s["color"]),
        _t(s["normal"]), _t(s["albedo"]), _t(s["roughness"]),
        _t(s["metallic"]), _t(cam.w2c), _t(cam.full_proj),
        float(cam.tanfovx), float(cam.tanfovy), h, w, torch.zeros(3), CFG)
    np.testing.assert_allclose(out.color.numpy(), g["accum"][0:3], atol=1e-5)
    np.testing.assert_allclose(out.opacity.numpy(), g["accum"][3:4],
                               atol=1e-5)


@pytest.mark.parametrize("scene", ["random", "root_bench"])
def test_capacity_bucket_and_count(scene):
    """The port's instance count against JAX's. On the root bench's scene
    (tests/bench_scene.py, default 16x64 tiles) also the capacity bucket
    the port probes on its own init of the same points, and the binned
    count after expand's exact f32 cull, against JAX's XLA expand (its
    Pallas expand slacks the cull for bf16 inputs and keeps more)."""
    from gi_gs_tpu.ops.rasterize.pipeline import (
        bucket_cap_instances as jax_bucket, count_instances as jax_count)
    if scene == "random":
        s, _, _ = _both(0)
        xyz, cov3d, opacity = s["xyz"], s["cov3d"], s["opacity"]
        cam, w, h = s["cam"], s["width"], s["height"]
        jcfg, cfg = JCFG, CFG
    else:
        jcfg, jparams, cam = bench_scene.jax_scene()[:3]
        xyz, cov3d = jparams.xyz, jparams.get_covariance(1.0)
        opacity = jparams.get_opacity()
        w, h = cam.width, cam.height
        jcfg = dataclasses.replace(jcfg.raster, use_pallas=False,
                                   expand_backend="xla")
        cfg = RasterConfig(cap_instances=jcfg.cap_instances)
    targs = (_t(xyz), _t(cov3d), _t(cam.w2c), _t(cam.full_proj),
             float(cam.tanfovx), float(cam.tanfovy))
    n_j = int(jax_count(xyz, cov3d, cam.w2c, cam.full_proj, cam.tanfovx,
                        cam.tanfovy, h, w, jcfg, opacity=opacity))
    n_t = pipeline.count_instances(*targs, h, w, cfg, opacity=_t(opacity))
    assert n_t == n_j
    if scene == "root_bench":
        pts, cols = bench_scene.points()
        params = create_from_points(pts, cols, bench_scene.SIZE["CAP"],
                                    device="cpu")
        pcam = make_camera(np.eye(3), np.zeros(3), 0.8, 0.8, w, h,
                           device="cpu")
        assert trainer.probe_cap_instances(cfg_mod.Config(), params, [pcam]) == \
            cfg.cap_instances
        jb = jax_bin_and_sort(jax_preprocess(
            xyz, cov3d, cam.w2c, cam.full_proj, cam.tanfovx, cam.tanfovy, w,
            h, jcfg, opacity=opacity), h, w, jcfg)
        tb = binning.bin_and_sort(preprocess(*targs, w, h, cfg,
                                             opacity=_t(opacity)), h, w, cfg)
        n_binned = int(tb.tile_count.sum())
        assert n_binned == int(np.asarray(jb.tile_count).sum()) > 0
        assert not int(tb.overflow)
    for k in (1, 65535, 65536, 525861, 3_000_000):
        assert pipeline.bucket_cap_instances(k) == jax_bucket(k)
