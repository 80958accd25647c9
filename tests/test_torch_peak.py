"""The port's argmax-depth ("peak") path against the JAX reference on the
CPU: `rasterize(argmax_depth=True)` against JAX's jnp oracle and its
Pallas kernel (`composite_fwd_pallas(peak=True)`, interpret mode), a
constructed exact tie, `rasterize_lite`, `mark_visible`, and
`renderer.render(argmax_depth=True)`. On the CPU the port runs the plain
version of the kernel `composite_fwd_peak` (`_composite_fwd_plain` with
`peak=True`)."""
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gi_gs_tpu.models.gaussians import GaussianParams as JaxParams
from gi_gs_tpu.ops.rasterize import RasterConfig as JaxRasterConfig
from gi_gs_tpu.ops.rasterize import pipeline as jax_pipeline
from gi_gs_tpu.ops.rasterize.pallas_composite import (PEAK_ROWS, ROW,
                                                      composite_fwd_pallas)
from gi_gs_tpu.renderer import render as jax_render
from gi_gs_tpu.scene.cameras import make_camera as jax_make_camera

from gi_gs_tpu_torch.models.gaussians import params_from_numpy
from gi_gs_tpu_torch.ops.rasterize import RasterConfig, composite, pipeline
from gi_gs_tpu_torch.renderer import render
from gi_gs_tpu_torch.scene.cameras import make_camera

from test_torch_kernels_cuda import tie_table
from test_torch_render import gaussian_fields
from utils import random_scene

torch.set_num_threads(1)

SIZES = dict(tile_h=8, tile_w=32, cap_instances=1 << 13, cap_tile=256,
             chunk=8)
CFG = RasterConfig(**SIZES)


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax(scene, use_pallas, argmax=True):
    cam = scene["cam"]
    return jax_pipeline.rasterize(
        scene["xyz"], scene["cov3d"], scene["opacity"], scene["color"],
        scene["normal"], scene["albedo"], scene["roughness"],
        scene["metallic"], cam.w2c, cam.full_proj, cam.tanfovx, cam.tanfovy,
        scene["height"], scene["width"], jnp.zeros(3),
        JaxRasterConfig(**SIZES, use_pallas=use_pallas, expand_backend="xla"),
        argmax_depth=argmax)


def _port(scene, argmax=True, **kw):
    cam = scene["cam"]
    return pipeline.rasterize(
        *(_t(scene[k]) for k in ("xyz", "cov3d", "opacity", "color",
                                 "normal", "albedo", "roughness",
                                 "metallic")),
        _t(cam.w2c), _t(cam.full_proj), float(cam.tanfovx),
        float(cam.tanfovy), scene["height"], scene["width"], torch.zeros(3),
        CFG, argmax_depth=argmax, **kw)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["jnp_oracle", "pallas_interpret"])
@pytest.mark.parametrize("seed", [2, 5])
def test_rasterize_argmax_depth_matches_jax(seed, use_pallas):
    """Depth/pos atol 1e-5 (the same peak instance; its depth and pos are
    copied, not summed), colour and the other channels atol 1e-4 (sums in
    another order)."""
    scene = random_scene(n=120, seed=seed)
    want = _jax(scene, use_pallas)
    got = _port(scene)
    covered = np.asarray(want.opacity[0]) > 1e-6
    assert covered.sum() > 200
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.pos_view.numpy(),
                               np.asarray(want.pos_view), atol=1e-5, rtol=0)
    for key in ("color", "opacity", "normal", "albedo", "roughness",
                "metallic", "final_t", "normal_view"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(want, key)),
                                   atol=1e-4, rtol=0, err_msg=key)
    # the peak is one instance's depth, not a weighted mean
    mean = _port(scene, argmax=False)
    assert not np.allclose(got.depth.numpy(), mean.depth.numpy(), atol=1e-3)


def test_argmax_depth_path_is_detached_and_plain_matches_oracle():
    """With argmax_depth no output carries a gradient (JAX's Pallas
    branch), and the one compositing call's peak rows equal the port's
    oracle `compute_peak_depth_pos` on the same binning."""
    scene = random_scene(n=100, seed=7)
    leaves = {k: _t(scene[k]).requires_grad_(True)
              for k in ("opacity", "color", "normal")}
    cam = scene["cam"]
    h, w = scene["height"], scene["width"]
    args = (_t(scene["xyz"]), _t(scene["cov3d"]), leaves["opacity"],
            leaves["color"], leaves["normal"], _t(scene["albedo"]),
            _t(scene["roughness"]), _t(scene["metallic"]), _t(cam.w2c),
            _t(cam.full_proj), float(cam.tanfovx), float(cam.tanfovy), h, w,
            torch.zeros(3), CFG)
    out = pipeline.rasterize(*args, argmax_depth=True)
    assert not any(t.requires_grad for t in (out.color, out.depth,
                                             out.opacity, out.normal))
    assert pipeline.rasterize(*args).color.requires_grad

    pre = pipeline.preprocess(args[0], args[1], args[8], args[9], args[10],
                              args[11], w, h, CFG, opacity=args[2])
    b = pipeline.bin_and_sort(pre, h, w, CFG)
    table = composite.composite_table(pre, *args[2:8])
    depth, pos = pipeline.compute_peak_depth_pos(table, b, CFG,
                                                 CFG.grid(h, w), h, w)
    o = out.opacity > 1e-6
    assert torch.equal(torch.where(o, depth, torch.zeros(())), out.depth)
    assert torch.equal(torch.where(o, pos, torch.zeros(())), out.pos_view)


@pytest.mark.parametrize("gap", [0, 7], ids=["same_chunk", "next_chunk"])
def test_exact_tie_first_wins_like_jax(gap):
    table = tie_table(gap)
    n = table.shape[0]
    cap = 16
    ids = np.zeros(cap, np.int32)
    ids[:n] = np.arange(n)
    ts, tc = np.zeros(1, np.int32), np.array([n], np.int32)
    grid = (1, 1)
    acc, ft, pk = composite.composite_fwd(_t(table), _t(ids), _t(ts), _t(tc),
                                          CFG, grid, peak=True)
    pk = pk.numpy()
    centre = 3 * 32 + 5
    np.testing.assert_array_equal(pk[0, :, centre], table[0, 17:21])
    # JAX: the jnp oracle and the Pallas kernel in interpret mode
    jcfg = JaxRasterConfig(**SIZES, use_pallas=True)
    b = types.SimpleNamespace(ids=jnp.asarray(ids), tile_start=jnp.asarray(ts),
                              tile_count=jnp.asarray(tc))
    jd, jp = jax_pipeline.compute_peak_depth_pos(jnp.asarray(table), b, jcfg,
                                                 grid, 8, 32)
    inst = jnp.pad(jnp.asarray(table)[b.ids], ((0, 0), (0, ROW - 21)))
    packed = np.asarray(composite_fwd_pallas(inst, b.tile_start, b.tile_count,
                                             jcfg, grid, interpret=True,
                                             peak=True))
    oracle = np.concatenate([np.asarray(jd), np.asarray(jp)]).reshape(4, -1)
    np.testing.assert_array_equal(pk[0], oracle)
    np.testing.assert_array_equal(pk[0], packed[0, PEAK_ROWS])
    np.testing.assert_allclose(acc.numpy()[0], packed[0, :16], atol=1e-6)
    np.testing.assert_allclose(ft.numpy()[0], packed[0, 16], atol=1e-6)


@pytest.mark.parametrize("argmax", [False, True])
def test_rasterize_lite_matches_jax(argmax):
    scene = random_scene(n=100, seed=4)
    cam, h, w = scene["cam"], scene["height"], scene["width"]
    want = jax_pipeline.rasterize_lite(
        scene["xyz"], scene["cov3d"], scene["opacity"], scene["color"],
        cam.w2c, cam.full_proj, cam.tanfovx, cam.tanfovy, h, w, jnp.zeros(3),
        JaxRasterConfig(**SIZES, use_pallas=False, expand_backend="xla"),
        argmax_depth=argmax)
    got = pipeline.rasterize_lite(
        _t(scene["xyz"]), _t(scene["cov3d"]), _t(scene["opacity"]),
        _t(scene["color"]), _t(cam.w2c), _t(cam.full_proj),
        float(cam.tanfovx), float(cam.tanfovy), h, w, torch.zeros(3), CFG,
        argmax_depth=argmax)
    for a, b, name in zip(got, want, ("color", "opacity", "depth", "final_t")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_mark_visible_matches_jax():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-2, 2, (200, 3)).astype(np.float32)
    pts[:3] = [[0, 0, 1.0], [0, 0, -1.0], [0, 0, 0.1]]
    R = np.array([[0.0, 0, 1], [0, 1, 0], [-1, 0, 0]])
    for rot, T in ((np.eye(3), np.zeros(3)), (R, np.array([0.1, 0, 0.5]))):
        cam = jax_make_camera(rot, T, 1.0, 1.0, 32, 32)
        want = np.asarray(jax_pipeline.mark_visible(jnp.asarray(pts), cam.w2c))
        got = pipeline.mark_visible(_t(pts), _t(cam.w2c)).numpy()
        np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def test_render_argmax_depth_matches_jax():
    """The whole renderer with argmax_depth at 64x48, against JAX's on its
    Pallas path (interpret mode): the depth-derived maps read the peak
    depth. Tolerance 1e-4 as tests/test_torch_render.py (1e-5 for the
    depth itself)."""
    fields = gaussian_fields(n=1500, cap=2048, seed=9)
    R, T = np.eye(3), np.array([0.0, 0.0, 3.0])
    jcfg = JaxRasterConfig(cap_instances=1 << 15, use_pallas=True,
                           expand_backend="xla")
    jparams = JaxParams(**{k: jnp.asarray(v) for k, v in fields.items()},
                        active_sh_degree=3, max_sh_degree=3)
    want = jax_render(jax_make_camera(R, T, 0.9, 0.7, 64, 48), jparams,
                      jnp.zeros(3), jcfg, inference=True, pad_normal=True,
                      compute_occlusion=False, argmax_depth=True)
    got = render(make_camera(R, T, 0.9, 0.7, 64, 48, device="cpu"),
                 params_from_numpy(fields, 3, 3, device="cpu"),
                 torch.zeros(3), RasterConfig(cap_instances=1 << 15),
                 inference=True, pad_normal=True, compute_occlusion=False,
                 argmax_depth=True)
    for key in ("render", "depth_map", "normal_map_from_depth", "depth_pos",
                "normal_map", "albedo_map", "roughness_map", "opacity_map"):
        a, b = got[key].numpy(), np.asarray(want[key])
        tol = 1e-5 if key == "depth_map" else 1e-4
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=key)
    assert (got["depth_map"].numpy() > 0).mean() > 0.2
