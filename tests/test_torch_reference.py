"""The port's brute-force rasterizer oracle
(gi_gs_tpu_torch.ops.rasterize.reference) against JAX's
`rasterize_bruteforce` and the frozen golden on the CPU, and the port's
tiled rasterizer against the port's oracle (as tests/test_rasterize.py
holds JAX's tiled path against JAX's oracle)."""
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gi_gs_tpu.ops.rasterize import RasterConfig as JaxRasterConfig
from gi_gs_tpu.ops.rasterize.preprocess import preprocess as jax_preprocess
from gi_gs_tpu.ops.rasterize.reference import \
    rasterize_bruteforce as jax_bruteforce

from gi_gs_tpu_torch.ops.rasterize import RasterConfig
from gi_gs_tpu_torch.ops.rasterize.pipeline import rasterize
from gi_gs_tpu_torch.ops.rasterize.preprocess import preprocess
from gi_gs_tpu_torch.ops.rasterize.reference import rasterize_bruteforce

from utils import random_scene

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
GOLDEN_SIZES = dict(tile_h=8, tile_w=32, cap_instances=1 << 14,
                    cap_tile=512, chunk=8)

# (seed, n, width, height, tile_h, tile_w)
CASES = [(0, 300, 64, 48, 8, 32), (1, 200, 64, 48, 16, 64),
         (2, 150, 40, 24, 8, 16), (3, 250, 96, 40, 16, 32)]


def _t(a):
    return torch.as_tensor(np.array(a))


def _cfgs(tile_h, tile_w):
    sizes = dict(GOLDEN_SIZES, tile_h=tile_h, tile_w=tile_w)
    return (JaxRasterConfig(**sizes, use_pallas=False, expand_backend="xla"),
            RasterConfig(**sizes))


def _jax_oracle(s, jcfg):
    """JAX's oracle on scene `s` with tests/test_rasterize.py's [N, 16]
    features (the G-buffer channels, view depth and position)."""
    cam, w, h = s["cam"], s["width"], s["height"]
    pre = jax_preprocess(s["xyz"], s["cov3d"], cam.w2c, cam.full_proj,
                         cam.tanfovx, cam.tanfovy, w, h, jcfg)
    feats = jnp.concatenate([
        s["color"], jnp.ones_like(s["roughness"]), s["normal"], s["albedo"],
        s["roughness"], s["metallic"], pre.depth[:, None], pre.pos_view],
        axis=1)
    acc, final_t = jax_bruteforce(s["xyz"], s["cov3d"], s["opacity"], feats,
                                  cam.w2c, cam.full_proj, cam.tanfovx,
                                  cam.tanfovy, h, w, jcfg)
    return np.asarray(feats), np.asarray(acc), np.asarray(final_t)


def _port_oracle(s, feats, cfg, opacity=None):
    cam = s["cam"]
    op = _t(s["opacity"]) if opacity is None else opacity
    return rasterize_bruteforce(
        _t(s["xyz"]), _t(s["cov3d"]), op, feats, _t(cam.w2c),
        _t(cam.full_proj), float(cam.tanfovx), float(cam.tanfovy),
        s["height"], s["width"], cfg)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_oracle_matches_jax(case):
    seed, n, w, h, th, tw = case
    jcfg, cfg = _cfgs(th, tw)
    s = random_scene(n=n, seed=seed, w=w, h=h)
    feats, j_acc, j_t = _jax_oracle(s, jcfg)
    acc, final_t = _port_oracle(s, _t(feats), cfg)
    assert acc.shape == (16, h, w) and final_t.shape == (h, w)
    np.testing.assert_allclose(acc.numpy(), j_acc, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(final_t.numpy(), j_t, rtol=1e-5, atol=1e-6)
    # the scene is neither empty nor saturated everywhere
    assert 0.0 < float(final_t.min()) < 0.5 < float(final_t.max())


def test_oracle_matches_golden():
    """tests/test_goldens.py's check of JAX's oracle, on the port's: the
    accumulators and the gradients of (acc^2).sum() + (final_T^2).sum()
    with respect to opacity and features, at the same tolerances."""
    g = np.load(os.path.join(FIX, "golden_rasterize.npz"))
    jcfg, cfg = _cfgs(8, 32)
    s = random_scene(n=300, seed=0)
    feats, _, _ = _jax_oracle(s, jcfg)
    op = _t(s["opacity"]).requires_grad_(True)
    ft = _t(feats).requires_grad_(True)
    acc, final_t = _port_oracle(s, ft, cfg, opacity=op)
    loss = (acc ** 2).sum() + (final_t ** 2).sum()
    d_op, d_feats = torch.autograd.grad(loss, [op, ft])
    np.testing.assert_allclose(acc.detach().numpy(), g["accum"], atol=1e-5)
    np.testing.assert_allclose(final_t.detach().numpy(), g["final_t"],
                               atol=1e-5)
    np.testing.assert_allclose(d_op.numpy(), g["d_opacity"], atol=2e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(d_feats.numpy(), g["d_features"], atol=2e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_tiled_render_matches_port_oracle(case):
    """The port's tiled rasterizer (plain expand and composite on the CPU)
    against its oracle, at tests/test_rasterize.py's tolerances (rtol
    1e-4, atol 1e-5)."""
    seed, n, w, h, th, tw = case
    _, cfg = _cfgs(th, tw)
    s = random_scene(n=n, seed=seed, w=w, h=h)
    cam = s["cam"]
    T = {k: _t(s[k]) for k in ("xyz", "cov3d", "opacity", "color", "normal",
                              "albedo", "roughness", "metallic")}
    out = rasterize(T["xyz"], T["cov3d"], T["opacity"], T["color"],
                    T["normal"], T["albedo"], T["roughness"], T["metallic"],
                    _t(cam.w2c), _t(cam.full_proj), float(cam.tanfovx),
                    float(cam.tanfovy), h, w, torch.zeros(3), cfg)
    pre = preprocess(T["xyz"], T["cov3d"], _t(cam.w2c), _t(cam.full_proj),
                     float(cam.tanfovx), float(cam.tanfovy), w, h, cfg)
    feats = torch.cat([T["color"], torch.ones_like(T["roughness"]),
                       T["normal"], T["albedo"], T["roughness"],
                       T["metallic"], pre.depth[:, None], pre.pos_view], 1)
    acc, final_t = (x.numpy() for x in _port_oracle(s, feats, cfg))
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.final_t[0].numpy(), final_t, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out.color.numpy(), acc[0:3], **tol)
    np.testing.assert_allclose(out.opacity[0].numpy(), acc[3], **tol)
    np.testing.assert_allclose(out.normal.numpy(), acc[4:7], **tol)
    np.testing.assert_allclose(out.albedo.numpy(), acc[7:10], **tol)
    np.testing.assert_allclose(out.roughness[0].numpy(), acc[10], **tol)
    np.testing.assert_allclose(out.metallic[0].numpy(), acc[11], **tol)
    o = acc[3]
    d = np.where(o > 1e-6, acc[12] / np.where(o > 1e-6, o, 1), 0)
    np.testing.assert_allclose(out.depth[0].numpy(), d, **tol)
