"""The port's compositing backward (the autograd Function of
gi_gs_tpu_torch.ops.rasterize.composite, plain version on the CPU)
against the JAX custom VJP of `composite` (jnp oracle) and of
`composite_pallas` (interpret mode), on the same table, binning and
numpy-seeded cotangents. Tolerance as tests/test_pallas_composite.py:
rtol 2e-4, atol 2e-5 x the largest column maximum (the two sum the same
terms in another order)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gi_gs_tpu.ops.rasterize import RasterConfig as JaxRasterConfig
from gi_gs_tpu.ops.rasterize.binning import bin_and_sort as jax_bin_and_sort
from gi_gs_tpu.ops.rasterize.composite import composite as jax_composite
from gi_gs_tpu.ops.rasterize.pallas_composite import composite_pallas
from gi_gs_tpu.ops.rasterize.preprocess import preprocess as jax_preprocess

from gi_gs_tpu_torch.ops.rasterize import RasterConfig
from gi_gs_tpu_torch.ops.rasterize import composite
from gi_gs_tpu_torch.ops.rasterize.binning import Binning

from utils import random_scene

torch.set_num_threads(1)

SIZES = dict(tile_h=8, tile_w=32, cap_instances=1 << 13, cap_tile=256,
             chunk=8)


def _setup(seed, w=64, h=48, n=200, op_max=0.95, **cfg_kw):
    sizes = dict(SIZES, **cfg_kw)
    jcfg = JaxRasterConfig(**sizes, use_pallas=False, expand_backend="xla")
    s = random_scene(n=n, seed=seed, w=w, h=h, op_max=op_max)
    cam = s["cam"]
    pre = jax_preprocess(s["xyz"], s["cov3d"], cam.w2c, cam.full_proj,
                         cam.tanfovx, cam.tanfovy, w, h, jcfg)
    b = jax_bin_and_sort(pre, h, w, jcfg)
    table = jnp.concatenate([
        pre.means2d, pre.conic, s["opacity"], s["color"], s["normal"],
        s["albedo"], s["roughness"], s["metallic"], pre.depth[:, None],
        pre.pos_view], axis=1)
    grid = jcfg.grid(h, w)
    rng = np.random.RandomState(100 + seed)
    T, P = grid[0] * grid[1], jcfg.pixels_per_tile
    g_acc = rng.normal(size=(T, 16, P)).astype(np.float32)
    g_t = rng.normal(size=(T, P)).astype(np.float32)
    return jcfg, RasterConfig(**sizes), table, b, grid, (h, w), g_acc, g_t


def _jax_grad(comp, jcfg, table, b, grid, hw, g_acc, g_t):
    def loss(t):
        accum, final_t = comp(t, b.ids, b.tile_start, b.tile_count,
                              b.inst_tile, b.inv_perm, b.offsets,
                              b.seg_gaussian, jcfg, grid, hw)
        return (accum * g_acc).sum() + (final_t * g_t).sum()
    return np.asarray(jax.grad(loss)(table))


def _port_grad(cfg, table, b, grid, hw, g_acc, g_t):
    t = lambda a: torch.as_tensor(np.array(a))
    pb = Binning(ids=t(b.ids), inst_tile=t(b.inst_tile),
                 perm=t(b.perm).long(), inv_perm=t(b.inv_perm).long(),
                 tile_start=t(b.tile_start), tile_count=t(b.tile_count),
                 offsets=t(b.offsets), overflow=t(b.overflow),
                 max_tile_count=t(b.max_tile_count))
    tab = t(table).clone().requires_grad_(True)
    accum, final_t = composite.composite(tab, pb, cfg, grid, hw)
    ((accum * t(g_acc)).sum() + (final_t * t(g_t)).sum()).backward()
    return tab.grad.numpy(), accum.detach().numpy(), final_t.detach().numpy()


def _assert_close(got, want):
    scale = np.abs(want).max(axis=0) + 1e-3
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-5 * scale[None, :].max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_backward_matches_jnp_vjp(seed):
    jcfg, cfg, table, b, grid, hw, g_acc, g_t = _setup(seed)
    want = _jax_grad(jax_composite, jcfg, table, b, grid, hw, g_acc, g_t)
    got, _, _ = _port_grad(cfg, table, b, grid, hw, g_acc, g_t)
    assert np.abs(want).max() > 0
    _assert_close(got, want)


def test_backward_matches_pallas_interpret():
    jcfg, cfg, table, b, grid, hw, g_acc, g_t = _setup(1)
    want = _jax_grad(composite_pallas, jcfg, table, b, grid, hw, g_acc, g_t)
    got, _, _ = _port_grad(cfg, table, b, grid, hw, g_acc, g_t)
    _assert_close(got, want)


def test_border_mask_uses_true_image_size():
    """60x45 pads to a 64x48 tile grid: the normal cotangent counts only
    strictly inside the true image; a normal cotangent on its 1-px border
    (or in the padding) moves no gradient."""
    jcfg, cfg, table, b, grid, hw, g_acc, g_t = _setup(3, w=60, h=45)
    want = _jax_grad(jax_composite, jcfg, table, b, grid, hw, g_acc, g_t)
    got, _, _ = _port_grad(cfg, table, b, grid, hw, g_acc, g_t)
    _assert_close(got, want)
    # only normal cotangents, and only on the border and padding
    px, py = composite._tile_pixel_coords(grid, cfg, torch.device("cpu"))
    inside = composite._border_mask(px, py, hw).numpy()
    g_border = np.zeros_like(g_acc)
    g_border[:, 4:7] = g_acc[:, 4:7] * (1.0 - inside)[:, None, :]
    got, _, _ = _port_grad(cfg, table, b, grid, hw, g_border,
                           np.zeros_like(g_t))
    assert np.abs(got).max() == 0.0


def test_cap_tile_truncation():
    """cap_tile 16 drops the most occluded instances of crowded tiles:
    they get no gradient, as in JAX."""
    jcfg, cfg, table, b, grid, hw, g_acc, g_t = _setup(4, n=400,
                                                       cap_tile=16)
    assert int(b.max_tile_count) > 16
    want = _jax_grad(jax_composite, jcfg, table, b, grid, hw, g_acc, g_t)
    got, _, _ = _port_grad(cfg, table, b, grid, hw, g_acc, g_t)
    _assert_close(got, want)


def test_early_termination():
    """Opaque layers saturate pixels (T < 1e-4 ends them): the done flag
    and the instances behind it are replayed as in JAX."""
    jcfg, cfg, table, b, grid, hw, g_acc, g_t = _setup(5, n=600,
                                                       op_max=0.999)
    table = table.at[:, 5].set(jnp.maximum(table[:, 5], 0.97))
    want = _jax_grad(jax_composite, jcfg, table, b, grid, hw, g_acc, g_t)
    got, accum, final_t = _port_grad(cfg, table, b, grid, hw, g_acc, g_t)
    assert (accum[:, 3] > 0.999).sum() > 50      # saturated pixels
    _assert_close(got, want)


def test_reduction_matches_jax():
    from gi_gs_tpu.ops.rasterize.composite import (
        reduce_sorted_instance_grads as jax_reduce)
    jcfg, cfg, table, b, grid, hw, g_acc, g_t = _setup(0)
    rows = np.random.RandomState(9).normal(
        size=(b.ids.shape[0], 21)).astype(np.float32)
    want = np.asarray(jax_reduce(jnp.asarray(rows), b.inv_perm, b.offsets,
                                 None))
    got = composite.reduce_sorted_instance_grads(
        torch.as_tensor(rows), torch.as_tensor(np.asarray(b.inv_perm)).long(),
        torch.as_tensor(np.asarray(b.offsets)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
