"""Tile-sharded compositing and training of the port against its
single-device path and against gi_gs_tpu on the CPU.

* The plain `composite_fwd` / `composite_bwd` over 2, 3 and 8 contiguous
  tile ranges (`tile_base`; 10 tiles, so 3 and 8 pad with empty tiles)
  against the whole-image call: the forward bit-equal, the backward rows
  summed over the ranges bit-equal (each instance row belongs to one
  tile).
* One range against JAX's jnp `composite` with the same `tile_base`.
* At 2 gloo ranks (tests/torch_dist_workers.py), `sharded_composite` and
  its summed table gradient against JAX's `sharded_composite` on a
  2-device mesh (15 tiles: one padding tile; tolerances of
  tests/test_tile_sharded.py), and
  `make_ts_phase1_step` for 3 steps (densify at iteration 2, the default
  2e-4 threshold) against the port's `make_phase1_step`; the two ranks'
  states bit-equal.
* JAX's tile-sharded step scales the gradient by its shard count (its
  all_gather's transpose sums the replicated cotangents before the
  psum): pinned here, and the port's step keeps the single-device
  statistics.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from gi_gs_tpu.config import (Config as JaxConfig, ModelConfig as JaxModel,
                              OptimizationConfig as JaxOpt,
                              TrainConfig as JaxTrain)
from gi_gs_tpu.models.gaussians import create_from_points as jax_create
from gi_gs_tpu.ops.rasterize import RasterConfig as JaxRasterConfig
from gi_gs_tpu.ops.rasterize.composite import composite as jax_composite
from gi_gs_tpu.parallel.tile_sharded import (
    make_ts_phase1_step as jax_ts_step,
    sharded_composite as jax_sharded_composite)
from gi_gs_tpu.scene.cameras import make_camera as jax_make_camera
from gi_gs_tpu.train import trainer as jtrainer
from gi_gs_tpu.train.optim import build_optimizer as jax_build_optimizer

from gi_gs_tpu_torch.models.gaussians import FIELDS
from gi_gs_tpu_torch.ops.rasterize import composite

import torch_dist_workers as workers
from test_torch_composite_bwd import _setup

torch.set_num_threads(1)


def _b(b) -> dict:
    return {k: np.asarray(getattr(b, k)) for k in
            ("ids", "inst_tile", "perm", "inv_perm", "tile_start",
             "tile_count", "offsets", "overflow", "max_tile_count")}


def _ranges(T, n):
    """(tile_base, t_local) of n contiguous ranges over T tiles padded to
    a multiple of n (the rule of pipeline._composite_local_tiles)."""
    t_local = -(-T // n)
    return [(r * t_local, t_local) for r in range(n)], n * t_local - T


@pytest.fixture(scope="module")
def scene():
    """64x40 at tile 8x32: a 5 x 2 grid of 10 tiles."""
    jcfg, cfg, table, b, grid, hw, g_acc, g_t = _setup(4, w=64, h=40)
    return dict(jcfg=jcfg, cfg=cfg, table=np.array(table), b=b, grid=grid,
                hw=hw, g_acc=g_acc, g_t=g_t)


@pytest.mark.parametrize("n_ranges", [2, 3, 8])
def test_plain_tile_ranges_equal_whole_image(scene, n_ranges):
    cfg, grid, hw = scene["cfg"], scene["grid"], scene["hw"]
    t = lambda a: torch.as_tensor(np.array(a))
    table, ids = t(scene["table"]), t(scene["b"].ids)
    ts, tc = t(scene["b"].tile_start), t(scene["b"].tile_count)
    g_acc, g_t = t(scene["g_acc"]), t(scene["g_t"])
    T = grid[0] * grid[1]
    accum, final_t = composite.composite_fwd(table, ids, ts, tc, cfg, grid)
    rows = composite.composite_bwd(table, ids, ts, tc, accum[:, :4], final_t,
                                   g_acc, g_t, cfg, grid, hw)
    assert float(rows.abs().max()) > 0
    ranges, pad = _ranges(T, n_ranges)
    assert pad == {2: 0, 3: 2, 8: 6}[n_ranges]
    z = torch.zeros(pad, dtype=ts.dtype)
    ts_p, tc_p = torch.cat([ts, z]), torch.cat([tc, z])
    g_acc_p = torch.cat([g_acc, g_acc.new_zeros((pad,) + g_acc.shape[1:])])
    g_t_p = torch.cat([g_t, g_t.new_zeros((pad,) + g_t.shape[1:])])
    parts_a, parts_t, row_sum = [], [], torch.zeros_like(rows)
    for base, n in ranges:
        sl = slice(base, base + n)
        a, f = composite.composite_fwd(table, ids, ts_p[sl], tc_p[sl], cfg,
                                       grid, tile_base=base)
        parts_a.append(a)
        parts_t.append(f)
        r = composite.composite_bwd(table, ids, ts_p[sl], tc_p[sl],
                                    a[:, :4], f, g_acc_p[sl], g_t_p[sl],
                                    cfg, grid, hw, tile_base=base)
        row_sum = row_sum + r
    assert torch.equal(torch.cat(parts_a)[:T], accum)
    assert torch.equal(torch.cat(parts_t)[:T], final_t)
    assert torch.equal(row_sum, rows)


def test_tile_range_matches_jax_composite(scene):
    """Tiles 3..7 of the image (tile_base 3): the forward and the table's
    vector-Jacobian product against JAX's jnp composite with the same
    tile_base (tolerance of tests/test_torch_composite_bwd.py)."""
    jcfg, cfg, grid, hw, b = (scene[k] for k in
                              ("jcfg", "cfg", "grid", "hw", "b"))
    base, n = 3, 5
    g_acc, g_t = scene["g_acc"][:n], scene["g_t"][:n]
    ts, tc = b.tile_start[base:base + n], b.tile_count[base:base + n]

    def loss(tab):
        a, f = jax_composite(tab, b.ids, ts, tc, b.inst_tile, b.inv_perm,
                             b.offsets, b.seg_gaussian, jcfg, grid, hw,
                             jnp.int32(base))
        return (a * g_acc).sum() + (f * g_t).sum(), (a, f)

    (jloss, (ja, jf)), jg = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(scene["table"]))
    local = workers.port_binning(_b(b))._replace(
        tile_start=torch.as_tensor(np.array(ts)),
        tile_count=torch.as_tensor(np.array(tc)))
    tab = torch.as_tensor(scene["table"]).clone().requires_grad_(True)
    a, f = composite.composite(tab, local, cfg, grid, hw, tile_base=base)
    ((a * torch.as_tensor(g_acc)).sum()
     + (f * torch.as_tensor(g_t)).sum()).backward()
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(ja),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(jf),
                               rtol=1e-5, atol=1e-6)
    want = np.asarray(jg)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(tab.grad.numpy(), want, rtol=2e-4,
                               atol=2e-5 * (np.abs(want).max(0) + 1e-3).max())


def test_sharded_composite_two_ranks_matches_jax(tmp_path):
    """96x40 at tile 8x32: 15 tiles, so the 2 ranks pad one empty tile."""
    jcfg, cfg, table, b, grid, hw, g_acc, g_t = _setup(5, w=96, h=40)
    scene = dict(cfg=cfg, table=np.array(table))
    assert grid[0] * grid[1] == 15
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))

    def loss(tab):
        a, f = jax_sharded_composite(mesh, tab, b, jcfg, grid, hw)
        return (a * g_acc).sum() + (f * g_t).sum()

    jloss, jg = jax.value_and_grad(loss)(jnp.asarray(scene["table"]))
    payload = dict(sizes={k: getattr(scene["cfg"], k) for k in
                          ("tile_h", "tile_w", "cap_instances", "cap_tile",
                           "chunk")},
                   table=scene["table"], binning=_b(b), grid=grid, hw=hw,
                   g_acc=g_acc, g_t=g_t)
    res = workers.run_ranks("sharded_composite_grad", payload, tmp_path)
    for r in res:
        np.testing.assert_allclose(r["loss"], float(jloss), rtol=1e-5)
    assert np.array_equal(res[0]["accum"], res[1]["accum"])
    grad = res[0]["grad"] + res[1]["grad"]
    np.testing.assert_allclose(grad, np.asarray(jg), rtol=1e-3, atol=5e-5)


# ---------------------------------------------------------------------------
# the tile-sharded training step
# ---------------------------------------------------------------------------

N, CAP, W, H = 80, 256, 64, 32
TS_SIZES = dict(tile_h=8, tile_w=16, cap_instances=1 << 12, cap_tile=256,
                chunk=8)
# densify at iteration 2 with the default threshold (2e-4)
TS_OPT = dict(densify_from_iter=0, densification_interval=2,
              densify_until_iter=10)


@pytest.fixture(scope="module")
def ts_run(tmp_path_factory):
    """The scene of tests/test_tile_sharded.py (JAX's create_from_points,
    carried over), 3 steps of the port's single-device step in this
    process and of its tile-sharded step on 2 gloo ranks."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    pts[:, 2] += 2.5
    params = jax_create(pts, rng.uniform(0.2, 0.9, (N, 3)).astype(
        np.float32), capacity=CAP)
    image = rng.rand(3, H, W).astype(np.float32)
    payload = dict(
        cfg=workers.port_config(TS_SIZES, TS_OPT, dict(light_base_res=16),
                                dict(step=4, start=2, delta=0.25), CAP),
        fields={k: np.asarray(getattr(params, k)) for k in FIELDS},
        sh=params.active_sh_degree,
        cams=[dict(R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=0.7, width=W,
                   height=H)],
        images=image[None], alphas=np.ones((1, 1, H, W), np.float32),
        bg=np.zeros(3, np.float32), iterations=[1, 2, 3])
    single = workers.phase1_single_steps(payload)
    ranks = workers.run_ranks("ts_steps", payload,
                              tmp_path_factory.mktemp("ts"))
    return dict(params=params, image=image, single=single, ranks=ranks)


def test_ts_step_two_ranks_matches_single_step(ts_run):
    single, ranks = ts_run["single"], ts_run["ranks"]
    np.testing.assert_allclose(ranks[0]["loss"], single["loss"], rtol=2e-5,
                               atol=1e-6)
    # each step: the compositing's all_gather and one all_reduce
    assert ranks[0]["calls"] == [{"all_reduce": 1, "all_gather": 1}] * 3
    want, got = single["after"][-1], ranks[0]["after"][-1]
    assert np.array_equal(got["alive"], want["alive"])
    assert want["alive"].sum() > N                 # densify fired
    for i in range(3):
        a, b = single["after"][i], ranks[0]["after"][i]
        scale = np.abs(a["stats.accum"]).max()
        np.testing.assert_allclose(b["stats.accum"], a["stats.accum"],
                                   rtol=1e-4, atol=1e-5 * scale)
    # Adam at eps 1e-15 turns a noise-level gradient into a full-lr step
    # of either sign (tests/test_tile_sharded.py): near-exact agreement
    # except for such rare elements, which stay within one noise step
    lrs = {"xyz": 0.00016 * 1.5, "opacity": 0.05, "scaling": 0.005}
    for f, lr in lrs.items():
        d = np.abs(got[f] - want[f])
        assert (d > 1e-4).mean() < 0.01, (f, (d > 1e-4).mean())
        assert d.max() <= 3 * 3.2 * lr, (f, d.max())
    for k in got:
        assert np.array_equal(got[k], ranks[1]["after"][-1][k]), k


def test_reference_ts_gradient_factor(ts_run):
    """After one step (no densification yet), JAX's make_ts_phase1_step
    on a 2-device mesh has 2x the single-chip step's accum (its
    value_and_grad runs inside the shard_map: the all_gather's transpose
    adds the two ranks' equal cotangents, then the psum adds the
    partials); the port's tile-sharded step has its single-device
    step's, which equals JAX's single-chip step's."""
    cfg = JaxConfig()
    cfg.model = JaxModel(capacity=CAP)
    cfg.opt = JaxOpt(**TS_OPT)
    cfg.train = JaxTrain(light_base_res=16)
    cfg.raster = JaxRasterConfig(**TS_SIZES, use_pallas=False,
                                 expand_backend="xla")
    tx = jax_build_optimizer(cfg.opt, 1.0)
    cam = jax_make_camera(R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=0.7,
                          width=W, height=H)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    accum = {}
    for name, fn in (("single", jtrainer.make_phase1_step(cfg, 1.0, tx)),
                     ("ts", jax_ts_step(cfg, 1.0, tx, mesh))):
        st = jtrainer.make_train_state(
            cfg, jax.tree.map(jnp.copy, ts_run["params"]),
            spatial_lr_scale=1.0)
        st, _ = fn(st, cam, jnp.asarray(ts_run["image"]),
                   jnp.ones((1, H, W)), jnp.zeros(3), jnp.int32(1))
        accum[name] = np.asarray(st.stats.accum)
    scale = np.abs(accum["single"]).max()
    assert scale > 0
    tol = dict(rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(accum["ts"], 2.0 * accum["single"], **tol)
    port_single = ts_run["single"]["after"][0]["stats.accum"]
    port_ts = ts_run["ranks"][0]["after"][0]["stats.accum"]
    np.testing.assert_allclose(port_single, accum["single"], **tol)
    np.testing.assert_allclose(port_ts, port_single, **tol)
