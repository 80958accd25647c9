"""Data-parallel training steps of the port against gi_gs_tpu on the CPU.

At 2 gloo ranks (tests/torch_dist_workers.py) x 2 views each, one step of
`make_dp_phase1_step` and of `make_dp_phase2_step` (light_base_res 16,
`indirect`) against JAX's `make_dp_phase{1,2}_step` on a 2-device mesh
with the same batch of 4 views (the scene of tests/test_data_parallel.py:
80 Gaussians at opacity 1.0, 32x16 views, densification off); the two
ranks' states bit-equal; 3 all_reduces per step. At world size 1, the
batch semantics of tests/test_data_parallel.py: the loss is the mean of
the views' losses, and the update is the optimizer's on their mean
gradient.

Adam at eps 1e-15 turns a gradient at noise level into a full-lr step of
either sign, so the parameters agree to 1e-4 except for a few such
elements, which stay within about one step (the rule of the JAX tests).
Parameters are compared on live slots only: dead slots take f32
prefix-sum residue as gradients, in JAX and the port alike.
"""
import numpy as np
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from gi_gs_tpu.config import (Config as JaxConfig, ModelConfig as JaxModel,
                              OptimizationConfig as JaxOpt,
                              TrainConfig as JaxTrain)
from gi_gs_tpu.models.gaussians import create_from_points as jax_create
from gi_gs_tpu.ops import shading as jax_shading
from gi_gs_tpu.ops.rasterize import RasterConfig as JaxRasterConfig
from gi_gs_tpu.ops.screen_space import GIParams as JaxGIParams
from gi_gs_tpu.parallel.data_parallel import (make_dp_phase1_step,
                                              make_dp_phase2_step,
                                              stack_cameras)
from gi_gs_tpu.scene.cameras import make_camera as jax_make_camera
from gi_gs_tpu.train import trainer as jtrainer
from gi_gs_tpu.train.optim import (build_light_optimizer as jax_light_opt,
                                   build_optimizer as jax_opt)

from gi_gs_tpu_torch.models.gaussians import FIELDS
from gi_gs_tpu_torch.train import optim, trainer

import torch_dist_workers as workers
from test_torch_render import shared_lut  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

N, CAP, W, H, VIEWS = 80, 128, 32, 16, 4
SIZES = dict(tile_h=8, tile_w=16, cap_instances=1 << 11, cap_tile=128,
             chunk=8)
GI = dict(step=4, start=2, delta=0.25)
# densification off; the BRDF schedule from step 0, so albedo moves
OPT = dict(densify_from_iter=10 ** 9, brdf_lr_offset=0)
TRAIN = {1: dict(light_base_res=16),
         2: dict(light_base_res=16, indirect=True)}


def _cams():
    """tests/test_data_parallel.py's camera sweep."""
    out = []
    for i in range(VIEWS):
        ang = 0.2 * (i - (VIEWS - 1) / 2.0)
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        T = np.array([0.1 * i, 0.0, 0.05 * (i % 2)], np.float32)
        out.append(dict(R=R, T=T, fovx=1.0, fovy=0.7, width=W, height=H))
    return out


def _scene(phase):
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    pts[:, 2] += 2.5
    params = jax_create(pts, rng.uniform(0.2, 0.9, (N, 3)).astype(
        np.float32), capacity=CAP)
    params = params.replace(opacity=jnp.full_like(params.opacity, 1.0))
    images = rng.rand(VIEWS, 3, H, W).astype(np.float32)
    cubemap = np.random.RandomState(7).uniform(
        0.25, 0.75, (6, 16, 16, 3)).astype(np.float32)
    return dict(
        params=params,
        cfg=workers.port_config(SIZES, OPT, TRAIN[phase], GI, CAP),
        fields={k: np.asarray(getattr(params, k)) for k in FIELDS},
        sh=params.active_sh_degree, cams=_cams(), images=images,
        alphas=np.ones((VIEWS, 1, H, W), np.float32),
        bg=np.zeros(3, np.float32), cubemap=cubemap, iterations=[1],
        phase=phase)


def _jax_step(p):
    """One step of JAX's DP step of p's phase on a 2-device mesh."""
    cfg = JaxConfig()
    cfg.model = JaxModel(capacity=CAP)
    cfg.opt = JaxOpt(**OPT)
    cfg.train = JaxTrain(**TRAIN[p["phase"]])
    cfg.raster = JaxRasterConfig(**SIZES, use_pallas=False,
                                 expand_backend="xla")
    cfg.gi = JaxGIParams(**GI)
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    tx = jax_opt(cfg.opt, 1.0)
    if p["phase"] == 2:
        step = make_dp_phase2_step(cfg, 1.0, tx, jax_light_opt(cfg.opt), mesh)
    else:
        step = make_dp_phase1_step(cfg, 1.0, tx, mesh)
    state = jtrainer.make_train_state(
        cfg, jax.tree.map(jnp.copy, p["params"]), spatial_lr_scale=1.0)
    state = state._replace(
        cubemap=jnp.asarray(p["cubemap"]),
        light_opt_state=jax_light_opt(cfg.opt).init(
            jnp.asarray(p["cubemap"])))
    cams = stack_cameras([jax_make_camera(**c) for c in p["cams"]])
    return step(state, cams, jnp.asarray(p["images"]),
                jnp.asarray(p["alphas"]), jnp.asarray(p["bg"]),
                jnp.int32(1))


def _near(got, want, lr, alive=None, frac=0.01):
    d = np.abs(np.asarray(got) - np.asarray(want))
    if alive is not None:
        d = d[alive]
    assert (d > 1e-4).mean() < frac, (d > 1e-4).mean()
    assert d.max() <= 3.2 * lr * 1.01, d.max()


def _ranks_equal(ranks):
    a, b = ranks[0]["after"][-1], ranks[1]["after"][-1]
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_dp_phase1_two_ranks_matches_jax(tmp_path):
    p = _scene(1)
    js, jaux = _jax_step(p)
    ranks = workers.run_ranks("dp_steps", p, tmp_path)
    got = ranks[0]["after"][0]
    assert ranks[0]["calls"] == [{"all_reduce": 3, "all_gather": 0}]
    np.testing.assert_allclose(ranks[0]["loss"][0], float(jaux.loss),
                               rtol=1e-5)
    alive = p["fields"]["alive"]
    _near(got["xyz"], js.params.xyz, 0.00016, alive)
    _near(got["opacity"], js.params.opacity, 0.05, alive)
    for k in ("accum", "accum_abs", "denom", "max_radii2d"):
        want = np.asarray(getattr(js.stats, k))
        np.testing.assert_allclose(got[f"stats.{k}"], want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())
    assert got["stats.denom"].sum() > 0
    _ranks_equal(ranks)


def test_dp_phase2_two_ranks_matches_jax(tmp_path):
    p = _scene(2)
    js, jaux = _jax_step(p)
    p["lut"] = jax_shading._brdf_lut_np(256, 64)
    ranks = workers.run_ranks("dp_steps", p, tmp_path)
    got = ranks[0]["after"][0]
    assert ranks[0]["calls"] == [{"all_reduce": 3, "all_gather": 0}]
    assert np.isfinite(ranks[0]["loss"][0])
    np.testing.assert_allclose(ranks[0]["loss"][0], float(jaux.loss),
                               rtol=1e-4)
    _near(got["albedo"], js.params.albedo, 0.05 * 0.01, p["fields"]["alive"])
    # the light's first Adam step is ~lr * sign(g) on every texel
    _near(got["cubemap"], js.cubemap, 0.05)
    assert np.abs(got["cubemap"] - p["cubemap"]).max() > 0
    _ranks_equal(ranks)


def test_dp_world_one_is_the_mean_over_views(tmp_path):
    """One rank, a batch of 2 views: the DP loss is the mean of the two
    single-view losses, and its xyz update is the optimizer's on the mean
    of their gradients (tests/test_data_parallel.py:92-140)."""
    p = _scene(1)
    p.update(cams=p["cams"][:2], images=p["images"][:2],
             alphas=p["alphas"][:2])
    res = workers.run_ranks("dp_steps", p, tmp_path, world=1)[0]
    assert res["calls"] == [{"all_reduce": 3, "all_gather": 0}]
    cfg = p["cfg"]
    state = workers.initial_state(p, cfg)
    losses, grads = [], []
    for cam, img, al in zip(workers.cameras(p), p["images"], p["alphas"]):
        loss, _, g, _ = trainer.loss_and_grads(
            cfg, state.params, cam, torch.as_tensor(img),
            torch.as_tensor(al), torch.as_tensor(p["bg"]))
        losses.append(float(loss))
        grads.append(g)
    np.testing.assert_allclose(res["loss"][0], np.mean(losses), rtol=1e-5)
    mean = {k: (grads[0][k] + grads[1][k]) / 2 for k in grads[0]}
    tx = optim.build_optimizer(cfg.opt, 1.0)
    view, _ = tx.step(mean, state.opt_state,
                      optim.trainable_view(state.params))
    _near(res["after"][0]["xyz"], view["xyz"].numpy(), 0.00016,
          p["fields"]["alive"], frac=0.02)
