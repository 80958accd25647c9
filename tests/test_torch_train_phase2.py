"""Phase-2 (deferred-PBR) training of the port against gi_gs_tpu on the
CPU, on numpy-seeded inputs: one phase-2 view loss plus env-TV with every
gradient (Gaussian fields, the densification hook and the cubemap) from a
carried-over state, then one full `make_phase2_step` (the schedule, the
light's Adam and the cubemap clamp).

The scene is 160x48: one full 128-column block of the coherent march and
one partial block whose centre lies in the padding. Both sides run
GIParams' default backend, "pallas": JAX its coherent Pallas kernel in
interpret mode (its SSR reads RGB packed 11-11-10), the port the plain
coherent march. The JAX rasterizer runs its jnp oracles
(use_pallas=False, expand_backend="xla"); light_base_res 64 runs one patch
level of the prefilter (JAX's Pallas patch kernels in interpret mode).
Both packages read one shared, small env-BRDF LUT. The one jitted JAX
function is the phase-2 value-and-grad (module-scoped)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gi_gs_tpu import config as jcfg_mod
from gi_gs_tpu.models import gaussians as jgauss
from gi_gs_tpu.models import light as jlight
from gi_gs_tpu.ops.rasterize import RasterConfig as JaxRasterConfig
from gi_gs_tpu.ops.screen_space import GIParams as JaxGIParams
from gi_gs_tpu.scene.cameras import make_camera as jax_make_camera
from gi_gs_tpu.train import densify as jdens
from gi_gs_tpu.train import optim as joptim
from gi_gs_tpu.train import trainer as jtrainer

from gi_gs_tpu_torch import config as cfg_mod
from gi_gs_tpu_torch.models import light as light_mod
from gi_gs_tpu_torch.models.gaussians import params_from_numpy
from gi_gs_tpu_torch.ops.rasterize import RasterConfig
from gi_gs_tpu_torch.ops.screen_space import GIParams
from gi_gs_tpu_torch.scene.cameras import compute_view_dirs, make_camera
from gi_gs_tpu_torch.train import densify, optim, trainer
from gi_gs_tpu_torch.utils.checkpoint import train_state_from_numpy

from test_torch_render import shared_lut  # noqa: F401  (autouse fixture)
from test_torch_train import (CAP, OPT, SIZES, _stats, close, jax_params,
                              opt_numpy, scene_fields)

torch.set_num_threads(1)

W, H = 160, 48
FOVX, FOVY = 1.2, 0.4
LIGHT = 64
GI = dict(step=4, start=2, delta=0.25)
TRAIN = dict(light_base_res=LIGHT, indirect=True, metallic=True)


def t(a):
    return torch.as_tensor(np.array(a))


def jax_cfg():
    c = jcfg_mod.Config()
    c.model = jcfg_mod.ModelConfig(capacity=CAP)
    c.opt = jcfg_mod.OptimizationConfig(**OPT)
    c.train = jcfg_mod.TrainConfig(**TRAIN)
    c.raster = JaxRasterConfig(**SIZES, use_pallas=False,
                               expand_backend="xla")
    c.gi = JaxGIParams(**GI)
    return c


def port_cfg():
    c = cfg_mod.Config()
    c.model = cfg_mod.ModelConfig(capacity=CAP)
    c.opt = cfg_mod.OptimizationConfig(**OPT)
    c.train = cfg_mod.TrainConfig(**TRAIN)
    c.raster = RasterConfig(**SIZES)
    c.gi = GIParams(**GI)
    return c


def phase2_fields(seed):
    """The phase-1 test population spread across the wide view, with
    varied BRDF attributes."""
    f = scene_fields(seed=seed)
    rng = np.random.RandomState(seed + 100)
    n = int(f["alive"].sum())
    f["xyz"][:n, 0] *= 2.5
    f["albedo"][:n] = rng.normal(0, 1, (n, 3))
    f["roughness"][:n] = rng.normal(0, 1, (n, 1))
    f["metallic"][:n] = rng.normal(-1, 1, (n, 1))
    return f


def image_inputs(seed=2):
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:H, 0:W] / W
    img = np.stack([0.4 + 0.3 * np.sin(9 * xs + 5 * ys + p)
                    for p in rng.uniform(0, 6, 3)]).astype(np.float32)
    alpha = (np.hypot((xs - 0.5) * 0.5, ys - 0.15) < 0.2)[None].astype(
        np.float32)
    return img, alpha


def cubemap(seed=3):
    return np.random.RandomState(seed).uniform(
        0.25, 0.75, (6, LIGHT, LIGHT, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_grad_fn():
    """fields, cubemap -> (loss, aux, grads, ndc_grad, cubemap grad) of
    JAX's phase-2 loss (phase2_view_loss + env-TV, as make_phase2_step's
    loss_fn) on the test view."""
    cfg = jax_cfg()
    cam = jax_make_camera(R=np.eye(3), T=np.zeros(3), fovx=FOVX, fovy=FOVY,
                          width=W, height=H)
    spec, arrays = jlight.build_prefilter_tables(LIGHT)
    view_dirs = jtrainer.compute_view_dirs(cam)

    def f(view, base, ndc, alive, img, alpha, tables):
        p = jgauss.GaussianParams(**view, alive=alive, active_sh_degree=1,
                                  max_sh_degree=3)
        light = jlight.build_mips_packed(base, spec, tables)
        loss, aux = jtrainer.phase2_view_loss(cfg, None, light, p, ndc, cam,
                                              img, alpha, jnp.zeros(3),
                                              view_dirs)
        return loss + jtrainer.env_tv_loss(base) * cfg.train.env_tv_weight, \
            aux

    vg = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))

    def run(fields, cube):
        img, alpha = image_inputs()
        view = {k: jnp.asarray(fields[k]) for k in optim.TRAINABLE_FIELDS}
        (loss, aux), (g, lg, ndc_g) = vg(view, jnp.asarray(cube),
                                         jnp.zeros((CAP, 2)),
                                         jnp.asarray(fields["alive"]),
                                         img, alpha, arrays)
        return loss, aux, g, ndc_g, lg
    return run


def port_inputs(fields, cube):
    params = params_from_numpy(fields, 1, 3, device="cpu")
    cam = make_camera(np.eye(3), np.zeros(3), FOVX, FOVY, W, H, device="cpu")
    img, alpha = (t(a) for a in image_inputs())
    return params, cam, img, alpha, t(cube)


# Gradients are compared on live slots at the compositing tests'
# tolerance (rtol 2e-4, atol 2e-5 x the field's largest magnitude), the
# loss to 1e-5 relative. The JAX SSR reads RGB packed 11-11-10 (up to
# 4.9e-4 of the image maximum per texel) where the port reads f32; on
# this scene that moves no gradient by more than 2e-6 of its field's
# largest. In phase 2 only the BRDF fields and the cubemap get a nonzero
# gradient on either side: the rasterizer's d(alpha) reads the colour and
# opacity channels only (a reference quirk) and the loss reads no colour.
close_p2 = close


def test_phase2_loss_and_gradients_match_jax(jax_grad_fn):
    f = phase2_fields(seed=21)
    cube = cubemap()
    jloss, jaux, jg, jndc, jlg = jax_grad_fn(f, cube)
    params, cam, img, alpha, tcube = port_inputs(f, cube)
    tables = light_mod.build_prefilter_tables(LIGHT, device="cpu")
    loss, aux, grads, ndc, lg = trainer.phase2_loss_and_grads(
        port_cfg(), tables, params, tcube, cam, img, alpha, torch.zeros(3),
        compute_view_dirs(cam))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(aux["l1"].detach()) == pytest.approx(float(jaux["l1"]),
                                                      rel=1e-5)
    alive = f["alive"]
    for k in optim.TRAINABLE_FIELDS:
        close_p2(grads[k][alive], np.asarray(jg[k])[alive])
        assert np.isfinite(grads[k].numpy()).all()
    # phase 2 trains the BRDF fields and the light
    for k in ("albedo", "roughness", "metallic"):
        assert np.abs(np.asarray(jg[k])[alive]).max() > 0, k
        assert np.abs(grads[k][alive].numpy()).max() > 0, k
    close_p2(ndc[alive], np.asarray(jndc)[alive])
    close_p2(lg, jlg)
    assert np.abs(np.asarray(jlg)).max() > 0
    np.testing.assert_array_equal(aux["radii"].numpy(),
                                  np.asarray(jaux["radii"]))


def test_phase2_full_step_from_carried_state(jax_grad_fn):
    """A JAX state with nonzero moments (count 4) for the Gaussians and
    the light, carried over by train_state_from_numpy; one phase-2 step on
    each side (JAX's schedule and light Adam run eagerly on JAX's
    gradients). Parameters and the cubemap are compared where |g| exceeds
    1e-3 of the field's largest gradient (Adam at eps 1e-15 turns a
    noise-level gradient into a full-lr step of either sign)."""
    f = phase2_fields(seed=22)
    cube = cubemap(seed=4)
    rng = np.random.RandomState(23)
    cfg_j = jax_cfg()
    tx_j = joptim.build_optimizer(cfg_j.opt, 1.0)
    ltx_j = joptim.build_light_optimizer(cfg_j.opt)
    jview = {k: jnp.asarray(f[k]) for k in optim.TRAINABLE_FIELDS}
    jst, jlst = tx_j.init(jview), ltx_j.init(jnp.asarray(cube))
    for _ in range(4):
        g = {k: jnp.asarray(rng.normal(0, 1e-3, f[k].shape), jnp.float32)
             for k in optim.TRAINABLE_FIELDS}
        _, jst = tx_j.update(g, jst, jview)
        _, jlst = ltx_j.update(
            jnp.asarray(rng.normal(0, 1e-5, cube.shape), jnp.float32), jlst,
            jnp.asarray(cube))
    stats = _stats(rng, CAP)
    jstate = jtrainer.TrainState(
        params=jax_params(f), opt_state=jst,
        stats=jdens.DensifyStats(**{k: jnp.asarray(v)
                                    for k, v in stats.items()}),
        cubemap=jnp.asarray(cube), light_opt_state=jlst,
        key=jax.random.PRNGKey(0))
    adam = jlst[0]
    pstate = train_state_from_numpy(
        f, opt_numpy(jst), stats, cube, 1, 3,
        light_opt={"cubemap": {"mu": np.asarray(adam.mu),
                               "nu": np.asarray(adam.nu),
                               "count": int(adam.count)}}, device="cpu")
    iteration = 7                      # no densification, no reset
    jloss, jaux, jg, jndc, jlg = jax_grad_fn(f, cube)
    jnew, _ = jtrainer._apply_schedule_updates(
        cfg_j, jstate, jstate.params, jg, jndc, jaux, jnp.int32(iteration),
        tx_j, 1.0)
    lupd, jlst2 = ltx_j.update(jlg, jlst, jstate.cubemap)
    jcube = np.maximum(np.asarray(jstate.cubemap + lupd), 0.0)

    params, cam, img, alpha, _ = port_inputs(f, cube)
    cfg = port_cfg()
    step = trainer.make_phase2_step(
        cfg, 1.0, optim.build_optimizer(cfg.opt, 1.0),
        optim.build_light_optimizer(cfg.opt), device="cpu")
    # the background is black in phase 2 whatever the caller passes
    pnew, aux = step(pstate, cam, img, alpha, torch.ones(3), iteration)
    assert float(aux.loss) == pytest.approx(float(jloss), rel=1e-5)
    for k in optim.TRAINABLE_FIELDS:
        g = np.abs(np.asarray(jg[k]))
        g[~f["alive"]] = 0.0
        # fields the phase-2 loss does not reach get zero gradients on
        # both sides (their step comes from the carried moments): compare
        # every live slot
        live = f["alive"].reshape((-1,) + (1,) * (g.ndim - 1))
        sel = g > 1e-3 * g.max() if g.max() > 0 else live & (g == 0)
        np.testing.assert_allclose(getattr(pnew.params, k).numpy()[sel],
                                   np.asarray(getattr(jnew.params, k))[sel],
                                   rtol=1e-5, atol=1e-5, err_msg=k)
        assert pnew.opt_state[optim.GROUP_OF_FIELD[k]]["count"] == 5
    for k in densify.DensifyStats.FIELDS:
        close(getattr(pnew.stats, k), getattr(jnew.stats, k), 1e-3, 1e-3)
    g = np.abs(np.asarray(jlg))
    sel = g > 1e-3 * g.max()
    np.testing.assert_allclose(pnew.cubemap.numpy()[sel], jcube[sel],
                               rtol=1e-5, atol=1e-5)
    assert (pnew.cubemap >= 0).all()
    assert pnew.light_opt_state["cubemap"]["count"] == int(jlst2[0].count)
    close(pnew.light_opt_state["cubemap"]["mu"], jlst2[0].mu, 1e-3, 1e-3)
