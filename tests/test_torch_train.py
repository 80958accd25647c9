"""Phase-1 training of the port (gi_gs_tpu_torch.train and the helpers it
adds) against gi_gs_tpu on the CPU, on numpy-seeded inputs: the math
helpers, knn, losses, Gaussian init, one phase-1 view loss with every
gradient, the optimizer, the densification schedule, capacity growth and
one full step from a carried-over mid-training state. The JAX side uses
the jnp oracles (use_pallas=False, expand_backend="xla"); the one jitted
JAX function is the phase-1 value-and-grad (module-scoped)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gi_gs_tpu import config as jcfg_mod
from gi_gs_tpu.models import gaussians as jgauss
from gi_gs_tpu.ops import knn as jknn
from gi_gs_tpu.ops.rasterize import RasterConfig as JaxRasterConfig
from gi_gs_tpu.ops.screen_space import GIParams as JaxGIParams
from gi_gs_tpu.scene.cameras import make_camera as jax_make_camera
from gi_gs_tpu.train import densify as jdens
from gi_gs_tpu.train import losses as jlosses
from gi_gs_tpu.train import optim as joptim
from gi_gs_tpu.train import trainer as jtrainer
from gi_gs_tpu.utils import image_utils as jimg
from gi_gs_tpu.utils import math_utils as jmath

from gi_gs_tpu_torch import config as cfg_mod
from gi_gs_tpu_torch.models import gaussians as gauss
from gi_gs_tpu_torch.models.gaussians import FIELDS, params_from_numpy
from gi_gs_tpu_torch.ops import knn
from gi_gs_tpu_torch.ops.rasterize import RasterConfig
from gi_gs_tpu_torch.ops.screen_space import GIParams
from gi_gs_tpu_torch.scene.cameras import make_camera
from gi_gs_tpu_torch.train import densify, losses, optim, trainer
from gi_gs_tpu_torch.utils import image_utils, math_utils
from gi_gs_tpu_torch.utils.checkpoint import train_state_from_numpy

import bench_scene

torch.set_num_threads(1)

CAP = 512
W, H = 64, 48
SIZES = dict(tile_h=8, tile_w=32, cap_instances=1 << 14, cap_tile=256,
             chunk=8)
GI = dict(step=4, start=2, delta=0.25)
OPT = dict(densify_from_iter=10, densification_interval=20,
           densify_until_iter=100, opacity_reset_interval=1000)


def t(a):
    return torch.as_tensor(np.array(a))


def jax_cfg():
    c = jcfg_mod.Config()
    c.model = jcfg_mod.ModelConfig(capacity=CAP)
    c.opt = jcfg_mod.OptimizationConfig(**OPT)
    c.train = jcfg_mod.TrainConfig(light_base_res=16)
    c.raster = JaxRasterConfig(**SIZES, use_pallas=False,
                               expand_backend="xla")
    c.gi = JaxGIParams(**GI)
    return c


def port_cfg():
    c = cfg_mod.Config()
    c.model = cfg_mod.ModelConfig(capacity=CAP)
    c.opt = cfg_mod.OptimizationConfig(**OPT)
    c.train = cfg_mod.TrainConfig(light_base_res=16)
    c.raster = RasterConfig(**SIZES)
    c.gi = GIParams(**GI)
    return c


def scene_fields(seed=1, n=300):
    """A mid-training-like Gaussian set in front of the camera: JAX init,
    then varied opacity, scale, rotation, SH and normals."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    pts[:, 2] += 2.5
    cols = rng.uniform(0.2, 0.9, (n, 3)).astype(np.float32)
    p = jgauss.create_from_points(pts, cols, capacity=CAP)
    f = {k: np.array(getattr(p, k)) for k in FIELDS}
    f["opacity"][:n] = rng.uniform(-1.0, 2.5, (n, 1))
    f["scaling"][:n] += rng.uniform(0.3, 1.2, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4))
    f["rotation"][:n] = q / np.linalg.norm(q, axis=1, keepdims=True)
    f["features_rest"][:n] = rng.normal(0, 0.2, (n, 15, 3))
    f["normal"][:n] = rng.normal(size=(n, 3))
    return f


def jax_params(f, sh=1):
    return jgauss.GaussianParams(**{k: jnp.asarray(v) for k, v in f.items()},
                                 active_sh_degree=sh, max_sh_degree=3)


def image_inputs(seed=2):
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:H, 0:W] / W
    img = np.stack([0.5 + 0.4 * np.sin(5 * xs + 3 * ys + p)
                    for p in rng.uniform(0, 6, 3)]).astype(np.float32)
    alpha = (np.hypot(xs - 0.5, ys - 0.37) < 0.3)[None].astype(np.float32)
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    return img, alpha, bg


def opt_numpy(opt_state):
    """{optax group label: {"mu", "nu", "count"}} of a JAX optimizer state."""
    out = {}
    for field, label in joptim.GROUP_OF_FIELD.items():
        adam = opt_state.inner_states[label].inner_state[0]
        out[label] = {"mu": np.array(adam.mu[field]),
                      "nu": np.array(adam.nu[field]),
                      "count": int(adam.count)}
    return out


def close(got, want, rtol=2e-4, rel_atol=2e-5):
    """Gradient tolerance of the compositing tests: rtol 2e-4, atol
    2e-5 x the largest magnitude."""
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rel_atol * (np.abs(want).max() + 1e-12))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def test_math_helpers_match_jax():
    rng = np.random.RandomState(0)
    q = rng.normal(size=(50, 4)).astype(np.float32)
    close(math_utils.quat_to_rotmat(t(q)), jmath.quat_to_rotmat(q), 1e-6,
          1e-7)
    for step in (-3, 0, 1, 57, 7000, 29999, 30000, 50000):
        a = dict(lr_init=5e-4, lr_final=5e-6, lr_delay_mult=0.01,
                 max_steps=30000)
        # XLA's exp/log may differ from torch's by an ulp
        assert math_utils.expon_lr(step, **a) == pytest.approx(
            float(jmath.expon_lr(step, **a)), rel=1e-6)
        assert math_utils.expon_lr(step, 1e-3, 1e-4, lr_delay_steps=100,
                                   lr_delay_mult=0.1) == pytest.approx(
            float(jmath.expon_lr(step, 1e-3, 1e-4, lr_delay_steps=100,
                                 lr_delay_mult=0.1)), rel=1e-6)
    x = rng.uniform(0.01, 0.99, 20).astype(np.float32)
    close(math_utils.inverse_sigmoid(t(x)), jmath.inverse_sigmoid(x), 1e-6,
          1e-7)
    assert float(math_utils.inverse_sigmoid(0.1)) == pytest.approx(
        float(jmath.inverse_sigmoid(0.1)), rel=1e-6)


def test_knn_exact_matches_jax():
    pts = np.random.RandomState(1).rand(700, 3).astype(np.float32)
    close(knn.mean_knn_dist2(t(pts)), jknn.mean_knn_dist2(jnp.asarray(pts)),
          1e-4, 1e-5)


def test_knn_morton_matches_jax():
    """The Morton path (taken beyond 2^18 points) on points whose codes
    are distinct, so the sort order is unique."""
    pts = np.random.RandomState(2).rand(4000, 3).astype(np.float32)
    q = ((pts - pts.min(0)) / (pts.max(0) - pts.min(0)) * 1023.0).astype(
        np.int32)
    assert len(np.unique(knn._morton_3d(t(q)).numpy())) == len(pts)
    close(knn.mean_knn_dist2_morton(t(pts)),
          jknn.mean_knn_dist2_morton(jnp.asarray(pts)), 1e-5, 1e-6)


def test_losses_and_gradients_match_jax():
    rng = np.random.RandomState(3)
    gt = rng.uniform(0, 1, (3, 20, 24)).astype(np.float32)
    pred = rng.uniform(0, 1, (3, 20, 24)).astype(np.float32)
    mask = rng.uniform(0, 1, (1, 20, 24)) > 0.3
    cases = [
        (lambda a, b: losses.tv_loss(a, b),
         lambda a, b: jlosses.tv_loss(a, b)),
        (lambda a, b: losses.tv_loss(a, b, pad=2, step=2),
         lambda a, b: jlosses.tv_loss(a, b, pad=2, step=2)),
        (lambda a, b: losses.masked_tv_loss(t(mask), a, b, erosion=True),
         lambda a, b: jlosses.masked_tv_loss(mask, a, b, erosion=True)),
        (lambda a, b: image_utils.l1_loss(b, a),
         lambda a, b: jimg.l1_loss(b, a)),
        (lambda a, b: image_utils.ssim(b, a), lambda a, b: jimg.ssim(b, a)),
    ]
    for tf, jf in cases:
        p = t(pred).requires_grad_(True)
        val = tf(t(gt), p)
        val.backward()
        jv, jg = jax.value_and_grad(lambda b: jf(jnp.asarray(gt), b))(
            jnp.asarray(pred))
        assert float(val.detach()) == pytest.approx(float(jv), rel=1e-5)
        close(p.grad, jg, 1e-4, 1e-5)
    m = (rng.uniform(0, 1, (1, 20, 24)) > 0.2).astype(np.float32)
    close(image_utils.erode(t(m)), jimg.erode(jnp.asarray(m)), 0, 0)


@pytest.mark.parametrize("scene", ["300_points", "root_bench"])
def test_create_from_points_matches_jax(scene):
    if scene == "root_bench":
        # tests/bench_scene.py: 2000 points far deeper than 300. The points
        # bit for bit. Their SH DC, (rgb - 0.5) / C0, within 1 f32 ulp:
        # XLA's CPU division by the constant rounds otherwise than
        # PyTorch's on ~18% of inputs. The knn log scales within rtol
        # 1e-3: the knn's |q|^2 + |p|^2 - 2 q.p cancels ~1000x at |q|^2 ~ 9
        # over d^2 ~ 0.01, so the two matmuls' last bits show at ~1.5e-4.
        # The other fields bit for bit.
        pts, cols = bench_scene.points()
        jp = bench_scene.jax_scene()[1]
        pp = gauss.create_from_points(pts, cols, bench_scene.SIZE["CAP"],
                                      device="cpu")
        assert pp.capacity == jp.capacity == bench_scene.SIZE["CAP"]
        for k in FIELDS:
            got, want = getattr(pp, k).numpy(), np.asarray(getattr(jp, k))
            if k == "features_dc":
                np.testing.assert_array_max_ulp(got, want, maxulp=1)
            elif k == "scaling":
                np.testing.assert_allclose(got, want, rtol=1e-3, err_msg=k)
            else:
                np.testing.assert_array_equal(got, want, err_msg=k)
        return
    rng = np.random.RandomState(4)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    jp = jgauss.create_from_points(pts, cols, capacity=CAP)
    pp = gauss.create_from_points(pts, cols, capacity=CAP, device="cpu")
    for k in FIELDS:
        close(getattr(pp, k).float(), np.asarray(getattr(jp, k), np.float32),
              1e-5, 1e-6)
    assert pp.active_sh_degree == 0 and int(pp.num_alive) == 300
    # more points than capacity: the same RandomState(0) subsample
    jp = jgauss.create_from_points(pts, cols, capacity=256)
    pp = gauss.create_from_points(pts, cols, capacity=256, device="cpu")
    close(pp.xyz, jp.xyz, 0, 0)


# ---------------------------------------------------------------------------
# the phase-1 view loss and its gradients
# ---------------------------------------------------------------------------

def make_jax_grad_fn():
    """fields -> (loss, aux, grads, ndc_grad) of JAX phase1_view_loss on
    the test view, through one jitted value-and-grad."""
    cfg = jax_cfg()
    cam = jax_make_camera(R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=0.8,
                          width=W, height=H)

    def f(view, ndc, alive, img, alpha, bg):
        p = jgauss.GaussianParams(**view, alive=alive, active_sh_degree=1,
                                  max_sh_degree=3)
        return jtrainer.phase1_view_loss(cfg, p, ndc, cam, img, alpha, bg)

    vg = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))

    def run(fields):
        img, alpha, bg = image_inputs()
        view = {k: jnp.asarray(fields[k]) for k in optim.TRAINABLE_FIELDS}
        (loss, aux), (g, ndc_g) = vg(view, jnp.zeros((CAP, 2)),
                                     jnp.asarray(fields["alive"]), img,
                                     alpha, bg)
        return loss, aux, g, ndc_g
    return run


@pytest.fixture(scope="module")
def jax_grad_fn():
    return make_jax_grad_fn()


def port_inputs(fields, sh=1):
    params = params_from_numpy(fields, sh, 3, device="cpu")
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.8, W, H, device="cpu")
    img, alpha, bg = (t(a) for a in image_inputs())
    return params, cam, img, alpha, bg


@pytest.mark.parametrize("scene", ["300_gaussians", "root_bench"])
def test_phase1_view_loss_and_gradients_match_jax(jax_grad_fn, scene):
    if scene == "root_bench":
        _root_bench_phase1_loss_and_gradients()
        return
    fields = scene_fields()
    jloss, jaux, jg, jndc = jax_grad_fn(fields)
    params, cam, img, alpha, bg = port_inputs(fields)
    loss, aux, grads, ndc = trainer.loss_and_grads(port_cfg(), params, cam,
                                                   img, alpha, bg)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(aux["l1"]) == pytest.approx(float(jaux["l1"]), rel=1e-5)
    assert float(aux["normal_loss"]) == pytest.approx(
        float(jaux["normal_loss"]), rel=1e-5)
    # Dead slots are not compared with JAX: their gradient is the f32
    # residue of the prefix-sum reduction (csum[hi] - csum[lo] over zero
    # rows), which normalize's rsqrt(max(|n|^2, 1e-24)) multiplies by 1e12
    # for their zero normals; it moves no live Gaussian. The NaN guards
    # keep it finite.
    alive = fields["alive"]
    for k in optim.TRAINABLE_FIELDS:
        close(grads[k][alive], np.asarray(jg[k])[alive])
        assert np.isfinite(grads[k][~alive].numpy()).all()
    close(ndc[alive], np.asarray(jndc)[alive])
    assert np.abs(np.asarray(jndc)).max() > 0
    np.testing.assert_array_equal(aux["radii"].numpy(),
                                  np.asarray(jaux["radii"]))


def _root_bench_phase1_loss_and_gradients():
    """The root bench's scene and config (tests/bench_scene.py; JAX's
    default Pallas kernels in interpret mode) through JAX's
    phase1_view_loss under value_and_grad, as make_phase1_step takes them,
    against the port's loss_and_grads on the same Gaussians. The loss
    within rel 1e-5 and each field's gradient norm over live slots within
    rel 2e-4. Element by element, rtol 2e-4 with atol 1e-4 x the field's
    largest: 2000 Gaussians in 64x64 pixels overlap far deeper than the
    300 of scene_fields in 64x48 (where `close`'s 2e-5 holds), and ~0.5%
    of the scaling gradients, sums of terms of both signs, differ by up to
    5e-5 of the largest."""
    jcfg, jp, jcam, jimg, jalpha, jbg = bench_scene.jax_scene()

    def loss_fn(view, ndc):
        return jtrainer.phase1_view_loss(jcfg, jp.replace(**view), ndc, jcam,
                                         jimg, jalpha, jbg)

    (jloss, _), (jg, _) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(
            joptim.trainable_view(jp), jnp.zeros((jp.capacity, 2)))
    p = params_from_numpy({k: np.asarray(getattr(jp, k)) for k in FIELDS},
                          jp.active_sh_degree, jp.max_sh_degree,
                          device="cpu")
    cfg = cfg_mod.Config()
    cfg.model = cfg_mod.ModelConfig(capacity=jp.capacity)
    cfg.raster = RasterConfig(cap_instances=jcfg.raster.cap_instances)
    cam = make_camera(np.eye(3), np.zeros(3), 0.8, 0.8, jcam.width,
                      jcam.height, device="cpu")
    loss, _, grads, _ = trainer.loss_and_grads(
        cfg, p, cam, t(jimg), t(jalpha), t(jbg))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    alive = p.alive.numpy()
    for k in optim.TRAINABLE_FIELDS:
        want = np.asarray(jg[k])[alive]
        got = grads[k].numpy()[alive]
        assert np.linalg.norm(got) == pytest.approx(np.linalg.norm(want),
                                                    rel=2e-4, abs=1e-12), k
        close(got, want, 2e-4, 1e-4)
    assert np.linalg.norm(grads["xyz"].numpy()[alive]) > 0


# ---------------------------------------------------------------------------
# optimizer, densification, growth
# ---------------------------------------------------------------------------

def test_optimizer_three_steps_match_optax():
    """Identical gradients through every group for 3 steps (the first
    xyz step at expon_lr(0), albedo at lr 0, roughness/metallic at
    opacity_lr), then a reset of the opacity group and new-slot surgery."""
    f = scene_fields(seed=5)
    opt_j = jcfg_mod.OptimizationConfig()
    tx_j = joptim.build_optimizer(opt_j, 2.5)
    tx_p = optim.build_optimizer(cfg_mod.OptimizationConfig(), 2.5)
    jview = {k: jnp.asarray(f[k]) for k in optim.TRAINABLE_FIELDS}
    pview = {k: t(f[k]) for k in optim.TRAINABLE_FIELDS}
    jst, pst = tx_j.init(jview), tx_p.init(pview)
    rng = np.random.RandomState(6)
    for _ in range(3):
        g = {k: rng.normal(0, 1e-3, f[k].shape).astype(np.float32)
             for k in optim.TRAINABLE_FIELDS}
        upd, jst = tx_j.update({k: jnp.asarray(v) for k, v in g.items()},
                               jst, jview)
        jview = jax.tree.map(lambda a, b: a + b, jview, upd)
        pview, pst = tx_p.step({k: t(v) for k, v in g.items()}, pst, pview)
    # the summed updates: optax's f32 bias correction 1 - b2^count is off
    # by up to ~3e-5 relative (XLA's pow), the port's is rounded once
    for k in optim.TRAINABLE_FIELDS:
        step = np.abs(np.asarray(jview[k]) - f[k]).max()
        np.testing.assert_allclose(
            pview[k].numpy(), np.asarray(jview[k]), rtol=0,
            atol=1e-4 * step + 4 * np.spacing(np.abs(f[k]).max()))
    jo = opt_numpy(jst)
    for label, st in pst.items():
        assert st["count"] == jo[label]["count"] == 3
        close(st["mu"], jo[label]["mu"], 1e-6, 1e-7)
        close(st["nu"], jo[label]["nu"], 1e-6, 1e-7)
    np.testing.assert_array_equal(pview["albedo"].numpy(), f["albedo"])
    mask = np.zeros(CAP, bool)
    mask[::7] = True
    jst = joptim.surgery_reset_group(
        joptim.surgery_new_slots(jst, jnp.asarray(mask)), "opacity")
    pst = optim.surgery_reset_group(optim.surgery_new_slots(pst, t(mask)),
                                    "opacity")
    jo = opt_numpy(jst)
    for label, st in pst.items():
        close(st["mu"], jo[label]["mu"], 0, 0)
        assert st["count"] == jo[label]["count"]


def _stats(rng, cap):
    denom = rng.randint(0, 6, (cap, 1)).astype(np.float32)
    return {"accum": (rng.gamma(1.0, 2e-4, (cap, 1)) * denom
                      ).astype(np.float32),
            "accum_abs": (rng.gamma(1.0, 3e-4, (cap, 1)) * denom
                          ).astype(np.float32),
            "accum_abs_max": rng.gamma(1.0, 3e-4, (cap, 1)).astype(np.float32),
            "denom": denom,
            "max_radii2d": rng.randint(0, 40, cap).astype(np.float32)}


@pytest.mark.parametrize("n_alive,size_thr", [(300, None), (300, 20.0),
                                              (480, 20.0)])
def test_densify_and_prune_matches_jax(n_alive, size_thr):
    """JAX statistics and JAX's noise draw fed to both: the same selection
    (clone/split/prune, the free-slot table, capacity saturation at 480
    alive) and the same new parameters."""
    rng = np.random.RandomState(7 + n_alive)
    f = scene_fields(seed=8, n=min(n_alive, 300))
    f["alive"] = np.arange(CAP) < n_alive
    f["scaling"][:n_alive] = rng.uniform(-4.5, -1.5, (n_alive, 3))
    st = _stats(rng, CAP)
    key = jax.random.PRNGKey(3)
    jp, jstats, jnew, jdrop = jdens.densify_and_prune(
        key, jax_params(f), jdens.DensifyStats(**{k: jnp.asarray(v)
                                                   for k, v in st.items()}),
        2e-4, 0.05, 3.0, size_thr, 0.01)
    noise = t(jax.random.normal(key, (CAP, 3), jnp.float32))
    pp, pstats, pnew, pdrop = densify.densify_and_prune(
        noise, params_from_numpy(f, 1, 3, device="cpu"),
        densify.DensifyStats(**{k: t(v) for k, v in st.items()}),
        2e-4, 0.05, 3.0, size_thr, 0.01)
    np.testing.assert_array_equal(pnew.numpy(), np.asarray(jnew))
    np.testing.assert_array_equal(pp.alive.numpy(), np.asarray(jp.alive))
    assert int(pdrop) == int(jdrop)
    assert pnew.sum() > 0
    for k in optim.TRAINABLE_FIELDS:
        close(getattr(pp, k), getattr(jp, k), 1e-5, 1e-6)
    assert float(pstats.denom.abs().sum()) == 0.0
    # update_stats on top, and the opacity reset
    ndc = rng.normal(0, 1e-3, (CAP, 2)).astype(np.float32)
    vis = rng.uniform(0, 1, CAP) > 0.4
    radii = rng.randint(0, 30, CAP).astype(np.int32)
    js = jdens.update_stats(jdens.DensifyStats(**{
        k: jnp.asarray(v) for k, v in st.items()}), ndc, vis, radii)
    ps = densify.update_stats(densify.DensifyStats(**{
        k: t(v) for k, v in st.items()}), t(ndc), t(vis), t(radii))
    for k in densify.DensifyStats.FIELDS:
        close(getattr(ps, k), getattr(js, k), 1e-6, 1e-8)
    close(densify.reset_opacity(pp).opacity,
          jdens.reset_opacity(jp).opacity, 1e-6, 1e-7)


def test_grow_state_matches_jax():
    f = scene_fields(seed=9)
    jstate = jtrainer.make_train_state(jax_cfg(), jax_params(f), 1.0)
    jstate = jstate._replace(stats=jdens.DensifyStats(**{
        k: jnp.asarray(v) for k, v in _stats(np.random.RandomState(1),
                                              CAP).items()}))
    pstate = train_state_from_numpy(
        f, opt_numpy(jstate.opt_state),
        {k: np.asarray(getattr(jstate.stats, k))
         for k in densify.DensifyStats.FIELDS},
        np.asarray(jstate.cubemap), 1, 3, device="cpu")
    jg = jtrainer.grow_state(jstate, 2 * CAP)
    pg = trainer.grow_state(pstate, 2 * CAP)
    for k in FIELDS:
        np.testing.assert_array_equal(
            getattr(pg.params, k).numpy(), np.asarray(getattr(jg.params, k)))
    jo = opt_numpy(jg.opt_state)
    for label, st in pg.opt_state.items():
        assert st["mu"].shape[0] == 2 * CAP
        close(st["nu"], jo[label]["nu"], 0, 0)
    for k in densify.DensifyStats.FIELDS:
        close(getattr(pg.stats, k), getattr(jg.stats, k), 0, 0)


# ---------------------------------------------------------------------------
# one full step from a carried-over mid-training state
# ---------------------------------------------------------------------------

def test_full_step_from_carried_state(jax_grad_fn):
    """A JAX state with nonzero moments (count 4) and statistics, carried
    over by train_state_from_numpy; one phase-1 step on each side (the
    JAX optimizer and schedule run eagerly on JAX's gradients).
    Parameters are compared where |g| exceeds 1e-3 of the field's
    largest gradient: Adam at eps 1e-15 turns a noise-level gradient into
    a full-lr step of either sign."""
    f = scene_fields(seed=10)
    rng = np.random.RandomState(11)
    cfg_j = jax_cfg()
    tx_j = joptim.build_optimizer(cfg_j.opt, 1.0)
    jview = {k: jnp.asarray(f[k]) for k in optim.TRAINABLE_FIELDS}
    jst = tx_j.init(jview)
    for _ in range(4):
        g = {k: jnp.asarray(rng.normal(0, 1e-3, f[k].shape), jnp.float32)
             for k in optim.TRAINABLE_FIELDS}
        _, jst = tx_j.update(g, jst, jview)
    stats = _stats(rng, CAP)
    jstate = jtrainer.TrainState(
        params=jax_params(f), opt_state=jst,
        stats=jdens.DensifyStats(**{k: jnp.asarray(v)
                                    for k, v in stats.items()}),
        cubemap=jnp.full((6, 16, 16, 3), 0.5),
        light_opt_state=joptim.build_light_optimizer(cfg_j.opt).init(
            jnp.full((6, 16, 16, 3), 0.5)),
        key=jax.random.PRNGKey(0))
    pstate = train_state_from_numpy(f, opt_numpy(jst), stats,
                                    np.full((6, 16, 16, 3), 0.5), 1, 3,
                                    device="cpu")
    iteration = 7                      # no densification, no reset
    jloss, jaux, jg, jndc = jax_grad_fn(f)
    jnew, _ = jtrainer._apply_schedule_updates(
        cfg_j, jstate, jstate.params, jg, jndc, jaux, jnp.int32(iteration),
        tx_j, 1.0)
    params, cam, img, alpha, bg = port_inputs(f)
    step = trainer.make_phase1_step(port_cfg(), 1.0,
                                    optim.build_optimizer(port_cfg().opt, 1.0))
    pnew, aux = step(pstate, cam, img, alpha, bg, iteration)
    assert float(aux.loss) == pytest.approx(float(jloss), rel=1e-5)
    for k in optim.TRAINABLE_FIELDS:
        g = np.abs(np.asarray(jg[k]))
        g[~f["alive"]] = 0.0               # see the view-loss test
        # fields the loss does not reach (albedo, roughness, metallic) get
        # zero gradients on both sides: compare every live slot
        sel = g > 1e-3 * g.max() if g.max() > 0 else f["alive"][:, None] & (
            g == 0)
        got = getattr(pnew.params, k).numpy()[sel]
        want = np.asarray(getattr(jnew.params, k))[sel]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert pnew.opt_state[optim.GROUP_OF_FIELD[k]]["count"] == 5
    for k in densify.DensifyStats.FIELDS:
        close(getattr(pnew.stats, k), getattr(jnew.stats, k), 1e-4, 1e-5)


@pytest.mark.parametrize("normal_weight", [0.0, 0.5])
def test_phase1_step_normal_weight_matches_jax(normal_weight):
    """make_phase1_step's weight of the normal-consistency loss against
    JAX's (the quality gate passes it through): one step from fresh
    optimizer states; the loss within 1e-5 relative and off the weight-1
    loss by (1 - weight) x the normal loss; the parameters within 1e-5
    where JAX's gradient (its first Adam moment / 0.1) exceeds 1e-3 of
    the field's largest, as in test_full_step_from_carried_state: Adam
    at eps 1e-15 turns a noise-level gradient into a full-lr step of
    either sign."""
    f = scene_fields(seed=12)
    cfg_j = jax_cfg()
    tx_j = joptim.build_optimizer(cfg_j.opt, 1.0)
    jstep = jtrainer.make_phase1_step(cfg_j, 1.0, tx_j,
                                      normal_weight=normal_weight)
    jstate = jtrainer.make_train_state(cfg_j, jax_params(f), 1.0)
    img, alpha, bg = image_inputs()
    cam_j = jax_make_camera(R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=0.8,
                            width=W, height=H)
    jnew, jaux = jstep(jstate, cam_j, jnp.asarray(img), jnp.asarray(alpha),
                       jnp.asarray(bg), jnp.int32(7))
    params, cam, pimg, palpha, pbg = port_inputs(f)
    cfg = port_cfg()
    tx = optim.build_optimizer(cfg.opt, 1.0)
    state = trainer.make_train_state(cfg, params, 1.0, tx=tx)
    pnew, aux = trainer.make_phase1_step(
        cfg, 1.0, tx, normal_weight=normal_weight)(state, cam, pimg, palpha,
                                                   pbg, 7)
    assert float(aux.loss) == pytest.approx(float(jaux.loss), rel=1e-5)
    assert float(aux.normal_loss) == pytest.approx(float(jaux.normal_loss),
                                                   rel=1e-5)
    assert float(aux.normal_loss) > 1e-3
    _, full = trainer.make_phase1_step(cfg, 1.0, tx)(state, cam, pimg,
                                                     palpha, pbg, 7)
    assert float(full.loss) - float(aux.loss) == pytest.approx(
        (1.0 - normal_weight) * float(aux.normal_loss), rel=1e-4)
    jmu = opt_numpy(jnew.opt_state)
    for k in ("xyz", "features_dc", "opacity", "normal", "scaling",
              "rotation"):
        g = np.abs(jmu[optim.GROUP_OF_FIELD[k]]["mu"]) / 0.1
        g[~f["alive"]] = 0.0
        sel = g > 1e-3 * g.max()
        assert sel.sum() > 0, k
        np.testing.assert_allclose(
            getattr(pnew.params, k).numpy()[sel],
            np.asarray(getattr(jnew.params, k))[sel], rtol=1e-5, atol=1e-5)
