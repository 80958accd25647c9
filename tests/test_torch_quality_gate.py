"""The port's quality gate (gi_gs_tpu_torch/quality_gate.py) against the
JAX gate (tools/quality_gate.py) on the CPU, in one process: the ring
cameras and their split, the GT scenes and envmaps, the phase-1 GT
renders, the two-stage lr, a few phase-1 steps of the gate before the
densification begins, and the optimizer counts' fast-forward. Two phase-2 gate runs, each in a file of its own:
tests/test_torch_quality_gate_phase2.py (from the reference init) and
tests/test_torch_quality_gate_specular.py (the specular gate from the
GT). Then the reduced recovery runs of tests/test_quality.py for
the port, under its bars (marked slow, as there).

The JAX side runs its rasterizer's jnp oracles (use_pallas=False,
expand_backend="xla", patched into its `_build_cfg`) and its other Pallas
kernels (the coherent march, the patch filter) in interpret mode. Both
packages read one small env-BRDF LUT (tests/test_torch_render.py)."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gi_gs_tpu.config import OptimizationConfig as JaxOpt
from gi_gs_tpu.renderer import render as jax_render
from gi_gs_tpu.train import optim as joptim
from gi_gs_tpu.train import trainer as jtrainer

from gi_gs_tpu_torch import quality_gate as qg
from gi_gs_tpu_torch.config import OptimizationConfig
from gi_gs_tpu_torch.models.gaussians import FIELDS
from gi_gs_tpu_torch.train import optim, trainer

from test_torch_render import shared_lut  # noqa: F401  (autouse fixture)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import tools.quality_gate as jq  # noqa: E402

torch.set_num_threads(1)

SIZE = 32
LIGHT = 32
# the gates' keyword arguments at the test size, light 32 (two patch
# levels of the prefilter) (before the densification
# begins at iteration 500: the densify noise is drawn from jax.random in
# JAX and from torch.Generator in the port)
P1 = dict(size=SIZE, iters=4, n_train=4, n_test=2, capacity=2048,
          max_capacity=4096, n_gauss=300, n_init=1000, eval_every=2)
P2 = dict(size=SIZE, iters=2, n_train=4, n_test=2, capacity=1024,
          n_gauss=300, light_res=LIGHT)


@pytest.fixture(scope="module", autouse=True)
def jax_oracles():
    """The JAX gate's config with the rasterizer's jnp oracles."""
    orig = jq._build_cfg

    def build(*a, **k):
        c = orig(*a, **k)
        c.raster = dataclasses.replace(c.raster, use_pallas=False,
                                       expand_backend="xla")
        return c

    mp = pytest.MonkeyPatch()
    mp.setattr(jq, "_build_cfg", build)
    yield
    mp.undo()


def _cam_arrays(c):
    return [np.asarray(c.w2c), np.asarray(c.full_proj),
            np.asarray(c.cam_pos), float(c.tanfovx), float(c.tanfovy),
            float(c.fx), float(c.fy), int(c.width), int(c.height)]


@pytest.mark.parametrize("n,n_test", [(12, 4), (72, 8)])
def test_ring_cameras_and_split_match_jax(n, n_test):
    jcams = jq.ring_cameras(n, SIZE)
    pcams = qg.ring_cameras(n, SIZE, device="cpu")
    for j, p in zip(jcams, pcams):
        for a, b in zip(_cam_arrays(j), _cam_arrays(p)):
            np.testing.assert_array_equal(
                b.numpy() if torch.is_tensor(b) else b, a)
    jtr, jte = jq._split_ring(jcams, n_test)
    ptr, pte = qg._split_ring(pcams, n_test)
    idx = lambda sub, cams: [next(i for i, c in enumerate(cams) if c is s)
                             for s in sub]
    assert idx(ptr, pcams) == idx(jtr, jcams)
    assert idx(pte, pcams) == idx(jte, jcams)


# f32 ulps between JAX's and the port's GT fields, live and dead slots:
# features_dc, albedo and roughness by at most one (XLA and PyTorch's f32
# log and division by a constant), scaling within 1e-5 relative (the knn
# mean distance, an f32 cancellation); the rest bit-equal.
ULPS = {"features_dc": 1, "albedo": 1, "roughness": 1}


@pytest.mark.parametrize("roughness,metallic", [(0.4, 0.02), (0.08, 0.9)])
def test_gt_scene_matches_jax(roughness, metallic):
    j = jq.make_gt_scene(n=300, seed=0, capacity=512, roughness=roughness,
                         metallic=metallic)
    p = qg.make_gt_scene(n=300, seed=0, capacity=512, roughness=roughness,
                         metallic=metallic, device="cpu")
    for k in FIELDS:
        want, got = np.asarray(getattr(j, k)), getattr(p, k).numpy()
        assert got.shape == want.shape, k
        if k == "alive":
            np.testing.assert_array_equal(got, want)
            assert want.sum() == 300
        elif k == "scaling":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        else:
            ulps = np.abs(got.view(np.int32).astype(np.int64) -
                          want.view(np.int32).astype(np.int64))
            assert ulps.max() <= ULPS.get(k, 0), (k, ulps.max())


@pytest.mark.parametrize("res", [16, 64])
def test_gt_envmap_matches_jax(res):
    np.testing.assert_array_equal(qg.make_gt_envmap(res, device="cpu").numpy(),
                                  np.asarray(jq.make_gt_envmap(res)))


def test_phase1_gt_renders_match_jax():
    """The phase-1 gate's GT (white background) on 3 ring views."""
    jcfg = jq._build_cfg(SIZE, 512, 64, white_background=True)
    pcfg = qg._build_cfg(SIZE, 512, 64, white_background=True)
    jgt = jq.make_gt_scene(n=300, capacity=512)
    pgt = qg.make_gt_scene(n=300, capacity=512, device="cpu")
    fn = jax.jit(lambda p, c: jnp.clip(jax_render(
        c, p, jnp.ones(3), jcfg.raster, jcfg.gi, derive_normal=False,
        compute_occlusion=False)["render"], 0.0, 1.0))
    for jc, pc in list(zip(jq.ring_cameras(6, SIZE),
                           qg.ring_cameras(6, SIZE, device="cpu")))[::2]:
        want = np.asarray(fn(jgt, jc))
        got = qg.render_rgb(pcfg, pgt, pc, torch.ones(3)).numpy()
        assert 0.05 < want.mean() < 0.95
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("du", [0, 3])
def test_two_stage_lr_matches_jax(du):
    """The gate's lr multiplier, evaluated in f32 as JAX's (the JAX gate's
    lr_scale_fn for the committed protocol, refine_lr_scale 0.3 and no
    refine_final, copied here on int32 counts): bit-equal. Then the
    learning rates the port's optimizer takes with it against optax's
    over a few steps across the end of the densify window."""
    iters, rf0 = 10, 0.3
    rf1 = rf0
    span = max(iters - du, 1)

    def jax_fn(s):                 # tools/quality_gate.py:299-308
        frac = jnp.clip((s - du) / span, 0.0, 1.0)
        return jnp.where(s <= du, 1.0,
                         rf0 * jnp.exp(frac * jnp.log(rf1 / rf0)))

    port_fn = qg.two_stage_lr_scale(du)
    for s in range(0, iters + 3):
        a = np.float32(port_fn(s)).view(np.int32)
        b = np.float32(jax_fn(jnp.int32(s))).view(np.int32)
        assert a == b, s
    rng = np.random.RandomState(0)
    f = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in (
        ("xyz", (8, 3)), ("features_dc", (8, 1, 3)),
        ("features_rest", (8, 15, 3)), ("opacity", (8, 1)),
        ("normal", (8, 3)), ("albedo", (8, 3)), ("roughness", (8, 1)),
        ("metallic", (8, 1)), ("scaling", (8, 3)), ("rotation", (8, 4)))}
    tx_j = joptim.build_optimizer(JaxOpt(), 1.0, lr_scale_fn=jax_fn)
    tx_p = optim.build_optimizer(OptimizationConfig(), 1.0,
                                 lr_scale_fn=port_fn)
    jview = {k: jnp.asarray(v) for k, v in f.items()}
    pview = {k: torch.as_tensor(v) for k, v in f.items()}
    jst, pst = tx_j.init(jview), tx_p.init(pview)
    for _ in range(6):
        g = {k: rng.normal(0, 1e-3, v.shape).astype(np.float32)
             for k, v in f.items()}
        upd, jst = tx_j.update({k: jnp.asarray(v) for k, v in g.items()},
                               jst, jview)
        jview = jax.tree.map(lambda a, b: a + b, jview, upd)
        pview, pst = tx_p.step({k: torch.as_tensor(v) for k, v in g.items()},
                               pst, pview)
    # the summed updates (as test_torch_train's optimizer test: optax's f32
    # bias correction is off by up to ~3e-5 relative)
    for k in f:
        step = np.abs(np.asarray(jview[k]) - f[k]).max()
        np.testing.assert_allclose(
            pview[k].numpy(), np.asarray(jview[k]), rtol=0,
            atol=1e-4 * step + 4 * np.spacing(np.abs(f[k]).max()))


def recording(module, name, images):
    """module.<name> (a step factory) wrapped so the steps it makes append
    the image of each call (the gate's GT render of that view) to
    `images`."""
    make = getattr(module, name)

    def factory(*a, **k):
        step = make(*a, **k)

        def recorded(state, cam, image, *rest):
            images.append(np.array(image))
            return step(state, cam, image, *rest)

        recorded.__dict__.update(getattr(step, "__dict__", {}))
        return recorded

    return factory


def record_steps(monkeypatch, name):
    """Record the GT images the JAX gate's and the port gate's steps are
    given: (jax images, port images)."""
    jimg, pimg = [], []
    monkeypatch.setattr(jtrainer, name, recording(jtrainer, name, jimg))
    monkeypatch.setattr(trainer, name, recording(trainer, name, pimg))
    return jimg, pimg


def test_phase1_gate_matches_jax(monkeypatch):
    """Four steps of the phase-1 gate from its random init (no
    densification yet), evaluated at steps 2 and 4: the GT renders the
    steps were given within 1e-5, the same held-out PSNR within 1e-3 dB,
    the same population, capacity and trajectory."""
    jimg, pimg = record_steps(monkeypatch, "make_phase1_step")
    want = jq.run_phase1_gate(**P1)
    got = qg.run_phase1_gate(**P1, device="cpu")
    assert len(pimg) == len(jimg) == P1["iters"]
    for a, b in zip(pimg, jimg):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    for k in ("iters", "size", "alive", "capacity", "total_dropped"):
        assert got[k] == want[k], k
    assert got["alive"] == 1000
    for k in ("test_psnr", "test_psnr_min"):
        assert abs(got[k] - want[k]) < 1e-3, (k, got[k], want[k])
    assert len(got["trajectory"]) == len(want["trajectory"]) == 2
    for a, b in zip(got["trajectory"], want["trajectory"]):
        assert abs(a.pop("test_psnr") - b.pop("test_psnr")) <= 0.01
        assert a == b
    assert got["steps_per_s"] > 0


def _phase2_setup():
    cfg = qg._build_cfg(16, 256, 16)
    cfg.opt = dataclasses.replace(cfg.opt, densify_from_iter=10 ** 9)
    gt = qg.make_gt_scene(n=100, capacity=256, device="cpu")
    cam = qg.ring_cameras(4, 16, device="cpu")[0]
    tx = optim.build_optimizer(cfg.opt, 1.0)
    ltx = optim.build_light_optimizer(cfg.opt)
    step = trainer.make_phase2_step(cfg, 1.5, tx, ltx, device="cpu")
    image = qg.render_pbr_rgb(cfg, step.light_tables, gt,
                              qg.make_gt_envmap(16, device="cpu"), cam)
    params = gt.replace(albedo=torch.ones_like(gt.albedo))
    state = trainer.make_train_state(cfg, params, 1.0, tx=tx)
    return step, state, (cam, image, torch.ones(1, 16, 16), torch.zeros(3))


def test_fast_forward_makes_the_albedo_move():
    """fast_forward_counts adds it0 to every group of the Gaussians'
    optimizer and to nothing of the light's; then the first phase-2 step
    (iteration it0 + 1) moves the albedo, which a count of 0 (the JAX
    gate's r3/r4 rounds) leaves at its init."""
    step, state, args = _phase2_setup()
    ff = qg.fast_forward_counts(state, qg.PHASE2_IT0)
    assert {st["count"] for st in ff.opt_state.values()} == {qg.PHASE2_IT0}
    assert ff.light_opt_state["cubemap"]["count"] == 0
    assert all(ff.opt_state[g]["mu"] is state.opt_state[g]["mu"]
               for g in state.opt_state)
    init = state.params.albedo.clone()
    moved, _ = step(ff, *args, qg.PHASE2_IT0 + 1)
    assert (moved.params.albedo - init).abs().max() > 0.1
    assert moved.light_opt_state["cubemap"]["count"] == 1
    stuck, _ = step(state, *args, qg.PHASE2_IT0 + 1)
    assert torch.equal(stuck.params.albedo, init)


@pytest.mark.slow
def test_phase1_recovery():
    """tests/test_quality.py's reduced phase-1 config and bar, for the
    port."""
    r = qg.run_phase1_gate(size=64, iters=1200, n_train=16, n_test=2,
                           capacity=4096, max_capacity=16384, n_gauss=500,
                           n_init=2000, device="cpu")
    assert r["test_psnr"] > 19.0, r


@pytest.mark.slow
def test_phase2_recovery():
    """tests/test_quality.py's reduced phase-2 config and bars, for the
    port."""
    r = qg.run_phase2_gate(size=64, iters=200, n_train=8, n_test=2,
                           capacity=2048, n_gauss=500, light_res=64,
                           device="cpu")
    assert r["albedo_psnr"] > 18.0, r
    assert r["env_irradiance_corr"] > 0.75, r
