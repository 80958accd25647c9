"""The port's BSDF primitives (gi_gs_tpu_torch/ops/bsdf.py) against
gi_gs_tpu/ops/bsdf.py on the CPU: every function's value and its
gradient with respect to every float input (autograd against jax.grad of
the same weighted sum), on numpy-seeded inputs. f32 on both sides:
rtol 1e-5, atol 1e-5 x the largest magnitude."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gi_gs_tpu.ops import bsdf as jbsdf

from gi_gs_tpu_torch.ops import bsdf

torch.set_num_threads(1)

SHAPE = (4, 5, 3)


def _u(rng, shape=SHAPE, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _lobes(rng):
    nrm, wi, wo = _u(rng), _u(rng), _u(rng)
    return nrm, wi, wo


# name -> (input builder (rng -> tuple of arrays), call(module, *inputs))
CASES = {
    "reflect": (lambda r: (_u(r), _u(r)), lambda m, x, n: m.reflect(x, n)),
    "safe_normalize": (lambda r: (_u(r),), lambda m, x: m.safe_normalize(x)),
    "prepare_shading_normal": (
        lambda r: (_u(r), _u(r), _u(r), _u(r), _u(r), _u(r)),
        lambda m, pos, vp, pn, sn, st, gn: m.prepare_shading_normal(
            pos, vp, pn, sn, st, gn)),
    "prepare_shading_normal_flat": (
        lambda r: (_u(r), _u(r), _u(r), _u(r), _u(r)),
        lambda m, pos, vp, sn, st, gn: m.prepare_shading_normal(
            pos, vp, None, sn, st, gn, two_sided_shading=False,
            opengl=False)),
    "lambert": (lambda r: (_u(r), _u(r)), lambda m, n, wi: m.lambert(n, wi)),
    "fresnel_schlick": (
        lambda r: (_u(r, lo=0, hi=1), _u(r, (4, 5, 1), 0.0, 1.0)),
        lambda m, f0, c: m.fresnel_schlick(f0, 1.0, c)),
    "ndf_ggx": (lambda r: (_u(r, (4, 5, 1), 0.01, 1.0),
                           _u(r, (4, 5, 1), 0.0, 1.0)),
                lambda m, a, c: m.ndf_ggx(a, c)),
    "lambda_ggx": (lambda r: (_u(r, (4, 5, 1), 0.01, 1.0),
                              _u(r, (4, 5, 1), 0.0, 1.0)),
                   lambda m, a, c: m.lambda_ggx(a, c)),
    "masking_smith_ggx_correlated": (
        lambda r: (_u(r, (4, 5, 1), 0.01, 1.0), _u(r, (4, 5, 1), 0.0, 1.0),
                   _u(r, (4, 5, 1), 0.0, 1.0)),
        lambda m, a, ci, co: m.masking_smith_ggx_correlated(a, ci, co)),
    "frostbite_diffuse": (
        lambda r: _lobes(r) + (_u(r, (4, 5, 1), 0.0, 1.0),),
        lambda m, n, wi, wo, lr: m.frostbite_diffuse(n, wi, wo, lr)),
    "phong": (lambda r: _lobes(r),
              lambda m, n, wi, wo: m.phong(n, wo, wi, 8.0)),
    "pbr_specular": (
        lambda r: _lobes(r) + (_u(r, lo=0, hi=1),
                               _u(r, (4, 5, 1), 0.0, 1.0)),
        lambda m, n, wi, wo, col, a: m.pbr_specular(col, n, wo, wi, a)),
    "pbr_bsdf_lambert": (
        lambda r: (_u(r, lo=0, hi=1), _u(r, lo=0, hi=1), _u(r), _u(r),
                   _u(r) * 3, _u(r) * 3),
        lambda m, kd, arm, pos, n, vp, lp: m.pbr_bsdf(kd, arm, pos, n, vp,
                                                      lp)),
    "pbr_bsdf_frostbite": (
        lambda r: (_u(r, lo=0, hi=1), _u(r, lo=0, hi=1), _u(r), _u(r),
                   _u(r) * 3, _u(r) * 3),
        lambda m, kd, arm, pos, n, vp, lp: m.pbr_bsdf(
            kd, arm, pos, n, vp, lp, bsdf="frostbite")),
    "xfm_points": (lambda r: (_u(r, (2, 7, 3)), _u(r, (2, 4, 4))),
                   lambda m, p, mat: m.xfm_points(p, mat)),
    "xfm_vectors": (lambda r: (_u(r, (2, 7, 3)), _u(r, (2, 4, 4))),
                    lambda m, v, mat: m.xfm_vectors(v, mat)),
}
for _loss in ("l1", "mse", "smape", "relmse"):
    for _tm in ("none", "log_srgb"):
        CASES[f"image_loss_{_loss}_{_tm}"] = (
            lambda r: (_u(r, (3, 8, 8), 0.0, 4.0), _u(r, (3, 8, 8), 0.0, 4.0)),
            lambda m, a, b, _l=_loss, _t=_tm: m.image_loss(a, b, _l, _t))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * (np.abs(want).max() + 1e-12))


@pytest.mark.parametrize("name", sorted(CASES))
def test_bsdf_value_and_gradient_match_jax(name):
    build, call = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    xs = build(rng)
    want = np.asarray(call(jbsdf, *map(jnp.asarray, xs)))
    weight = rng.normal(size=want.shape).astype(np.float32)
    ts = [torch.tensor(x, requires_grad=True) for x in xs]
    got = call(bsdf, *ts)
    _close(got.detach().numpy(), want)
    jg = jax.grad(lambda *a: (call(jbsdf, *a) * weight).sum(),
                  argnums=tuple(range(len(xs))))(*map(jnp.asarray, xs))
    (got * torch.as_tensor(weight)).sum().backward()
    assert any(np.abs(np.asarray(g)).max() > 0 for g in jg)
    for t, g in zip(ts, jg):
        _close(t.grad.numpy(), g)
