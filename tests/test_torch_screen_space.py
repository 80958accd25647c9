"""The port's screen-space operators against the JAX reference on the
CPU: SSAO/SSR through the plain version of the csrc/gi_march.cu kernel
vs the jnp oracle (exact), vs the Pallas exact kernel in interpret mode
(within its RGB quantisation bound) and vs the frozen goldens; the
block-coherent march (plain version of csrc/gi_march_coherent.cu) and its
centre-offset table vs the Pallas coherent kernel; the backend dispatch
and SSR's albedo-only gradient."""
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gi_gs_tpu.ops import pallas_gi
from gi_gs_tpu.ops import screen_space as jss

from gi_gs_tpu_torch.ops import screen_space as tss

from march_scenes import degenerate_centres

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
SMALL = dict(radius=0.8, bias=0.01, thick=0.05, delta=0.25, step=4, start=2)


def _scene(h, w, seed=0):
    """Smooth-ish depth with a hard edge, unit normals and a few
    background pixels, like a rendered G-buffer."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    z = 2.5 + 0.4 * np.sin(xs / 11.0) + 0.3 * np.cos(ys / 7.0)
    z += 0.05 * rng.rand(h, w).astype(np.float32)
    z[:, w // 2:] += 0.8
    fx = fy = float(np.float32(0.9 * w))
    pos = np.stack([(xs - w / 2.0) / fx * z, (ys - h / 2.0) / fy * z, z],
                   0).astype(np.float32)
    n = rng.randn(3, h, w).astype(np.float32)
    n[2] -= 1.5
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    n[:, :2, :3] = 0.0
    pos[:, :2, :3] = 0.0
    return n, pos, fx, fy


def _ssr_inputs(h, w, seed):
    rng = np.random.RandomState(seed)
    return [rng.rand(c, h, w).astype(np.float32) * s
            for c, s in ((3, 1.0), (3, 1.0), (1, 1.0), (1, 1.0), (3, 0.2))]


@pytest.mark.parametrize("gi", [SMALL, {}], ids=["small", "defaults"])
def test_ssao_ssr_match_jnp_oracle(gi):
    h, w = (16, 40) if gi else (12, 24)
    n, pos, fx, fy = _scene(h, w, seed=1)
    rgb, albedo, rough, metal, f0 = _ssr_inputs(h, w, seed=2)
    jp = jss.GIParams(**gi, backend="jnp")
    tp = tss.GIParams(**gi, backend="jnp")
    T = torch.as_tensor
    ao_j = np.asarray(jss.ssao(jnp.asarray(n), jnp.asarray(pos), fx, fy, jp))
    ao_t = tss.ssao(T(n), T(pos), fx, fy, tp).numpy()
    np.testing.assert_allclose(ao_t, ao_j, rtol=1e-5, atol=1e-5)
    cj, gj = jss.ssr(*map(jnp.asarray, (n, pos, rgb, albedo, rough, metal,
                                        f0)), fx, fy, jp)
    ct, gt = tss.ssr(*map(T, (n, pos, rgb, albedo, rough, metal, f0)),
                     fx, fy, tp)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-5)


def test_ssr_matches_pallas_exact_within_quantisation():
    """The Pallas exact kernel packs RGB into 11-11-10 bits; the port reads
    f32 RGB like the jnp oracle, so the two agree within that kernel's own
    quantisation bound (tests/test_pallas_gi.py)."""
    h, w = 16, 144
    n, pos, fx, fy = _scene(h, w, seed=1)
    rgb, albedo, rough, metal, f0 = _ssr_inputs(h, w, seed=2)
    jp = jss.GIParams(**SMALL, backend="pallas_exact")
    cj, gj = pallas_gi.ssr_pallas(
        *map(jnp.asarray, (n, pos, rgb, albedo, rough, metal, f0)), fx, fy,
        jp, interpret=True, mode="exact")
    ct, gt = tss.ssr(*map(torch.as_tensor, (n, pos, rgb, albedo, rough,
                                            metal, f0)),
                     fx, fy, tss.GIParams(**SMALL, backend="pallas_exact"))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=5e-3,
                               atol=5e-3)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=5e-3,
                               atol=5e-3)


def test_screen_space_matches_golden():
    """The goldens hold the exact march (JAX backend "jnp")."""
    g = np.load(os.path.join(FIX, "golden_screen_space.npz"))
    p = tss.GIParams(**SMALL, backend="jnp")
    T = torch.as_tensor
    normal, pos = T(g["normal"]), T(g["pos"])
    fx, fy = float(g["fx"]), float(g["fy"])
    ao = tss.ssao(normal, pos, fx, fy, p)[0].numpy()
    np.testing.assert_allclose(ao, g["ao"], atol=1e-5)
    h, w = g["ao"].shape
    color, abd = tss.ssr(normal, pos, T(g["rgb"]), T(g["albedo"]),
                         torch.full((1, h, w), 0.4), torch.zeros(1, h, w),
                         torch.full((3, h, w), 0.04), fx, fy, p)
    np.testing.assert_allclose(color.numpy(), g["ssr_color"], atol=1e-5)
    np.testing.assert_allclose(abd.numpy(), g["ssr_abd"], atol=1e-5)
    nrm_w, dpos = tss.depth_to_normal(pos[2], torch.eye(4), fx, fy)
    np.testing.assert_allclose(nrm_w.numpy(), g["d2n_normal"], atol=1e-5)
    np.testing.assert_allclose(dpos.numpy(), g["d2n_pos"], atol=1e-5)


def test_depth_to_normal_matches_jax():
    rng = np.random.RandomState(5)
    _, pos, fx, fy = _scene(20, 30, seed=3)
    depth = pos[2].copy()
    depth[5:8, 10:14] = 0.0          # holes trip the 5x5 validity window
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
    nj, pj = jss.depth_to_normal(jnp.asarray(depth), jnp.asarray(w2c), fx, fy)
    nt, pt = tss.depth_to_normal(torch.as_tensor(depth),
                                 torch.as_tensor(w2c), fx, fy)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)


def test_direction_table_matches_pallas_gi():
    for gi in (SMALL, {}):
        tab_j, sw_j, n_j = pallas_gi._direction_table(jss.GIParams(**gi))
        tab_t, sw_t, n_t = tss.direction_table(tss.GIParams(**gi))
        np.testing.assert_array_equal(tab_t, tab_j)
        assert (sw_t, n_t) == (sw_j, n_j)


# ---------------------------------------------------------------------------
# The block-coherent march (GIParams.backend "pallas", the default)
# ---------------------------------------------------------------------------

def _padded_table_jax(n, pos, dirs, fx, fy, p):
    """JAX's _centre_offset_table on the G-buffer zero-padded to (16, 128)
    multiples, as _march_pallas calls it."""
    h, w = pos.shape[1:]
    hp, wp = -(-h // 16) * 16, -(-w // 128) * 128
    pad = ((0, 0), (0, hp - h), (0, wp - w))
    return np.asarray(pallas_gi._centre_offset_table(
        jnp.pad(jnp.asarray(n), pad), jnp.pad(jnp.asarray(pos), pad),
        jnp.asarray(dirs), jnp.float32(fx), jnp.float32(fy), h, w, p,
        (hp // 16, wp // 128)))


@pytest.mark.parametrize("h,w,case", [
    pytest.param(32, 200, "scene", id="32-200"),
    pytest.param(16, 144, "scene", id="16-144"),
    pytest.param(48, 160, "scene", id="48-160"),
    pytest.param(48, 272, "degenerate", id="48-272-degenerate"),
    pytest.param(20, 30, "start_eq_step", id="20-30-start_eq_step"),
    pytest.param(20, 30, "start_past_step", id="20-30-start_past_step")])
def test_centre_offset_table_matches_pallas_gi(h, w, case):
    """Integer keys, so equal or not: no mismatch is allowed. When the
    last column block's centre (column 128 k + 64) lies past the image, as
    at W = 144, 160, 272 and 800 but not 200, it sits in the zero padding
    (a zero normal at the origin), as on the TPU. The degenerate case adds
    centres with normals at +-up and of length 0 and a centre at z = 1e-6
    whose offsets are clipped to +-2047 (march_scenes.degenerate_centres);
    with start >= step both sides give the zero table [nby, nbx, nd, 1]."""
    gi = dict(SMALL)
    if case == "degenerate":
        n, pos, fx, fy = degenerate_centres(h, w, seed=1)
    else:
        n, pos, fx, fy = _scene(h, w, seed=1)
        gi.update({"start_eq_step": dict(start=4),
                   "start_past_step": dict(start=6)}.get(case, {}))
    p = tss.GIParams(**gi)
    dirs = tss.direction_table(p)[0]
    want = _padded_table_jax(n, pos, dirs, fx, fy, jss.GIParams(**gi))
    got = tss.centre_offset_table(torch.as_tensor(n), torch.as_tensor(pos),
                                  torch.as_tensor(dirs), fx, fy, p)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert int((got.numpy() != want).sum()) == 0
    if case.startswith("start"):
        assert got.shape[3] == 1 and not got.any()
        return
    # a padded-centre block projects every sample to the image centre:
    # its column offset is the image centre's minus the block centre's,
    # whatever the direction and step
    centre = (w // 128) * 128 + 64
    if centre >= w:
        dx = got.numpy()[:, -1] % 4096 - 2048
        assert (dx == round(w / 2.0) - centre).all()
    if case == "degenerate":
        dy, dx = got.numpy() // 4096 - 2048, got.numpy() % 4096 - 2048
        assert (np.maximum(np.abs(dx), np.abs(dy))[1, 1] == 2047).any()


@pytest.mark.parametrize("start", [4, 6], ids=["start_eq_step",
                                              "start_past_step"])
@pytest.mark.parametrize("mode", ["coherent", "exact"])
def test_start_not_below_step_matches_pallas_gi(mode, start):
    """With start >= step the march takes no step, as in JAX: SSAO is 1 on
    every pixel and SSR 0, for the port's coherent and exact marches alike
    (plain versions) against `ssao_pallas` / `ssr_pallas` in interpret
    mode. The coherent march's zero table [nby, nbx, nd, 1] is JAX's
    (pallas_gi.py:429-430)."""
    h, w = 20, 30
    n, pos, fx, fy = _scene(h, w, seed=1)
    rgb, albedo, rough, metal, f0 = _ssr_inputs(h, w, seed=2)
    backend = "pallas" if mode == "coherent" else "pallas_exact"
    gi = dict(SMALL, start=start)
    jp = jss.GIParams(**gi, backend=backend)
    tp = tss.GIParams(**gi, backend=backend)
    J, T = jnp.asarray, torch.as_tensor
    ao_j = np.asarray(pallas_gi.ssao_pallas(J(n), J(pos), fx, fy, jp,
                                            interpret=True, mode=mode))
    ao_t = tss.ssao(T(n), T(pos), fx, fy, tp).numpy()
    np.testing.assert_array_equal(ao_t, ao_j)
    assert float(ao_t.sum()) == h * w
    ins = (n, pos, rgb, albedo, rough, metal, f0)
    cj, gj = pallas_gi.ssr_pallas(*map(J, ins), fx, fy, jp, interpret=True,
                                  mode=mode)
    ct, gt = tss.ssr(*map(T, ins), fx, fy, tp)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert not ct.numpy().any()


@pytest.mark.parametrize("h,w", [(32, 200), (16, 144)])
def test_coherent_ssao_ssr_match_pallas_coherent(h, w):
    """The port's coherent march (plain version of
    csrc/gi_march_coherent.cu) against the Pallas coherent kernel in
    interpret mode: SSAO to 1e-5 (same hits, sums in another order), SSR
    within the Pallas kernel's 11-11-10 RGB quantisation bound (5e-3, as
    the exact march's test above)."""
    n, pos, fx, fy = _scene(h, w, seed=1)
    rgb, albedo, rough, metal, f0 = _ssr_inputs(h, w, seed=2)
    jp = jss.GIParams(**SMALL)
    tp = tss.GIParams(**SMALL)
    assert tp.backend == "pallas"
    ao_j = np.asarray(pallas_gi.ssao_pallas(
        jnp.asarray(n), jnp.asarray(pos), fx, fy, jp, interpret=True,
        mode="coherent"))
    ao_t = tss.ssao(torch.as_tensor(n), torch.as_tensor(pos), fx, fy, tp)
    np.testing.assert_allclose(ao_t.numpy(), ao_j, rtol=1e-5, atol=1e-5)
    cj, gj = pallas_gi.ssr_pallas(
        *map(jnp.asarray, (n, pos, rgb, albedo, rough, metal, f0)), fx, fy,
        jp, interpret=True, mode="coherent")
    ct, gt = tss.ssr(*map(torch.as_tensor, (n, pos, rgb, albedo, rough,
                                            metal, f0)), fx, fy, tp)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=5e-3,
                               atol=5e-3)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=5e-3,
                               atol=5e-3)
    # the exact march gives another occlusion on this scene
    ao_x = tss.ssao(torch.as_tensor(n), torch.as_tensor(pos), fx, fy,
                    tss.GIParams(**SMALL, backend="pallas_exact"))
    assert float((ao_x - ao_t).abs().max()) > 0.05


def test_default_gi_params_run_the_coherent_march():
    """Default GIParams (backend "pallas") select the coherent march, as
    in JAX: the port's SSAO equals JAX's default SSAO (to 1e-5, sums in
    another order) at the default direction grid."""
    n, pos, fx, fy = _scene(16, 144, seed=4)
    assert tss.GIParams().backend == jss.GIParams().backend == "pallas"
    want = np.asarray(jss.ssao(jnp.asarray(n), jnp.asarray(pos), fx, fy,
                               jss.GIParams()))
    got = tss.ssao(torch.as_tensor(n), torch.as_tensor(pos), fx, fy,
                   tss.GIParams())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_ssr_gradient_is_albedo_only(backend):
    """JAX's SSR passes gradient to albedo only (color = stop_gradient(gd)
    * albedo): d(sum color)/d(albedo) = gd, nothing to the G-buffer, RGB,
    f0, roughness or metallic. The port's albedo gradient equals JAX's
    (exactly for the exact march; within the Pallas RGB quantisation,
    5e-3, for the coherent one)."""
    h, w = 16, 144
    n, pos, fx, fy = _scene(h, w, seed=3)
    ins = (n, pos) + tuple(_ssr_inputs(h, w, seed=5))
    jp = jss.GIParams(**SMALL, backend=backend)
    jgrads = jax.grad(lambda *a: jss.ssr(*a, fx, fy, jp)[0].sum(),
                      argnums=tuple(range(7)))(*map(jnp.asarray, ins))
    leaves = [torch.tensor(a, requires_grad=True) for a in ins]
    color, gd = tss.ssr(*leaves, fx, fy, tss.GIParams(**SMALL,
                                                      backend=backend))
    color.sum().backward()
    tol = 1e-6 if backend == "jnp" else 5e-3
    np.testing.assert_allclose(leaves[3].grad.numpy(), gd.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(leaves[3].grad.numpy(), np.asarray(jgrads[3]),
                               rtol=tol, atol=tol)
    assert np.abs(np.asarray(jgrads[3])).max() > 0
    for i in (0, 1, 2, 4, 5, 6):
        assert not np.asarray(jgrads[i]).any()
        assert leaves[i].grad is None or not leaves[i].grad.any(), i


def test_plain_march_sqrt_is_correctly_rounded():
    """The plain marches' f32 square root (`_sqrt`, in `_unit3` and the
    offset table) is the correctly rounded one, as the kernels' `sqrtf`
    and the card's `torch.sqrt`: PyTorch's vectorised f32 `sqrt` on the
    CPU is off by an ulp on ~0.7% of inputs, enough to move a sample to
    the next pixel and flip a ray, so the CPU and the card built different
    keys from one G-buffer at 800x800. numpy's f32 sqrt is IEEE."""
    rng = np.random.RandomState(0)
    x = np.exp(rng.uniform(np.log(1e-30), np.log(1e30), 1 << 20)
               ).astype(np.float32)
    got = tss._sqrt(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.sqrt(x).view(np.int32))
    v = rng.randn(3, 64, 64).astype(np.float32) * 3
    f = np.float32
    n = np.maximum(np.sqrt((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2]),
                   f(1e-20))
    np.testing.assert_array_equal(tss._unit3(torch.as_tensor(v)).numpy(),
                                  v / n[None])


def test_depth_normal_rotation_is_a_fixed_order_sum():
    """depth_to_normal rotates its normals to world as (M[i, 0] n0 +
    M[i, 1] n1) + M[i, 2] n2, one rounding per elementwise op, so the CPU
    and the card give the same bits. A BLAS einsum rounds as its library
    goes (fused multiply-adds on the CPU): with it, chip_smoke's card-vs-CPU
    normal gradients (phase 9) left their tolerance."""
    rng = np.random.RandomState(3)
    depth = torch.as_tensor(rng.uniform(1.0, 3.0, (24, 32)).astype(
        np.float32))
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                    2 * (x * z + w * y)],
                   [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                    2 * (y * z - w * x)],
                   [2 * (x * z - w * y), 2 * (y * z + w * x),
                    1 - 2 * (x * x + y * y)]]
    w2c = torch.as_tensor(w2c)
    n_cam, _ = tss.depth_to_normal(depth, torch.eye(4), 40.0, 40.0)
    got, _ = tss.depth_to_normal(depth, w2c, 40.0, 40.0)
    m = w2c[:3, :3].T
    want = torch.stack([m[i, 0] * n_cam[0] + m[i, 1] * n_cam[1] +
                        m[i, 2] * n_cam[2] for i in range(3)])
    assert float(n_cam.abs().max()) > 0.5
    assert torch.equal(got, want)
