"""The port's cubemap prefilter, light and PBR shading against the JAX
reference on the CPU, forward and (for phase-2 training) backward. The
patch filter's plain versions are what CUDA tensors would send to
csrc/patch_fwd.cu and csrc/patch_bwd.cu."""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gi_gs_tpu.models import light as jax_light
from gi_gs_tpu.ops import cubemap as jcm
from gi_gs_tpu.ops import shading as jax_shading
from gi_gs_tpu.ops.pallas_patch import patch_apply_bwd, patch_apply_fwd

from gi_gs_tpu_torch.models import light as light_mod
from gi_gs_tpu_torch.ops import cubemap as cm
from gi_gs_tpu_torch.ops import shading

torch.set_num_threads(1)


def test_patch_plain_matches_ref_and_pallas():
    rng = np.random.RandomState(7)
    R = 64
    h, src_idx, W = jcm._patch_tables(R, 0.15, 0.99)
    t_h, t_src, t_W = cm._patch_tables(R, 0.15, 0.99)
    assert t_h == h
    np.testing.assert_array_equal(t_src, np.asarray(src_idx))
    np.testing.assert_array_equal(t_W, np.asarray(W))
    cmap = rng.rand(6, R, R, 3).astype(np.float32)
    ref = np.asarray(jcm._apply_patch_ref(jnp.asarray(cmap), src_idx, W, h))
    out = cm._apply_patch_plain(torch.as_tensor(cmap), torch.as_tensor(t_src),
                                torch.as_tensor(t_W), h)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    # the kernel's interface: W and the halo-padded faces
    E = R + 2 * h
    padded = cmap.reshape(-1, 3)[t_src.reshape(-1)].reshape(6, E, E, 3)
    padded = np.ascontiguousarray(padded.transpose(0, 3, 1, 2))
    pal = np.asarray(patch_apply_fwd(W, jnp.asarray(padded), R, 2 * h + 1, h,
                                     interpret=True))
    got = cm.patch_fwd(torch.as_tensor(t_W), torch.as_tensor(padded), R,
                       2 * h + 1, h)
    np.testing.assert_allclose(got.numpy(), pal, rtol=1e-5, atol=1e-6)
    # the border-strip gather path equals the full gather
    strip = cm._specular_apply_patch(torch.as_tensor(cmap),
                                     torch.as_tensor(t_src),
                                     torch.as_tensor(t_W), h)
    np.testing.assert_allclose(strip.numpy(), out.numpy(), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("R,h", [(256, 7), (128, 20), (64, 28), (64, 4)],
                         ids=["256", "128", "64", "base64"])
def test_patch_fwd_shape_covers_the_level(R, h):
    """`patch_fwd_shape` at the three patch levels of the 256 light and the
    64 light's one level: its ring fits the H100's 232,448 B of opt-in
    shared memory three CTAs to an SM (1 KB reserved each of 228 KB), each
    stage holds one row of the P weight planes and every channel's padded
    row at a shift of up to 3 floats, and the kernel's mapping (CTA
    (0, y, f), consumer thread x < R -> texel (f, y, x)) gives every
    output texel of the level to exactly one thread."""
    s = cm.patch_fwd_shape(R, h)
    P, E = 2 * h + 1, R + 2 * h
    assert s["smem"] <= 232448
    assert 3 * (s["smem"] + 1024) <= 228 * 1024
    assert s["slot"] >= ((3 + E + 3) & ~3) and s["slot"] % 4 == 0
    assert s["stage_floats"] >= P * R + 3 * s["slot"]
    assert s["stage_floats"] % 32 == 0 and (E * E) % 4 == 0
    assert 2 <= s["stages"] <= P
    assert s["threads"] - 32 >= R and s["threads"] % 32 == 0
    gx, gy, gz = s["grid"]
    assert (gx, gz) == (1, 6) and s["ctas"] == gy * gz
    count = np.zeros((6, R, R), np.int64)
    x = np.arange(s["threads"] - 32)
    x = x[x < R]
    for f in range(gz):
        for y in range(gy):
            np.add.at(count, (f, y, x), 1)
    assert (count == 1).all()


def test_build_mips_packed_matches_jax():
    """Base 64: levels 64 (patch filter), 32 and 16 (dense) + diffuse."""
    rng = np.random.RandomState(3)
    base = rng.uniform(0.0, 2.0, (6, 64, 64, 3)).astype(np.float32)
    spec, arrays = jax_light.build_prefilter_tables(64)
    jl = jax_light.build_mips_packed(jnp.asarray(base), spec, arrays)
    t_spec, t_arrays = light_mod.build_prefilter_tables(64, device="cpu")
    assert t_spec == spec
    tl = light_mod.build_mips_packed(torch.as_tensor(base), t_spec, t_arrays)
    assert [s.shape[1] for s in tl.specular] == [64, 32, 16]
    for a, b in zip(tl.specular, jl.specular):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(tl.diffuse.numpy(), np.asarray(jl.diffuse),
                               rtol=1e-5, atol=1e-5)


def test_sampling_and_envmap_match_jax():
    rng = np.random.RandomState(4)
    base = rng.rand(6, 16, 16, 3).astype(np.float32)
    dirs = rng.randn(500, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ref = np.asarray(jcm.sample_cubemap(jnp.asarray(base), jnp.asarray(dirs)))
    got = cm.sample_cubemap(torch.as_tensor(base), torch.as_tensor(dirs))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    env_j = np.asarray(jax_light.export_envmap(jnp.asarray(base), (16, 32)))
    env_t = light_mod.export_envmap(torch.as_tensor(base), (16, 32))
    np.testing.assert_allclose(env_t.numpy(), env_j, rtol=1e-5, atol=1e-6)
    mip_j = np.asarray(jcm.cubemap_mip(jnp.asarray(base)))
    np.testing.assert_allclose(cm.cubemap_mip(torch.as_tensor(base)).numpy(),
                               mip_j, rtol=1e-6)


def test_sample_brdf_lut_matches_jax():
    rng = np.random.RandomState(9)
    lut = rng.rand(32, 32, 2).astype(np.float32)
    nov, rough = (rng.rand(50, 1).astype(np.float32) for _ in range(2))
    want = jax_shading.sample_brdf_lut(*map(jnp.asarray, (lut, nov, rough)))
    got = shading.sample_brdf_lut(*map(torch.as_tensor, (lut, nov, rough)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_pbr_shading_chw_matches_jax(monkeypatch):
    """Split-sum shading of random G-buffer images against a prefiltered
    base-32 light (dense levels) — same LUT taps, same cubemap taps."""
    rng = np.random.RandomState(0)
    H, W = 12, 20
    spec, arrays = jax_light.build_prefilter_tables(32)
    base = rng.uniform(0, 1.5, (6, 32, 32, 3)).astype(np.float32)
    jl = jax_light.build_mips_packed(jnp.asarray(base), spec, arrays)
    tl = light_mod.CubemapLight(
        specular=tuple(torch.as_tensor(np.array(s)) for s in jl.specular),
        diffuse=torch.as_tensor(np.array(jl.diffuse)))
    n = rng.randn(3, H, W).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    v = rng.randn(3, H, W).astype(np.float32)
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    albedo, rough, metal, occ = (rng.rand(c, H, W).astype(np.float32)
                                 for c in (3, 1, 1, 1))
    mask = rng.rand(1, H, W) > 0.2
    # The LUT generator is compared at a small size; the shading itself
    # then reads one shared table (the 256 x 4096-sample build takes
    # ~15 s per package on one CPU thread).
    np.testing.assert_array_equal(shading._brdf_lut_np(16, 1024),
                                  jax_shading._brdf_lut_np(16, 1024))
    lut = jax_shading._brdf_lut_np(256, 64)
    for mod in (shading, jax_shading):
        monkeypatch.setattr(mod, "_brdf_lut_np", lambda *a: lut)
        mod._brdf_lut_quad.cache_clear()
    for kw in (dict(), dict(tone=True, gamma=True, metallic=metal)):
        jo = jax_shading.pbr_shading_chw(
            jl, *map(jnp.asarray, (n, v, albedo, rough, mask)),
            occlusion=jnp.asarray(occ),
            **{k: (jnp.asarray(x) if k == "metallic" else x)
               for k, x in kw.items()})
        to = shading.pbr_shading_chw(
            tl, *map(torch.as_tensor, (n, v, albedo, rough, mask)),
            occlusion=torch.as_tensor(occ),
            **{k: (torch.as_tensor(x) if k == "metallic" else x)
               for k, x in kw.items()})
        for key in jo:
            np.testing.assert_allclose(to[key].numpy(), np.asarray(jo[key]),
                                       rtol=1e-5, atol=1e-5, err_msg=key)
    for mod in (shading, jax_shading):
        mod._brdf_lut_quad.cache_clear()


# ---------------------------------------------------------------------------
# The light under autograd (phase-2 training)
# ---------------------------------------------------------------------------

def _patch_case(R=64, rough=0.15, seed=11):
    rng = np.random.RandomState(seed)
    h, src_idx, W = jcm._patch_tables(R, rough, 0.99)
    cmap = rng.rand(6, R, R, 3).astype(np.float32)
    g = rng.randn(6, R, R, 3).astype(np.float32)
    return h, src_idx, W, cmap, g


def test_patch_bwd_and_filter_gradient_match_jax():
    """The plain transpose `_patch_bwd_plain` (what CUDA tensors send to
    csrc/patch_bwd.cu) against the Pallas `patch_apply_bwd` in interpret
    mode, and the cubemap gradient of the whole filter (the Function's
    backward, then autograd of the halo gathers for the border) against
    jax.grad of `_specular_apply_patch` (its `_sap_bwd` segment sum), at
    R = 64. Tolerance 1e-5 absolute: the same products summed in another
    order."""
    h, src_idx, W, cmap, g = _patch_case()
    R, P = cmap.shape[1], 2 * h + 1
    t_W = torch.as_tensor(np.asarray(W))
    gt = torch.as_tensor(np.ascontiguousarray(g.transpose(0, 3, 1, 2)))
    want = np.asarray(patch_apply_bwd(W, jnp.asarray(gt.numpy()), R, P, h,
                                      interpret=True))
    got = cm.patch_bwd(t_W, gt, R, P, h)
    assert got.shape == (6, 3, R + 2 * h, R + 2 * h)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    jg = jax.grad(lambda c: (jcm._specular_apply_patch(c, src_idx, W, h)
                             * g).sum())(jnp.asarray(cmap))
    c = torch.tensor(cmap, requires_grad=True)
    out = cm._specular_apply_patch(c, torch.as_tensor(np.asarray(src_idx)),
                                   t_W, h)
    (out * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)


def test_patch_bwd_matches_jax_at_a_clamped_halo():
    """At R = 16 and roughness 0.36 the halo the NDF asks for (9 texels)
    is clamped to R // 2 = 8, so P = R + 1 and every padded texel gathers
    from the whole face: the plain transpose against the Pallas
    `patch_apply_bwd` in interpret mode (1e-5 absolute, the same products
    summed in another order)."""
    R, rough = 16, 0.36
    theta = math.acos(min(cm.ndf_cutoff(rough, 0.99), 1.0))
    assert int(math.ceil(theta / (2.0 / R) * 1.6)) + 2 > R // 2
    h, src_idx, W, cmap, g = _patch_case(R=R, rough=rough)
    assert h == R // 2
    P = 2 * h + 1
    gt = torch.as_tensor(np.ascontiguousarray(g.transpose(0, 3, 1, 2)))
    want = np.asarray(patch_apply_bwd(W, jnp.asarray(gt.numpy()), R, P, h,
                                      interpret=True))
    got = cm.patch_bwd(torch.as_tensor(np.asarray(W)), gt, R, P, h)
    assert got.shape == want.shape == (6, 3, R + 2 * h, R + 2 * h)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_patch_filter_gradient_survives_a_kernel_forward(monkeypatch):
    """On the card `patch_fwd` launches on raw pointers and returns a fresh
    tensor outside the autograd graph. Its gradient must still reach the
    cubemap, through the filter's own backward: here the forward is made
    graph-less the same way and the gradient is held against the plain
    filter's autograd gradient (1e-5 absolute, another summation order)."""
    h, src_idx, W, cmap, g = _patch_case(seed=12)
    t_src, t_W = torch.as_tensor(np.asarray(src_idx)), torch.as_tensor(
        np.asarray(W))
    c0 = torch.tensor(cmap, requires_grad=True)
    (cm._apply_patch_plain(c0, t_src, t_W, h) * torch.as_tensor(g)
     ).sum().backward()
    plain_fwd = cm.patch_fwd
    monkeypatch.setattr(cm, "patch_fwd",
                        lambda *a: plain_fwd(*a).detach().clone())
    calls = []
    plain_bwd = cm.patch_bwd
    monkeypatch.setattr(cm, "patch_bwd",
                        lambda *a: calls.append(1) or plain_bwd(*a))
    c = torch.tensor(cmap, requires_grad=True)
    (cm._specular_apply_patch(c, t_src, t_W, h) * torch.as_tensor(g)
     ).sum().backward()
    assert calls == [1]
    assert c.grad is not None
    np.testing.assert_allclose(c.grad.numpy(), c0.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_cubemap_mip_backward_matches_jax():
    """JAX's custom VJP: the bilinear sample of 0.25 * dout at the fine
    texel directions, not the pool's transpose (1e-6: the same taps)."""
    rng = np.random.RandomState(13)
    base = rng.rand(6, 32, 32, 3).astype(np.float32)
    dout = rng.randn(6, 16, 16, 3).astype(np.float32)
    want = jax.grad(lambda b: (jcm.cubemap_mip(b) * dout).sum())(
        jnp.asarray(base))
    b = torch.tensor(base, requires_grad=True)
    (cm.cubemap_mip(b) * torch.as_tensor(dout)).sum().backward()
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    transpose = np.repeat(np.repeat(dout, 2, 1), 2, 2) * 0.25
    assert np.abs(b.grad.numpy() - transpose).max() > 1e-2


def test_light_build_gradient_matches_jax():
    """d/d(base) of every level of the prefiltered light (the mip chain's
    backward, one patch level at 64, dense levels 32 and 16, the diffuse
    operator) against jax.grad of build_mips_packed. Tolerance 1e-5
    relative to the largest gradient (sums in another order)."""
    rng = np.random.RandomState(14)
    base = rng.uniform(0.0, 2.0, (6, 64, 64, 3)).astype(np.float32)
    spec, arrays = jax_light.build_prefilter_tables(64)
    ws = [rng.randn(6, r, r, 3).astype(np.float32) for r in (64, 32, 16, 16)]

    def jloss(b):
        lt = jax_light.build_mips_packed(b, spec, arrays)
        return sum((x * w).sum() for x, w in
                   zip(lt.specular + (lt.diffuse,), ws))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(base)))
    t_spec, t_arrays = light_mod.build_prefilter_tables(64, device="cpu")
    b = torch.tensor(base, requires_grad=True)
    lt = light_mod.build_mips_packed(b, t_spec, t_arrays)
    sum((x * torch.as_tensor(w)).sum() for x, w in
        zip(lt.specular + (lt.diffuse,), ws)).backward()
    np.testing.assert_allclose(b.grad.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_latlong_sampler_and_env_tv_match_jax():
    """The lat-long sampler equals JAX's make_latlong_sampler (1e-6: the
    same taps) and export_envmap (rtol 1e-4, atol 5e-6 as
    tests/test_cubemap.py: its taps come from an f64 direction grid,
    export_envmap's from f32), and env-TV and its cubemap gradient equal
    JAX's env_tv_loss: both transpose the sampler by the differences of an
    f32 cumsum over the sorted taps, rounded in another association, so
    the gradient is compared at 1e-4 of its largest magnitude."""
    from gi_gs_tpu.train import trainer as jtrainer
    from gi_gs_tpu_torch.train import trainer
    rng = np.random.RandomState(15)
    base = rng.uniform(0.0, 2.0, (6, 16, 16, 3)).astype(np.float32)
    env = light_mod.make_latlong_sampler(16, (32, 64))(torch.as_tensor(base))
    np.testing.assert_allclose(
        env.numpy(), light_mod.export_envmap(torch.as_tensor(base),
                                             (32, 64)).numpy(),
        rtol=1e-4, atol=5e-6)
    np.testing.assert_allclose(
        env.numpy(), np.asarray(jax_light.make_latlong_sampler(16, (32, 64))(
            jnp.asarray(base))), rtol=1e-6, atol=1e-6)
    jv, jg = jax.value_and_grad(jtrainer.env_tv_loss)(jnp.asarray(base))
    b = torch.tensor(base, requires_grad=True)
    v = trainer.env_tv_loss(b)
    v.backward()
    assert float(v.detach()) == pytest.approx(float(jv), rel=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(b.grad.numpy(), jg, rtol=0,
                               atol=1e-4 * np.abs(jg).max())


def test_pbr_shading_chw_gradients_match_jax(monkeypatch):
    """Gradients of split-sum shading (render, diffuse and specular
    outputs against random cotangents) with respect to albedo, roughness,
    metallic, every specular mip and the diffuse light, against jax.grad
    of the JAX shading (same shared LUT as the forward test above).
    Tolerance rtol 1e-4, atol 1e-5 x the largest gradient: the same taps,
    scatter-adds in another order."""
    rng = np.random.RandomState(16)
    H, W = 12, 20
    spec, arrays = jax_light.build_prefilter_tables(32)
    base = rng.uniform(0, 1.5, (6, 32, 32, 3)).astype(np.float32)
    jl = jax_light.build_mips_packed(jnp.asarray(base), spec, arrays)
    lights = [np.array(s) for s in jl.specular] + [np.array(jl.diffuse)]
    n = rng.randn(3, H, W).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    v = rng.randn(3, H, W).astype(np.float32)
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    albedo, rough, metal, occ = (rng.rand(c, H, W).astype(np.float32)
                                 for c in (3, 1, 1, 1))
    rough = rough * 0.96 + 0.04
    mask = rng.rand(1, H, W) > 0.2
    cots = [rng.randn(3, H, W).astype(np.float32) for _ in range(3)]
    lut = jax_shading._brdf_lut_np(256, 64)
    for mod in (shading, jax_shading):
        monkeypatch.setattr(mod, "_brdf_lut_np", lambda *a: lut)
        mod._brdf_lut_quad.cache_clear()
    keys = ("render_rgb", "diffuse_rgb", "specular_rgb")

    def jloss(a, r, m, *lt):
        o = jax_shading.pbr_shading_chw(
            jax_light.CubemapLight(specular=tuple(lt[:-1]), diffuse=lt[-1]),
            jnp.asarray(n), jnp.asarray(v), a, r, jnp.asarray(mask),
            occlusion=jnp.asarray(occ), metallic=m, gamma=True)
        return sum((o[k] * c).sum() for k, c in zip(keys, cots))

    want = jax.grad(jloss, argnums=tuple(range(3 + len(lights))))(
        *map(jnp.asarray, [albedo, rough, metal] + lights))
    leaves = [torch.tensor(x, requires_grad=True)
              for x in [albedo, rough, metal] + lights]
    o = shading.pbr_shading_chw(
        light_mod.CubemapLight(specular=tuple(leaves[3:-1]),
                               diffuse=leaves[-1]),
        torch.as_tensor(n), torch.as_tensor(v), leaves[0], leaves[1],
        torch.as_tensor(mask), occlusion=torch.as_tensor(occ),
        metallic=leaves[2], gamma=True)
    sum((o[k] * torch.as_tensor(c)).sum() for k, c in zip(keys, cots)
        ).backward()
    for leaf, w in zip(leaves, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())
    for mod in (shading, jax_shading):
        mod._brdf_lut_quad.cache_clear()
