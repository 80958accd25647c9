"""The port's cubemap prefilter, light and PBR shading against the JAX
reference on the CPU. The patch filter's plain version is what CUDA
tensors would send to csrc/patch_fwd.cu."""
import numpy as np
import torch
import jax.numpy as jnp

from gi_gs_tpu.models import light as jax_light
from gi_gs_tpu.ops import cubemap as jcm
from gi_gs_tpu.ops import shading as jax_shading
from gi_gs_tpu.ops.pallas_patch import patch_apply_fwd

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
