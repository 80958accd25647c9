"""The port's gather transposes against the JAX package's custom VJPs on
the CPU: `take_rows` (JAX's `take_rows` / `take_rows3`), the strip gather
of `pad_cubemap`, the patch filter's VJP (`_sap_bwd`) and the lat-long
sampler's sorted-gather-and-cumsum backward (`make_latlong_sampler`), and
a graph test that the light's backward holds no autograd index backward.
The card runs the same Functions in tests/test_torch_kernels_cuda.py."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gi_gs_tpu.models import light as jax_light
from gi_gs_tpu.ops import cubemap as jcm

from gi_gs_tpu_torch.models import light as light_mod
from gi_gs_tpu_torch.ops import cubemap as cm
from gi_gs_tpu_torch.ops import shading
from gi_gs_tpu_torch.train import trainer

from test_torch_render import shared_lut  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)


def _vjp(fn, *args, cot):
    out, pull = jax.vjp(fn, *args)
    return np.asarray(out), [np.asarray(g) for g in pull(jnp.asarray(cot))]


@pytest.mark.parametrize("rows", [17, 1734])
@pytest.mark.parametrize("C", [3, 8, 12])
def test_take_rows_matches_jax(C, rows):
    """20,000 indices [100, 200] into `rows` rows (~1,176 or ~12 per row;
    1,734 is the 16^2 diffuse cube's quad table): the forward equal, the
    backward against jax.vjp of `take_rows3` (C = 3) or `take_rows`
    within 2e-6 x the largest summed row (the same f32 sums of up to
    ~1,300 terms, in another order)."""
    rng = np.random.RandomState(C * rows)
    flat = rng.randn(rows, C).astype(np.float32)
    idx = rng.randint(0, rows, (100, 200))
    g = rng.randn(100, 200, C).astype(np.float32)
    jfn = jcm.take_rows3 if C == 3 else jcm.take_rows
    want, (want_g,) = _vjp(lambda f: jfn(f, jnp.asarray(idx, jnp.int32)),
                           jnp.asarray(flat), cot=g)
    f = torch.tensor(flat, requires_grad=True)
    out = cm.take_rows(f, torch.as_tensor(idx))
    assert out.shape == (100, 200, C)
    np.testing.assert_array_equal(out.detach().numpy(), want)
    out.backward(torch.as_tensor(g))
    assert f.grad.shape == (rows, C)
    np.testing.assert_allclose(f.grad.numpy(), want_g, rtol=0,
                               atol=2e-6 * np.abs(want_g).max())


@pytest.mark.parametrize("C", [3, 1])
def test_pad_cubemap_matches_jax(C):
    """The 1-texel halo of a 64^2 cube: the padded faces equal JAX's
    (`take_rows3` strips for C = 3, a plain gather otherwise), and the
    cubemap cotangent within 1e-6 (each halo texel adds one to three
    cotangents onto its source)."""
    rng = np.random.RandomState(3 + C)
    cube = rng.rand(6, 64, 64, C).astype(np.float32)
    g = rng.randn(6, 66, 66, C).astype(np.float32)
    want, (want_g,) = _vjp(jcm.pad_cubemap, jnp.asarray(cube), cot=g)
    c = torch.tensor(cube, requires_grad=True)
    out = cm.pad_cubemap(c)
    np.testing.assert_array_equal(out.detach().numpy(), want)
    out.backward(torch.as_tensor(g))
    np.testing.assert_allclose(c.grad.numpy(), want_g, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rough", [0.08, 0.36])
def test_patch_filter_vjp_matches_jax(rough):
    """The patch level of a base-64 light at the first and the last
    specular roughness: forward and cubemap cotangent against
    jax.vjp(_specular_apply_patch) (the Pallas kernels in interpret mode,
    `_sap_bwd`'s segment sum over the halo ring). 1e-5 absolute: the same
    products and ring sums in another order."""
    R = 64
    rng = np.random.RandomState(int(rough * 100))
    h, src_idx, W = jcm._patch_tables(R, rough, 0.99)
    cube = rng.rand(6, R, R, 3).astype(np.float32)
    g = rng.randn(6, R, R, 3).astype(np.float32)
    want, (want_g,) = _vjp(lambda c: jcm._specular_apply_patch(c, src_idx, W,
                                                               h),
                           jnp.asarray(cube), cot=g)
    c = torch.tensor(cube, requires_grad=True)
    out = cm._specular_apply_patch(c, torch.as_tensor(np.asarray(src_idx)),
                                   torch.as_tensor(np.array(W)), h)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    out.backward(torch.as_tensor(g))
    np.testing.assert_allclose(c.grad.numpy(), want_g, rtol=0, atol=1e-5)


@pytest.mark.parametrize("R,h,w", [(16, 32, 64), (64, 128, 256)])
def test_latlong_sampler_vjp_matches_jax(R, h, w):
    """The sampler's forward equals JAX's (1e-6, the same taps) and its
    backward JAX's sorted gather and cumsum segments within 4 f32 ulps
    (2^-23) of the largest prefix sum of the sorted tap cotangents (both
    are differences of f32 prefix sums over all 4HW taps, rounded in
    another association, so the rounding scales with the prefix); two
    backward calls give the same bits."""
    rng = np.random.RandomState(R + h)
    base = rng.uniform(0, 2, (6, R, R, 3)).astype(np.float32)
    g = rng.randn(h, w, 3).astype(np.float32)
    want, (want_g,) = _vjp(jax_light.make_latlong_sampler(R, (h, w)),
                           jnp.asarray(base), cot=g)
    sample = light_mod.make_latlong_sampler(R, (h, w))
    grads = []
    for _ in range(2):
        b = torch.tensor(base, requires_grad=True)
        out = sample(b)
        out.backward(torch.as_tensor(g))
        grads.append(b.grad)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    _, tap_w, order, _ = light_mod._latlong_struct(R, h, w)
    taps = (g.reshape(-1, 1, 3) * tap_w[..., None]).reshape(-1, 3)
    prefix = np.abs(np.cumsum(taps[order], axis=0)).max()
    np.testing.assert_allclose(grads[0].numpy(), want_g, rtol=0,
                               atol=4 * 2.0 ** -23 * prefix)
    assert torch.equal(grads[0], grads[1])


def _graph_nodes(t: torch.Tensor) -> set:
    seen, stack, names = set(), [t.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


def test_light_backward_has_no_index_backward():
    """Phase 2's light path under autograd: the light built from a leaf
    cubemap (base 64: a patch level, two dense levels, the diffuse cube),
    split-sum shading of leaf G-buffer images, and env-TV. Its backward
    graph holds the transposes' own nodes and no autograd index backward
    (`IndexBackward0` sorts the indices and sums each run serially on the
    card), and the cubemap receives a gradient."""
    rng = np.random.RandomState(21)
    H, W = 8, 12
    spec, arrays = light_mod.build_prefilter_tables(64, device="cpu")
    base = torch.tensor(rng.uniform(0, 2, (6, 64, 64, 3)).astype(np.float32),
                        requires_grad=True)
    leaf = lambda c: torch.tensor(rng.rand(c, H, W).astype(np.float32),
                                  requires_grad=True)
    normals, views = leaf(3), leaf(3)
    albedo, rough, metal, occ = leaf(3), leaf(1), leaf(1), leaf(1)
    light = light_mod.build_mips_packed(base, spec, arrays)
    out = shading.pbr_shading_chw(
        light, torch.nn.functional.normalize(normals, dim=0),
        torch.nn.functional.normalize(views, dim=0), albedo, rough,
        torch.ones(1, H, W, dtype=torch.bool), occlusion=occ,
        metallic=metal, gamma=True)
    loss = sum(out[k].sum() for k in ("render_rgb", "diffuse_rgb",
                                      "specular_rgb"))
    loss = loss + trainer.env_tv_loss(base)
    names = _graph_nodes(loss)
    assert not names & {"IndexBackward0", "IndexPutBackward0"}, names
    assert {"_TakeRowsBackward", "_PatchFilterBackward",
            "_LatlongSampleBackward", "_CubemapMipBackward"} <= names
    loss.backward()
    assert float(base.grad.abs().max()) > 0
    assert float(rough.grad.abs().max()) > 0
