"""The port's SH colour (`ops/sh._SHColour`, one autograd Function over
features_dc and features_rest with a backward derived by hand) against
JAX's `sh_to_rgb` and its vjp, and against the autograd einsum path it
replaced, at degrees 0-3, an active degree below the maximum, colours
that clamp, and a colour exactly at the clamp; float64 gradcheck."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gi_gs_tpu.ops import sh as jax_sh

from gi_gs_tpu_torch.models.gaussians import create_from_points
from gi_gs_tpu_torch.ops import sh

N = 257
# (active degree, max degree): every degree at its own maximum, and
# active degrees below a degree-3 set of coefficients
DEGREES = [(0, 0), (1, 1), (2, 2), (3, 3), (0, 3), (1, 3), (2, 3)]


def inputs(deg_max, seed, dtype=torch.float32, dc_std=1.0):
    """features_dc [N, 1, 3], features_rest [N, K-1, 3], means [N, 3] and
    campos [3], as numpy arrays; at dc_std 1 a few % of the colours
    clamp."""
    rng = np.random.RandomState(seed)
    K = (deg_max + 1) ** 2
    dt = np.float64 if dtype == torch.float64 else np.float32
    return (rng.normal(0, dc_std, (N, 1, 3)).astype(dt),
            rng.normal(0, 0.3, (N, K - 1, 3)).astype(dt),
            rng.normal(0, 2.0, (N, 3)).astype(dt),
            np.array([0.3, -0.2, 4.0], dt))


def leaves(arrays):
    dc, rest, means, campos = (torch.tensor(a) for a in arrays)
    return [t.requires_grad_() for t in (dc, rest, means)] + [campos]


def port(deg, dc, rest, means, campos, g):
    """The colour and the gradients to dc, rest and means (degree 0 gives
    means none: zeros here)."""
    out = sh.sh_to_rgb(deg, dc, rest, means, campos)
    grads = torch.autograd.grad(out, (dc, rest, means), g, allow_unused=True)
    return out, [torch.zeros_like(x) if gx is None else gx
                 for x, gx in zip((dc, rest, means), grads)]


def einsum_path(deg, dc, rest, means, campos, clamp=True):
    """The autograd path the Function replaced: the coefficients
    concatenated, the basis of the normalised direction, one einsum, the
    clamp as torch.maximum (none without `clamp`)."""
    feats = torch.cat([dc, rest], dim=1)
    d = means - campos
    n2 = (d * d).sum(-1, keepdim=True)
    d = d * torch.rsqrt(torch.maximum(n2, torch.full_like(n2, 1e-24)))
    basis = sh.sh_basis(deg, d)
    B = basis.shape[-1]
    rgb = torch.einsum("...k,...kc->...c", basis, feats[..., :B, :]) + 0.5
    return torch.maximum(rgb, rgb.new_zeros(())) if clamp else rgb


def jax_reference(deg, arrays, g):
    dc, rest, means, campos = (jnp.asarray(a) for a in arrays)
    feats = jnp.concatenate([dc, rest], axis=1)
    out, vjp = jax.vjp(lambda f, m: jax_sh.sh_to_rgb(deg, f, m, campos),
                       feats, means)
    g_feats, g_means = vjp(jnp.asarray(g))
    g_feats = np.asarray(g_feats)
    return (np.asarray(out), g_feats[:, :1], g_feats[:, 1:],
            np.asarray(g_means))


def cotangent(seed):
    return np.random.RandomState(seed + 100).normal(
        0, 1, (N, 3)).astype(np.float32)


@pytest.mark.parametrize("deg,deg_max", DEGREES)
def test_matches_jax_and_its_vjp(deg, deg_max):
    arrays = inputs(deg_max, seed=deg * 10 + deg_max)
    g = cotangent(deg)
    dc, rest, means, campos = leaves(arrays)
    out, grads = port(deg, dc, rest, means, campos, torch.tensor(g))
    ref = jax_reference(deg, arrays, g)
    assert (ref[0] == 0).any(), "no colour clamps: the mask is untested"
    np.testing.assert_allclose(out.detach().numpy(), ref[0], rtol=1e-6,
                               atol=1e-6)
    for got, want in zip(grads, ref[1:]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # coefficients past the active degree take no part
    B = (deg + 1) ** 2
    assert not grads[1][:, B - 1:].any()


@pytest.mark.parametrize("deg,deg_max", DEGREES)
def test_matches_the_einsum_path(deg, deg_max):
    arrays = inputs(deg_max, seed=deg * 10 + deg_max + 1)
    g = torch.tensor(cotangent(deg + 1))
    dc, rest, means, campos = leaves(arrays)
    out, grads = port(deg, dc, rest, means, campos, g)
    want = einsum_path(deg, dc, rest, means, campos)
    ref = torch.autograd.grad(want, (dc, rest, means), g, allow_unused=True)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    mask = (want > 0) == (out > 0)
    assert mask.all() and (want == 0).any()
    # a coefficient's gradient is one product, basis value x colour
    # gradient, on either path
    assert torch.equal(grads[0], ref[0]) and torch.equal(grads[1], ref[1])
    if ref[2] is None:                     # degree 0: no direction
        assert deg == 0 and not grads[2].any()
    else:
        torch.testing.assert_close(grads[2], ref[2], rtol=1e-5, atol=1e-6)


def test_a_colour_at_the_clamp_takes_half_its_gradient():
    """A channel whose colour is exactly 0 passes half its gradient, as
    torch.maximum (and jnp.maximum) splits a tie."""
    c0 = torch.tensor(sh.SH_C0, dtype=torch.float32)
    x = torch.tensor(-0.5, dtype=torch.float32) / c0
    for _ in range(64):
        if c0 * x + 0.5 == 0:
            break
        x = torch.nextafter(x, torch.tensor(0.0))
    assert c0 * x + 0.5 == 0
    arrays = list(inputs(1, seed=5))
    arrays[0][0, 0, 1] = x.item()
    arrays[1][0] = 0.0                       # no direction-dependent part
    dc, rest, means, campos = leaves(arrays)
    g = torch.ones(N, 3)
    out, grads = port(1, dc, rest, means, campos, g)
    assert out[0, 1] == 0
    want = einsum_path(1, dc, rest, means, campos)
    ref = torch.autograd.grad(want, (dc, rest, means), g)
    assert grads[0][0, 0, 1] == 0.5 * sh.SH_C0 * torch.ones(())
    for got, r in zip(grads, ref):
        torch.testing.assert_close(got, r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("deg,deg_max", DEGREES)
def test_gradcheck_float64(deg, deg_max):
    """Away from the clamp's kink: a colour within 0.05 of 0 is moved to
    0.1 by its DC coefficient; some channels stay clamped."""
    dc, rest, means, campos = (
        torch.tensor(a[:16] if a.ndim > 1 else a)
        for a in inputs(deg_max, seed=deg + 40, dtype=torch.float64,
                        dc_std=1.5))
    pre = einsum_path(deg, dc, rest, means, campos, clamp=False)
    near = pre.abs() < 0.05
    dc[:, 0] += torch.where(near, (0.1 - pre) / sh.SH_C0, 0.0)
    pre = einsum_path(deg, dc, rest, means, campos, clamp=False)
    assert (pre.abs() > 0.04).all() and (pre < 0).any() and (pre > 0).any()
    if deg_max:
        fn = lambda a, b, m: sh.sh_to_rgb(deg, a, b, m, campos)
        args = (dc, rest, means)
    else:                               # no rest coefficients to vary
        fn = lambda a, m: sh.sh_to_rgb(deg, a, rest, m, campos)
        args = (dc, means)
    assert torch.autograd.gradcheck(
        fn, tuple(t.requires_grad_() for t in args), eps=1e-6, atol=1e-7,
        rtol=1e-6)


def test_no_concatenation_and_both_spans():
    """colors_from_sh over a degree-3 state concatenates no coefficients:
    its only cats are torch.stack's (of [N] columns: the basis values and
    the direction's gradient). In span mode it records `sh` (forward) and
    `sh_bwd` (backward)."""
    from gi_gs_tpu_torch.utils import timing
    rng = np.random.RandomState(3)
    p = create_from_points(rng.normal(0, 1, (200, 3)).astype(np.float32),
                           rng.uniform(0, 1, (200, 3)).astype(np.float32),
                           capacity=256, max_sh_degree=3, device="cpu")
    p = p.replace(active_sh_degree=3, **{
        k: getattr(p, k).requires_grad_() for k in
        ("features_dc", "features_rest", "xyz")})
    campos = torch.tensor([0.0, 0.0, 5.0])
    timing.start_spans()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            p.colors_from_sh(campos).sum().backward()
    finally:
        rec = timing.stop_spans()
    cats = [e for e in prof.events() if e.name == "aten::cat"]
    assert len(cats) == 2
    assert all(e.cpu_parent.name == "aten::stack" for e in cats)
    assert sorted(s.name for s in rec.spans) == ["sh", "sh_bwd"]
    assert p.features_rest.grad.abs().sum() > 0


def test_cpu_tensors_take_the_plain_twin():
    """On CPU tensors the Function runs the plain twin, with the incoming
    gradient laid out as the compositing table hands it over (columns
    6:9 of a column-major [N, 21]): no kernel is built or launched, and
    the colour and gradients are the plain functions' own. The kernels'
    wrappers refuse CPU tensors instead of falling back."""
    from gi_gs_tpu_torch.ops import cuda_kernels as ck
    arrays = inputs(3, seed=7)
    dc, rest, means, campos = leaves(arrays)
    table_grad = torch.tensor(np.random.RandomState(8).normal(
        0, 1, (21, N)).astype(np.float32)).t()
    g = table_grad[:, 6:9]
    assert g.stride() == (1, N)
    out, grads = port(3, dc, rest, means, campos, g)
    assert ck.launches["sh_fwd"] == 0 and ck.launches["sh_bwd"] == 0
    assert ck._lib is None
    x = [t.detach() for t in (dc, rest, means)] + [campos]
    want, saved = sh._sh_fwd_plain(3, *x)
    assert torch.equal(out, want)
    for got, ref in zip(grads, sh._sh_bwd_plain(3, g, saved,
                                                (True, True, True))):
        assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        sh.sh_fwd(3, *x)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        sh.sh_bwd(3, g, *x, (True, True, True))
