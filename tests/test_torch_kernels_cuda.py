"""The eight CUDA kernels against their plain PyTorch versions on the card
(csrc/*.cu, built at first use). Marked `cuda`: they skip without a GPU.
On a machine with one (without JAX, so skip the tests' conftest):
    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py"""
import numpy as np
import pytest
import torch

from gi_gs_tpu_torch.ops import cubemap as cm
from gi_gs_tpu_torch.ops import cuda_kernels as ck
from gi_gs_tpu_torch.ops import screen_space as ss
from gi_gs_tpu_torch.ops.rasterize import RasterConfig, binning, composite
from gi_gs_tpu_torch.ops.rasterize.preprocess import preprocess
from gi_gs_tpu_torch.scene.cameras import make_camera
from gi_gs_tpu_torch.utils.math_utils import build_covariance_3d

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _scene(dev, n=4000, w=200, h=120, seed=0):
    rng = np.random.RandomState(seed)
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.7, w, h, device=dev)
    z = rng.uniform(1, 5, (n, 1))
    xyz = np.concatenate([rng.uniform(-0.45, 0.45, (n, 2)) * z, z], 1)
    q = rng.normal(size=(n, 4))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    cov = build_covariance_3d(t(np.exp(rng.uniform(-4, -2.5, (n, 3)))),
                              t(q / np.linalg.norm(q, axis=1, keepdims=True)))
    op = t(rng.uniform(0.05, 0.99, (n, 1)))
    cfg = RasterConfig(cap_instances=1 << 16)
    pre = preprocess(t(xyz), cov, cam.w2c, cam.full_proj, cam.tanfovx,
                     cam.tanfovy, w, h, cfg, opacity=op)
    feats = t(rng.uniform(0, 1, (n, 15)))
    return cfg, pre, op, feats, (h, w)


def tie_table(gap):
    """Two Gaussians with the same footprint centred on pixel (5, 3) of
    one 8x32 tile, opacities 0.2 then 0.25, and `gap` zero-opacity
    instances between them. At the centre alpha is the opacity, and in
    f32 0.25 * (1 - 0.2) == 0.2: the two weights tie exactly, in the
    oracle's cumulative product, the Pallas kernel's and the sequential
    walk alike. The first (depth 2) must win the tie."""
    n = gap + 2
    table = np.zeros((n, 21), np.float32)
    table[:, 0:2] = (5.0, 3.0)
    table[:, 2:5] = (0.02, 0.0, 0.02)
    table[:, 5] = 0.0
    table[0, 5], table[-1, 5] = 0.2, 0.25
    table[:, 6:17] = np.random.RandomState(0).uniform(0, 1, (n, 11))
    table[:, 17] = np.arange(n) + 2.0
    table[:, 18:21] = np.arange(n)[:, None] * np.array([1.0, -1.0, 0.5])
    f = np.float32
    assert f(0.25) * (f(1) - f(0.2)) == f(0.2)
    return table


def test_expand_matches_plain(dev):
    cfg, pre, _, _, (h, w) = _scene(dev)
    before = ck.launches["expand"]
    k = binning.expand(pre, h, w, cfg)
    p = binning._expand_plain(pre, h, w, cfg)
    assert ck.launches["expand"] == before + 1
    for a, b in zip(k[:4], p[:4]):
        assert torch.equal(a, b)


def test_composite_matches_plain(dev):
    cfg, pre, op, feats, (h, w) = _scene(dev, seed=1)
    b = binning.bin_and_sort(pre, h, w, cfg)
    table = torch.cat([pre.means2d, pre.conic, op, feats[:, :11],
                       pre.depth[:, None], pre.pos_view], 1).contiguous()
    grid = cfg.grid(h, w)
    ka, kt = composite.composite_fwd(table, b.ids, b.tile_start,
                                     b.tile_count, cfg, grid)
    pa, pt = composite._composite_fwd_plain(table, b.ids, b.tile_start,
                                            b.tile_count, cfg, grid)
    torch.testing.assert_close(ka, pa, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kt, pt, rtol=1e-5, atol=1e-6)


def test_composite_fwd_peak_matches_plain(dev):
    """The peak kernel's accumulator and final-T rows equal the peak=False
    kernel's bit for bit (the same walk); its peak rows match the plain
    version's on all but near-tie pixels (<= 0.1% of covered pixels: the
    plain cumulative product and the sequential product round apart);
    a constructed exact tie resolves to the first instance on the card."""
    cfg, pre, op, feats, (h, w) = _scene(dev, seed=4)
    b = binning.bin_and_sort(pre, h, w, cfg)
    table = torch.cat([pre.means2d, pre.conic, op, feats[:, :11],
                       pre.depth[:, None], pre.pos_view], 1).contiguous()
    grid = cfg.grid(h, w)
    args = (table, b.ids, b.tile_start, b.tile_count, cfg, grid)
    before = dict(ck.launches)
    ka, kt, kp = composite.composite_fwd(*args, peak=True)
    assert ck.launches["composite_fwd_peak"] == \
        before["composite_fwd_peak"] + 1
    assert ck.launches["composite_fwd"] == before["composite_fwd"]
    fa, ft = composite.composite_fwd(*args)
    assert torch.equal(ka, fa) and torch.equal(kt, ft)
    pa, pt, pp = composite._composite_fwd_plain(*args, peak=True)
    torch.testing.assert_close(ka, pa, rtol=1e-5, atol=1e-5)
    covered = pa[:, 3] > 1e-6
    differ = (kp != pp).any(dim=1) & covered
    assert int(covered.sum()) > 1000
    assert int(differ.sum()) <= 1e-3 * int(covered.sum())

    for gap in (0, 7):
        tie = torch.as_tensor(tie_table(gap), device=dev)
        ids = torch.arange(16, dtype=torch.int32, device=dev) % tie.shape[0]
        ts = torch.zeros(1, dtype=torch.int32, device=dev)
        tc = torch.full((1,), tie.shape[0], dtype=torch.int32, device=dev)
        tcfg = RasterConfig(tile_h=8, tile_w=32, cap_tile=256, chunk=8)
        _, _, k = composite.composite_fwd(tie, ids, ts, tc, tcfg, (1, 1),
                                          peak=True)
        _, _, p = composite._composite_fwd_plain(tie, ids, ts, tc, tcfg,
                                                 (1, 1), peak=True)
        assert torch.equal(k, p)
        assert torch.equal(k[0, :, 3 * 32 + 5], tie[0, 17:21])


def test_composite_bwd_matches_plain(dev):
    """Gradient rows and the per-Gaussian reduction against the plain
    backward, at the JAX test tolerance (rtol 2e-4, atol 2e-5 x the
    largest column maximum): the kernel sums each instance's pixels in
    warp order, the plain version per chunk."""
    cfg, pre, op, feats, (h, w) = _scene(dev, seed=2)
    b = binning.bin_and_sort(pre, h, w, cfg)
    table = torch.cat([pre.means2d, pre.conic, op, feats[:, :11],
                       pre.depth[:, None], pre.pos_view], 1).contiguous()
    grid = cfg.grid(h, w)
    acc, ft = composite.composite_fwd(table, b.ids, b.tile_start,
                                      b.tile_count, cfg, grid)
    g = torch.Generator(device=dev).manual_seed(3)
    g_acc = torch.randn(acc.shape, device=dev, generator=g)
    g_t = torch.randn(ft.shape, device=dev, generator=g)
    args = (table, b.ids, b.tile_start, b.tile_count,
            acc[:, :4].contiguous(), ft, g_acc, g_t, cfg, grid, (h, w))
    before = ck.launches["composite_bwd"]
    k = composite.composite_bwd(*args)
    assert ck.launches["composite_bwd"] == before + 1
    p = composite._composite_bwd_plain(*args)
    red = lambda r: composite.reduce_sorted_instance_grads(r, b.inv_perm,
                                                           b.offsets)
    for got, want in ((k, p), (red(k), red(p))):
        scale = float(want.abs().amax(dim=0).max()) + 1e-3
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5 * scale)


@pytest.mark.parametrize("with_rgb", [False, True])
def test_gi_march_matches_plain(dev, with_rgb):
    h, w = 60, 90
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    z = 2.5 + 0.4 * np.sin(xs / 11) + 0.3 * np.cos(ys / 7)
    z[:, w // 2:] += 0.8
    fx = float(np.float32(0.9 * w))
    pos = torch.tensor(np.stack([(xs - w / 2) / fx * z, (ys - h / 2) / fx * z,
                                 z]), dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    nrm = torch.randn(3, h, w, device=dev, generator=g)
    nrm[2] -= 1.5
    rgb = torch.rand(3, h, w, device=dev, generator=g) if with_rgb else None
    p = ss.GIParams()
    ko, kd = ss.gi_march(nrm, pos, rgb, fx, fx, p)
    po, pd = ss._gi_march_plain(nrm, pos, rgb, fx, fx, p)
    # same hits; the sums run in another order
    torch.testing.assert_close(ko, po, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(kd, pd, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("R,rough", [(64, 0.36), (128, 0.22)])
def test_patch_matches_plain(dev, R, rough):
    h, src, W = cm._patch_tables(R, rough, 0.99)
    W = torch.as_tensor(W, device=dev)
    src = torch.as_tensor(src, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    cmap = torch.rand(6, R, R, 3, device=dev, generator=g)
    k = cm._specular_apply_patch(cmap, src, W, h)
    p = cm._apply_patch_plain(cmap, src, W, h)
    torch.testing.assert_close(k, p, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_rgb", [False, True])
def test_gi_march_coherent_matches_plain(dev, with_rgb):
    """One full 128-column block and a partial one whose centre lies in
    the padding. The offset table built on the card equals the one built
    on the CPU (integer keys, no mismatch allowed); the kernel matches the
    plain coherent march on the same keys (same hits, sums over the
    directions in another order: rtol 1e-5, atol 1e-4)."""
    h, w = 48, 200
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    z = 2.5 + 0.4 * np.sin(xs / 11) + 0.3 * np.cos(ys / 7)
    z[:, w // 2:] += 0.8
    fx = float(np.float32(0.9 * w))
    pos = torch.tensor(np.stack([(xs - w / 2) / fx * z, (ys - h / 2) / fx * z,
                                 z]), dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    nrm = torch.randn(3, h, w, device=dev, generator=g)
    nrm[2] -= 1.5
    rgb = torch.rand(3, h, w, device=dev, generator=g) if with_rgb else None
    p = ss.GIParams()
    tab = ss.direction_table(p)[0]
    keys = ss.centre_offset_table(nrm, pos, torch.as_tensor(tab, device=dev),
                                  fx, fx, p)
    keys_cpu = ss.centre_offset_table(nrm.cpu(), pos.cpu(),
                                      torch.as_tensor(tab), fx, fx, p)
    assert torch.equal(keys.cpu(), keys_cpu)
    before = ck.launches["gi_march_coherent"]
    ko, kd = ss.gi_march_coherent(nrm, pos, rgb, fx, fx, p)
    assert ck.launches["gi_march_coherent"] == before + 1
    po, pd = ss._gi_march_coherent_plain(nrm, pos, rgb, keys, p)
    torch.testing.assert_close(ko, po, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(kd, pd, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("R,rough", [(64, 0.36), (128, 0.22)])
def test_patch_bwd_matches_plain(dev, R, rough):
    """The transpose kernel against `_patch_bwd_plain` (the same products
    added in the same offset order, no FMA: 1e-6), and the cubemap
    gradient of the whole filter on the card (forward and backward
    kernels) against autograd of the plain filter (1e-5: the halo
    border's scatter adds in another order)."""
    h, src, W = cm._patch_tables(R, rough, 0.99)
    W = torch.as_tensor(W, device=dev)
    src = torch.as_tensor(src, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    cot = torch.randn(6, 3, R, R, device=dev, generator=g)
    P = 2 * h + 1
    before = ck.launches["patch_bwd"]
    k = cm.patch_bwd(W, cot, R, P, h)
    assert ck.launches["patch_bwd"] == before + 1
    torch.testing.assert_close(k, cm._patch_bwd_plain(W, cot, h), rtol=1e-6,
                               atol=1e-6)
    cmap = torch.rand(6, R, R, 3, device=dev, generator=g)
    gout = cot.permute(0, 2, 3, 1)
    grads = []
    for fn in (cm._specular_apply_patch, cm._apply_patch_plain):
        c = cmap.clone().requires_grad_(True)
        (fn(c, src, W, h) * gout).sum().backward()
        grads.append(c.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-5)
