"""The ported serving slice end to end against the JAX reference on the
CPU: `render_pbr_view` on one view with every output key (the CLI on a
carried-over JAX state is in test_torch_render_cli.py).

The JAX side runs its plain paths (expand_backend="xla", the jnp
compositing and the jnp GI march); the port runs the plain versions of
its four kernels. Both packages read one shared, small env-BRDF LUT (the
LUT generator itself is compared in test_torch_cubemap.py)."""
import dataclasses
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gi_gs_tpu import config as jax_config
from gi_gs_tpu.cli import render_cli as jax_cli
from gi_gs_tpu.models.gaussians import GaussianParams as JaxParams
from gi_gs_tpu.ops import shading as jax_shading
from gi_gs_tpu.scene.cameras import make_camera as jax_make_camera

from gi_gs_tpu_torch import config
from gi_gs_tpu_torch.cli import render_cli
from gi_gs_tpu_torch.models.gaussians import params_from_numpy
from gi_gs_tpu_torch.ops import shading
from gi_gs_tpu_torch.ops.screen_space import direction_table
from gi_gs_tpu_torch.scene.cameras import make_camera
from gi_gs_tpu_torch.utils import device as device_mod

torch.set_num_threads(1)

CAP = 1 << 15
# Keys the GI march feeds. The march is exact, so a z-buffer value one
# ulp apart between the packages (their compositing sums in other orders)
# can flip a ray's hit test sitting exactly on z + bias or z - thick; each
# flip moves occlusion by one direction weight, at most
# max(w) / sum(w) = 0.0031 with the default direction grid.
GI_KEYS = ("occlusion_map", "diffuse_rgb", "render_rgb", "indirect")


@pytest.fixture(scope="module", autouse=True)
def shared_lut():
    lut = jax_shading._brdf_lut_np(256, 64)
    mp = pytest.MonkeyPatch()
    for mod in (shading, jax_shading):
        mp.setattr(mod, "_brdf_lut_np", lambda *a: lut)
        mod._brdf_lut_quad.cache_clear()
    _drop_device_luts()
    yield
    mp.undo()
    for mod in (shading, jax_shading):
        mod._brdf_lut_quad.cache_clear()
    _drop_device_luts()


def _drop_device_luts():
    """Forget the LUT copies `device_constant` keeps, so a LUT built
    before or under the patch is not read after it."""
    for key in [k for k in device_mod._constants
                if k[0] is shading._brdf_lut_quad]:
        del device_mod._constants[key]


def gaussian_fields(n=2000, cap=2048, seed=0):
    """Raw GaussianParams fields, numpy, capacity-padded like the JAX
    trainer's state."""
    rng = np.random.RandomState(seed)
    f = dict(
        xyz=np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)),
                            rng.uniform(-0.6, 0.6, (n, 1))], 1),
        features_dc=rng.normal(0, 0.5, (n, 1, 3)),
        features_rest=rng.normal(0, 0.1, (n, 15, 3)),
        opacity=rng.normal(0.5, 1.0, (n, 1)), normal=rng.normal(size=(n, 3)),
        albedo=rng.normal(size=(n, 3)), roughness=rng.normal(size=(n, 1)),
        metallic=rng.normal(size=(n, 1)),
        scaling=rng.uniform(-4.5, -2.5, (n, 3)),
        rotation=rng.normal(size=(n, 4)))
    out = {k: np.concatenate([v, np.zeros((cap - n,) + v.shape[1:])], 0)
           .astype(np.float32) for k, v in f.items()}
    out["scaling"][n:] = -10.0
    out["rotation"][n:, 0] = 1.0
    out["alive"] = np.arange(cap) < n
    return out


def jax_cfg():
    cfg = jax_config.Config()
    cfg.raster = dataclasses.replace(cfg.raster, use_pallas=False,
                                     expand_backend="xla", cap_instances=CAP)
    cfg.gi = cfg.gi._replace(backend="jnp")
    cfg.train.light_base_res = 64
    return cfg


def jax_state(fields, cubemap):
    params = JaxParams(**{k: jnp.asarray(v) for k, v in fields.items()},
                       active_sh_degree=3, max_sh_degree=3)
    return types.SimpleNamespace(params=params, cubemap=jnp.asarray(cubemap))


def _assert_gi_close(got, want, key):
    diff = np.abs(got.astype(np.float64) - want)
    assert (diff > 1e-4).mean() < 0.01, (key, (diff > 1e-4).mean())
    assert diff.max() < 0.02, (key, diff.max())


def test_render_pbr_view_matches_jax():
    fields = gaussian_fields()
    cubemap = np.random.RandomState(1).uniform(0, 1.5, (6, 64, 64, 3)
                                               ).astype(np.float32)
    R, T = np.eye(3), np.array([0.0, 0.0, 3.0])
    want = jax_cli.render_pbr_view(jax_cfg(), jax_state(fields, cubemap),
                                   jax_make_camera(R, T, 0.9, 0.7, 64, 48),
                                   jnp.zeros(3))
    cfg = config.Config()
    cfg.raster = dataclasses.replace(cfg.raster, cap_instances=CAP)
    cfg.gi = cfg.gi._replace(backend="jnp")     # the exact march, as JAX's
    state = types.SimpleNamespace(
        params=params_from_numpy(fields, 3, 3, device="cpu"),
        cubemap=torch.as_tensor(cubemap))
    got = render_cli.render_pbr_view(
        cfg, state, make_camera(R, T, 0.9, 0.7, 64, 48, device="cpu"),
        torch.zeros(3))
    assert set(want) <= set(got)
    w = direction_table(cfg.gi)[0][:, 3]
    assert w.max() / w.sum() < 0.0032
    for key, value in want.items():
        a, b = got[key].numpy(), np.asarray(value)
        assert a.shape == b.shape, key
        if key in GI_KEYS:
            _assert_gi_close(a, b, key)
        else:
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=key)
    assert np.isfinite(got["render_rgb"].numpy()).all()


@pytest.mark.parametrize("field", ["opacity", "scaling"])
def test_activations_do_not_depend_on_position(field):
    """The CPU parity of the serving render (chip_smoke phase 6) failed in
    a few fresh processes, in the first CPU render, at preprocess
    (tools/parity_processes.py's stage hashes), which reads the activated
    opacity and scale. PyTorch's f32 `sigmoid` on the CPU gives an
    element of its vector loop's scalar tail other bits, and neither f32
    activation rounds as the card's does. Both now round an f64 value to
    f32: the same raw values activated whole and as slices of other
    lengths and offsets agree bit for bit, and match the f64 value rounded
    once (the card's bits too)."""
    rng = np.random.RandomState(0)
    n = 1 << 16
    fields = {k: np.zeros((n,) + s, np.float32) for k, s in (
        ("xyz", (3,)), ("features_dc", (1, 3)), ("features_rest", (15, 3)),
        ("opacity", (1,)), ("normal", (3,)), ("albedo", (3,)),
        ("roughness", (1,)), ("metallic", (1,)), ("scaling", (3,)),
        ("rotation", (4,)))}
    fields[field] = rng.uniform(-8, 8, fields[field].shape).astype(
        np.float32)
    fields["alive"] = np.ones(n, bool)
    get = {"opacity": "get_opacity", "scaling": "get_scaling"}[field]
    whole = getattr(params_from_numpy(fields, 3, 3, device="cpu"), get)()
    for length in (4096, 2047, 4095, 100, 17):
        for off in (0, 1, 3):
            part = {k: v[off:off + length] for k, v in fields.items()}
            got = getattr(params_from_numpy(part, 3, 3, device="cpu"), get)()
            assert torch.equal(got, whole[off:off + length])
    fn = torch.exp if field == "scaling" else torch.sigmoid
    assert torch.equal(whole, fn(torch.as_tensor(fields[field]).double())
                       .float())
