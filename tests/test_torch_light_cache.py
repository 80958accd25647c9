"""The light's prefilter tables kept on their device
(`models/light.build_prefilter_tables`): every light built on a device
after the first reads the tables the first one uploaded, a relit light is
bit-equal to one built from a fresh upload (`ops/cubemap.
build_prefilter_tables`), and tables first kept under the render CLI's
inference mode still serve a phase-2 step's light backward, with the
gradient unchanged.

Imports no JAX; the env-BRDF LUT is the small one of test_torch_spans
(`small_lut`)."""
import numpy as np
import pytest
import torch

from gi_gs_tpu_torch import config as cfg_mod
from gi_gs_tpu_torch.cli import render_cli
from gi_gs_tpu_torch.models import light as light_mod
from gi_gs_tpu_torch.ops import cubemap as cm
from gi_gs_tpu_torch.train import optim, trainer
from gi_gs_tpu_torch.utils.device import canonical

from test_torch_spans import Scene, port_cfg, small_lut  # noqa: F401

RES = 64                     # a patch level (64), two dense (32, 16)
UPLOAD = cm.build_prefilter_tables


@pytest.fixture
def fresh_tables(monkeypatch):
    """An empty table store, and the number of uploads made into it."""
    monkeypatch.setattr(light_mod, "_tables", {})
    uploads = []

    def counted(*a, **k):
        out = UPLOAD(*a, **k)
        uploads.append(out)
        return out

    monkeypatch.setattr(cm, "build_prefilter_tables", counted)
    return uploads


def fresh_upload(res):
    """The tables as every light uploaded them before they were kept."""
    return UPLOAD(
        res, min_res=light_mod.LIGHT_MIN_RES,
        min_roughness=light_mod.MIN_ROUGHNESS,
        max_roughness=light_mod.MAX_ROUGHNESS, device="cpu")


def cube(seed, res=RES):
    rng = np.random.RandomState(seed)
    return torch.as_tensor(rng.uniform(0, 1.5, (6, res, res, 3)),
                           dtype=torch.float32)


def test_two_lights_on_one_device_share_the_tables(fresh_tables):
    cfg = cfg_mod.Config()
    render_cli.build_light(cfg, cube(1))
    render_cli.build_light(cfg, cube(2))
    assert len(fresh_tables) == 1
    spec, arrays = light_mod.build_prefilter_tables(RES, device="cpu")
    again = light_mod.build_prefilter_tables(RES,
                                             device=torch.device("cpu"))
    assert len(fresh_tables) == 1
    assert spec == fresh_tables[0][0] == again[0]
    assert [a.data_ptr() for a in arrays] == \
        [a.data_ptr() for a in fresh_tables[0][1]] == \
        [a.data_ptr() for a in again[1]]
    assert not any(a.is_inference() for a in arrays)
    # another resolution is another set of tables
    light_mod.build_prefilter_tables(32, device="cpu")
    assert len(fresh_tables) == 2


def test_a_relit_light_is_bit_equal_to_a_fresh_upload(fresh_tables):
    cfg = cfg_mod.Config()
    render_cli.build_light(cfg, cube(1))            # keeps the tables
    for seed in (2, 3):                             # two new environments
        got = render_cli.build_light(cfg, cube(seed))
        spec, arrays = fresh_upload(RES)
        want = light_mod.build_mips_packed(cube(seed), spec, arrays)
        assert len(got.specular) == len(want.specular) == 3
        for g, w in zip(got.specular, want.specular):
            assert torch.equal(g, w)
        assert torch.equal(got.diffuse, want.diffuse)
    assert len(fresh_tables) == 1


def _light_gradient(tables):
    base = cube(4).requires_grad_(True)
    light = light_mod.build_mips_packed(base, *tables)
    w = [torch.linspace(0.5, 1.5, x.numel()).reshape(x.shape)
         for x in light.specular + (light.diffuse,)]
    loss = sum((x * wx).sum() for x, wx in zip(light.specular +
                                                (light.diffuse,), w))
    (g,) = torch.autograd.grad(loss, base)
    return g


def test_tables_kept_under_inference_mode_serve_a_light_backward(
        fresh_tables):
    render_cli.build_light(cfg_mod.Config(), cube(1))   # inference mode
    kept = light_mod.build_prefilter_tables(RES, device="cpu")
    got = _light_gradient(kept)
    assert len(fresh_tables) == 1
    assert torch.equal(got, _light_gradient(fresh_upload(RES)))
    assert float(got.abs().sum()) > 0


def test_tables_kept_under_inference_mode_serve_a_phase2_step(
        fresh_tables):
    """A phase-2 step made after the render CLI built a light on the same
    device takes its tables, and its cubemap gradient is the one it takes
    from tables of its own."""
    scene = Scene("cpu")
    cfg = port_cfg()
    tx = optim.build_optimizer(cfg.opt, 1.0)
    ltx = optim.build_light_optimizer(cfg.opt)

    def light_grad():
        step = trainer.make_phase2_step(cfg, 1.0, tx, ltx, "cpu")
        grads = trainer.phase2_loss_and_grads(
            cfg, step.light_tables, scene.params, scene.cubemap, scene.cam,
            scene.image, scene.alpha, scene.bg,
            trainer.compute_view_dirs(scene.cam))
        return step.light_tables, grads[-1]

    render_cli.build_light(cfg, scene.cubemap)
    tables, got = light_grad()
    assert len(fresh_tables) == 1 and tables is fresh_tables[0]
    light_mod._tables.clear()
    own, want = light_grad()
    assert own is not tables
    assert torch.equal(got, want) and float(got.abs().sum()) > 0


def test_a_device_without_its_index_is_the_current_one():
    assert canonical("cpu") == torch.device("cpu")
    assert canonical(torch.device("cpu")) == torch.device("cpu")
    if torch.cuda.is_available():
        assert canonical("cuda") == torch.device(
            "cuda", torch.cuda.current_device())
