"""The port's phase-2 quality gate against the JAX gate on the CPU from
its reference init (raw BRDF fields 1.0, a fresh cubemap), beside
tests/test_torch_quality_gate.py, whose JAX settings it shares: the
rasterizer's jnp oracles, the coherent march and the patch filter in
interpret mode, one small env-BRDF LUT."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gi_gs_tpu.train import trainer as jtrainer

from gi_gs_tpu_torch import quality_gate as qg
from gi_gs_tpu_torch.train import trainer

from test_torch_render import shared_lut  # noqa: F401  (autouse fixture)
from test_torch_quality_gate import (LIGHT, P2, jax_oracles,  # noqa: F401
                                     jq, record_steps)

torch.set_num_threads(1)


@pytest.fixture
def shared_cubemap(monkeypatch):
    """The phase-2 initial cubemap from numpy on both sides (JAX draws it
    from jax.random, the port from torch.Generator)."""
    cube = np.random.RandomState(7).uniform(
        0.25, 0.75, (6, LIGHT, LIGHT, 3)).astype(np.float32)
    jmake, pmake = jtrainer.make_train_state, trainer.make_train_state
    monkeypatch.setattr(jtrainer, "make_train_state", lambda *a, **k: jmake(
        *a, **k)._replace(cubemap=jnp.asarray(cube)))
    monkeypatch.setattr(trainer, "make_train_state", lambda *a, **k: pmake(
        *a, **k).replace(cubemap=torch.as_tensor(cube)))


def test_phase2_gate_matches_jax(shared_cubemap, monkeypatch):
    """Two steps of the phase-2 gate from the reference init under one
    numpy-drawn cubemap. The GT renders the steps were given agree within
    5e-3 (JAX's coherent SSR packs RGB into 11-11-10 bits); the albedo
    PSNR within 0.05 dB, its median ratios within 1e-2 relative and the
    envmap correlations within 1e-4. The albedo moved: it starts flat,
    and only the fast-forward of the optimizer counts gives the BRDF
    schedule a rate."""
    jimg, pimg = record_steps(monkeypatch, "make_phase2_step")
    want = jq.run_phase2_gate(**P2)
    got = qg.run_phase2_gate(**P2, device="cpu")
    assert len(pimg) == len(jimg) == P2["iters"]
    for a, b in zip(pimg, jimg):
        assert a.max() > 0.1
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-3)
    assert abs(got["albedo_psnr"] - want["albedo_psnr"]) < 0.05
    for k in ("env_corr", "env_irradiance_corr"):
        assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])
    np.testing.assert_allclose(got["albedo_ratio"], want["albedo_ratio"],
                               rtol=1e-2)
    assert (got["iters"], got["size"]) == (want["iters"], want["size"])
    assert got["steps_per_s"] > 0
