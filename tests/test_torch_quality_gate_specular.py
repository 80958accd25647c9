"""The port's specular phase-2 quality gate against the JAX gate on the
CPU, started at the GT (the JAX gate's diagnostic mode), beside
tests/test_torch_quality_gate.py, whose JAX settings it shares: the
rasterizer's jnp oracles, the coherent march and the patch filter in
interpret mode, one small env-BRDF LUT."""
import numpy as np
import torch

from gi_gs_tpu_torch import quality_gate as qg

from test_torch_render import shared_lut  # noqa: F401  (autouse fixture)
from test_torch_quality_gate import (P2, jax_oracles,  # noqa: F401
                                     jq, record_steps)

torch.set_num_threads(1)


def test_phase2_specular_gate_from_gt_matches_jax(monkeypatch):
    """Two steps of the specular phase-2 gate (GT roughness 0.08 and
    metallic 0.9, metallic fitted) from the GT (init_at="gt", whose
    cubemap is the GT envmap), as the JAX gate's diagnostic mode. The GT
    renders the steps were given agree within 5e-3: JAX's coherent SSR
    packs its RGB into 11-11-10 bits (pallas_gi.py:434-477), the port's
    reads f32 (tests/test_torch_render.py bounds the two alike). There
    the photometric residual is f32 residue: JAX's GT render and its
    step's forward are two XLA programs that differ in the last bits, the
    port's are bit-equal (residual 0), and Adam at eps 1e-15 turns either
    into full-lr steps of their own signs. So the bound is the state's
    distance from the GT after two such steps, not the noise's pattern:
    both stay above 30 dB albedo and 0.99 irradiance correlation, within
    2 dB and 0.01 of each other."""
    jimg, pimg = record_steps(monkeypatch, "make_phase2_step")
    want = jq.run_phase2_specular_gate(**P2, init_at="gt")
    got = qg.run_phase2_specular_gate(**P2, init_at="gt", device="cpu")
    assert len(pimg) == len(jimg) == P2["iters"]
    for a, b in zip(pimg, jimg):
        assert a.max() > 0.1
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-3)
    for r in (got, want):
        assert 30.0 < r["albedo_psnr"] < 99.0     # moved, but stayed near
        assert r["env_irradiance_corr"] > 0.99
    assert abs(got["albedo_psnr"] - want["albedo_psnr"]) < 2.0
    for k in ("env_corr", "env_irradiance_corr"):
        assert abs(got[k] - want[k]) < 0.01, (k, got[k], want[k])
