"""The port's bench (gi_gs_tpu_torch.bench) against the root bench.py on
the CPU, both shrunk alike through their module constants (H = W = 64,
N = 2000, CAP = 4096): the same scene, instance count and per-stage
work, one phase-1 loss and gradient, and the port's JSON line. The
light tables are built at light_base_res 64 where the test builds them
(256 is ~1.5 GB of host tables per side)."""
import ast
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import bench as jbench
from gi_gs_tpu.train import optim as joptim
from gi_gs_tpu.train import trainer as jtrainer
from gi_gs_tpu.utils import profiling as jprofiling

from gi_gs_tpu_torch import bench as pbench
from gi_gs_tpu_torch.models.gaussians import FIELDS, params_from_numpy
from gi_gs_tpu_torch.train import optim, trainer
from gi_gs_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(H=64, W=64, N=2000, CAP=4096)
LIGHT_RES = 64


@pytest.fixture(scope="module")
def tiny():
    """Both benches shrunk to TINY for the module's tests."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jbench, pbench):
            for k, v in TINY.items():
                mp.setattr(mod, k, v)
        yield mp


@pytest.fixture(scope="module")
def scenes(tiny):
    return jbench.build_scene(), pbench.build_scene("cpu")


@pytest.fixture(scope="module")
def jax_gaussians(scenes):
    """The root bench's Gaussians as the port's params, so the stage and
    step comparisons start from the same values (the two knn inits differ
    in the last bits, see test_build_scene_matches_root_bench)."""
    jp = scenes[0][1]
    return params_from_numpy({k: np.asarray(getattr(jp, k)) for k in FIELDS},
                             jp.active_sh_degree, jp.max_sh_degree,
                             device="cpu")


def _small_light(cfg):
    cfg.train = dataclasses.replace(cfg.train, light_base_res=LIGHT_RES)
    return cfg


def test_build_scene_matches_root_bench(scenes):
    (jcfg, jp, jcam, jimg, jalpha, jbg, jrng), \
        (cfg, p, cam, img, alpha, bg, rng) = scenes
    assert p.capacity == jp.capacity == TINY["CAP"]
    # The points bit for bit. The colours are the same draws (the rng
    # states below are equal after them); their SH DC, (rgb - 0.5) / C0,
    # is within 1 f32 ulp: XLA's CPU division by the constant rounds
    # otherwise than PyTorch's on ~18% of inputs. The log scales within
    # rtol 1e-3: the knn's |q|^2 + |p|^2 - 2 q.p cancels ~1000x at
    # |q|^2 ~ 9 over d^2 ~ 0.01, so the two matmuls' last bits show at
    # ~1.5e-4. The other fields bit for bit.
    for k in FIELDS:
        got, want = getattr(p, k).numpy(), np.asarray(getattr(jp, k))
        if k == "features_dc":
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        elif k == "scaling":
            np.testing.assert_allclose(got, want, rtol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))
    np.testing.assert_array_equal(alpha.numpy(), np.asarray(jalpha))
    np.testing.assert_array_equal(bg.numpy(), np.asarray(jbg))
    assert cfg.raster.cap_instances == jcfg.raster.cap_instances
    np.testing.assert_array_equal(cam.w2c.numpy(), np.asarray(jcam.w2c))
    np.testing.assert_array_equal(cam.full_proj.numpy(),
                                  np.asarray(jcam.full_proj))
    # the rest of the draws (the stage table's) continue alike
    np.testing.assert_array_equal(rng.get_state()[1], jrng.get_state()[1])
    assert rng.get_state()[2] == jrng.get_state()[2]
    assert (cfg.opt.densify_from_iter, cfg.train.indirect, cfg.gi) == (
        jcfg.opt.densify_from_iter, jcfg.train.indirect,
        tuple(jcfg.gi))


def _jax_stage_work(jcfg, jp, jcam):
    """Run the root bench's stage table through binning (the later stages
    skipped: the work needs only the instance count and the light tables)
    and capture the `work` and peaks its StageTimes.report receives.
    Returns (captured, n_instances)."""
    seen = {}
    orig = jprofiling.StageTimes.report

    def report(self, work=None, peak_flops=None, peak_bw=None):
        seen.update(work=work, peak_flops=peak_flops, peak_bw=peak_bw)
        return orig(self, work, peak_flops=peak_flops, peak_bw=peak_bw)

    calls = []

    def out_of_time():
        calls.append(1)
        return len(calls) > 2      # preprocess and binning run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jprofiling.StageTimes, "report", report)
        mp.setattr(jbench, "PEAK_BW", profiling.H100_HBM_BYTES_PER_S)
        mp.setattr(jbench, "PEAK_VPU", profiling.H100_F32_FLOPS)
        table, n_inst = jbench.stage_table(jcfg, jp, jcam,
                                           np.random.RandomState(1),
                                           out_of_time=out_of_time)
    assert table["composite_fwd"]["skipped_for_budget"]
    return seen, n_inst


def test_stage_work_and_roofline_match_root_bench(scenes, jax_gaussians):
    """On the root bench's Gaussians: n_instances, the per-stage work dict
    (equal) and each stage's roofline_ms from JAX's StageTimes.report with
    its peaks patched to the H100's (within rtol 1e-6).

    The port's expand culls tiles with `_expand_xla`'s exact f32 test, as
    its CUDA kernel does; the root bench's default Pallas expand slacks
    the cull for its bf16 inputs and keeps more instances. So the count
    is held to the root bench's stage table with expand_backend="xla",
    and the Pallas count is at least it."""
    (jcfg, jp, jcam, *_), (cfg, _, cam, *_) = scenes
    jcfg, cfg = _small_light(dataclasses.replace(jcfg)), \
        _small_light(dataclasses.replace(cfg))
    _, j_pallas = _jax_stage_work(jcfg, jp, jcam)
    jcfg.raster = dataclasses.replace(jcfg.raster, expand_backend="xla")
    seen, j_inst = _jax_stage_work(jcfg, jp, jcam)
    calls = []
    table, n_inst = pbench.stage_table(
        cfg, jax_gaussians, cam, np.random.RandomState(1),
        out_of_time=lambda: calls.append(1) or len(calls) > 2)
    assert n_inst == j_inst > 0
    assert j_pallas >= n_inst
    assert table["ssao"]["skipped_for_budget"]
    from gi_gs_tpu_torch.models import light as light_mod
    _, arrays = light_mod.build_prefilter_tables(LIGHT_RES, device="cpu")
    work = pbench.stage_work(cfg, n_inst, arrays)
    assert work == seen["work"]
    assert set(work) == {"preprocess", "binning", "composite_fwd",
                         "composite_fwd_bwd", "ssao", "ssr", "build_mips",
                         "pbr_shading"}
    jst, pst = jprofiling.StageTimes(), profiling.StageTimes()
    jst.times = {k: 1e-3 for k in work}
    pst.times = dict(jst.times)
    jrep = jst.report(seen["work"], peak_flops=seen["peak_flops"],
                      peak_bw=seen["peak_bw"])
    prep = pst.report(work)
    for k in work:
        assert prep[k]["roofline_ms"] == pytest.approx(
            jrep[k]["roofline_ms"], rel=1e-6), k


def test_phase1_loss_and_gradient_match_root_bench(scenes, jax_gaussians):
    """The loss and gradient of the root bench's phase-1 step (JAX's
    phase1_view_loss under value_and_grad, as make_phase1_step takes them,
    trainer.py:232-240; its Pallas kernels in interpret mode) against the
    port's, on the same scene and Gaussians. At the tolerances of
    tests/test_torch_train.py: the loss within rel 1e-5 and each field's
    gradient norm over live slots within rel 2e-4. Element by element,
    rtol 2e-4 with atol 1e-4 x the field's largest: 2000 Gaussians in
    64x64 pixels overlap far deeper than test_torch_train.py's 300 in
    64x48 (where 2e-5 holds), and a few scaling gradients, sums of terms
    of both signs, differ by up to 5e-5 of the largest."""
    (jcfg, jp, jcam, jimg, jalpha, jbg, _), \
        (cfg, _, cam, img, alpha, bg, _) = scenes
    p = jax_gaussians

    def loss_fn(view, ndc):
        return jtrainer.phase1_view_loss(jcfg, jp.replace(**view), ndc, jcam,
                                         jimg, jalpha, jbg)

    (jloss, _), (jg, _) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(
            joptim.trainable_view(jp), jnp.zeros((jp.capacity, 2)))
    loss, _, grads, _ = trainer.loss_and_grads(cfg, p, cam, img, alpha, bg)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    alive = p.alive.numpy()
    for k in optim.TRAINABLE_FIELDS:
        want = np.asarray(jg[k])[alive]
        got = grads[k].numpy()[alive]
        assert np.linalg.norm(got) == pytest.approx(np.linalg.norm(want),
                                                    rel=2e-4, abs=1e-12), k
        np.testing.assert_allclose(
            got, want, rtol=2e-4, atol=1e-4 * (np.abs(want).max() + 1e-12),
            err_msg=k)
    assert np.linalg.norm(grads["xyz"].numpy()[alive]) > 0


def test_time_steps_leaves_the_state_as_it_was(scenes):
    """Phase 2 is timed from the same state as phase 1 (the root bench
    times phase 1 on a copy): the port's steps must not mutate it."""
    _, (cfg, p, cam, img, alpha, bg, _) = scenes
    state = trainer.make_train_state(cfg, p, spatial_lr_scale=1.0)
    before = {k: getattr(p, k).clone() for k in FIELDS}
    mu = {g: s["mu"].clone() for g, s in state.opt_state.items()}
    tx = optim.build_optimizer(cfg.opt, 1.0)
    step = trainer.make_phase1_step(cfg, cameras_extent=3.0, tx=tx)
    dt, loss = pbench.time_steps(step, state, cam, img, alpha, bg, iters=1)
    assert dt > 0 and np.isfinite(loss)
    for k in FIELDS:
        assert torch.equal(getattr(state.params, k), before[k]), k
    for g, s in state.opt_state.items():
        assert s["count"] == 0 and torch.equal(s["mu"], mu[g]), g
    assert float(state.stats.denom.abs().sum()) == 0.0


def test_cuda_parity_on_cpu_is_zero():
    """On CPU tensors both sides of the parity check are the plain march."""
    out = pbench.cuda_parity(None, np.random.RandomState(0), "cpu")
    assert out == {"ssao_exact_vs_oracle_maxdiff": 0.0}


def _root_result_keys():
    """(top-level keys, `extra` keys) of the result dict in the root
    bench's main(), read from its source."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "result":
            top = {k.value: v for k, v in zip(node.value.keys,
                                              node.value.values)}
            return set(top), {k.value for k in top["extra"].keys}
    raise AssertionError("no result dict in bench.py main()")


def test_main_prints_one_json_line(tiny, capsys):
    """main(device="cpu") prints exactly one line on stdout: JSON with the
    root bench's keys (tpu_parity -> cuda_parity), a finite loss and
    every stage timed."""
    orig = pbench.build_scene

    def build_scene(dev):
        cfg, *rest = orig(dev)
        return (_small_light(cfg), *rest)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pbench, "build_scene", build_scene)
        pbench.main(device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    top, extra = _root_result_keys()
    assert set(res) == top
    assert set(res["extra"]) == (extra - {"tpu_parity"}) | {"cuda_parity"}
    ex = res["extra"]
    assert ex["loss_finite"] is True
    assert ex["device"] == "cpu"
    assert ex["resolution"] == [TINY["H"], TINY["W"]]
    assert ex["n_gaussians"] == TINY["N"] and ex["n_instances"] > 0
    assert set(ex["stages"]) == {
        "preprocess", "binning", "composite_fwd", "composite_fwd_bwd",
        "ssao", "ssr", "build_mips", "pbr_shading"}
    for name, row in ex["stages"].items():
        assert "skipped_for_budget" not in row and row["ms"] > 0, name
    assert ex["cuda_parity"] == {"ssao_exact_vs_oracle_maxdiff": 0.0}
    assert res["value"] > 0 and ex["phase2_iters_per_s"] > 0
