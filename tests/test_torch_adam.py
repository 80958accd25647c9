"""GroupAdam's two routes on the CPU: CPU tensors take the plain chain
(`adam_step`), with no kernel built or launched, inside one span `adam`;
the host side of the `adam` kernel's launch (its table of groups: the f32
rate and the f32 reciprocals of the bias corrections, the pointers and
sizes, the chain's f32 constants) against numpy's f32 arithmetic; and
the launcher refusing CPU tensors. The kernel itself is held bit-equal
to the chain by the card tests (tests/test_torch_kernels_cuda.py)."""
import numpy as np
import pytest
import torch

from gi_gs_tpu_torch.config import OptimizationConfig
from gi_gs_tpu_torch.ops import cuda_kernels as ck
from gi_gs_tpu_torch.train import optim
from gi_gs_tpu_torch.utils import timing

import adam_cases

F32 = np.float32


@pytest.mark.parametrize("group", ["gaussians", "light"])
def test_cpu_step_takes_the_plain_chain(group):
    tx = adam_cases.optimizer(group)
    view, grads, state = adam_cases.step_inputs(group, 3)
    before = dict(ck.launches)
    timing.start_spans()
    new_view, new_state = tx.step(grads, state, view)
    rec = timing.stop_spans()
    assert ck.launches == before and ck._lib is None
    assert [s.name for s in rec.spans] == ["adam"]
    assert list(new_view) == list(view)
    for f, p in view.items():
        grp = optim.GROUP_OF_FIELD.get(f, f)
        want_p, want_st = optim.adam_step(p, grads[f], state[grp],
                                          tx.lrs[grp])
        assert torch.equal(new_view[f], want_p)
        assert torch.equal(new_state[grp]["mu"], want_st["mu"])
        assert torch.equal(new_state[grp]["nu"], want_st["nu"])
        assert new_state[grp]["count"] == 3


def _rates():
    opt = OptimizationConfig()
    tx = optim.build_optimizer(opt, 2.7)
    return {"xyz": tx.lrs["xyz"], "albedo": tx.lrs["albedo"],
            "f_rest": tx.lrs["f_rest"], "cubemap": opt.opacity_lr}


@pytest.mark.parametrize("count", adam_cases.COUNTS)
@pytest.mark.parametrize("group", sorted(_rates()))
def test_table_scalars_are_f32_arithmetic(group, count):
    """[rate, 1 / bc1, 1 / bc2] of the step to `count`: the rate at the
    count before it (the scheduled ones in f32 already), each rounded to
    f32 once, and the reciprocals in f32 of the f32 corrections, as
    PyTorch's CUDA division by a CPU scalar takes them."""
    lr = _rates()[group]
    rate = lr(count - 1) if callable(lr) else lr
    got = optim.adam_scalars(count, rate)
    assert got.dtype == np.float32
    bc1 = F32(1.0 - 0.9 ** count)
    bc2 = F32(1.0 - 0.999 ** count)
    want = np.array([F32(rate), F32(1) / bc1, F32(1) / bc2], np.float32)
    assert got.tobytes() == want.tobytes()
    if group == "albedo":
        # the BRDF's schedule is 0 before its offset and starts at it
        assert (got[0] > 0) == (count == 30_001)


def test_constants_are_the_chains_f32_scalars():
    assert optim.F32_CONSTANTS == tuple(
        float(F32(v)) for v in (1 - 0.9, 0.9, 1 - 0.999, 0.999, 1e-15))
    assert F32(optim.F32_CONSTANTS[0]) == F32(0.1)


def test_table_rows_hold_pointers_sizes_and_scalars():
    view, grads, state = adam_cases.step_inputs("gaussians", 2)
    groups = []
    for f, p in view.items():
        st = state[optim.GROUP_OF_FIELD[f]]
        out = [torch.empty_like(p) for _ in range(3)]
        groups.append((p, grads[f], st["mu"], st["nu"], *out,
                       optim.adam_scalars(2, 0.01 * len(groups))))
    ptrs, scalars = optim.adam_table(groups)
    assert ptrs.shape == (10, 8) and ptrs.dtype == np.int64
    assert scalars.shape == (10, 3) and scalars.dtype == np.float32
    for row, srow, grp in zip(ptrs, scalars, groups):
        assert list(row[:7]) == [t.data_ptr() for t in grp[:7]]
        assert row[7] == grp[0].numel()
        assert srow.tobytes() == grp[7].tobytes()
    sizes = dict(zip(view, ptrs[:, 7]))
    assert sizes["features_rest"] == adam_cases.SLOTS * 45
    assert sum(ptrs[:, 7]) == adam_cases.SLOTS * 67
    assert any(n % 4 for n in ptrs[:, 7])


def test_launcher_refuses_cpu_tensors():
    view, grads, state = adam_cases.step_inputs("light", 1)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        optim.adam_cuda([("cubemap", view["cubemap"], grads["cubemap"],
                          state["cubemap"], 0.05)])
    assert ck._lib is None


def test_loaded_moments_are_contiguous():
    """The CPU chain leaves normal's and albedo's moments column-major (as
    their gradients arrive); a checkpoint's moments load contiguous, as
    the CUDA launcher takes them."""
    from gi_gs_tpu_torch.utils import checkpoint
    mu = torch.arange(12.0).reshape(3, 4).t()
    assert not mu.is_contiguous()
    got = checkpoint._opt_to({"normal": {"mu": mu, "nu": mu.numpy(),
                                         "count": 7}}, "cpu")["normal"]
    for k in ("mu", "nu"):
        assert got[k].is_contiguous() and torch.equal(got[k], mu)
    assert got["count"] == 7
